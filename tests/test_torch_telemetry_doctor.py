"""The port's roofline doctor, peak table, telemetry sites and command
line (``distributedarrays_tpu_torch/telemetry/perf.py``, ``__main__.py``)
against the JAX package's.

- ``perf.analyze`` on one journal with the same explicit peaks (and with
  each named platform) gives an equal report in both packages, findings,
  action hints and rendering included.
- A small main path (``distribute`` -> ``dmap`` -> ``dsum`` -> ``A @ B`` ->
  ``gather``) journals the same span names, label keys and cost stamps
  in both packages (durations left out), and the same comm records.
- Every subcommand of the command line but ``advise`` prints the same
  output on the same journal (the live ones, ``agg``, ``stream`` and
  ``top``, up to ports and timings); ``advise`` runs the port's advisor
  (its parity with JAX's is in ``tests/test_torch_advisor.py``).
- The peak table holds the H100 under JAX's schema and maps
  ``torch.cuda.get_device_name()`` onto it; the journal carries the
  device kind that the doctor reads.
"""

import contextlib
import io
import json
import re

import numpy as np
import pytest
import torch

from distributedarrays_tpu import telemetry as JT
from distributedarrays_tpu.telemetry import __main__ as JCLI
from distributedarrays_tpu.telemetry import perf as JP

import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu_torch import telemetry as TT
from distributedarrays_tpu_torch.telemetry import __main__ as TCLI
from distributedarrays_tpu_torch.telemetry import perf as TP
from distributedarrays_tpu_torch.telemetry.fixtures import (  # noqa: F401
    telemetry_capture)

from _torch_port import (jax_plan_cache, jax_process_state,  # noqa: F401
                         port_ranks)

X = np.arange(64 * 32, dtype=np.float32).reshape(64, 32) / 100
Y = np.arange(32 * 16, dtype=np.float32).reshape(32, 16) / 100
PEAKS = {"flops": 5e9, "hbm": 2e9, "ici": 1e9}


@contextlib.contextmanager
def jax_journal(path):
    """JAX's telemetry on, journaling to ``path``; its prior switch and
    journal path restored after (``jax_process_state`` restores the
    registry)."""
    core = JT.core
    prev_en, prev_path = core.enabled(), core.journal_path()
    core.reset()
    core.configure(str(path))
    core.enable()
    try:
        yield
    finally:
        core.reset()
        core.configure(prev_path)
        if prev_en:
            core.enable()
        else:
            core.disable()


def _read(path) -> list:
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _main_path(pkg, mk):
    a, b = pkg.distribute(mk(X)), pkg.distribute(mk(Y))
    c = pkg.dmap(lambda t: t * 2, a)
    pkg.dsum(c)
    return np.asarray(c @ b)


def _spans(events) -> list:
    return [(e["name"], sorted(e.get("labels", {})),
             {k: e["labels"][k] for k in ("flops", "bytes_hbm", "bytes_ici")
              if k in e.get("labels", {})})
            for e in events if e.get("cat") == "span"]


def _comm(events) -> list:
    return [{k: v for k, v in e.items() if k in ("name", "bytes", "op",
                                                  "shape", "grid")}
            for e in events if e.get("cat") == "comm"]


def test_main_path_journals_the_same_spans_and_stamps(tmp_path,
                                                      telemetry_capture):
    with jax_journal(tmp_path / "jax.jsonl"):
        want = _main_path(__import__("distributedarrays_tpu"), lambda x: x)
    got = _main_path(tdat, torch.from_numpy)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    jev = _read(tmp_path / "jax.jsonl")
    tev = _read(telemetry_capture.journal_path())
    assert _spans(tev) == _spans(jev)
    assert [s[0] for s in _spans(tev)] == ["distribute", "distribute",
                                           "matmul", "gather"]
    assert _comm(tev) == _comm(jev)


def _journal(path) -> list:
    """A port journal with cost-stamped spans of every kind the doctor
    reads: the main path, a mapreduce, a trainer step (``train.step``,
    ``train.grad``, ``train.sync``), a ring GEMM span, and nested spans
    that leave a coverage gap."""
    TT.configure(str(path))
    _main_path(tdat, torch.from_numpy)
    tdat.dmapreduce(torch.square, "sum", tdat.distribute(torch.ones(64, 8)))
    with tdat.Trainer(tdat.train.mlp_task(sizes=(4, 8, 2), batch_size=8),
                      ranks=[0, 1, 2, 3]) as t:
        t.fit(2)
    tdat.autotune.record("matmul_impl_dist", tdat.autotune.device_key_for(
        64, 16, 32, 4, torch.float32, torch.float32), "ring_ag")
    A = tdat.distribute(torch.from_numpy(X), procs=range(4), dist=(4, 1))
    B = tdat.distribute(torch.from_numpy(Y), procs=range(4), dist=(4, 1))
    np.asarray(A @ B)
    with TT.span("outer", flops=10, bytes_hbm=10, bytes_ici=0):
        with TT.span("inner"):
            sum(range(1000))
    TT.configure(None)
    return _read(path)


@pytest.fixture
def journal(tmp_path, telemetry_capture):
    path = tmp_path / "run.jsonl"
    events = _journal(path)
    tdat.autotune.clear()
    return path, events


@pytest.mark.parametrize("how", ["peaks", "cpu", "v5e", "h100"])
def test_analyze_gives_the_same_report(journal, how):
    _, events = journal
    kw = {"peaks": dict(PEAKS)} if how == "peaks" else {"platform": how}
    if how == "h100":
        # JAX's table has no h100 row: hand it the port's
        kw = {"peaks": TP.peaks_for("h100")}
    want, got = JP.analyze(events, **kw), TP.analyze(events, **kw)
    assert got == want
    assert {c["name"] for c in got["classified"]} >= {
        "matmul", "train.step", "matmul.ring_ag", "distribute",
        "gather", "mapreduce"}
    jout, tout = io.StringIO(), io.StringIO()
    JP.format_analysis(want, jout)
    TP.format_analysis(got, tout)
    assert tout.getvalue() == jout.getvalue()


def test_peak_table_holds_the_h100():
    h = TP.peaks_for("NVIDIA H100 80GB HBM3")
    assert h == {"flops": 989e12, "hbm": 3.35e12, "ici": 450e9,
                 "platform": "h100"}
    for name in ("h100", "NVIDIA H100", "nvidia h100 80gb hbm3"):
        assert TP.platform_alias(name) == "h100"
    # JAX's schema and rows otherwise
    for plat in ("tpu-v5e", "tpu-v5p", "cpu"):
        assert TP.DEFAULT_PEAKS[plat] == JP.DEFAULT_PEAKS[plat]
    assert set(TP.DEFAULT_PEAKS["h100"]) == set(JP.DEFAULT_PEAKS["cpu"])
    assert TP.platform_alias("some other card") == "cpu"
    assert TP.reduce_cost(100, 2) == JP.reduce_cost(100, 2)
    assert TP.reduce_cost(7, 4, flops_per_elem=3) == \
        JP.reduce_cost(7, 4, flops_per_elem=3)


def test_peaks_override_reaches_the_h100_row(monkeypatch):
    monkeypatch.setenv("DA_TPU_PEAKS", json.dumps({"h100": {"flops": 1e15}}))
    assert TP.peaks_for("NVIDIA H100 80GB HBM3")["flops"] == 1e15
    monkeypatch.setenv("DA_TPU_PEAKS", json.dumps({"hbm": 3e12}))
    p = TP.peaks_for("h100")
    assert p["hbm"] == 3e12 and p["flops"] == 989e12


def test_journal_carries_the_device_kind(tmp_path, telemetry_capture):
    TT.configure(str(tmp_path / "k.jsonl"))
    tdat.init(nranks=8, device="cpu")
    events = _read(tmp_path / "k.jsonl")
    assert TP.journal_platform(events) == "cpu"
    # a card's name, as torch.cuda.get_device_name gives it, selects the
    # h100 row; an explicit platform or peaks win
    events.append({"cat": "device", "name": "platform",
                   "platform": "NVIDIA H100 80GB HBM3"})
    assert TP.analyze(events)["platform"] == "h100"
    assert TP.analyze(events, platform="cpu")["platform"] == "cpu"
    assert TP.journal_platform([]) is None
    assert TP.analyze([])["platform"] == "cpu" == JP.analyze([])["platform"]


def test_kernel_wrapper_spans_carry_jax_stamps(telemetry_capture):
    from distributedarrays_tpu_torch.ops import cuda_attention as CA
    from distributedarrays_tpu_torch.ops import cuda_gemm as CG
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    CG.cuda_matmul(a, b)
    qa = torch.randint(-5, 5, (8, 16), dtype=torch.int8)
    qb = torch.randint(-5, 5, (16, 4), dtype=torch.int8)
    CG.cuda_matmul_int8(qa, qb, torch.ones(8), torch.ones(4))
    q = torch.randn(8, 2, 4)
    CA.flash_attention(q, q, q, causal=True)
    got = {s["name"]: s for s in telemetry_capture.spans()}
    mm = got["pallas.matmul"]["labels"]
    assert mm["flops"] == 2 * 8 * 4 * 16 and mm["bytes_ici"] == 0
    assert mm["bytes_hbm"] == (8 * 16 + 16 * 4 + 8 * 4) * 4
    assert mm["shape"] == [8, 16, 4] and "autotune_key" in mm
    i8 = got["pallas.matmul_int8"]["labels"]
    assert {k: i8[k] for k in ("flops", "bytes_hbm", "bytes_ici")} == \
        JP.gemm_cost(8, 4, 16, 1, out_itemsize=4)
    assert "pallas.flash_attention" in got


def test_collective_sites_count_dispatch_and_comm(telemetry_capture):
    from distributedarrays_tpu_torch.ops import cuda_collectives as CC
    blocks = [torch.ones(4, 3) * r for r in range(4)]
    CC.ring_all_gather(blocks, 0)
    CC.ring_reduce_scatter(blocks, 0)
    tdat.preduce(blocks)
    tdat.pshift(blocks)
    for op in ("ring_all_gather", "ring_reduce_scatter"):
        assert telemetry_capture.counter_value(
            "pallas_collectives.dispatch", op=op, path="plain") == 1
    assert telemetry_capture.comm_bytes("psum") > 0
    assert telemetry_capture.comm_bytes("ppermute") > 0
    tdat.run_spmd(lambda x: tdat.pshift(x), list(range(4)), blocks)
    assert telemetry_capture.counter_value("op.run_spmd") == 1


def test_sites_cost_one_check_when_disabled(telemetry_capture,
                                            monkeypatch):
    # with telemetry disabled a site costs its one check: no cost stamp,
    # byte count, label or comm record is computed, and nothing recorded
    from distributedarrays_tpu_torch.ops import cuda_collectives as CC
    from distributedarrays_tpu_torch.ops import linalg as TL
    from distributedarrays_tpu_torch.parallel import collectives as PC

    def refuse(*args, **kw):
        raise AssertionError("a disabled telemetry site did work")
    TT.disable()
    try:
        for mod, name in ((TP, "gemm_cost"), (TP, "reduce_cost"),
                          (TT, "record_comm"), (TT, "nbytes_of"),
                          (TT, "annotate")):
            monkeypatch.setattr(mod, name, refuse)
        a = tdat.distribute(torch.from_numpy(X))
        np.asarray(a @ tdat.distribute(torch.from_numpy(Y)))
        tdat.dsum(a)
        A = tdat.distribute(torch.from_numpy(X), dist=(4, 1), procs=range(4))
        B = tdat.distribute(torch.from_numpy(Y), dist=(4, 1), procs=range(4))
        TL._ring_ag_gemm(A, B, torch.float32)
        A = tdat.distribute(torch.from_numpy(X), dist=(2, 2), procs=range(4))
        B = tdat.distribute(torch.from_numpy(Y), dist=(2, 2), procs=range(4))
        TL._summa_gemm(A, B, torch.float32)
        blocks = [torch.full((8,), float(r)) for r in range(4)]
        PC.pbarrier(blocks)
        PC.pbcast(blocks)
        PC.pshift(blocks)
        PC.pgather(blocks)
        PC.preduces([blocks])
        PC.pall_to_all(blocks, 0, 0)
        CC.ring_all_gather(blocks)
        CC.ring_reduce_scatter(blocks)
        assert TT.spans() == [] and TT.events() == []
    finally:
        TT.enable()


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def _run(cli, argv) -> tuple:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


_PORTS = re.compile(r"(127\.0\.0\.1:|port )\d+")
_NUMBERS = re.compile(r"\d+(\.\d+)?( ?[KMG]i?B\b| B\b)?")


def _files(tmp_path, events) -> dict:
    """The inputs of the offline subcommands: a report, a bundle, a fresh
    bench row and a banked trajectory."""
    report = tmp_path / "report.json"
    TT.dump(str(report))
    bundle = tmp_path / "bundle.json"
    bundle.write_text(json.dumps(TT.flight.snapshot_bundle(
        "test", ValueError("boom"))))
    bank = tmp_path / "bank"
    bank.mkdir()
    for i, v in enumerate((1.00, 1.02, 0.99, 1.01)):
        (bank / f"BENCH_r{i:02d}.json").write_text(json.dumps(
            {"parsed": {"metric": "step_s", "value": v}}))
    fresh = tmp_path / "fresh.json"
    fresh.write_text(json.dumps({"metric": "step_s", "value": 1.4}))
    return {"report": str(report), "bundle": str(bundle),
            "bank": str(bank), "fresh": str(fresh)}


OFFLINE = {
    "summarize": lambda j, f: ["summarize", j],
    "summarize_json": lambda j, f: ["summarize", j, "--json"],
    "legacy": lambda j, f: [j],
    "trace": lambda j, f: ["trace", j],
    "prom": lambda j, f: ["prom", j],
    "prom_report": lambda j, f: ["prom", f["report"]],
    "mem": lambda j, f: ["mem", j],
    "mem_report": lambda j, f: ["mem", f["report"], "--json"],
    "postmortem": lambda j, f: ["postmortem", f["bundle"]],
    "doctor": lambda j, f: ["doctor", j],
    "doctor_json": lambda j, f: ["doctor", j, "--json", "--platform", "v5p"],
    "doctor_gate": lambda j, f: ["doctor", j, "--min-findings", "999"],
    "regress": lambda j, f: ["regress", f["fresh"], "--baseline", f["bank"],
                             "--explain"],
    "regress_json": lambda j, f: ["regress", f["fresh"], "--baseline",
                                  f["bank"], "--json"],
    "incident": lambda j, f: ["incident", j, "--bundles", f["bundle"]],
    "flame": lambda j, f: ["flame", j],
    "flame_json": lambda j, f: ["flame", j, "--json"],
    "missing": lambda j, f: ["summarize", j + ".absent"],
}


@pytest.mark.parametrize("case", list(OFFLINE))
def test_cli_subcommands_print_what_jax_prints(journal, tmp_path, case):
    path, events = journal
    files = _files(tmp_path, events)
    argv = OFFLINE[case](str(path), files)
    want, got = _run(JCLI, argv), _run(TCLI, argv)
    assert got[0] == want[0], (got, want)
    assert got[1] == want[1]
    assert got[2].replace("distributedarrays_tpu_torch",
                          "distributedarrays_tpu") == want[2]
    if case in ("doctor", "summarize", "flame"):
        assert got[1]


def test_cli_advise_runs_the_ported_advisor(journal):
    # the ported advise: the doctor's report on the journal through
    # advisor.advise, JAX's flags and exit codes (2 below --min-actions)
    from distributedarrays_tpu_torch.telemetry import advisor
    path, events = journal
    rc, out, err = _run(TCLI, ["advise", str(path), "--json"])
    assert rc == 0, err
    doc = json.loads(out)
    want = [a.to_dict() for a in advisor.advise(TP.analyze(events))]
    assert doc == json.loads(json.dumps({"actions": want, "results": None}))
    rc, out, err = _run(TCLI, ["advise", str(path), "--min-actions",
                               str(len(want) + 1)])
    assert rc == 2 and "required at least" in err


def test_cli_live_subcommands_match_jax(journal, tmp_path):
    # agg serves for a moment, stream ships the journal to it, top reads
    # its snapshot: the same lines in both packages up to ports and
    # timings
    from distributedarrays_tpu.telemetry import agg as JA
    from distributedarrays_tpu_torch.telemetry import agg as TA
    path, _ = journal
    # the exporters also ship their own process's registry: both empty
    JT.core.reset()
    TT.reset()
    outs = {}
    for name, cli, agg in (("jax", JCLI, JA), ("port", TCLI, TA)):
        with agg.AggServer(port=0, eval_interval_s=0.05) as srv:
            res = [_run(cli, ["stream", str(path), "--agg", srv.url,
                              "--interval", "0.05", "--duration", "0.3"]),
                   _run(cli, ["top", "--url", srv.url, "--once"])]
            assert srv.agg.frames_ingested >= 1
        res.append(_run(cli, ["agg", "--port", "0", "--duration", "0.1",
                              "--no-advertise"]))
        outs[name] = [(rc, _NUMBERS.sub("N", _PORTS.sub("P", o)),
                       _NUMBERS.sub("N", _PORTS.sub("P", e)))
                      for rc, o, e in res]
    assert outs["port"] == outs["jax"]
    assert all(rc == 0 for rc, _, _ in outs["port"])
