"""The port's ``utils/native.py``, ``utils/profiling.py`` and the invariant
checker of ``utils/debug.py`` on the CPU.

- ``native.assemble``/``scatter_chunks`` (the port's copy of
  ``chunkcopy.cpp``, built by ``g++``) against numpy slicing, on uneven
  chunk grids of several dtypes; the numpy path with a ``warn_once`` when
  no ``g++`` is found; the checkpoint's peer-replica restore through the
  native copier, equal to the numpy path, and JAX's ``assemble`` on the
  same inputs; ``DArray.region`` onto the host copying each piece into its
  view of the output, for any dtype, without the native copier.
- ``debug.validate``/``check_all`` on uneven layouts, and each broken
  invariant named.
- ``profiling.trace`` writes a Chrome trace naming the annotated ranges,
  journaled; ``annotate`` and ``OpTimer`` spans.
"""

import json
import warnings

import numpy as np
import pytest
import torch

import distributedarrays_tpu_torch as tdat
from distributedarrays_tpu.utils import native as JN
from distributedarrays_tpu_torch import telemetry as tm
from distributedarrays_tpu_torch.telemetry.fixtures import (  # noqa: F401
    telemetry_capture)
from distributedarrays_tpu_torch.utils import checkpoint as TC
from distributedarrays_tpu_torch.utils import debug, native, profiling

from _torch_port import port_ranks  # noqa: F401


def _grid(shape, grid, rng):
    """Uneven cut vectors of ``shape`` on a ``grid``, and each chunk's
    origin and shape."""
    cuts = [[0] + sorted(rng.choice(np.arange(1, n), g - 1, replace=False)
                         .tolist()) + [n] for n, g in zip(shape, grid)]
    boxes = []
    for ci in np.ndindex(*grid):
        o = tuple(c[j] for c, j in zip(cuts, ci))
        s = tuple(c[j + 1] - c[j] for c, j in zip(cuts, ci))
        boxes.append((o, s))
    return cuts, boxes


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int16,
                                   np.uint8, np.complex64, np.bool_])
@pytest.mark.parametrize("shape,grid", [((37, 11), (4, 3)),
                                        ((9, 7, 5), (3, 2, 2)),
                                        ((50,), (6,))])
def test_native_matches_numpy_slicing(dtype, shape, grid):
    rng = np.random.default_rng(7)
    full = (rng.standard_normal(shape) * 100).astype(dtype)
    _, boxes = _grid(shape, grid, rng)
    offs = [o for o, _ in boxes]
    chunks = native.scatter_chunks(full, [s for _, s in boxes], offs,
                                   n_threads=3)
    for c, (o, s) in zip(chunks, boxes):
        np.testing.assert_array_equal(
            c, full[tuple(slice(a, a + n) for a, n in zip(o, s))])
        assert c.flags.c_contiguous
    out = native.assemble(np.zeros_like(full), chunks, offs, n_threads=2)
    np.testing.assert_array_equal(out, full)
    assert native.available()
    # JAX's copier gives the same array on the same inputs
    np.testing.assert_array_equal(
        JN.assemble(np.zeros_like(full), chunks, offs), out)


def test_native_rejects_out_of_bounds_and_falls_back_on_strides():
    dst = np.zeros((4, 4), np.float32)
    with pytest.raises(ValueError, match="exceeds"):
        native.assemble(dst, [np.ones((3, 3), np.float32)], [(2, 2)])
    strided = np.arange(32, dtype=np.float32).reshape(4, 8)[:, ::2]
    out = native.assemble(np.zeros((4, 4), np.float32), [strided], [(0, 0)])
    np.testing.assert_array_equal(out, strided)


def test_worth_using_needs_size_chunks_and_no_build_below_it(monkeypatch):
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    assert not native.worth_using(native.MIN_BYTES - 1, 8)
    assert not native.worth_using(native.MIN_BYTES, 1)
    assert native._tried is False               # nothing built for those
    monkeypatch.setattr(native.os, "cpu_count", lambda: 4)
    assert native.worth_using(native.MIN_BYTES, 2)


def test_no_gxx_takes_the_numpy_path_with_a_warning(monkeypatch):
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setattr(debug, "_warned", set())
    with pytest.warns(RuntimeWarning, match="no g\\+\\+"):
        assert not native.available()
    full = np.arange(20, dtype=np.float32).reshape(4, 5)
    out = native.assemble(np.zeros_like(full),
                          [full[:2].copy(), full[2:].copy()],
                          [(0, 0), (2, 0)])
    np.testing.assert_array_equal(out, full)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not native.available()          # said once


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.bool,
                                   torch.float8_e4m3fn])
def test_region_to_host_copies_each_piece_into_its_view(monkeypatch, dtype):
    # region copies every piece straight into its view of the output, for
    # any dtype (numpy lacks bfloat16 and float8), and never takes the
    # native copier, whatever the size
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((50, 8)).astype(np.float32)
                         * 10).to(dtype)
    d = tdat.distribute(x, dist=(4, 2))
    assert d.cuts[0] == [0, 13, 26, 38, 50]
    monkeypatch.setattr(native, "MIN_BYTES", 0)
    monkeypatch.setattr(native, "assemble", lambda *a, **k: pytest.fail(
        "region took the native copier"))
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[x.element_size()]
    got = d.full(torch.device("cpu"))
    assert got.dtype == dtype
    assert torch.equal(got.view(bits), x.view(bits))
    box = d.region([(5, 40), (1, 7)], torch.device("cpu"))
    assert torch.equal(box.view(bits), x[5:40, 1:7].view(bits))
    if dtype != torch.float8_e4m3fn:
        np.testing.assert_array_equal(tdat.gather(d),
                                      np.asarray(x.float() if dtype ==
                                                 torch.bfloat16 else x))


def test_replica_restore_through_the_native_copier(tmp_path, monkeypatch):
    a = np.arange(64 * 6, dtype=np.float32).reshape(64, 6)
    d = tdat.distribute(a, procs=[0, 1, 2, 3], dist=(4, 1))
    store = TC.PeerReplicaStore()
    mgr = TC.CheckpointManager(tmp_path, async_save=False, replicas=store)
    mgr.save(2, {"d": d, "step": 2})
    _, plain, _ = store.fetch(2, live_ranks=range(8))
    calls = []
    real = native.assemble
    monkeypatch.setattr(native, "MIN_BYTES", 0)
    monkeypatch.setattr(native.os, "cpu_count", lambda: 4)
    monkeypatch.setattr(native, "assemble",
                        lambda *a_, **k: calls.append(len(a_[1])) or
                        real(*a_, **k))
    _, arrays, info = store.fetch(2, live_ranks=range(8))
    assert calls and max(calls) == 4
    assert sorted(arrays) == sorted(plain)
    for key in arrays:
        np.testing.assert_array_equal(arrays[key], plain[key])
    assert info == {"local_chunks": info["local_chunks"], "peer_chunks": 0}
    mgr.close()


# ---------------------------------------------------------------------------
# validate / check_all
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,dist", [((50, 8), (4, 2)), ((37, 11), (3, 1)),
                                        ((13,), (8,)), ((9, 7, 5), (2, 2, 2))])
def test_validate_uneven_layouts(shape, dist):
    d = tdat.drand(shape, dist=dist)
    e = tdat.dzeros(shape, dtype=torch.bfloat16, procs=range(8)[::-1][
        :int(np.prod(dist))], dist=dist)
    debug.validate(d)
    debug.validate(e)
    assert debug.check_all() >= 2
    for r in d.pids.flat:
        ci = tuple(np.argwhere(d.pids == r)[0])
        assert d.localindices(int(r)) == d.indices[ci]


def _broken(what):
    d = tdat.drand((50, 8), dist=(4, 2))
    ci = (1, 0)
    if what == "cuts":
        d.cuts[0][2] = 20
    elif what == "span":
        d.cuts[1][-1] = 9
    elif what == "dtype":
        d._parts[ci] = d._parts[ci].double()
    elif what == "shape":
        d._parts[ci] = d._parts[ci][:-1]
    elif what == "device":
        d._parts[ci] = d._parts[ci].to("meta")
    elif what == "pids":
        d.pids[1, 0] = d.pids[0, 0]
    elif what == "closed":
        d.close()
    return d


@pytest.mark.parametrize("what,msg", [
    ("cuts", "indices"), ("span", "do not span"), ("dtype", "float64"),
    ("shape", "its cell"), ("device", "meta"), ("pids", "two cells"),
    ("closed", "closed")])
def test_validate_names_each_broken_invariant(what, msg):
    d = _broken(what)
    with pytest.raises(AssertionError, match=msg):
        debug.validate(d)


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------


def test_trace_writes_a_chrome_trace_and_journals_it(tmp_path,
                                                     telemetry_capture):
    A = tdat.drand((64, 32), dist=(4, 1))
    B = tdat.drand((32, 16), dist=(4, 1))
    with profiling.trace(str(tmp_path / "prof")) as prof:
        with profiling.annotate("phase.matmul"):
            A @ B
    doc = json.loads(open(prof.trace_path).read())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "phase.matmul" in names
    assert any("mm" in str(n) for n in names)
    evs = [e for e in telemetry_capture.events("profile")]
    assert [e["name"] for e in evs] == ["trace_start", "trace_stop"]
    assert evs[1]["path"] == prof.trace_path
    assert telemetry_capture.spans("phase.matmul")[0]["labels"][
        "src"] == "annotate"


def test_op_timer_spans_and_report(telemetry_capture):
    t = profiling.OpTimer()
    for _ in range(3):
        with t("distribute"):
            tdat.distribute(torch.ones(16, 4))
    rep = t.report()["distribute"]
    assert rep["calls"] == 3 and rep["total_s"] > 0
    assert len(telemetry_capture.spans("distribute")) >= 3
    assert tm.report()["histograms"]["optimer.distribute"]["count"] == 3

