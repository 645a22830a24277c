"""The port's dalint (``distributedarrays_tpu_torch/analysis``: the engine,
cache, rules, call graph, lock analysis, SPMD effect prover and command
line) against the JAX package's.

- Engine level: on the same sources both linters report the same
  ``(code, line, suppressed)`` findings (suppressions, DAL003, DAL005,
  DAL006, DAL008/DAL009, DAL100, call-graph resolution), and the
  ``json``/``github`` formats carry them.
- Framework rules: each fixture of ``tests/test_analysis.py`` and
  ``tests/test_effects.py`` goes through JAX's linter, and its torch-form
  twin (the same program in the port's vocabulary, line for line) through
  the port's: the same codes at the same lines.  The effect corpus's twins
  also run under the port's runtime divergence checker.
- The port's own rules: process-index and job-collective divergence,
  host syncs in ``djit``/``run_spmd`` bodies, rank tensors moved by hand.
- The sweep: ``lint``, ``verify-spmd`` and ``locks`` exit 0 on the port's
  package and ``chip_smoke.py``, every suppression justified;
  ``verify-protocols`` exits 0 on the port's protocol model.
"""

import io
import json
import re
import textwrap
import tokenize
from pathlib import Path

import pytest

from distributedarrays_tpu.analysis import effects as JE
from distributedarrays_tpu.analysis import engine as JENG
from distributedarrays_tpu_torch.analysis import cache as TC
from distributedarrays_tpu_torch.analysis import effects as TE
from distributedarrays_tpu_torch.analysis import engine as TENG
from distributedarrays_tpu_torch.analysis import rules as TRU
from distributedarrays_tpu_torch.analysis.__main__ import main as tmain
from distributedarrays_tpu_torch.analysis.callgraph import (CallGraph,
                                                            module_name_for)
from distributedarrays_tpu_torch.parallel import spmd_mode as TS

import test_effects as JTE   # the JAX effect corpus (DIVERGENT, CLEAN)
from _torch_port import port_ranks  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def _found(findings):
    return sorted((f.code, f.line, f.suppressed) for f in findings)


def _jax_lint(src, path="corpus.py"):
    return _found(JENG.lint_source(textwrap.dedent(src), path))


def _port_lint(src, path="corpus.py"):
    return _found(TENG.lint_source(textwrap.dedent(src), path))


def twin(src: str) -> str:
    """The torch form of a JAX-package program: the same lines with the
    port's package name."""
    return re.sub(r"\bdistributedarrays_tpu\b", "distributedarrays_tpu_torch",
                  src)


# ---------------------------------------------------------------------------
# engine level: the same sources, the same findings
# ---------------------------------------------------------------------------

_LOCKED_SLEEP = (
    "import threading, time\n"
    "class C:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "    def f(self):\n"
    "        with self._lock:\n"
    "            time.sleep(1)\n")

ENGINE = {
    "dal003_unguarded": (
        "from distributedarrays_tpu_torch import telemetry as _tm\n"
        "def f(n):\n"
        "    _tm.event('a', 'b', key=f'x{n}')\n"),
    "dal003_guarded_nested": (
        "from distributedarrays_tpu_torch import telemetry as _tm\n"
        "def f(n):\n"
        "    for i in range(n):\n"
        "        if _tm.enabled():\n"
        "            _tm.record_comm('k', len(str(i)))\n"),
    "dal003_constant": (
        "from distributedarrays_tpu_torch import telemetry as _tm\n"
        "def f():\n"
        "    _tm.event('a', 'b', key='static')\n"),
    "dal005_star_phantom": (
        "from os.path import *\n"
        "__all__ = ['real', 'phantom', 'real']\n"
        "def real():\n"
        "    pass\n"),
    "dal005_clean": (
        "import os\n__all__ = ['x', 'f', 'C']\nx = 1\n"
        "def f():\n    pass\nclass C:\n    pass\n"),
    "dal006_leak_and_close": (
        "import distributedarrays_tpu_torch as tdat\n"
        "def f():\n"
        "    for i in range(10):\n"
        "        d = tdat.dzeros((8, 8))\n"
        "def g():\n"
        "    for i in range(10):\n"
        "        d = tdat.dzeros((8, 8))\n"
        "        d.close()\n"),
    "dal008_sleep_under_lock": _LOCKED_SLEEP,
    "dal008_suppressed": _LOCKED_SLEEP.replace(
        "time.sleep(1)",
        "time.sleep(1)  # dalint: disable=DAL008 — demo justification"),
    "dal008_queue_put": (
        "import threading, queue\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._queue = queue.Queue(4)\n"
        "    def f(self, req):\n"
        "        with self._lock:\n"
        "            self._queue.put(req)\n"),
    "dal008_condition_wait": (
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._cond = threading.Condition()\n"
        "    def f(self):\n"
        "        with self._cond:\n"
        "            self._cond.wait(0.1)\n"
        "    def g(self):\n"
        "        with self._lock:\n"
        "            with self._cond:\n"
        "                self._cond.wait(0.1)\n"),
    "dal008_interprocedural": (
        "import threading, time\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def _backoff(self):\n"
        "        time.sleep(0.5)\n"
        "    def f(self):\n"
        "        with self._lock:\n"
        "            self._backoff()\n"),
    "dal008_join": (
        "import threading\n"
        "_lock = threading.Lock()\n"
        "def f(worker, parts):\n"
        "    with _lock:\n"
        "        ' | '.join(parts)\n"
        "        worker.join(2.0)\n"),
    "dal009_abba": (
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._a = threading.Lock()\n"
        "        self._b = threading.Lock()\n"
        "    def f(self):\n"
        "        with self._a:\n"
        "            with self._b:\n"
        "                pass\n"
        "    def g(self):\n"
        "        with self._b:\n"
        "            with self._a:\n"
        "                pass\n"),
    "dal009_reentry": (
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def close(self):\n"
        "        with self._lock:\n"
        "            self._drain()\n"
        "    def _drain(self):\n"
        "        with self._lock:\n"
        "            pass\n"),
    "file_level_suppression": (
        "# dalint: disable-file=DAL006\n"
        "import distributedarrays_tpu_torch as tdat\n"
        "def f():\n"
        "    for i in range(10):\n"
        "        d = tdat.dzeros((8, 8))\n"),
    "syntax_error": "def broken(:\n",
}


@pytest.mark.parametrize("name", sorted(ENGINE))
def test_engine_findings_match_jax(name):
    src = ENGINE[name]
    got = _port_lint(src)
    assert got == _jax_lint(src)
    if name not in ("dal005_clean", "dal003_constant",
                    "dal003_guarded_nested"):
        assert got, name


@pytest.mark.parametrize("name", ["dal008_suppressed",
                                  "file_level_suppression"])
def test_unused_suppressions_match_jax(name):
    # DAL100: a suppression that silences nothing, in both packages alike
    src = ENGINE[name].replace("DAL008", "DAL003").replace(
        "disable-file=DAL006", "disable-file=DAL004") + \
        "x = 1  # dalint: disable=DAL099 — typo\n"
    for eng in (JENG, TENG):
        fs = eng.lint_source(src, "m.py")
        rows = sorted((f.line, f.message.split(":")[0])
                      for f in eng.unused_suppressions(src, "m.py", fs))
        if eng is JENG:
            want = rows
    assert rows == want and len(rows) == 2


def test_module_names_root_at_the_port():
    assert module_name_for("/x/y/distributedarrays_tpu_torch/ops/linalg.py") \
        == "distributedarrays_tpu_torch.ops.linalg"
    assert module_name_for("distributedarrays_tpu/core.py") == \
        "distributedarrays_tpu.core"
    assert module_name_for("chip_smoke.py") == "chip_smoke"


def test_callgraph_resolves_imports_methods_and_partials():
    g = CallGraph([
        ("pkg_a.py", "import functools\n"
                     "def helper():\n    return 1\n"
                     "class C:\n    def m(self):\n        return 2\n"
                     "h2 = functools.partial(helper)\n"),
        ("pkg_b.py", "from pkg_a import helper as h\n"
                     "import pkg_a\n"
                     "def use():\n"
                     "    h()\n"
                     "    c = pkg_a.C()\n"
                     "    c.m()\n"),
    ])
    import ast
    use = next(k for k in g.funcs if k[2] == "use")
    calls = [n for n in ast.walk(ast.parse("h()\n"))
             if isinstance(n, ast.Call)]
    b = g.resolve_call(calls[0], use[0], None, {})
    assert b is not None and b.ref[2] == "helper"
    p = g._module_binding(g.scans["pkg_a"], "h2")
    assert p is not None and p.kind == "partial"


def test_cli_formats(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(twin(JTE.DIVERGENT["direct_branch"][0]))
    assert tmain(["lint", "--no-cache", "--format", "json", str(bad)]) == 1
    rows = json.loads(capsys.readouterr().out)
    assert {r["code"] for r in rows} == {"DAL001", "DAL010"}
    assert all(r["path"] == str(bad) for r in rows)
    assert tmain(["lint", "--no-cache", "--format", "github", str(bad)]) == 1
    out = capsys.readouterr().out
    assert out.count("::error file=") == 2 and "title=DAL010" in out
    assert tmain(["verify-spmd", "--format=json", str(bad)]) == 1
    assert json.loads(capsys.readouterr().out)[0]["code"] == "DAL010"
    good = tmp_path / "good.py"
    good.write_text(twin(JTE.CLEAN["symmetric_bcast"][0]))
    assert tmain(["verify-spmd", str(good)]) == 0
    assert tmain(["effects", f"{good}:prog", str(good)]) == 0
    assert "bcast(root=0" in capsys.readouterr().out


def test_cache_is_the_ports_own(tmp_path, monkeypatch, capsys):
    from distributedarrays_tpu.analysis import cache as JC
    assert str(TC.default_cache_path()) == "build/dalint_torch_cache.json"
    assert TC.analysis_salt() != JC.analysis_salt()
    monkeypatch.chdir(tmp_path)
    f = tmp_path / "m.py"
    f.write_text("x = 1\n")
    assert tmain(["lint", str(f)]) == 0
    assert "cache: 0 hit / 1 miss" in capsys.readouterr().out
    assert tmain(["lint", str(f)]) == 0
    assert "cache: 1 hit / 0 miss" in capsys.readouterr().out
    assert (tmp_path / "build" / "dalint_torch_cache.json").exists()
    assert not (tmp_path / "build" / "dalint_cache.json").exists()


# ---------------------------------------------------------------------------
# framework rules: each JAX fixture and its torch-form twin
# ---------------------------------------------------------------------------

# name -> (JAX source, port twin, path); the twin keeps every line where
# the JAX program has it
RULE_TWINS = {
    "dal001_rank_gated": (
        "from distributedarrays_tpu.parallel import myid, barrier\n"
        "def f():\n"
        "    me = myid()\n"
        "    if me == 0:\n"
        "        barrier()\n",
        "from distributedarrays_tpu_torch.parallel.spmd_mode import myid, "
        "barrier\n"
        "def f():\n"
        "    me = myid()\n"
        "    if me == 0:\n"
        "        barrier()\n", None),
    "dal001_traced_rank": (
        "from jax import lax\n"
        "def f(x):\n"
        "    r = lax.axis_index('p')\n"
        "    if r == 0:\n"
        "        return lax.psum(x, 'p')\n"
        "    return x\n",
        "from distributedarrays_tpu_torch.parallel import collectives as C\n"
        "def f(x):\n"
        "    r = C.axis_rank(x)\n"
        "    if r == 0:\n"
        "        return C.pbarrier(x)\n"
        "    return x\n", None),
    "dal001_symmetric": (
        "from distributedarrays_tpu.parallel import myid, bcast, barrier\n"
        "def f():\n"
        "    me = myid()\n"
        "    v = bcast('x' if me == 0 else None, root=0)\n"
        "    barrier()\n"
        "    return v\n", None, None),
    "dal001_p2p": (
        "from distributedarrays_tpu.parallel import myid, sendto, recvfrom\n"
        "def f():\n"
        "    if myid() == 0:\n"
        "        sendto(1, 'x')\n"
        "    else:\n"
        "        recvfrom(0)\n", None, None),
    "dal002_np_asarray": (
        "import jax\nimport numpy as np\nimport jax.numpy as jnp\n"
        "@jax.jit\ndef f(x):\n    return np.asarray(x).sum()\n",
        "from distributedarrays_tpu_torch import djit\nimport numpy as np\n"
        "import torch\n@djit\ndef f(x):\n    return np.asarray(x).sum()\n",
        None),
    "dal002_item": (
        "import jax\nimport numpy as np\nimport jax.numpy as jnp\n"
        "@jax.jit\ndef f(x):\n    return x.item()\n",
        "from distributedarrays_tpu_torch import djit\nimport numpy as np\n"
        "import torch\n@djit\ndef f(x):\n    return x.item()\n", None),
    "dal002_float": (
        "import jax\nimport numpy as np\nimport jax.numpy as jnp\n"
        "@jax.jit\ndef f(x):\n    return float(x)\n",
        "from distributedarrays_tpu_torch import djit\nimport numpy as np\n"
        "import torch\n@djit\ndef f(x):\n    return float(x)\n", None),
    "dal002_clean": (
        "import jax\nimport numpy as np\nimport jax.numpy as jnp\n"
        "@jax.jit\ndef f(x):\n    return jnp.sum(x) + int(3)\n",
        "from distributedarrays_tpu_torch import djit\nimport numpy as np\n"
        "import torch\n@djit\ndef f(x):\n    return torch.sum(x) + int(3)\n",
        None),
    "dal002_passed_to_jit": (
        "import jax\n"
        "def step(x):\n"
        "    return x.item()\n"
        "g = jax.jit(step)\n",
        "from distributedarrays_tpu_torch import djit\n"
        "def step(x):\n"
        "    return x.item()\n"
        "g = djit(step)\n", None),
    "dal002_djit_gather": (
        "from distributedarrays_tpu import djit, gather\n"
        "@djit\n"
        "def f(d):\n"
        "    return gather(d)\n", None, None),
    "dal002_method_chain": (
        "from distributedarrays_tpu import djit\n"
        "@djit\n"
        "def step(x):\n"
        "    return float(x.sum())\n", None, None),
    "dal002_untraced": (
        "import numpy as np\n"
        "def host_side(x):\n"
        "    return float(np.asarray(x).sum())\n", None, None),
    "dal002_device_gather": (
        "import jax\nfrom jax import lax\n"
        "@jax.jit\ndef f(x, idx, dnums, ss):\n"
        "    return lax.gather(x, idx, dnums, ss)\n",
        "from distributedarrays_tpu_torch import djit\nimport torch\n"
        "@djit\ndef f(x, idx, dnums, ss):\n"
        "    return torch.gather(x, 0, idx)\n", None),
    "dal004_typo_axis": (
        "from jax.sharding import Mesh\nfrom jax import lax\n"
        "import numpy as np, jax\n"
        "def f(x):\n"
        "    mesh = Mesh(np.array(jax.devices()).reshape(8), ('p',))\n"
        "    return lax.psum(x, 'q')\n", None, None),
    "dal004_bound_and_caller_axis": (
        "from jax.sharding import Mesh\nfrom jax import lax\n"
        "import numpy as np, jax\n"
        "def f(x):\n"
        "    mesh = Mesh(np.array(jax.devices()).reshape(8), ('p',))\n"
        "    return lax.psum(x, 'p')\n"
        "def g(x, axis):\n"
        "    return lax.psum(x, axis)\n"
        "def h(x):\n"
        "    return lax.psum(x, 'anything')\n", None, None),
    "dal004_axisless_eager": (
        "from distributedarrays_tpu.parallel import (spmd_mesh, bcast,\n"
        "                                            barrier)\n"
        "def f():\n"
        "    mesh = spmd_mesh(8)\n"
        "    barrier('sync')\n"
        "    return bcast('go', root=0)\n",
        "from distributedarrays_tpu_torch.parallel.collectives import (\n"
        "    spmd_mesh, preduce)\n"
        "def f(x):\n"
        "    mesh = spmd_mesh(8)\n"
        "    preduce(x, 'sum')\n"
        "    return preduce(x, 'max')\n", None),
    "dal006_loop": (
        "import distributedarrays_tpu as dat\n"
        "def f():\n"
        "    for i in range(10):\n"
        "        d = dat.dzeros((8, 8))\n", None, None),
    "dal007_flags": (
        "import jax\n"
        "from jax.sharding import NamedSharding, PartitionSpec as P\n"
        "def place(x, mesh):\n"
        "    return jax.device_put(x, NamedSharding(mesh, P('d0')))\n",
        "from distributedarrays_tpu_torch import layout as L\n"
        "\n"
        "def place(d, ci, r):\n"
        "    return d.part(ci).to(L.device_of(r))\n", "pkg/ops/thing.py"),
    "dal007_named_target": (
        "import jax\n"
        "def place(x, out_sharding):\n"
        "    return jax.device_put(x, out_sharding)\n",
        "import torch\n"
        "def place(d, r, dev):\n"
        "    return d.localpart(r).to(dev)\n", "pkg/m.py"),
    "dal007_copy_between_darrays": (
        "import jax\n"
        "def place(x, out_sharding):\n"
        "    return jax.device_put(x, out_sharding)\n",
        "import torch\n"
        "def place(d, e, ci):\n"
        "    return e.part(ci).copy_(d.part(ci))\n", "pkg/m.py"),
    "dal007_reshard_home": (
        "import jax\n"
        "def place(x, sharding):\n"
        "    return jax.device_put(x, sharding)\n",
        "import torch\n"
        "def place(d, ci, dev):\n"
        "    return d.part(ci).to(dev)\n",
        "distributedarrays_tpu/parallel/reshard.py"),
    "dal007_collectives_home": (
        "import jax\n"
        "def stage(x, sharding):\n"
        "    return jax.device_put(x, sharding)\n",
        "import torch\n"
        "def stage(d, ci, dev):\n"
        "    return d.part(ci).to(dev)\n",
        "distributedarrays_tpu/ops/pallas_collectives.py"),
    "dal007_bare_device": (
        "import jax\n"
        "def pin(x):\n"
        "    device = jax.devices()[0]\n"
        "    y = jax.device_put(x, device)\n"
        "    return jax.device_put(y)\n",
        "import torch\n"
        "def pin(x, out):\n"
        "    device = torch.device('cuda', 0)\n"
        "    y = x.to(device)\n"
        "    return out.copy_(y)\n", "pkg/m.py"),
    "dal007_suppressed": (
        "import jax\n"
        "def place(x, sharding):\n"
        "    return jax.device_put(x, sharding)  "
        "# dalint: disable=DAL007 — host scatter, no source layout\n",
        "import torch\n"
        "def place(d, dev):\n"
        "    return d.localpart(0).to(dev)  "
        "# dalint: disable=DAL007 — host scatter, no source layout\n",
        "pkg/m.py"),
    "inline_suppressions": (
        "from distributedarrays_tpu.parallel import myid, barrier\n"
        "def f():\n"
        "    if myid() == 0:  # dalint: disable=DAL010 — test fixture\n"
        "        barrier()  # dalint: disable=DAL001 — test fixture\n",
        None, None),
}


def _port_path(path):
    if path is None:
        return "corpus.py"
    return path.replace("distributedarrays_tpu/parallel/reshard.py",
                        "distributedarrays_tpu_torch/parallel/reshard.py") \
        .replace("distributedarrays_tpu/ops/pallas_collectives.py",
                 "distributedarrays_tpu_torch/ops/cuda_collectives.py")


@pytest.mark.parametrize("name", sorted(RULE_TWINS))
def test_rule_fixture_twins_match_jax(name):
    jsrc, tsrc, path = RULE_TWINS[name]
    tsrc = twin(jsrc) if tsrc is None else tsrc
    assert len(jsrc.splitlines()) == len(tsrc.splitlines()), name
    want = _jax_lint(jsrc, path or "corpus.py")
    got = _port_lint(tsrc, _port_path(path))
    assert got == want, (name, got, want)


def _effect_found(rep):
    return sorted((f.code, f.line, f.suppressed) for f in rep.findings)


@pytest.mark.parametrize("name", sorted(JTE.DIVERGENT) + sorted(JTE.CLEAN))
def test_effect_corpus_twins_match_jax(name):
    src = (JTE.DIVERGENT.get(name) or JTE.CLEAN[name])[0]
    want = _effect_found(JE.analyze_sources(
        [("corpus.py", textwrap.dedent(src))]))
    got = _effect_found(TE.analyze_sources(
        [("corpus.py", textwrap.dedent(twin(src)))]))
    assert got == want
    assert bool(got) == (name in JTE.DIVERGENT)


def _run_twin(src, pids=(0, 1)):
    ns = {}
    exec(compile(textwrap.dedent(twin(src)), "corpus.py", "exec"), ns)
    return TS.spmd(ns["prog"], pids=list(pids))


@pytest.mark.parametrize("name", sorted(
    k for k, (_, _, rt) in JTE.DIVERGENT.items() if rt))
def test_divergent_twins_caught_by_the_ports_runtime_checker(name,
                                                             monkeypatch):
    from distributedarrays_tpu_torch.analysis import CollectiveDivergenceError
    monkeypatch.setenv("DA_TPU_CHECK_DIVERGENCE", "1")
    with pytest.raises(CollectiveDivergenceError):
        _run_twin(JTE.DIVERGENT[name][0])


@pytest.mark.parametrize("name", sorted(
    k for k, (_, rt) in JTE.CLEAN.items() if rt))
def test_clean_twins_run_divergence_free(name, monkeypatch):
    monkeypatch.setenv("DA_TPU_CHECK_DIVERGENCE", "1")
    _run_twin(JTE.CLEAN[name][0])


@pytest.mark.parametrize("name", ["dal011_unbound", "dal011_bound"])
def test_dal011_twins_match_jax(name):
    axis = "model" if name == "dal011_unbound" else "data"
    src = ("import jax\n\ndef body():\n"
           f"    jax.lax.psum(1, axis_name={axis!r})\n\n"
           "def prog():\n    mesh = jax.make_mesh((4,), ('data',))\n"
           "    with mesh:\n        body()\n")
    want = _effect_found(JE.analyze_sources([("corpus.py", src)]))
    assert _effect_found(TE.analyze_sources([("corpus.py", src)])) == want
    assert bool(want) == (name == "dal011_unbound")


# ---------------------------------------------------------------------------
# the port's own vocabulary
# ---------------------------------------------------------------------------


def _codes(src, path="corpus.py"):
    return sorted({f.code for f in TENG.lint_source(textwrap.dedent(src),
                                                    path)
                   if not f.suppressed})


def test_process_index_branch_skipping_a_store_barrier():
    # the failure class of a job: one process skips the barrier its
    # peers wait on (they wait out the store timeout)
    src = """
    from distributedarrays_tpu_torch import layout as L
    from distributedarrays_tpu_torch.parallel import multihost

    def step(d):
        if L.process_index() == 0:
            multihost.sync_hosts("step")
        return d
    """
    assert _codes(src) == ["DAL001", "DAL010"]
    ok = src.replace('        if L.process_index() == 0:\n    '
                     '        multihost.sync_hosts("step")',
                     '        multihost.sync_hosts("step")\n'
                     '        if L.process_index() == 0:\n'
                     '            print("leader")')
    assert _codes(ok) == []


def test_job_collectives_through_helpers_and_quorum():
    src = """
    from distributedarrays_tpu_torch.parallel import multihost
    from distributedarrays_tpu_torch import layout as L

    def fetch(d):
        return multihost.fetch_regions([(d, None, L.local_device())])

    def prog(d):
        verdict = multihost.quorum_assess()
        if verdict["quorum"]:
            fetch(d)
        for _ in range(L.process_index()):
            multihost.cell_values(d, len)
    """
    fs = TE.analyze_sources([("corpus.py", textwrap.dedent(src))]).findings
    assert sorted({f.code for f in fs}) == ["DAL010", "DAL012"]
    assert any("fetch_regions" in f.message for f in fs)


def test_dal002_port_host_syncs_in_traced_bodies():
    src = """
    import torch
    from distributedarrays_tpu_torch import djit
    from distributedarrays_tpu_torch.parallel.collectives import run_spmd

    @djit
    def a(x):
        return x.cpu()

    def b(blocks):
        torch.cuda.synchronize()
        return [t.tolist() for t in blocks]

    run_spmd(b, [0, 1])

    def host(x):
        return x.cpu().numpy()
    """
    fs = [f for f in TENG.lint_source(textwrap.dedent(src), "m.py")
          if f.code == "DAL002"]
    assert sorted(f.line for f in fs) == [8, 11, 12]


def test_rules_json_gives_each_code_its_port_scope(capsys):
    assert tmain(["rules", "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert [r["code"] for r in rows] == \
        [f"DAL{i:03d}" for i in range(1, 13)] + ["DAL100"]
    assert all(r["port"] and r["title"] for r in rows)
    assert set(TRU.PORT_SCOPE) == {r["code"] for r in rows}


def test_verify_protocols_exits_2_naming_its_roadmap_entry(capsys):
    # the name is from before the port's protocol model existed (the verb
    # exited 2 naming ROADMAP queue A); now it proves the shipped
    # schedules and refutes the mutants (exit 0), and exits 2 only when
    # it cannot run (tests/test_torch_protocol.py holds the rest)
    assert tmain(["verify-protocols", "--ps", "2", "--quiet"]) == 0
    assert "protocol verification: OK" in capsys.readouterr().out
    assert tmain(["verify-protocols", "--ps", "x"]) == 2
    assert "--ps" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the sweep: the port's own sources are clean
# ---------------------------------------------------------------------------


def test_port_sweep_is_clean(capsys, monkeypatch):
    monkeypatch.chdir(REPO)
    assert tmain(["lint", "--no-cache"]) == 0
    assert "0 finding(s)" in capsys.readouterr().out
    assert tmain(["verify-spmd", "--warn-unused-suppressions"]) == 0
    out = capsys.readouterr().out
    assert "0 finding(s)" in out and "TRUNCATED" not in out
    assert tmain(["locks"]) == 0
    assert "locks: 0 finding(s)" in capsys.readouterr().out


def test_every_port_suppression_is_justified():
    files = sorted((REPO / "distributedarrays_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    seen = 0
    for f in files:
        if f.parent.name == "analysis":
            continue                  # the catalog documents the syntax
        src = f.read_text()
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type != tokenize.COMMENT or "dalint:" not in tok.string:
                continue
            seen += 1
            m = re.search(r"disable=[A-Z0-9,]+ — (.{12,})", tok.string)
            assert m, f"{f.name}:{tok.start[0]}: {tok.string}"
    assert seen >= 50
