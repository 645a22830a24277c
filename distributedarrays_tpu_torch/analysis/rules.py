"""dalint rule catalog: framework-aware static checks DAL001-DAL012.

The port's copy of ``distributedarrays_tpu/analysis/rules.py``, retargeted
to the port's vocabulary (``PORT_SCOPE`` gives each code one line on what
it catches in the port; ``rules --json`` prints it):

- rank sources: JAX's ``myid``/``current_rank``/``axis_index``/
  ``axis_rank``, and the port's ``process_index`` (a controller
  process's index in a job of several) and quorum verdicts
  (``partition_verdict``, ``majority_side``, ``quorum_assess``);
- collectives: the eager ``spmd_mode`` ones, the rank-list collectives of
  ``parallel/collectives.py`` (``pbarrier``, ``pbcast``, ``pshift``,
  ``pshifts``, ``halo_exchange*``, ``preduce(s)``, ``psum_scatter``,
  ``pall_to_all``, ``pgather``, ``pconcat``) and the job's calls of
  ``parallel/multihost.py`` and ``ops/cuda_collectives.py`` that every
  process must make (``exchange``, ``fetch_regions``, ``cell_values``,
  ``_all_gather_objects``, ``_all_gather_json``, the store barrier
  ``sync_hosts``, ``process_regions``, ``peer_call``);
- traced regions: the bodies of ``djit`` and ``run_spmd``; a host sync
  there is ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``float``/``int`` of an argument, ``np.asarray`` of one,
  ``torch.cuda.synchronize()``, ``gather`` or ``set_localpart``;
- DAL007: a rank tensor (``d.part(ci)``, ``d.localpart(r)``,
  ``d._parts[ci]``, a slice of one) moved to a device by hand
  (``.to(device_of(r))``, ``.to(dev)``, a ``copy_`` between two DArrays'
  rank tensors) outside the planner
  (``parallel/reshard.py``) and the copy kernel's home
  (``ops/cuda_collectives.py``).

The JAX catalog's text follows.

- DAL001  collective call in a rank-dependent branch — the classic SPMD
          deadlock: every rank (every controller process of a job) must
          issue the identical collective sequence, so a ``pbarrier``/
          ``barrier`` under ``if myid() == 0:`` hangs the others forever.
- DAL002  host synchronization inside a traced region — ``.item()`` /
          ``.cpu()`` / ``float(arg)`` / ``gather`` on a value of a
          ``djit``/``run_spmd`` body forces a device→host transfer per
          call.
- DAL003  telemetry ``event``/``record_comm`` with computed arguments and
          no ``telemetry.enabled()`` guard — disabled mode must collapse to
          one boolean check; building f-strings or calling ``nbytes_of``
          first defeats that.
- DAL004  collective over an axis name no enclosing mesh binds — a typo'd
          axis only fails at trace time, deep inside shard_map.
- DAL005  import/export hygiene — star imports and ``__all__`` entries the
          module never defines (the Aqua.jl / ExplicitImports.jl gates).
- DAL006  DArray constructed in a loop with no ``close()``/context
          discipline in the loop body — each iteration's HBM lingers until
          GC, the leak pattern the reference's finalizer tests guard.
- DAL007  a rank tensor moved to another rank's device outside
          ``parallel/reshard.py`` — whole-array eager moves bypass the
          reshard planner (plan cache, the copy kernel, moved-bytes
          accounting); route through ``parallel.reshard``.
- DAL008  blocking call (queue put/get, event/condition wait, thread
          join, sleep, eager SPMD receive, subprocess wait) made while
          holding a lock — every contender on that lock now waits on
          the blocker's condition too; the submit/drain race class
          (engine: ``analysis/locks.py``, interprocedural).
- DAL009  lock-order cycle in the acquisition graph (ABBA deadlock) or
          a non-reentrant ``threading.Lock`` re-acquired while held
          (the SIGTERM-handler self-deadlock shape); cross-file cycles
          surface via ``python -m distributedarrays_tpu_torch.analysis
          locks``.
- DAL010  static SPMD divergence: a rank-tainted branch (``myid`` /
          ``axis_index`` / quorum verdict, propagated through calls,
          returns, partials and closures) whose arms have
          non-equivalent collective effect signatures — the static twin
          of the runtime ``CollectiveDivergenceError`` (engine:
          ``analysis/effects.py``, interprocedural).
- DAL011  collective axis name unbound by the mesh context *reaching*
          the call — DAL004 generalized across calls: mesh axes flow
          from ``Mesh``/``spmd_mesh``/``mesh_for`` construction sites
          into callees; cross-file flows surface via ``python -m
          distributedarrays_tpu_torch.analysis verify-spmd``.
- DAL012  collective under a rank-tainted loop bound: per-rank
          iteration counts differ, so per-rank collective counts
          diverge (the loop-shaped variant of DAL010).

Rules are conservative by design: a rule that cannot prove its premise
(axis bound elsewhere, value not traced, ...) stays silent.  Intentional
violations carry ``# dalint: disable=CODE`` with a justification comment.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

FindingTuple = tuple[int, int, str]  # (line, col, message)


class Rule:
    """A registered rule: stable code, severity, and an AST check."""

    def __init__(self, code: str, severity: str, title: str, check):
        self.code = code
        self.severity = severity
        self.title = title
        self._check = check

    def check(self, tree: ast.Module, path: str,
              lines: list[str]) -> Iterator[FindingTuple]:
        return self._check(tree, path, lines)


RULES: dict[str, Rule] = {}

# what each code catches in the port's sources (``rules --json``)
PORT_SCOPE = {
    "DAL001": "a spmd_mode, rank-list or job collective (pbarrier, "
              "fetch_regions, sync_hosts, ...) issued in only one arm of "
              "a branch on myid/current_rank/process_index/a quorum "
              "verdict",
    "DAL002": ".item()/.tolist()/.cpu()/.numpy(), float/int of an "
              "argument, torch.cuda.synchronize(), gather or "
              "set_localpart inside a djit or run_spmd body",
    "DAL003": "telemetry.event/record_comm with computed arguments and no "
              "telemetry.enabled() guard",
    "DAL004": "a collective naming a mesh axis no mesh built in the scope "
              "binds (the port's collectives take rank lists, so only "
              "code that names a mesh axis can trip it)",
    "DAL005": "star imports and __all__ entries the module never binds",
    "DAL006": "a DArray made every loop iteration with no close() or "
              "d_closeall in the loop",
    "DAL007": "a DArray's rank tensor moved to a device by hand "
              "(.to(device_of(r)) or .to(dev) on d.part/localpart/_parts, "
              "copy_ between two DArrays' rank tensors) outside "
              "parallel/reshard.py and ops/cuda_collectives.py",
    "DAL008": "a blocking call (queue, event/condition wait, join, sleep, "
              "spmd receive, store barrier, job all-gather, subprocess) "
              "made while holding a lock",
    "DAL009": "a lock-order cycle, or a threading.Lock re-acquired while "
              "held",
    "DAL010": "a branch on a rank-tainted value (through calls, returns, "
              "partials, closures) whose arms issue different collective "
              "sequences: one process skips a barrier or an exchange its "
              "peers wait on",
    "DAL011": "a collective whose axis name the mesh reaching the call "
              "does not bind (dormant in the port: no named mesh axes)",
    "DAL012": "a collective in a loop whose trip count is rank-tainted",
    "DAL100": "a '# dalint: disable=' comment that silences nothing",
}


def _rule(code: str, severity: str, title: str):
    def deco(fn):
        RULES[code] = Rule(code, severity, title, fn)
        return fn
    return deco


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------


def _dotted(node: ast.expr) -> str | None:
    """Dotted name of an expression (``a.b.c``), or None if not a pure
    name/attribute chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _call_name(call: ast.Call) -> str | None:
    return _dotted(call.func)


def _last_seg(name: str | None) -> str | None:
    return None if name is None else name.rsplit(".", 1)[-1]


def _root_seg(name: str | None) -> str | None:
    return None if name is None else name.split(".", 1)[0]


def _function_scopes(tree: ast.Module):
    """Yield (scope_node, is_module) for the module and every function."""
    yield tree, True
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            yield node, False


def _body_of(scope) -> list[ast.stmt]:
    if isinstance(scope, ast.Lambda):
        return [ast.Expr(scope.body)]
    return scope.body


def _walk_same_scope(stmts):
    """Walk statements without descending into nested function/class
    definitions (their bodies are separate scopes)."""
    stack = list(stmts)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue  # yielded (its name may matter) but not descended
        stack.extend(ast.iter_child_nodes(node))


# ---------------------------------------------------------------------------
# DAL001 — collective call in a rank-dependent branch
# ---------------------------------------------------------------------------

# rank identity sources: eager (myid/current_rank) and traced
# (axis_index/axis_rank) — either way, branching on them and issuing a
# collective in only one arm diverges the ranks' collective sequences
_RANK_SOURCES = {"myid", "current_rank", "axis_index", "axis_rank",
                 # the port: a controller process's index in a job, and
                 # the quorum machinery's per-process verdicts
                 "process_index", "partition_verdict", "majority_side",
                 "quorum_assess"}

# calls that are collectives: every rank of the context (every process of
# a job) must participate
_COLLECTIVES = {
    # parallel.collectives: the rank-list collectives
    "pshift", "pshifts", "halo_exchange", "halo_exchange_2d", "pbarrier",
    "pbcast", "pgather", "preduce", "preduces", "pconcat", "pall_to_all",
    "psum_scatter",
    # parallel.spmd_mode (eager collectives)
    "barrier", "bcast", "scatter", "gather_spmd",
    # a job of several controller processes: the data plane, the
    # object all-gathers and the store barrier (parallel.multihost), the
    # cross-process region copy and IPC protocol (ops.cuda_collectives)
    "exchange", "fetch_regions", "cell_values", "_all_gather_objects",
    "_all_gather_json", "sync_hosts", "process_regions", "peer_call",
}


def _rank_tainted_names(scope) -> set[str]:
    """Names assigned (anywhere in the scope, nested defs included — an
    overapproximation that follows closures) from a rank-identity call."""
    tainted: set[str] = set()
    for node in ast.walk(scope):
        if not isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign,
                                 ast.NamedExpr)):
            continue
        value = node.value
        if value is None:
            continue
        has_rank_src = any(
            isinstance(n, ast.Call)
            and _last_seg(_call_name(n)) in _RANK_SOURCES
            for n in ast.walk(value))
        if not has_rank_src:
            continue
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        for t in targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    tainted.add(n.id)
    return tainted


def _is_rank_dependent(test: ast.expr, tainted: set[str]) -> bool:
    for n in ast.walk(test):
        if isinstance(n, ast.Name) and n.id in tainted:
            return True
        if (isinstance(n, ast.Call)
                and _last_seg(_call_name(n)) in _RANK_SOURCES):
            return True
    return False


@_rule("DAL001", "error", "collective call in a rank-dependent branch")
def _check_dal001(tree, path, lines):
    seen: set[tuple[int, int]] = set()
    for scope, _is_mod in _function_scopes(tree):
        tainted = _rank_tainted_names(scope)
        for node in _walk_same_scope(_body_of(scope)):
            if not isinstance(node, ast.If):
                continue
            if not _is_rank_dependent(node.test, tainted):
                continue
            for branch in (node.body, node.orelse):
                for sub in _walk_same_scope(branch):
                    if not isinstance(sub, ast.Call):
                        continue
                    name = _last_seg(_call_name(sub))
                    if name in _COLLECTIVES:
                        key = (sub.lineno, sub.col_offset)
                        if key not in seen:
                            seen.add(key)
                            yield (sub.lineno, sub.col_offset,
                                   f"collective '{name}' inside a "
                                   f"rank-dependent branch (test at line "
                                   f"{node.lineno}): every rank must issue "
                                   f"the identical collective sequence or "
                                   f"SPMD execution deadlocks")


# ---------------------------------------------------------------------------
# DAL002 — host synchronization inside a jit-traced region
# ---------------------------------------------------------------------------

_TRACING_WRAPPERS = {"djit", "run_spmd"}
_JIT_NAMES: set[str] = set()


def _is_jit_decorator(dec: ast.expr) -> bool:
    name = _dotted(dec)
    if name is not None:
        return (name in _JIT_NAMES or _last_seg(name) == "djit")
    if isinstance(dec, ast.Call):
        fname = _call_name(dec)
        if fname in _JIT_NAMES or _last_seg(fname) == "djit":
            return True  # @jax.jit(static_argnums=...) style
        if _last_seg(fname) == "partial" and dec.args:
            inner = _dotted(dec.args[0])
            return inner in _JIT_NAMES or _last_seg(inner) == "djit"
    return False


def _traced_function_names(tree) -> set[str]:
    """Names of functions handed to a traced-region wrapper anywhere in
    the module: ``djit(f)``, ``run_spmd(f, ...)``, including
    ``partial(f, ...)`` first arguments."""
    names: set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        fname = _call_name(node)
        if not (fname in _JIT_NAMES
                or _last_seg(fname) in _TRACING_WRAPPERS):
            continue
        target = node.args[0]
        if (isinstance(target, ast.Call)
                and _last_seg(_call_name(target)) == "partial"
                and target.args):
            target = target.args[0]
        tname = _dotted(target)
        if tname is not None:
            names.add(_last_seg(tname))
    return names


_HOST_NP_CALLS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
# tensor methods that copy to the host and wait for the device
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}


def _expr_root(node: ast.expr):
    """Root Name of an access/method chain: ``x``, ``x.shape[0]``, and
    ``x.sum().mean()`` all root at ``x`` — so ``float(x.sum())`` on a
    traced param is caught, not just ``float(x)``."""
    while True:
        if isinstance(node, (ast.Attribute, ast.Subscript)):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        else:
            break
    return node.id if isinstance(node, ast.Name) else None


def _scope_params(scope) -> set[str]:
    if isinstance(scope, ast.Module):
        return set()
    a = scope.args
    return {p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)
            } | {p.arg for p in (a.vararg, a.kwarg) if p is not None}


@_rule("DAL002", "error", "host synchronization inside a jit-traced region")
def _check_dal002(tree, path, lines):
    traced_names = _traced_function_names(tree)
    for scope, is_mod in _function_scopes(tree):
        if is_mod or isinstance(scope, ast.Lambda):
            continue
        traced = (scope.name in traced_names
                  or any(_is_jit_decorator(d) for d in scope.decorator_list))
        if not traced:
            continue
        params = _scope_params(scope)
        for node in _walk_same_scope(scope.body):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            last = _last_seg(name)
            if last in _HOST_METHODS and \
                    isinstance(node.func, ast.Attribute) and \
                    _root_seg(name) not in ("torch", "np", "numpy"):
                yield (node.lineno, node.col_offset,
                       f".{last}() inside a traced region forces a "
                       f"device→host sync per call; keep the value on "
                       f"the device or move the read out of the body")
            elif name in ("torch.cuda.synchronize", "cuda.synchronize"):
                yield (node.lineno, node.col_offset,
                       "torch.cuda.synchronize() inside a traced region "
                       "stalls the host on every call; synchronize "
                       "outside the body")
            elif (name in _HOST_NP_CALLS and node.args
                    and _expr_root(node.args[0]) in params):
                yield (node.lineno, node.col_offset,
                       f"{name}(...) on a traced argument materializes it "
                       f"on the host inside the traced region; use torch "
                       f"or hoist the conversion out of the body")
            elif (name in ("float", "int") and node.args
                    and _expr_root(node.args[0]) in params):
                yield (node.lineno, node.col_offset,
                       f"{name}(...) on a traced argument reads it to the "
                       f"host (a device sync); keep it a tensor "
                       f"(.to(dtype)) instead")
            elif (last == "gather"
                    and (name == "gather" or _root_seg(name) == "dat"
                         or (name or "").endswith("darray.gather"))):
                yield (node.lineno, node.col_offset,
                       "gather() collects the global array to host — "
                       "never inside a traced region")
            elif last == "set_localpart":
                yield (node.lineno, node.col_offset,
                       "set_localpart() rebinds a rank's chunk; inside a "
                       "traced region the body's inputs are copies, so "
                       "the write is lost — return the new value "
                       "instead")


# ---------------------------------------------------------------------------
# DAL003 — unguarded telemetry call with computed arguments
# ---------------------------------------------------------------------------

_TELEMETRY_ROOTS = {"telemetry", "_tm", "tm"}
_GUARD_NEEDED = {"event", "record_comm"}


def _has_enabled_guard(test: ast.expr) -> bool:
    return any(isinstance(n, ast.Call)
               and _last_seg(_call_name(n)) == "enabled"
               for n in ast.walk(test))


def _computed(arg: ast.expr) -> bool:
    return any(isinstance(n, (ast.Call, ast.JoinedStr, ast.BinOp,
                              ast.ListComp, ast.SetComp, ast.DictComp,
                              ast.GeneratorExp))
               for n in ast.walk(arg))


def _walk_expr(e: ast.expr):
    """Walk an expression without descending into lambda bodies (those run
    later, in their own guard context)."""
    stack = [e]
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, ast.Lambda):
            continue
        stack.extend(ast.iter_child_nodes(n))


@_rule("DAL003", "warning",
       "telemetry event/record_comm with computed args, no enabled() guard")
def _check_dal003(tree, path, lines):
    findings: list[FindingTuple] = []

    def scan_expr(e, guarded):
        if guarded or e is None:
            return
        for sub in _walk_expr(e):
            if not isinstance(sub, ast.Call):
                continue
            name = _call_name(sub)
            if (_last_seg(name) in _GUARD_NEEDED
                    and _root_seg(name) in _TELEMETRY_ROOTS
                    and any(_computed(a) for a in
                            list(sub.args)
                            + [k.value for k in sub.keywords])):
                findings.append((
                    sub.lineno, sub.col_offset,
                    f"telemetry.{_last_seg(name)} argument work "
                    f"(f-string / call / arithmetic) runs even with "
                    f"telemetry disabled; wrap the call in "
                    f"`if telemetry.enabled():`"))

    def visit(stmts, guarded):
        for node in stmts:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                visit(node.body, False)
                continue
            if isinstance(node, ast.If):
                scan_expr(node.test, guarded)
                visit(node.body, guarded or _has_enabled_guard(node.test))
                visit(node.orelse, guarded)
                continue
            # generic compound/simple statement: scan header expressions
            # in the current guard context, recurse into statement lists
            for _field, value in ast.iter_fields(node):
                if isinstance(value, ast.expr):
                    scan_expr(value, guarded)
                elif isinstance(value, list):
                    if value and isinstance(value[0], ast.stmt):
                        visit(value, guarded)
                    else:
                        for v in value:
                            if isinstance(v, ast.expr):
                                scan_expr(v, guarded)
                            elif isinstance(v, ast.ExceptHandler):
                                visit(v.body, guarded)
                            elif isinstance(v, ast.withitem):
                                scan_expr(v.context_expr, guarded)

    visit(tree.body, False)
    seen: set[tuple[int, int]] = set()
    for f in findings:
        if (f[0], f[1]) not in seen:
            seen.add((f[0], f[1]))
            yield f


# ---------------------------------------------------------------------------
# DAL004 — collective axis name not bound by any enclosing mesh
# ---------------------------------------------------------------------------

# only the collectives that take a mesh-axis NAME: the port's rank-list
# collectives take rank lists and int dims (a string positional there is a
# reduction op or a tag, not an axis), so the names left are the JAX ones,
# which only code written against a named mesh calls
_AXIS_TAKERS = {
    "psum", "pmax", "pmin", "pmean", "ppermute", "all_gather",
    "all_to_all", "pbroadcast", "axis_index", "axis_size",
}
_DN_AXIS = re.compile(r"^d\d+$")


def _literal_axis_names(call: ast.Call) -> tuple[set[str], bool]:
    """Axis names a mesh-building call binds; (names, known).  ``known``
    False means the binding could not be determined statically."""
    name = _last_seg(_call_name(call))
    if name == "Mesh":
        cands = list(call.args[1:2]) + [
            k.value for k in call.keywords if k.arg == "axis_names"]
        for c in cands:
            if isinstance(c, (ast.Tuple, ast.List)) and all(
                    isinstance(e, ast.Constant) and isinstance(e.value, str)
                    for e in c.elts):
                return {e.value for e in c.elts}, True
            if isinstance(c, ast.Constant) and isinstance(c.value, str):
                return {c.value}, True
        return set(), False
    if name == "spmd_mesh":
        for k in call.keywords:
            if k.arg == "axis":
                if (isinstance(k.value, ast.Constant)
                        and isinstance(k.value.value, str)):
                    return {k.value.value, "d0"}, True
                return set(), False
        if len(call.args) >= 2:
            a = call.args[1]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                return {a.value, "d0"}, True
            return set(), False
        return {"p", "d0"}, True  # spmd_mesh default axis
    if name in ("mesh_for", "make_mesh"):
        # binds the d0/d1/... family (layout.mesh_for) or unknown names
        return set(), name == "mesh_for"
    return set(), True


def _call_axis_literals(call: ast.Call) -> list[str]:
    """String axis names this collective call references: the first
    positional string constant (the axis slot in every collective API
    here) plus any axis=/axes= keyword literals."""
    out: list[str] = []
    for a in call.args:
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            out.append(a.value)
            break
    for k in call.keywords:
        if k.arg in ("axis", "axes", "axis_name"):
            if (isinstance(k.value, ast.Constant)
                    and isinstance(k.value.value, str)):
                out.append(k.value.value)
            elif isinstance(k.value, (ast.Tuple, ast.List)):
                out.extend(e.value for e in k.value.elts
                           if isinstance(e, ast.Constant)
                           and isinstance(e.value, str))
    return out


@_rule("DAL004", "error", "collective axis name unbound by enclosing mesh")
def _check_dal004(tree, path, lines):
    for scope, _is_mod in _function_scopes(tree):
        bound: set[str] = set()
        allow_dn = False
        known = True
        saw_mesh = False
        for node in _walk_same_scope(_body_of(scope)):
            if not isinstance(node, ast.Call):
                continue
            name = _last_seg(_call_name(node))
            if name in ("Mesh", "spmd_mesh", "mesh_for", "make_mesh"):
                saw_mesh = True
                names, ok = _literal_axis_names(node)
                bound |= names
                known = known and ok
                if name in ("mesh_for",):
                    allow_dn = True
        if not saw_mesh or not known:
            continue  # axis bound by the caller / not statically decidable
        for node in _walk_same_scope(_body_of(scope)):
            if not isinstance(node, ast.Call):
                continue
            if _last_seg(_call_name(node)) not in _AXIS_TAKERS:
                continue
            for axis in _call_axis_literals(node):
                if axis in bound or (allow_dn and _DN_AXIS.match(axis)):
                    continue
                yield (node.lineno, node.col_offset,
                       f"axis {axis!r} is not bound by any mesh built in "
                       f"this scope (bound: {sorted(bound)}); a mismatched "
                       f"axis name only fails at trace time inside "
                       f"shard_map")


# ---------------------------------------------------------------------------
# DAL005 — import/export hygiene (star imports, phantom __all__ entries)
# ---------------------------------------------------------------------------


def _module_bindings(tree: ast.Module) -> set[str]:
    """Names bound at module level (descending into if/try/with/loop
    blocks but not into function or class bodies)."""
    bound: set[str] = set()
    for node in _walk_same_scope(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            bound.add(node.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                bound.add(a.asname or a.name.split(".", 1)[0])
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                if a.name != "*":
                    bound.add(a.asname or a.name)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            # covers plain/ann/aug assigns, loop targets, with-as, walrus
            bound.add(node.id)
    return bound


@_rule("DAL005", "error", "import/export hygiene")
def _check_dal005(tree, path, lines):
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and any(
                a.name == "*" for a in node.names):
            yield (node.lineno, node.col_offset,
                   f"star import from {node.module!r}: explicit imports "
                   f"only (ExplicitImports discipline)")
    # __all__ must be a literal list/tuple of strings naming real bindings
    for node in tree.body:
        if not (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "__all__"
                        for t in node.targets)):
            continue
        if not isinstance(node.value, (ast.List, ast.Tuple)):
            continue  # dynamically built __all__: out of scope
        names = [e.value for e in node.value.elts
                 if isinstance(e, ast.Constant) and isinstance(e.value, str)]
        bound = _module_bindings(tree)
        seen: set[str] = set()
        for name in names:
            if name in seen:
                yield (node.lineno, node.col_offset,
                       f"__all__ lists {name!r} twice")
            seen.add(name)
            if name not in bound:
                yield (node.lineno, node.col_offset,
                       f"__all__ exports {name!r} but the module never "
                       f"binds it")


# ---------------------------------------------------------------------------
# DAL006 — DArray constructed in a loop without close()/context discipline
# ---------------------------------------------------------------------------

_DARRAY_CTORS = {
    "dzeros", "dones", "dfill", "drand", "drandn", "drandint", "dsample",
    "darray", "darray_like", "dfromfunction", "distribute", "from_chunks",
    "ddata", "ddata_bcoo",
}
_CLOSERS = {"close", "d_closeall", "close_context"}


@_rule("DAL006", "warning",
       "DArray created in a loop without close()/context discipline")
def _check_dal006(tree, path, lines):
    seen: set[tuple[int, int]] = set()
    for node in ast.walk(tree):
        if not isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            continue
        body = list(node.body)
        has_closer = any(
            isinstance(sub, ast.Call)
            and _last_seg(_call_name(sub)) in _CLOSERS
            for sub in _walk_same_scope(body))
        if has_closer:
            continue
        for sub in _walk_same_scope(body):
            if not isinstance(sub, ast.Call):
                continue
            name = _last_seg(_call_name(sub))
            if name in _DARRAY_CTORS:
                key = (sub.lineno, sub.col_offset)
                if key in seen:
                    continue
                seen.add(key)
                yield (sub.lineno, sub.col_offset,
                       f"'{name}' allocates a DArray every iteration and "
                       f"the loop body never close()s one — per-iteration "
                       f"HBM lingers until GC (leak-prone; see "
                       f"core.d_closeall / DArray.close)")


# ---------------------------------------------------------------------------
# DAL007 — a rank tensor moved to another rank's device outside the planner
# ---------------------------------------------------------------------------

# modules allowed to move rank tensors between devices: the planner itself
# (its region copies ARE the planned strategy) and the copy kernel's home,
# the planner's own lowering
_RESHARD_HOME = ("parallel/reshard.py", "parallel\\reshard.py",
                 "ops/cuda_collectives.py", "ops\\cuda_collectives.py")

# the calls and subscripts that name one rank's tensor of a DArray
_RANK_TENSOR_CALLS = {"part", "localpart", "lp"}


def _rank_tensor(node: ast.expr) -> str | None:
    """The DArray expression whose rank tensor ``node`` is
    (``d.part(ci)``, ``d.localpart(r)``, ``d._parts[ci]``, a slice of
    one), else None."""
    while isinstance(node, ast.Subscript) and not (
            isinstance(node.value, ast.Attribute)
            and node.value.attr == "_parts"):
        node = node.value
    if isinstance(node, ast.Subscript):
        return ast.unparse(node.value.value)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr in _RANK_TENSOR_CALLS:
        return ast.unparse(node.func.value)
    return None


def _rank_device(node: ast.expr) -> bool:
    """A device chosen by rank: ``device_of(...)``."""
    return any(isinstance(n, ast.Call)
               and _last_seg(_call_name(n)) == "device_of"
               for n in ast.walk(node))


@_rule("DAL007", "warning",
       "rank tensor moved to another rank's device outside "
       "parallel/reshard.py")
def _check_dal007(tree, path, lines):
    norm = path.replace("\\", "/")
    if any(norm.endswith(h.replace("\\", "/")) for h in _RESHARD_HOME):
        return
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or \
                not isinstance(node.func, ast.Attribute) or not node.args:
            continue
        recv, arg = node.func.value, node.args[0]
        if node.func.attr == "to":
            hit = _rank_tensor(recv) is not None and (
                _rank_device(arg)
                or (isinstance(arg, (ast.Name, ast.Attribute))
                    and "dev" in ast.unparse(arg).lower()))
        elif node.func.attr == "copy_":
            a, b = _rank_tensor(recv), _rank_tensor(arg)
            hit = a is not None and b is not None and a != b
        else:
            continue
        if hit:
            yield (node.lineno, node.col_offset,
                   "a rank tensor moved to another rank's device by hand "
                   "bypasses the reshard planner (plan cache, the copy "
                   "kernel, moved-bytes accounting); use "
                   "parallel.reshard (relayout, copyto_) — or suppress "
                   "with a justification if this site cannot have a "
                   "plannable source layout")


# ---------------------------------------------------------------------------
# DAL008/DAL009 — lock-order and blocking-under-lock (analysis/locks.py)
# ---------------------------------------------------------------------------

# The real engine lives in ``analysis/locks.py`` (it is interprocedural
# and also runs cross-file via the ``locks`` CLI verb); the rule
# catalog exposes its single-file mode so the ordinary lint sweep and
# the usual suppression syntax apply.  Single-file mode still resolves
# ``self.method()`` / module-function calls within the file, so a
# helper that sleeps three calls deep is caught from the locked caller.


def _lock_findings(tree, path, lines, code):
    # re-serialize from the lines the engine parsed: locks.py caches per
    # (path, source), so the two rule codes share one analysis pass
    from . import locks as _locks
    src = "\n".join(lines)
    for f in _locks.findings_for_source(src, path):
        if f.code == code:
            yield (f.line, f.col, f.message)


@_rule("DAL008", "warning",
       "blocking call made while holding a lock")
def _check_dal008(tree, path, lines):
    yield from _lock_findings(tree, path, lines, "DAL008")


@_rule("DAL009", "warning",
       "lock-order cycle / non-reentrant re-acquisition (deadlock)")
def _check_dal009(tree, path, lines):
    yield from _lock_findings(tree, path, lines, "DAL009")


# ---------------------------------------------------------------------------
# DAL010/011/012 — interprocedural SPMD effects (analysis/effects.py)
# ---------------------------------------------------------------------------

# The engine is the effect-signature interpreter in
# ``analysis/effects.py`` (callgraph + abstract interpretation; it also
# runs cross-file via the ``verify-spmd`` CLI verb).  The rule catalog
# exposes its single-file mode so the ordinary lint sweep and the usual
# suppression syntax apply: taint and collective effects that close
# within one file — helpers, closures, ``functools.partial`` — are
# caught here; cross-module flows need ``verify-spmd``.


def _effect_findings(tree, path, lines, code):
    from . import effects as _effects
    src = "\n".join(lines)
    for f in _effects.findings_for_source(src, path):
        if f.code == code:
            yield (f.line, f.col, f.message)


@_rule("DAL010", "error",
       "static SPMD divergence: rank-tainted branch, non-equivalent "
       "collective signatures")
def _check_dal010(tree, path, lines):
    yield from _effect_findings(tree, path, lines, "DAL010")


@_rule("DAL011", "error",
       "collective axis unbound by the mesh context reaching the call")
def _check_dal011(tree, path, lines):
    yield from _effect_findings(tree, path, lines, "DAL011")


@_rule("DAL012", "error",
       "collective under a rank-tainted loop bound")
def _check_dal012(tree, path, lines):
    yield from _effect_findings(tree, path, lines, "DAL012")
