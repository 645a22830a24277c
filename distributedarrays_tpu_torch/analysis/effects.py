"""Interprocedural SPMD collective-effect inference (dalint v3).

The port's copy of ``distributedarrays_tpu/analysis/effects.py`` over the
port's vocabulary (``analysis/rules.py``'s docstring lists it): the rank
sources add ``process_index`` and ``quorum_assess``; the collective
events are the eager ``spmd_mode`` ones, the rank-list collectives of
``parallel/collectives.py`` and the calls every process of a job must
make (``multihost.exchange``, ``fetch_regions``, ``cell_values``, the
object all-gathers, the store barrier ``sync_hosts``, the cross-process
``process_regions`` and ``peer_call``).  A process that skips one of
those leaves its peers waiting out the store timeout: DAL010/DAL012.

The runtime ``DivergenceChecker`` (analysis/divergence.py) only catches
collective-order divergence when a rank actually *takes* the bad branch
under the thread backend, and DAL001/DAL004 are single-function
syntactic checks — rank taint that flows through a helper call, a
stored closure, or a ``functools.partial`` is invisible to both.  This
module is the static prover: an abstract interpreter that computes, per
function, an ordered **collective effect signature** — a small
regex-like algebra of collective events with sequence, branch
alternation, and loop star —

    barrier(tag=None); {bcast(root=0, tag=None) | ε}; (psum(axis='p'))*

composed interprocedurally over ``analysis/callgraph.py`` with taint
summaries, so rank-dependence (``myid``/``axis_index``/quorum verdicts)
propagates through parameters, returns, and captured variables.  On top
of the signatures, three rules:

- **DAL010 — static SPMD divergence**: a rank-tainted branch whose arms
  have non-equivalent effect signatures.  The finding prints the call
  path and both signatures in the same shape as the runtime
  ``CollectiveDivergenceError`` report, so static and runtime findings
  cross-reference.  Arms that *terminate* the program (``raise``,
  ``sys.exit``) are exempt — an aborting rank is an error, not a silent
  deadlock.  ``gather_spmd`` payloads whose array shape is rank-tainted
  (the payload-signature divergence the runtime checker compares) are
  also flagged here.
- **DAL011 — interprocedural unbound collective axis**: DAL004
  generalized across calls — mesh context flows from ``Mesh`` /
  ``spmd_mesh`` / ``mesh_for`` construction sites into every function
  those scopes reach, and a collective whose literal axis name is
  unbound in the *reaching* mesh context is flagged with the call path.
  Functions that build their own mesh stay DAL004's domain.
- **DAL012 — collective under a rank-tainted loop bound**: per-rank
  iteration counts differ, so per-rank collective *counts* diverge —
  the loop-shaped variant of DAL010.

Like every dalint analysis this one is conservative in the
false-positive direction: an unresolvable call is assumed
collective-free, an unknown axis or tag compares equal to another
unknown, and a rule that cannot prove its premise stays silent.
Surfaces: the per-file rule catalog (suppressible with ``# dalint:
disable=DAL010`` etc.), ``python -m distributedarrays_tpu_torch.analysis
effects <module:fn>`` (print one signature), and ``verify-spmd`` (the
cross-file package gate).
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Iterable

from .callgraph import Binding, CallGraph, dotted_name, module_name_for
from .engine import Finding, parse_suppressions

__all__ = ["analyze_sources", "analyze_paths", "findings_for_source",
           "signature_for", "render", "EffectReport",
           "DEFAULT_EFFECT_TARGETS", "EPS"]

# the sweep surface the verify-spmd CLI verb defaults to — tests/ is in
# scope: seeded-divergence fixtures there must carry suppressions, and a
# *new* test helper with a real rank-gated collective is exactly the bug
# this gate exists to stop
DEFAULT_EFFECT_TARGETS = ("distributedarrays_tpu_torch", "chip_smoke.py")

# -- event vocabularies ------------------------------------------------------

_RANK_SOURCES = {"myid", "current_rank", "axis_index", "axis_rank",
                 "process_index"}
# quorum machinery: branching on a partition verdict is domain/rank-
# dependent control flow (resilience/domains.py, elastic.partition_verdict,
# multihost.quorum_assess)
_QUORUM_SOURCES = {"partition_verdict", "majority_side", "quorum_assess"}

# eager spmd_mode collectives: detail mirrors spmd_mode._dv_note so the
# static signature reads like the runtime per-rank sequence entries
_EAGER = {"barrier", "bcast", "scatter", "gather_spmd"}
# the rank-list collectives (parallel.collectives) and the calls every
# process of a job makes (parallel.multihost, ops.cuda_collectives):
# detail is an axis name where one is given (none in the port)
_TRACED = {
    "pshift", "pshifts", "halo_exchange", "halo_exchange_2d", "pbarrier",
    "pbcast", "pgather", "preduce", "preduces", "pconcat", "pall_to_all",
    "psum_scatter",
    "exchange", "fetch_regions", "cell_values", "_all_gather_objects",
    "_all_gather_json", "sync_hosts", "process_regions", "peer_call",
}
# the JAX axis-taking collectives: the port has no named mesh axes, so
# only code that names one reaches DAL011
_JAX_AXIS = {"psum", "pmax", "pmin", "pmean", "ppermute", "all_gather",
             "all_to_all", "pbroadcast"}
# DArray-level contract surface: in multihost SPMD every rank must
# co-issue these driver ops (the boundary DrJAX-style differentiable
# primitives are verified against)
_DARRAY_OPS = {"map_localparts", "map_localparts_into", "mapreduce",
               "dmap", "dmap_into"}

_MESH_CTORS = {"Mesh", "spmd_mesh", "mesh_for", "make_mesh"}
_DN_AXIS = re.compile(r"^d\d+$")

# array constructors whose result shape is a function of their arguments
# — a rank-tainted shape fed to gather_spmd diverges the payload
# signatures the runtime checker compares
_ARRAY_CTORS = {"zeros", "ones", "empty", "full", "arange", "reshape",
                "rand", "randn", "tile", "repeat", "broadcast_to"}

# terminating calls: an arm that exits typed is an error path, exempt
# from the divergence comparison (mirrors the runtime rule that a user
# exception stays the root cause)
_EXIT_CALLS = {"exit", "_exit", "abort", "fail", "skip"}

_CLOSING = ("Every rank must issue the identical collective sequence — "
            "across controller processes this program deadlocks (the "
            "peers wait out the store timeout). "
            "(Runtime twin: CollectiveDivergenceError under "
            "DA_TPU_CHECK_DIVERGENCE=1.)")


# ---------------------------------------------------------------------------
# the signature algebra: eps | ev | seq | alt | star | opaque
# ---------------------------------------------------------------------------

EPS = ("eps",)


def _seq(nodes) -> tuple:
    out = []
    for n in nodes:
        if n == EPS:
            continue
        if n[0] == "seq":
            out.extend(n[1])
        else:
            out.append(n)
    if not out:
        return EPS
    if len(out) == 1:
        return out[0]
    return ("seq", tuple(out))


def _alt(nodes) -> tuple:
    flat = []
    for n in nodes:
        if n[0] == "alt":
            flat.extend(n[1])
        else:
            flat.append(n)
    uniq = sorted(set(flat), key=repr)
    if len(uniq) == 1:
        return uniq[0]
    return ("alt", tuple(uniq))


def _star(n) -> tuple:
    if n == EPS:
        return EPS
    if n[0] == "star":
        return n
    return ("star", n)


def _has_ev(n) -> bool:
    if n[0] == "ev":
        return True
    if n[0] == "seq" or n[0] == "alt":
        return any(_has_ev(c) for c in n[1])
    if n[0] == "star":
        return _has_ev(n[1])
    return False


def equivalent(a: tuple, b: tuple) -> bool:
    """Signature equivalence = structural equality of normalized forms.
    Sound for the rule's purpose: equal forms never diverge; distinct
    forms are only *reported* when at least one side contains a real
    collective event (two opaque-only forms stay silent)."""
    return a == b


def render(n: tuple, top: bool = True) -> str:
    """Human form of a signature: ``barrier(tag=None); {bcast(root=0) |
    ε}; (psum(axis='p'))*`` — ``(none)`` for an empty top-level form,
    matching the runtime sequence printout."""
    if n == EPS:
        return "(none)" if top else "ε"
    kind = n[0]
    if kind == "ev":
        _k, op, detail = n
        if not detail:
            return op
        return f"{op}({', '.join(f'{k}={v}' for k, v in detail)})"
    if kind == "seq":
        return "; ".join(render(c, False) for c in n[1])
    if kind == "alt":
        return "{" + " | ".join(render(c, False) for c in n[1]) + "}"
    if kind == "star":
        return f"({render(n[1], False)})*"
    if kind == "opaque":
        return f"<{n[1]}>"
    return repr(n)


# ---------------------------------------------------------------------------
# analysis contexts and summaries
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Ctx:
    """Calling context a function is analyzed under.  Part of the memo
    key — contexts stay small because only taint, resolved function
    arguments, literal constants, and the mesh axes flow through."""

    tainted: frozenset = frozenset()        # tainted parameter names
    shape_tainted: frozenset = frozenset()  # params with rank-tainted shape
    bindings: tuple = ()                    # ((param, Binding), ...)
    consts: tuple = ()                      # ((param, literal), ...)
    mesh: tuple | None = None               # (frozenset(axes), allow_dn)
    mesh_from: str = ""                     # where the mesh was built


@dataclasses.dataclass
class _Summary:
    sig: tuple = EPS
    ret_taint: bool = False


_MISSING = object()


@dataclasses.dataclass
class _Val:
    """Abstract value of one expression."""

    sig: tuple = EPS
    taint: bool = False
    binding: Binding | None = None
    const: object = _MISSING
    shape_taint: bool = False
    why: str = ""                 # taint provenance, for messages


@dataclasses.dataclass
class EffectReport:
    """Cross-file analysis result (``verify-spmd``)."""

    findings: list
    functions: int
    contexts: int
    truncated: bool = False


# ---------------------------------------------------------------------------
# the interprocedural driver
# ---------------------------------------------------------------------------

_BUDGET = 60000   # (function, context) analyses per run — a runaway
                  # guard, far above any real sweep; exceeding it stops
                  # emitting findings and marks the report truncated


class _Analysis:
    def __init__(self, graph: CallGraph):
        self.graph = graph
        self.memo: dict = {}
        self.in_progress: set = set()
        self.findings: dict = {}     # (path, line, col, code) -> message
        self.spent = 0
        self.truncated = False

    # -- entry sweep ---------------------------------------------------------

    def run(self) -> None:
        for key in list(self.graph.funcs):
            self.summarize(key, _Ctx(), ())

    def summarize(self, key, ctx: _Ctx, path_stack: tuple) -> _Summary:
        mkey = (key, ctx)
        hit = self.memo.get(mkey)
        if hit is not None:
            return hit
        if mkey in self.in_progress or len(path_stack) > 25:
            fdef = self.graph.func(key)
            return _Summary(("opaque", fdef.qname if fdef else str(key)))
        if self.spent >= _BUDGET:
            self.truncated = True
            return _Summary()
        self.spent += 1
        fdef = self.graph.func(key)
        if fdef is None:
            return _Summary()
        self.in_progress.add(mkey)
        try:
            interp = _FnInterp(self, fdef, ctx, path_stack)
            sig, _term = interp.block(fdef.node.body)
            out = _Summary(sig, interp.ret_taint)
        finally:
            self.in_progress.discard(mkey)
        self.memo[mkey] = out
        return out

    def emit(self, path: str, line: int, col: int, code: str,
             message: str) -> None:
        if self.truncated:
            return
        self.findings.setdefault((path, line, col, code), message)


# ---------------------------------------------------------------------------
# per-function abstract interpretation
# ---------------------------------------------------------------------------


def _walk_own(node):
    """Walk a function's own statements/expressions without descending
    into nested function/class bodies."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(n))


class _FnInterp:
    def __init__(self, analysis: _Analysis, fdef, ctx: _Ctx,
                 path_stack: tuple):
        self.a = analysis
        self.graph = analysis.graph
        self.fdef = fdef
        self.ctx = ctx
        self.path_stack = path_stack
        self.tainted: set[str] = set(ctx.tainted)
        self.shape_tainted: set[str] = set(ctx.shape_tainted)
        self.env: dict[str, Binding] = dict(ctx.bindings)
        self.consts: dict[str, object] = dict(ctx.consts)
        self.nested_caps: dict[str, frozenset] = {}
        self.taint_why: dict[str, str] = {
            n: f"tainted argument for parameter {n!r}"
            for n in ctx.tainted}
        self.ret_taint = False
        # does this function build its own mesh?  then DAL004 owns its
        # axis checks and the local axes flow to callees instead of the
        # inherited context
        from . import rules as _rules
        axes: set[str] = set()
        allow_dn = False
        known = True
        saw = False
        for n in _walk_own(fdef.node):
            ctor = _last(dotted_name(n.func)) \
                if isinstance(n, ast.Call) else None
            if ctor in _MESH_CTORS:
                saw = True
                names, ok = _rules._literal_axis_names(n)
                if ctor == "make_mesh":
                    names, ok = _make_mesh_axes(n)
                axes |= names
                known = known and ok
                if ctor == "mesh_for":
                    allow_dn = True
        self.own_mesh = saw
        if saw and known:
            self.mesh: tuple | None = (frozenset(axes), allow_dn)
            self.mesh_from = fdef.qname
        elif saw:
            self.mesh = None          # own mesh, axes not static: silent
            self.mesh_from = ""
        else:
            self.mesh = ctx.mesh
            self.mesh_from = ctx.mesh_from

    # -- helpers -------------------------------------------------------------

    @property
    def path_str(self) -> str:
        return " → ".join([f.qname for f in self.path_stack]
                          + [self.fdef.qname])

    def _emit(self, node, code, message):
        self.a.emit(self.fdef.path, node.lineno, node.col_offset, code,
                    message)

    def _src(self, node) -> str:
        try:
            text = ast.unparse(node)
        except Exception:   # pragma: no cover - unparse is total on 3.12
            return "<expr>"
        return text if len(text) <= 60 else text[:57] + "..."

    def _test_why(self, test: ast.expr) -> str:
        for n in ast.walk(test):
            if isinstance(n, ast.Call):
                last = _last(dotted_name(n.func))
                if last in _RANK_SOURCES | _QUORUM_SOURCES:
                    return f"{last}()"
            if isinstance(n, ast.Name) and n.id in self.tainted:
                return self.taint_why.get(n.id, f"tainted {n.id!r}")
        return "rank-tainted value"

    # -- statement interpretation -------------------------------------------

    def block(self, stmts: list) -> tuple[tuple, str | None]:
        """Effect of a statement list; returns ``(sig, terminator)``
        with terminator ∈ {None, "return", "break", "dead"}."""
        if not stmts:
            return EPS, None
        st, rest = stmts[0], stmts[1:]

        if isinstance(st, ast.If):
            return self._if(st, rest)
        if isinstance(st, ast.Return):
            v = self.eval(st.value) if st.value is not None else _Val()
            if v.taint:
                self.ret_taint = True
            return v.sig, "return"
        if isinstance(st, ast.Raise):
            return EPS, "dead"
        if isinstance(st, (ast.Break, ast.Continue)):
            return EPS, "break"
        if isinstance(st, ast.Expr) and self._is_exit_call(st.value):
            return EPS, "dead"

        sig = self.stmt(st)
        rest_sig, term = self.block(rest)
        return _seq([sig, rest_sig]), term

    def _is_exit_call(self, e) -> bool:
        return (isinstance(e, ast.Call)
                and _last(dotted_name(e.func)) in _EXIT_CALLS)

    def _if(self, node: ast.If, rest: list) -> tuple[tuple, str | None]:
        test_v = self.eval(node.test)
        a_sig, a_term = self.block(node.body)
        b_sig, b_term = self.block(node.orelse)
        rest_sig, rest_term = self.block(rest)

        def arm(sig, term):
            return sig if term is not None else _seq([sig, rest_sig])

        arm_a, arm_b = arm(a_sig, a_term), arm(b_sig, b_term)
        if (test_v.taint and a_term != "dead" and b_term != "dead"
                and not equivalent(arm_a, arm_b)
                and (_has_ev(arm_a) or _has_ev(arm_b))):
            self._emit(node, "DAL010", self._divergence_msg(
                node, arm_a, arm_b))
        if a_term == "dead" and b_term == "dead":
            return _seq([test_v.sig]), "dead"
        if a_term == "dead":
            out_term = b_term if b_term is not None else rest_term
            return _seq([test_v.sig, arm_b]), out_term
        if b_term == "dead":
            out_term = a_term if a_term is not None else rest_term
            return _seq([test_v.sig, arm_a]), out_term
        whole = _seq([test_v.sig, _alt([arm_a, arm_b])])
        if a_term is not None and b_term is not None:
            return whole, "return"
        return whole, rest_term

    def _divergence_msg(self, node, arm_a, arm_b) -> str:
        return (f"static SPMD divergence at rank-dependent branch "
                f"(`{self._src(node.test)}`, tainted via "
                f"{self._test_why(node.test)}): the arms issue "
                f"non-identical collective sequences\n"
                f"  per-branch collective signatures "
                f"[call path: {self.path_str}]:\n"
                f"  if-arm  : {render(arm_a)}\n"
                f"  else-arm: {render(arm_b)}\n"
                f"  {_CLOSING}")

    def stmt(self, st) -> tuple:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            key = (self.fdef.module, self.fdef.cls,
                   f"{self.fdef.name}.{st.name}")
            if key in self.graph.funcs:
                self.env[st.name] = Binding("func", key)
                caps = frozenset(
                    self.graph.funcs[key].freevars) & self.tainted
                self.nested_caps[st.name] = caps
            return EPS
        if isinstance(st, ast.ClassDef):
            return EPS
        if isinstance(st, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            return self._assign(st)
        if isinstance(st, ast.Expr):
            return self.eval(st.value).sig
        if isinstance(st, (ast.For, ast.AsyncFor)):
            return self._loop(st, iter_expr=st.iter)
        if isinstance(st, ast.While):
            return self._loop(st, test_expr=st.test)
        if isinstance(st, (ast.With, ast.AsyncWith)):
            parts = [self.eval(it.context_expr).sig for it in st.items]
            body, _term = self.block(st.body)
            return _seq(parts + [body])
        if isinstance(st, ast.Try):
            body, _t = self.block(st.body)
            orelse, _t2 = self.block(st.orelse)
            final, _t3 = self.block(st.finalbody)
            return _seq([body, orelse, final])
        if isinstance(st, ast.Match):
            return self._match(st)
        if isinstance(st, ast.Assert):
            return self.eval(st.test).sig
        # Import/Global/Pass/Delete/...: no collective effect
        return EPS

    def _match(self, st: ast.Match) -> tuple:
        subj = self.eval(st.subject)
        arms = []
        for case in st.cases:
            sig, term = self.block(case.body)
            if term != "dead":
                arms.append(sig)
        if subj.taint and len(arms) > 1:
            distinct = sorted({a for a in arms}, key=repr)
            if len(distinct) > 1 and any(_has_ev(a) for a in arms):
                self._emit(
                    st, "DAL010",
                    f"static SPMD divergence at rank-dependent match "
                    f"(`{self._src(st.subject)}`): case bodies issue "
                    f"non-identical collective sequences\n"
                    f"  per-branch collective signatures "
                    f"[call path: {self.path_str}]:\n"
                    + "\n".join(f"  case arm: {render(a)}"
                                for a in distinct[:4])
                    + f"\n  {_CLOSING}")
        return _seq([subj.sig, _alt(arms) if arms else EPS])

    def _loop(self, st, iter_expr=None, test_expr=None) -> tuple:
        bound_v = self.eval(iter_expr if iter_expr is not None
                            else test_expr)
        if iter_expr is not None:
            # loop targets inherit the iterable's taint
            for n in ast.walk(st.target):
                if isinstance(n, ast.Name):
                    if bound_v.taint:
                        self.tainted.add(n.id)
                        self.taint_why.setdefault(
                            n.id, f"loop over {self._src(iter_expr)}")
        body, _term = self.block(st.body)
        orelse, _t = self.block(st.orelse)
        if bound_v.taint and _has_ev(body):
            kind = ("iteration space" if iter_expr is not None
                    else "condition")
            bound_src = self._src(iter_expr if iter_expr is not None
                                  else test_expr)
            self._emit(st, "DAL012",
                       f"collective under a rank-tainted loop "
                       f"{kind} (`{bound_src}`, tainted via "
                       f"{self._test_why(iter_expr or test_expr)}): "
                       f"per-rank iteration counts differ, so per-rank "
                       f"collective sequences diverge\n"
                       f"  loop body signature "
                       f"[call path: {self.path_str}]: "
                       f"{render(_star(body))}\n  {_CLOSING}")
        return _seq([bound_v.sig, _star(body), orelse])

    def _assign(self, st) -> tuple:
        v = self.eval(st.value) if st.value is not None else _Val()
        targets = (st.targets if isinstance(st, ast.Assign)
                   else [st.target])
        aug = isinstance(st, ast.AugAssign)
        for t in targets:
            for n in ast.walk(t):
                if not isinstance(n, ast.Name):
                    continue
                if v.taint or (aug and n.id in self.tainted):
                    self.tainted.add(n.id)
                    self.taint_why.setdefault(
                        n.id, v.why or f"assigned from "
                                       f"{self._src(st.value)}")
                elif not aug:
                    self.tainted.discard(n.id)
                if v.shape_taint:
                    self.shape_tainted.add(n.id)
                elif not aug:
                    self.shape_tainted.discard(n.id)
                if isinstance(t, ast.Name):   # plain x = ... only
                    if v.binding is not None:
                        self.env[n.id] = v.binding
                    elif not aug:
                        self.env.pop(n.id, None)
                    if v.const is not _MISSING:
                        self.consts[n.id] = v.const
                    elif not aug:
                        self.consts.pop(n.id, None)
        return v.sig

    # -- expression interpretation ------------------------------------------

    def eval(self, e) -> _Val:
        if e is None:
            return _Val()
        if isinstance(e, ast.Constant):
            return _Val(const=e.value)
        if isinstance(e, ast.Name):
            b = self.env.get(e.id)
            if b is None:
                g = self.graph.lookup(self.fdef.module, e.id,
                                      self.fdef.cls, self.env)
                b = g
            return _Val(taint=e.id in self.tainted, binding=b,
                        const=self.consts.get(e.id, _MISSING),
                        shape_taint=e.id in self.shape_tainted,
                        why=self.taint_why.get(e.id, ""))
        if isinstance(e, ast.Call):
            return self.eval_call(e)
        if isinstance(e, (ast.Attribute, ast.Subscript)):
            dn = dotted_name(e)
            binding = None
            if dn is not None:
                binding = self.graph.lookup(self.fdef.module, dn,
                                            self.fdef.cls, self.env)
            inner = self.eval(e.value)
            extra = _Val()
            if isinstance(e, ast.Subscript):
                extra = self.eval(e.slice)
            return _Val(_seq([inner.sig, extra.sig]),
                        inner.taint or extra.taint, binding,
                        shape_taint=inner.shape_taint, why=inner.why)
        if isinstance(e, ast.Lambda):
            return _Val()
        if isinstance(e, ast.IfExp):
            t = self.eval(e.test)
            a, b = self.eval(e.body), self.eval(e.orelse)
            return _Val(_seq([t.sig, _alt([a.sig, b.sig])]),
                        t.taint or a.taint or b.taint,
                        why=t.why or a.why or b.why)
        if isinstance(e, ast.NamedExpr):
            v = self.eval(e.value)
            if isinstance(e.target, ast.Name):
                if v.taint:
                    self.tainted.add(e.target.id)
                if v.const is not _MISSING:
                    self.consts[e.target.id] = v.const
            return v
        # generic: fold children left-to-right
        parts, taint, shape, why = [], False, False, ""
        for sub in ast.iter_child_nodes(e):
            if isinstance(sub, ast.expr):
                v = self.eval(sub)
                parts.append(v.sig)
                taint = taint or v.taint
                shape = shape or v.shape_taint
                why = why or v.why
            elif isinstance(sub, ast.comprehension):
                for ce in [sub.iter, sub.target] + sub.ifs:
                    v = self.eval(ce)
                    parts.append(v.sig)
                    taint = taint or v.taint
        return _Val(_seq(parts), taint, shape_taint=shape, why=why)

    # -- calls ---------------------------------------------------------------

    def eval_call(self, call: ast.Call) -> _Val:
        name = dotted_name(call.func)
        last = _last(name)
        recv_val = _Val()
        if name is None and isinstance(call.func, ast.Attribute):
            recv_val = self.eval(call.func.value)
            last = call.func.attr
        arg_vals = [self.eval(a) for a in call.args]
        kw_vals = {k.arg: self.eval(k.value) for k in call.keywords}
        pre = _seq([recv_val.sig] + [v.sig for v in arg_vals]
                   + [v.sig for v in kw_vals.values()])
        any_taint = (recv_val.taint or any(v.taint for v in arg_vals)
                     or any(v.taint for v in kw_vals.values()))

        if last in _RANK_SOURCES:
            if last == "axis_index":
                self._check_axis(call, last)
            return _Val(pre, True, why=f"{last}()")
        if last in _JAX_AXIS:
            self._check_axis(call, last)
        if last in _QUORUM_SOURCES:
            return _Val(pre, True, why=f"{last}() verdict")
        if last in _EAGER or last in _TRACED or last in _DARRAY_OPS:
            ev = self._collective_event(call, last, arg_vals, kw_vals)
            return _Val(_seq([pre, ev]), any_taint)
        if last in _ARRAY_CTORS:
            return _Val(pre, any_taint, shape_taint=any_taint,
                        why=f"array shaped by {self._src(call)}"
                        if any_taint else "")
        if last in _MESH_CTORS:
            return _Val(pre, False)
        # local partial construction and call-through wrappers: the
        # resulting value *is* (a binding to) the wrapped function
        if last == "partial" and call.args:
            base = arg_vals[0].binding
            if base is not None and base.kind in ("func", "partial"):
                bargs = (base.bound_args if base.kind == "partial"
                         else ()) + tuple(call.args[1:])
                bkw = base.bound_kwargs + tuple(
                    (k.arg, k.value) for k in call.keywords if k.arg)
                return _Val(pre, binding=Binding("partial", base.ref,
                                                 bargs, bkw))
        if last in ("jit", "djit", "lru_cache", "cache", "wraps",
                    "shard_map", "traced", "run_spmd") and call.args:
            wrapped = arg_vals[0].binding
            if wrapped is not None and wrapped.kind in ("func",
                                                        "partial"):
                out = self._call_known(wrapped, call, arg_vals[1:],
                                       {})
                return _Val(_seq([pre, out.sig]), out.taint,
                            binding=wrapped, why=out.why) \
                    if last in ("traced", "run_spmd") else \
                    _Val(pre, binding=wrapped)
        # f()(...) — call on a call result (e.g. djit(f)(x))
        if isinstance(call.func, ast.Call):
            fv = self.eval_call(call.func)
            if fv.binding is not None and fv.binding.kind in (
                    "func", "partial"):
                out = self._call_known(fv.binding, call, arg_vals,
                                       kw_vals)
                return _Val(_seq([fv.sig, pre, out.sig]), out.taint,
                            why=out.why)
            return _Val(_seq([fv.sig, pre]), any_taint or fv.taint)

        binding = None
        if name is not None:
            binding = self.graph.lookup(self.fdef.module, name,
                                        self.fdef.cls, self.env)
        if binding is None:
            binding = self.graph.resolve_call(
                call, self.fdef.module, self.fdef.cls, self.env)
        if binding is None and isinstance(call.func, ast.Name):
            binding = self.env.get(call.func.id)
        if binding is not None and binding.kind == "instance":
            binding = self.graph.method(("class", binding.ref),
                                        "__call__")
        if binding is not None and binding.kind == "class":
            init = self.graph.method(("class", binding.ref), "__init__")
            init_sig = EPS
            if init is not None:
                init_sig = self._call_known(init, call, arg_vals,
                                            kw_vals).sig
            return _Val(_seq([pre, init_sig]),
                        binding=Binding("instance", binding.ref))
        if binding is not None and binding.kind in ("func", "partial"):
            out = self._call_known(binding, call, arg_vals, kw_vals)
            return _Val(_seq([pre, out.sig]), out.taint,
                        why=out.why)
        # unresolved: assume collective-free; taint flows through
        return _Val(pre, any_taint,
                    why=recv_val.why
                    or next((v.why for v in arg_vals if v.why), ""))

    def _call_known(self, binding: Binding, call: ast.Call,
                    arg_vals: list, kw_vals: dict) -> _Val:
        if binding.kind == "partial":
            bound_vals = [self.eval(a) for a in binding.bound_args]
            bound_kw = {k: self.eval(v)
                        for k, v in binding.bound_kwargs}
            key = binding.ref
            pos_vals = bound_vals + arg_vals
            kw_vals = {**bound_kw, **kw_vals}
        else:
            key = binding.ref
            pos_vals = arg_vals
        fdef = self.graph.func(key)
        if fdef is None:
            return _Val()
        params = list(fdef.params)
        if fdef.cls is not None and params and params[0] in ("self",
                                                            "cls"):
            params = params[1:]
        tainted, shape_t, bindings, consts = set(), set(), [], []
        pairs = list(zip(params, pos_vals))
        pairs += [(k, v) for k, v in kw_vals.items()
                  if k is not None and k in fdef.params]
        for pname, v in pairs:
            if v.taint:
                tainted.add(pname)
            if v.shape_taint:
                shape_t.add(pname)
            if v.binding is not None and v.binding.kind in ("func",
                                                           "partial"):
                bindings.append((pname, v.binding))
            if v.const is not _MISSING and isinstance(v.const,
                                                      (str, int, bool)):
                consts.append((pname, v.const))
        caps = frozenset()
        if isinstance(call.func, ast.Name):
            caps = self.nested_caps.get(call.func.id, frozenset())
        ctx = _Ctx(frozenset(tainted) | caps, frozenset(shape_t),
                   tuple(sorted(bindings, key=lambda p: p[0])),
                   tuple(sorted(consts, key=lambda p: str(p[0]))),
                   self.mesh, self.mesh_from)
        summary = self.a.summarize(key, ctx,
                                   self.path_stack + (self.fdef,))
        return _Val(summary.sig, summary.ret_taint,
                    why=f"return value of {fdef.name}()"
                    if summary.ret_taint else "")

    # -- collective events ---------------------------------------------------

    def _const_str(self, v: _Val) -> object:
        return v.const if v.const is not _MISSING else None

    def _arg(self, arg_vals, kw_vals, idx, kw):
        if kw in kw_vals:
            return kw_vals[kw]
        if idx is not None and len(arg_vals) > idx:
            return arg_vals[idx]
        return None

    def _fmt(self, v: _Val | None, default=_MISSING) -> str:
        if v is None:
            return repr(default) if default is not _MISSING else "?"
        c = v.const
        if c is _MISSING:
            return "?"
        return repr(c)

    def _collective_event(self, call, op, arg_vals, kw_vals) -> tuple:
        detail: list[tuple[str, str]] = []
        if op in _EAGER:
            if op == "barrier":
                detail = [("tag", self._fmt(
                    self._arg(arg_vals, kw_vals, 0, "tag"),
                    default=None))]
            else:
                detail = [("root", self._fmt(
                    self._arg(arg_vals, kw_vals, 1, "root"))),
                    ("tag", self._fmt(
                        self._arg(arg_vals, kw_vals, 2, "tag"),
                        default=None))]
            if op == "gather_spmd":
                payload = self._arg(arg_vals, kw_vals, 0, "x")
                if payload is not None and payload.shape_taint:
                    why = payload.why or "rank-dependent array ctor"
                    self._emit(call, "DAL010",
                               f"static SPMD divergence: gather_spmd "
                               f"payload has a rank-tainted shape "
                               f"({why}) — per-rank payload "
                               f"signatures (shape:dtype) will "
                               f"differ, the exact mismatch the "
                               f"runtime checker compares"
                               f"\n  call path: {self.path_str}"
                               f"\n  {_CLOSING}")
        elif op in _TRACED:
            ax = self._axis_of(call)
            detail = [("axis", repr(ax) if ax not in (None, "?")
                       else "?")]
        sig = ("ev", op, tuple(detail))
        return sig

    def _axis_of(self, call: ast.Call) -> str | None:
        from . import rules as _rules
        lits = _rules._call_axis_literals(call)
        if lits:
            return lits[0]
        # const-resolved local/parameter names
        for a in list(call.args[:2]) + [k.value for k in call.keywords
                                        if k.arg in ("axis", "axes",
                                                     "axis_name")]:
            if isinstance(a, ast.Name):
                c = self.consts.get(a.id)
                if isinstance(c, str):
                    return c
        return "?"

    def _check_axis(self, call: ast.Call, op: str) -> None:
        if self.own_mesh or self.mesh is None:
            return   # DAL004's domain / no statically-known context
        axes, allow_dn = self.mesh
        ax = self._axis_of(call)
        if ax in (None, "?"):
            return
        if ax in axes or (allow_dn and _DN_AXIS.match(ax)):
            return
        self._emit(call, "DAL011",
                   f"collective axis {ax!r} is not bound by the mesh "
                   f"context reaching this call (axes bound at "
                   f"{self.mesh_from or 'caller'}: {sorted(axes)}; "
                   f"call path: {self.path_str}); a mismatched axis "
                   f"name only fails at trace time inside shard_map")


def _last(name: str | None) -> str | None:
    return None if name is None else name.rsplit(".", 1)[-1]


def _make_mesh_axes(call: ast.Call) -> tuple[set, bool]:
    """Axis names bound by ``jax.make_mesh(shape, axis_names)``."""
    cands = list(call.args[1:2]) + [k.value for k in call.keywords
                                    if k.arg == "axis_names"]
    for c in cands:
        if isinstance(c, (ast.Tuple, ast.List)) and all(
                isinstance(e, ast.Constant) and isinstance(e.value, str)
                for e in c.elts):
            return {e.value for e in c.elts}, True
        if isinstance(c, ast.Constant) and isinstance(c.value, str):
            return {c.value}, True
    return set(), False


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def analyze_sources(sources: Iterable[tuple[str, str]]) -> EffectReport:
    """Cross-file effect analysis over ``(path, source)`` pairs.
    Findings honor per-line and file-level dalint suppressions."""
    sources = list(sources)
    graph = CallGraph(sources)
    ana = _Analysis(graph)
    ana.run()
    supp = {path: parse_suppressions(src.splitlines())
            for path, src in sources}
    sev = {"DAL010": "error", "DAL011": "error", "DAL012": "error"}
    findings = []
    for (path, line, col, code), msg in ana.findings.items():
        per_line, whole = supp.get(path, ({}, set()))
        suppressed = code in whole or code in per_line.get(line, set())
        findings.append(Finding(path, line, col, code, sev[code], msg,
                                suppressed))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return EffectReport(findings, len(graph.funcs), len(ana.memo),
                        ana.truncated)


def analyze_paths(paths: Iterable[str | Path]) -> EffectReport:
    from .engine import iter_python_files
    sources = []
    for f in iter_python_files(paths):
        try:
            sources.append((str(f), Path(f).read_text()))
        except (OSError, UnicodeDecodeError):
            continue
    return analyze_sources(sources)


_CACHE: dict = {}


def findings_for_source(src: str, path: str) -> list[Finding]:
    """Single-file adapter for the rule catalog (DAL010/011/012 with
    taint that closes within the file; ``verify-spmd`` covers the
    cross-file flows).  Cached per (path, source) — the engine asks
    once per rule code."""
    key = (path, hash(src))
    if _CACHE.get("key") != key:
        _CACHE.clear()
        _CACHE["key"] = key
        _CACHE["findings"] = analyze_sources([(path, src)]).findings
    return _CACHE["findings"]


def signature_for(target: str,
                  paths: Iterable[str | Path] | None = None) -> str:
    """Render the effect signature of ``module:function`` (or
    ``path/to/file.py:function``, ``module:Class.method``) analyzed
    over ``paths`` (default: the verify-spmd surface)."""
    if ":" not in target:
        raise ValueError(
            f"target {target!r} must look like module:function")
    mod_part, fn_part = target.rsplit(":", 1)
    scan_paths = list(paths) if paths else \
        [p for p in DEFAULT_EFFECT_TARGETS if Path(p).exists()]
    if mod_part.endswith(".py") and Path(mod_part).exists():
        scan_paths.append(mod_part)
    from .engine import iter_python_files
    sources = []
    for f in iter_python_files(scan_paths):
        try:
            sources.append((str(f), Path(f).read_text()))
        except (OSError, UnicodeDecodeError):
            continue
    graph = CallGraph(sources)
    cls, fn = (fn_part.split(".", 1) + [None])[:2] \
        if "." in fn_part else (None, fn_part)
    if fn is None:
        cls, fn = None, fn_part
    want_mod = (module_name_for(mod_part) if mod_part.endswith(".py")
                else mod_part)
    key = None
    for k in graph.funcs:
        mod, kcls, name = k
        if name != fn or kcls != cls:
            continue
        if mod == want_mod or mod.endswith("." + want_mod) \
                or want_mod.endswith("." + mod) or mod == want_mod:
            key = k
            break
    if key is None:
        raise ValueError(f"no function {fn_part!r} found in module "
                         f"{want_mod!r} over {len(graph.funcs)} "
                         f"analyzed functions")
    ana = _Analysis(graph)
    summary = ana.summarize(key, _Ctx(), ())
    fdef = graph.func(key)
    lines = [f"{fdef.qname}  ({fdef.path}:{fdef.node.lineno})",
             f"  signature : {render(summary.sig)}",
             f"  returns-rank-taint: "
             f"{'yes' if summary.ret_taint else 'no'}"]
    return "\n".join(lines)
