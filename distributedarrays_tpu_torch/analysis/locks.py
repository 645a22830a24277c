"""Interprocedural lock-order and blocking-under-lock analysis.

The port's copy of ``distributedarrays_tpu/analysis/locks.py``, over the
port's sources (its cross-file sweep covers the whole
``distributedarrays_tpu_torch`` package).  Lock deadlocks sink a serving
stack *silently*: the process doesn't crash, it just stops.  This module
makes that class statically visible:

- **DAL008 (blocking-under-lock)**: a call that can block on another
  thread or on wall-clock time — queue put/get, ``Event.wait``,
  ``Condition.wait`` (when *other* locks are held; waiting releases
  only its own), thread ``join``, ``time.sleep``/backoff sleeps, eager
  SPMD receives (``recvfrom``/``barrier``/``gather_spmd``), a job's
  store barrier and all-gathers (``sync_hosts``, ``_all_gather_json``,
  ``_all_gather_objects``, ``fetch_regions``, ``cell_values``),
  subprocess waits — made while holding a lock.  Every thread that touches that
  lock now waits on whatever the blocker waits on.
- **DAL009 (lock-order cycle)**: the acquisition graph (lock A held
  while lock B is acquired ⇒ edge A→B, including acquisitions made by
  transitively-called functions) contains a cycle — the classic ABBA
  deadlock — or a non-reentrant ``threading.Lock`` is re-acquired
  while already held (the SIGTERM self-deadlock shape).

The analysis is interprocedural over whatever file set it is given:
each function gets a summary (locks acquired, blocking calls, calls
made, each with the lock-set held at that point); summaries propagate
through the resolvable call graph (``self.method``, module-level
names, ``module.attr``) to a fixpoint, so ``submit()`` holding the
server lock and calling a helper whose helper sleeps is still one
finding, anchored at ``submit``'s call site with the witness chain in
the message.

Lock identity is name-based: ``self.X`` assigned a
``threading.Lock/RLock/Condition/Semaphore`` in class ``C`` is
``C.X``; module-level ``N = threading.Lock()`` is ``module.N``.  Two
keys are assumed distinct locks unless equal — the same convention the
protocol checker uses for buffer regions.  Like every dalint rule the
analysis is conservative: an acquisition through an unresolvable
receiver is ignored rather than guessed, and intentional findings
carry ``# dalint: disable=DAL008`` / ``DAL009`` with a justification.

Used two ways: per-file through the dalint rule catalog (cycles must
then close within the file), and cross-file through ``python -m
distributedarrays_tpu_torch.analysis locks`` (the CI sweep), which analyzes
the whole package together and prints the acquisition graph alongside the
findings.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Iterable

from .engine import Finding, parse_suppressions

__all__ = ["analyze_paths", "analyze_sources", "findings_for_source",
           "LockReport", "DEFAULT_LOCK_TARGETS", "format_graph"]

# the sweep surface the CLI verb defaults to
DEFAULT_LOCK_TARGETS = ("distributedarrays_tpu_torch",)

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}
# ctors whose acquire may be re-entered by the owning thread
_REENTRANT = {"RLock", "Condition"}

# receivers whose .get/.put block on capacity/emptiness
_QUEUEISH = ("queue", "mailbox", "inbox", "mbox", "fifo")


def _dotted(node) -> str | None:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


# ---------------------------------------------------------------------------
# per-function facts
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Site:
    line: int
    col: int


@dataclasses.dataclass
class _Acq(_Site):
    lock: tuple
    held: tuple


@dataclasses.dataclass
class _Blk(_Site):
    desc: str
    held: tuple


@dataclasses.dataclass
class _CallOut(_Site):
    callee: tuple          # unresolved reference, see _resolve_callee
    held: tuple


@dataclasses.dataclass
class _Func:
    qname: tuple           # (module, cls|None, name)
    path: str
    acquires: list = dataclasses.field(default_factory=list)
    blocking: list = dataclasses.field(default_factory=list)
    calls: list = dataclasses.field(default_factory=list)
    # fixpoint results
    eff_locks: set = dataclasses.field(default_factory=set)
    eff_block: dict = dataclasses.field(default_factory=dict)


def _module_name(path: str) -> str:
    p = Path(path)
    parts = [q for q in p.with_suffix("").parts if q not in (".", "")]
    return ".".join(parts[-2:]) if len(parts) >= 2 else ".".join(parts)


class _FileScan(ast.NodeVisitor):
    """One file: lock definitions + per-function summaries."""

    def __init__(self, tree: ast.Module, path: str):
        self.path = path
        self.module = _module_name(path)
        self.lock_kinds: dict[tuple, str] = {}   # lock id -> ctor name
        self.lock_lines: dict[tuple, int] = {}
        self.funcs: dict[tuple, _Func] = {}
        self._cls: str | None = None
        self._collect_locks(tree)
        self._walk_module(tree)

    # -- lock definitions ---------------------------------------------------

    def _lock_ctor(self, node) -> str | None:
        if isinstance(node, ast.Call):
            name = _dotted(node.func)
            if name:
                last = name.rsplit(".", 1)[-1]
                if last in _LOCK_CTORS:
                    return last
        return None

    def _collect_locks(self, tree):
        for node in ast.walk(tree):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            kind = self._lock_ctor(node.value)
            if kind is None:
                continue
            tgt = node.targets[0]
            lid = None
            if isinstance(tgt, ast.Name):
                lid = ("mod", self.module, tgt.id)
            elif (isinstance(tgt, ast.Attribute)
                  and isinstance(tgt.value, ast.Name)
                  and tgt.value.id == "self"):
                cls = self._enclosing_class(tree, node)
                if cls:
                    lid = ("cls", cls, tgt.attr)
            if lid is not None:
                self.lock_kinds[lid] = kind
                self.lock_lines.setdefault(lid, node.lineno)

    @staticmethod
    def _enclosing_class(tree, node) -> str | None:
        for cls in ast.walk(tree):
            if isinstance(cls, ast.ClassDef):
                for sub in ast.walk(cls):
                    if sub is node:
                        return cls.name
        return None

    # -- function discovery -------------------------------------------------

    def _walk_module(self, tree):
        for node in tree.body:
            self._walk_stmt_for_defs(node, None)

    def _walk_stmt_for_defs(self, node, cls):
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                self._walk_stmt_for_defs(sub, node.name)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            qname = (self.module, cls, node.name)
            fn = _Func(qname, self.path)
            self.funcs[qname] = fn
            self._scan_block(node.body, fn, cls, ())
            # nested defs are their own (rarely-called) scopes; their
            # bodies do NOT run under the enclosing lock
            for sub in ast.walk(node):
                if (isinstance(sub, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))
                        and sub is not node):
                    q2 = (self.module, cls, f"{node.name}.{sub.name}")
                    f2 = self.funcs[q2] = _Func(q2, self.path)
                    self._scan_block(sub.body, f2, cls, ())
        elif isinstance(node, (ast.If, ast.Try)):
            for field in ("body", "orelse", "finalbody"):
                for sub in getattr(node, field, []):
                    self._walk_stmt_for_defs(sub, cls)

    # -- lock-reference resolution ------------------------------------------

    def _lock_ref(self, node, cls) -> tuple | None:
        """Resolve an expression to a lock id, or None."""
        name = _dotted(node)
        if name is None:
            return None
        parts = name.split(".")
        if parts[0] == "self" and len(parts) == 2 and cls:
            lid = ("cls", cls, parts[1])
            if lid in self.lock_kinds or _looks_lockish(parts[1]):
                return lid
            return None
        if len(parts) == 1:
            lid = ("mod", self.module, parts[0])
            if lid in self.lock_kinds:
                return lid
            if _looks_lockish(parts[0]):
                return lid
            return None
        # module.attr — keyed by the referenced module's basename so
        # tracing.py's ``core._LOCK`` meets core.py's definition
        lid = ("modref", parts[-2], parts[-1])
        if _looks_lockish(parts[-1]):
            return lid
        return None

    # -- statement scanning --------------------------------------------------

    def _scan_block(self, stmts, fn, cls, held):
        held = tuple(held)
        for st in stmts:
            held = self._scan_stmt(st, fn, cls, held)

    def _scan_stmt(self, st, fn, cls, held) -> tuple:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return held
        if isinstance(st, (ast.With, ast.AsyncWith)):
            new = held
            for item in st.items:
                lid = self._lock_ref(item.context_expr, cls)
                if lid is not None:
                    fn.acquires.append(_Acq(item.context_expr.lineno,
                                            item.context_expr.col_offset,
                                            lid, new))
                    new = new + (lid,)
                else:
                    self._scan_expr(item.context_expr, fn, cls, held)
            self._scan_block(st.body, fn, cls, new)
            return held
        if isinstance(st, ast.Expr) and isinstance(st.value, ast.Call):
            call = st.value
            name = _dotted(call.func)
            if name and name.endswith(".acquire"):
                lid = self._lock_ref(call.func.value, cls)
                if lid is not None:
                    # blocking=False acquires don't block and don't
                    # establish an order edge worth reporting
                    nonblock = any(
                        k.arg in ("blocking", "block")
                        and isinstance(k.value, ast.Constant)
                        and k.value.value is False
                        for k in call.keywords)
                    if not nonblock:
                        fn.acquires.append(_Acq(call.lineno,
                                                call.col_offset,
                                                lid, held))
                        return held + (lid,)
                    return held
            if name and name.endswith(".release"):
                lid = self._lock_ref(call.func.value, cls)
                if lid is not None and lid in held:
                    out = list(held)
                    out.reverse()
                    out.remove(lid)
                    out.reverse()
                    return tuple(out)
        for field, value in ast.iter_fields(st):
            if isinstance(value, list):
                if value and isinstance(value[0], ast.stmt):
                    # compound bodies share the enclosing held set;
                    # .acquire() effects stay local to their block
                    self._scan_block(value, fn, cls, held)
                else:
                    for v in value:
                        if isinstance(v, ast.expr):
                            self._scan_expr(v, fn, cls, held)
            elif isinstance(value, ast.expr):
                self._scan_expr(value, fn, cls, held)
        return held

    def _scan_expr(self, node, fn, cls, held):
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            desc = self._blocking_desc(sub, cls, held)
            if desc is not None:
                eff = desc[1]
                fn.blocking.append(_Blk(sub.lineno, sub.col_offset,
                                        desc[0], eff))
                continue
            ref = self._callee_ref(sub, cls)
            if ref is not None:
                fn.calls.append(_CallOut(sub.lineno, sub.col_offset,
                                         ref, held))

    # -- blocking-call classification ---------------------------------------

    def _blocking_desc(self, call, cls, held):
        """``(description, effective_held)`` when ``call`` can block,
        else None.  ``Condition.wait`` releases its own lock while
        waiting, so the condition itself is subtracted from the held
        set — blocking only counts against *other* locks."""
        name = _dotted(call.func)
        if name is None:
            return None
        last = name.rsplit(".", 1)[-1]
        if name in ("time.sleep", "sleep") or last.endswith("_sleep"):
            return (f"{last}()", held)
        if last in ("wait", "wait_for"):
            recv = call.func.value if isinstance(call.func,
                                                 ast.Attribute) else None
            lid = self._lock_ref(recv, cls) if recv is not None else None
            eff = tuple(h for h in held if h != lid)
            return (f"{name}()", eff)
        if last == "join":
            if self._joins_thread(call):
                return (f"{name}()", held)
            return None
        if last in ("get", "put"):
            if self._queueish(call, last):
                return (f"{name}()", held)
            return None
        if last == "result" and isinstance(call.func, ast.Attribute):
            rname = _dotted(call.func.value) or ""
            if "fut" in rname.lower() or "promise" in rname.lower():
                return (f"{name}()", held)
            return None
        if last in ("recvfrom", "barrier", "gather_spmd", "communicate",
                    "check_output", "check_call", "sync_hosts",
                    "_all_gather_json", "_all_gather_objects",
                    "all_gather_object", "fetch_regions", "cell_values") \
                or name == "subprocess.run":
            return (f"{name}()", held)
        return None

    @staticmethod
    def _joins_thread(call):
        # ``" | ".join(parts)`` is string glue; ``t.join()`` /
        # ``t.join(timeout_expr)`` parks the calling thread
        if isinstance(call.func, ast.Attribute) and \
                isinstance(call.func.value, ast.Constant):
            return False
        if call.keywords:
            return any(k.arg == "timeout" for k in call.keywords)
        if not call.args:
            return True
        if len(call.args) != 1:
            return False
        arg = call.args[0]
        if isinstance(arg, ast.Constant):
            return isinstance(arg.value, (int, float))
        names = {n.id for n in ast.walk(arg) if isinstance(n, ast.Name)}
        names |= {n.attr for n in ast.walk(arg)
                  if isinstance(n, ast.Attribute)}
        hints = {"timeout", "deadline", "remaining", "budget", "grace"}
        return bool(names & hints) or any(
            isinstance(n, ast.Call) and _dotted(n.func) in ("max", "min")
            for n in ast.walk(arg))

    @staticmethod
    def _queueish(call, last):
        if any(k.arg in ("timeout", "block") for k in call.keywords):
            return True
        if not isinstance(call.func, ast.Attribute):
            return False
        recv = call.func.value
        rname = _dotted(recv)
        if rname is not None:
            seg = rname.rsplit(".", 1)[-1].lower()
            return seg in ("q", "mb") or any(h in seg for h in _QUEUEISH)
        if isinstance(recv, ast.Call):
            inner = _dotted(recv.func) or ""
            return any(h in inner.rsplit(".", 1)[-1].lower()
                       for h in _QUEUEISH)
        return False

    # -- call-graph references ----------------------------------------------

    def _callee_ref(self, call, cls):
        name = _dotted(call.func)
        if name is None:
            return None
        parts = name.split(".")
        if parts[0] == "self" and len(parts) == 2 and cls:
            return ("method", cls, parts[1])
        if len(parts) == 1:
            return ("func", self.module, parts[0])
        if len(parts) == 2 and parts[0] != "self":
            return ("modfunc", parts[0], parts[1])
        return None


def _looks_lockish(attr: str) -> bool:
    a = attr.lower()
    return ("lock" in a or a.endswith("_lk") or "_cv" in a
            or a.endswith("cond") or a.startswith("cond")
            or a.endswith("_sem"))


# ---------------------------------------------------------------------------
# interprocedural propagation + findings
# ---------------------------------------------------------------------------


def _fmt_lock(lid: tuple) -> str:
    _kind, owner, attr = lid
    return f"{owner}.{attr}"


@dataclasses.dataclass
class LockReport:
    """Cross-file analysis result.  ``findings`` carry DAL008/DAL009
    codes and already honor per-line/file suppressions; ``edges`` is
    the acquisition graph ``{(A, B): [(path, line), ...]}``."""

    findings: list
    edges: dict
    lock_kinds: dict
    funcs: int


def _resolve(scans: list[_FileScan]):
    """Match call references to analyzed functions; unify modref lock
    ids against known module-level definitions."""
    by_method: dict = {}
    by_modfunc: dict = {}
    mod_locks: dict = {}
    for sc in scans:
        for q in sc.funcs:
            mod, cls, name = q
            if cls and "." not in name:
                by_method.setdefault((cls, name), q)
            if not cls:
                by_modfunc.setdefault((mod.rsplit(".", 1)[-1], name), q)
        for lid in sc.lock_kinds:
            if lid[0] == "mod":
                mod_locks.setdefault((lid[1].rsplit(".", 1)[-1],
                                      lid[2]), lid)

    def canon_lock(lid):
        if lid[0] == "modref":
            return mod_locks.get((lid[1], lid[2]), lid)
        return lid

    def callee(ref):
        kind, a, b = ref
        if kind == "method":
            return by_method.get((a, b))
        if kind == "func":
            return by_modfunc.get((a.rsplit(".", 1)[-1], b))
        return by_modfunc.get((a, b))

    return canon_lock, callee


def analyze_sources(sources: Iterable[tuple[str, str]]) -> LockReport:
    """Analyze ``(path, source)`` pairs together (interprocedural
    within the set).  Unparsable files are skipped — the lint engine
    already reports DAL000 for them."""
    scans = []
    supp = {}
    for path, src in sources:
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError:
            continue
        scans.append(_FileScan(tree, path))
        supp[path] = parse_suppressions(src.splitlines())
    canon_lock, resolve_callee = _resolve(scans)
    lock_kinds = {}
    funcs: dict[tuple, _Func] = {}
    for sc in scans:
        funcs.update(sc.funcs)
        for lid, kind in sc.lock_kinds.items():
            lock_kinds[canon_lock(lid)] = kind

    # fixpoint: which locks / blocking calls does each function reach?
    for fn in funcs.values():
        fn.eff_locks = {canon_lock(a.lock) for a in fn.acquires}
        fn.eff_block = {b.desc: b.desc for b in fn.blocking}
    changed = True
    while changed:
        changed = False
        for fn in funcs.values():
            for c in fn.calls:
                target = resolve_callee(c.callee)
                if target is None or target not in funcs:
                    continue
                tgt = funcs[target]
                new_locks = tgt.eff_locks - fn.eff_locks
                if new_locks:
                    fn.eff_locks |= new_locks
                    changed = True
                for desc, via in tgt.eff_block.items():
                    label = f"{target[2]}() → {via}"
                    if desc not in fn.eff_block:
                        fn.eff_block[desc] = label
                        changed = True

    findings: list[Finding] = []
    edges: dict = {}

    def emit(path, line, col, code, msg):
        per_line, whole = supp.get(path, ({}, set()))
        suppressed = code in whole or code in per_line.get(line, set())
        findings.append(Finding(path, line, col, code, "warning", msg,
                                suppressed))

    # DAL008 + order edges
    for fn in funcs.values():
        for b in fn.blocking:
            held = tuple(canon_lock(h) for h in b.held)
            if held:
                emit(fn.path, b.line, b.col, "DAL008",
                     f"{b.desc} blocks while holding "
                     f"{', '.join(_fmt_lock(h) for h in held)} — every "
                     f"thread contending that lock now waits on this "
                     f"call's condition too; move the blocking call "
                     f"outside the locked section")
        for a in fn.acquires:
            lock = canon_lock(a.lock)
            for h in a.held:
                ch = canon_lock(h)
                if ch == lock:
                    kind = lock_kinds.get(lock)
                    if kind is not None and kind not in _REENTRANT:
                        emit(fn.path, a.line, a.col, "DAL009",
                             f"non-reentrant threading.{kind} "
                             f"{_fmt_lock(lock)} re-acquired while "
                             f"already held — self-deadlock (use an "
                             f"RLock or restructure)")
                    continue
                edges.setdefault((ch, lock), []).append(
                    (fn.path, a.line))
        for c in fn.calls:
            if not c.held:
                continue
            target = resolve_callee(c.callee)
            if target is None or target not in funcs:
                continue
            tgt = funcs[target]
            held = tuple(canon_lock(h) for h in c.held)
            if tgt.eff_block:
                via = next(iter(tgt.eff_block.values()))
                emit(fn.path, c.line, c.col, "DAL008",
                     f"call to {target[2]}() may block (via {via}) "
                     f"while holding "
                     f"{', '.join(_fmt_lock(h) for h in held)}")
            for lock in tgt.eff_locks:
                for h in held:
                    if h == lock:
                        # interprocedural self-reacquisition: a callee
                        # (transitively) re-takes the non-reentrant lock
                        # this site already holds — the SIGTERM-handler
                        # self-deadlock shape, one call deep
                        kind = lock_kinds.get(lock)
                        if kind is not None and kind not in _REENTRANT:
                            emit(fn.path, c.line, c.col, "DAL009",
                                 f"call to {target[2]}() re-acquires "
                                 f"non-reentrant threading.{kind} "
                                 f"{_fmt_lock(lock)} already held at "
                                 f"this site — self-deadlock (use an "
                                 f"RLock or restructure)")
                        continue
                    edges.setdefault((h, lock), []).append(
                        (fn.path, c.line))

    # DAL009: cycles in the acquisition graph
    adj: dict = {}
    for (a, b) in edges:
        adj.setdefault(a, set()).add(b)
    for cyc in _cycles(adj):
        pairs = list(zip(cyc, cyc[1:] + cyc[:1]))
        desc = " → ".join(_fmt_lock(x) for x in cyc + [cyc[0]])
        for pair in pairs:
            for path, line in edges.get(pair, [])[:1]:
                emit(path, line, 0, "DAL009",
                     f"lock-order cycle {desc}: this site acquires "
                     f"{_fmt_lock(pair[1])} while holding "
                     f"{_fmt_lock(pair[0])}, and the reverse order "
                     f"also occurs — two threads interleaving these "
                     f"acquisitions deadlock (establish one global "
                     f"order or narrow one critical section)")

    findings.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return LockReport(findings, edges, lock_kinds, len(funcs))


def _cycles(adj: dict) -> list[list]:
    """Elementary cycles, canonicalized (smallest node first) and
    de-duplicated — DFS over the lock graph, which is tiny."""
    out, seen = [], set()

    def dfs(start, node, path, onpath):
        for nxt in sorted(adj.get(node, ())):
            if nxt == start:
                cyc = path[:]
                i = cyc.index(min(cyc))
                canon = tuple(cyc[i:] + cyc[:i])
                if canon not in seen:
                    seen.add(canon)
                    out.append(list(canon))
            elif nxt not in onpath and nxt > start:
                dfs(start, nxt, path + [nxt], onpath | {nxt})

    for start in sorted(adj):
        dfs(start, start, [start], {start})
    return out


def analyze_paths(paths: Iterable[str | Path]) -> LockReport:
    from .engine import iter_python_files
    sources = []
    for f in iter_python_files(paths):
        try:
            sources.append((str(f), Path(f).read_text()))
        except (OSError, UnicodeDecodeError):
            continue
    return analyze_sources(sources)


def format_graph(report: LockReport) -> str:
    """The acquisition graph, one ``A → B`` edge per line with sites."""
    lines = [f"{len(report.lock_kinds)} known lock(s), "
             f"{report.funcs} function summaries, "
             f"{len(report.edges)} order edge(s)"]
    for (a, b), sites in sorted(report.edges.items()):
        where = ", ".join(f"{Path(p).name}:{ln}" for p, ln in sites[:3])
        more = f" (+{len(sites) - 3} more)" if len(sites) > 3 else ""
        lines.append(f"  {_fmt_lock(a)} → {_fmt_lock(b)}   [{where}{more}]")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# per-file rule adapter (DAL008/DAL009 in the dalint catalog)
# ---------------------------------------------------------------------------

_CACHE: dict = {}


def findings_for_source(src: str, path: str) -> list[Finding]:
    """Single-file analysis for the rule catalog (cycles must close
    within the file; the ``locks`` CLI verb covers cross-file).
    Cached per (path, source) — the engine asks once per rule code."""
    key = (path, hash(src))
    if _CACHE.get("key") != key:
        _CACHE.clear()
        _CACHE["key"] = key
        _CACHE["findings"] = analyze_sources([(path, src)]).findings
    return _CACHE["findings"]
