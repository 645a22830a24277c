"""Package-wide AST call graph for the interprocedural analyses.

The port's copy of ``distributedarrays_tpu/analysis/callgraph.py``; its
module names root at ``distributedarrays_tpu_torch`` (and the JAX
package's, for the parity tests).

``analysis/locks.py`` resolves calls with three ad-hoc patterns
(``self.method``, bare module function, ``module.attr``); the SPMD
effect inference (``analysis/effects.py``) needs the full contract
surface — rank taint and collective effects flow through helpers,
stored closures and ``functools.partial`` objects, exactly the shapes
invisible to the single-function DAL001/DAL004 checks.  This module
builds one resolvable call graph over an arbitrary ``(path, source)``
file set:

- **module naming** — dotted names derived from the file path
  (``distributedarrays_tpu_torch/ops/mapreduce.py`` →
  ``distributedarrays_tpu_torch.ops.mapreduce``); import targets resolve by
  dotted-suffix match so absolute paths, test trees and single files
  all work.
- **imports** — ``import m [as a]``, ``from m import f [as g]`` and
  relative ``from .m import f`` all produce bindings; a ``from``-import
  of a submodule binds the module, of a function binds the function.
- **methods** — ``self.m()`` resolves by the enclosing class;
  ``x.m()`` resolves through receiver-type tracking (``x = C(...)``
  locally or at module level) with a unique-definition fallback (a
  method name defined by exactly one class in the graph).
- **aliases and partials** — ``g = f``, ``g = functools.partial(f,
  a)``, and wrapper constructions whose semantics are call-through
  (``djit(f)``, ``lru_cache()(f)``, ``run_spmd(f, ...)``,
  ``traced(f)``) unwrap to the underlying function; partial bindings carry
  their bound argument expressions so callers can propagate taint.
- **closures** — nested ``def``s register as ``outer.inner`` and the
  graph records their free variables, so an effect/taint analysis can
  seed captured state when the closure is invoked or passed along.

Resolution is deliberately conservative: an unresolvable callee is
``None``, never a guess — the analyses built on top treat unknown
calls as effect-free, the same "prove it or stay silent" discipline as
the rest of dalint.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Iterable

__all__ = ["CallGraph", "FuncDef", "Binding", "module_name_for",
           "dotted_name", "graph_for_paths"]

FuncKey = tuple  # (module, cls | None, name) — name may be "outer.inner"


def dotted_name(node: ast.expr) -> str | None:
    """``a.b.c`` for a pure Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def module_name_for(path: str) -> str:
    """Dotted module name from a file path, rooted at the innermost
    recognizable package anchor so repo-relative and absolute paths
    agree (``/tmp/x/distributedarrays_tpu_torch/core.py`` and
    ``distributedarrays_tpu_torch/core.py`` both → the package name)."""
    p = Path(path)
    parts = list(p.with_suffix("").parts)
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    for anchor in ("distributedarrays_tpu_torch", "distributedarrays_tpu",
                   "examples", "tests", "tools"):
        if anchor in parts:
            parts = parts[parts.index(anchor):]
            break
    else:
        parts = parts[-1:]
    return ".".join(q for q in parts if q not in (".", "", "/"))


# ---------------------------------------------------------------------------
# bindings — what a name in a scope refers to
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Binding:
    """A resolved meaning for a name.

    ``kind`` ∈ {"func", "class", "module", "instance", "partial"}:

    - ``func``: ``ref`` is a :class:`FuncDef` key.
    - ``class``: ``ref`` is ``(module, clsname)``.
    - ``module``: ``ref`` is the dotted module name (graph-resolved).
    - ``instance``: ``ref`` is the class key the value was constructed
      from (receiver-type tracking for method resolution).
    - ``partial``: ``ref`` is the underlying func key; ``bound_args`` /
      ``bound_kwargs`` carry the frozen argument AST nodes.
    """

    kind: str
    ref: tuple | str
    bound_args: tuple = ()
    bound_kwargs: tuple = ()   # ((name, ast.expr), ...)


# wrappers whose call-through semantics preserve the wrapped function's
# collective effects: calling the result calls the argument
_CALL_THROUGH = {"partial", "jit", "djit", "lru_cache", "cache", "wraps",
                 "shard_map", "traced", "run_spmd"}


@dataclasses.dataclass
class FuncDef:
    """One analyzed function (module-level, method, or nested def)."""

    key: FuncKey
    path: str
    node: ast.AST                     # FunctionDef | AsyncFunctionDef
    params: tuple = ()
    freevars: tuple = ()              # names read but never bound locally
    decorators: tuple = ()            # dotted decorator names (last seg)

    @property
    def module(self) -> str:
        return self.key[0]

    @property
    def cls(self) -> str | None:
        return self.key[1]

    @property
    def name(self) -> str:
        return self.key[2]

    @property
    def qname(self) -> str:
        mod, cls, name = self.key
        return f"{mod}.{cls}.{name}" if cls else f"{mod}.{name}"


def _params_of(node) -> tuple:
    a = node.args
    names = [p.arg for p in a.posonlyargs + a.args]
    # kwonly/vararg/kwarg params participate in taint tracking but not
    # positional argument mapping; keep them after the positional block
    names += [p.arg for p in a.kwonlyargs]
    for extra in (a.vararg, a.kwarg):
        if extra is not None:
            names.append(extra.arg)
    return tuple(names)


def _bound_names(node) -> set[str]:
    """Names bound anywhere inside a function body (assignments, loop
    targets, with-as, imports, nested defs) — the complement of its
    free variables."""
    bound = set(_params_of(node))
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and isinstance(sub.ctx,
                                                    (ast.Store, ast.Del)):
            bound.add(sub.id)
        elif isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and sub is not node:
            bound.add(sub.name)
        elif isinstance(sub, (ast.Import, ast.ImportFrom)):
            for al in sub.names:
                bound.add((al.asname or al.name).split(".", 1)[0])
        elif isinstance(sub, ast.ExceptHandler) and sub.name:
            bound.add(sub.name)
    return bound


def _freevars_of(node) -> tuple:
    bound = _bound_names(node)
    free = []
    for sub in ast.walk(node):
        if (isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load)
                and sub.id not in bound and sub.id not in free):
            free.append(sub.id)
    return tuple(free)


# ---------------------------------------------------------------------------
# per-module scan
# ---------------------------------------------------------------------------


class _ModuleScan:
    def __init__(self, tree: ast.Module, path: str, module: str):
        self.path = path
        self.module = module
        self.tree = tree
        self.funcs: dict[str, FuncKey] = {}        # local name -> key
        self.classes: dict[str, dict[str, FuncKey]] = {}
        self.imports: dict[str, str] = {}          # alias -> dotted module
        self.from_imports: dict[str, tuple[str, str]] = {}  # name->(mod,orig)
        self.assign_values: dict[str, ast.expr] = {}  # module-level x = expr
        self.all_funcs: dict[FuncKey, FuncDef] = {}
        self._scan(tree)

    def _register(self, node, cls: str | None, prefix: str = "") -> FuncKey:
        name = f"{prefix}{node.name}"
        key: FuncKey = (self.module, cls, name)
        self.all_funcs[key] = FuncDef(
            key, self.path, node, _params_of(node), _freevars_of(node),
            tuple(filter(None, ((dotted_name(d) or "").rsplit(".", 1)[-1]
                                for d in node.decorator_list))))
        # nested defs: registered as outer.inner so closures resolve
        for sub in ast.iter_child_nodes(node):
            self._scan_stmt_nested(sub, cls, f"{name}.")
        return key

    def _scan_stmt_nested(self, node, cls, prefix):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._register(node, cls, prefix)
        elif not isinstance(node, (ast.ClassDef, ast.Lambda)):
            for sub in ast.iter_child_nodes(node):
                self._scan_stmt_nested(sub, cls, prefix)

    def _scan(self, tree):
        for node in self._top_stmts(tree.body):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.funcs[node.name] = self._register(node, None)
            elif isinstance(node, ast.ClassDef):
                methods: dict[str, FuncKey] = {}
                for sub in self._top_stmts(node.body):
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        methods[sub.name] = self._register(sub, node.name)
                self.classes[node.name] = methods
            elif isinstance(node, ast.Import):
                for al in node.names:
                    self.imports[al.asname or al.name.split(".", 1)[0]] = \
                        al.name
            elif isinstance(node, ast.ImportFrom):
                base = self._resolve_relative(node)
                for al in node.names:
                    if al.name != "*":
                        self.from_imports[al.asname or al.name] = \
                            (base, al.name)
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                self.assign_values[node.targets[0].id] = node.value

    @staticmethod
    def _top_stmts(stmts):
        """Top-level statements, descending through if/try guards (the
        TYPE_CHECKING / optional-dependency import idioms)."""
        for st in stmts:
            yield st
            if isinstance(st, (ast.If, ast.Try)):
                for field in ("body", "orelse", "finalbody"):
                    yield from _ModuleScan._top_stmts(
                        getattr(st, field, []))

    def _resolve_relative(self, node: ast.ImportFrom) -> str:
        if not node.level:
            return node.module or ""
        parts = self.module.split(".")
        # level 1 = current package (drop the module's own leaf name)
        parts = parts[:len(parts) - node.level]
        if node.module:
            parts += node.module.split(".")
        return ".".join(parts)


# ---------------------------------------------------------------------------
# the graph
# ---------------------------------------------------------------------------


class CallGraph:
    """Call graph over a set of ``(path, source)`` pairs.  Unparsable
    files are skipped (the lint engine reports DAL000 separately)."""

    def __init__(self, sources: Iterable[tuple[str, str]]):
        self.scans: dict[str, _ModuleScan] = {}
        self.funcs: dict[FuncKey, FuncDef] = {}
        self._method_owners: dict[str, list[FuncKey]] = {}
        for path, src in sources:
            try:
                tree = ast.parse(src, filename=path)
            except SyntaxError:
                continue
            mod = module_name_for(path)
            # first scan of a module name wins (duplicate basenames in
            # unrelated trees stay separate only via distinct anchors)
            if mod in self.scans:
                mod = f"{mod}#{len(self.scans)}"
            self.scans[mod] = _ModuleScan(tree, path, mod)
        for sc in self.scans.values():
            self.funcs.update(sc.all_funcs)
            for cls, methods in sc.classes.items():
                for m, key in methods.items():
                    self._method_owners.setdefault(m, []).append(key)
        # dotted-suffix index for import resolution
        self._by_suffix: dict[str, list[str]] = {}
        for mod in self.scans:
            segs = mod.split(".")
            for i in range(len(segs)):
                self._by_suffix.setdefault(".".join(segs[i:]),
                                           []).append(mod)

    # -- module + import resolution -----------------------------------------

    def resolve_module(self, dotted: str) -> str | None:
        """A known module whose dotted name equals or suffix-matches
        ``dotted`` (unique matches only)."""
        if dotted in self.scans:
            return dotted
        cands = self._by_suffix.get(dotted, [])
        return cands[0] if len(cands) == 1 else None

    def _module_binding(self, sc: _ModuleScan, name: str) -> Binding | None:
        """What ``name`` means at module level in ``sc``."""
        if name in sc.funcs:
            return Binding("func", sc.funcs[name])
        if name in sc.classes:
            return Binding("class", (sc.module, name))
        if name in sc.imports:
            return Binding("module", sc.imports[name])
        if name in sc.from_imports:
            base, orig = sc.from_imports[name]
            # submodule import?
            tgt = self.resolve_module(f"{base}.{orig}" if base else orig)
            if tgt is not None:
                return Binding("module", tgt)
            tmod = self.resolve_module(base) if base else None
            if tmod is not None:
                inner = self.scans[tmod]
                if orig in inner.funcs:
                    return Binding("func", inner.funcs[orig])
                if orig in inner.classes:
                    return Binding("class", (tmod, orig))
                if orig in inner.assign_values:
                    return self._value_binding(inner,
                                               inner.assign_values[orig])
            return None
        if name in sc.assign_values:
            return self._value_binding(sc, sc.assign_values[name])
        return None

    def _value_binding(self, sc: _ModuleScan, value: ast.expr,
                       _depth: int = 0) -> Binding | None:
        """Binding for a module-level assigned value: aliases
        (``g = f``), partials, call-through wrappers, constructions."""
        if _depth > 4:
            return None
        name = dotted_name(value)
        if name is not None:
            return self.lookup(sc.module, name, None, {})
        if isinstance(value, ast.Call):
            fname = dotted_name(value.func)
            last = (fname or "").rsplit(".", 1)[-1]
            if last == "partial" and value.args:
                inner = self._value_binding(sc, value.args[0], _depth + 1)
                if inner is not None and inner.kind in ("func", "partial"):
                    base_args = inner.bound_args \
                        if inner.kind == "partial" else ()
                    return Binding(
                        "partial", inner.ref,
                        base_args + tuple(value.args[1:]),
                        inner.bound_kwargs + tuple(
                            (k.arg, k.value) for k in value.keywords
                            if k.arg))
            if last in _CALL_THROUGH and value.args:
                return self._value_binding(sc, value.args[0], _depth + 1)
            # x = ClassName(...) — receiver-type tracking
            target = self._value_binding(sc, value.func, _depth + 1) \
                if not isinstance(value.func, ast.Name) else \
                self._module_binding(sc, value.func.id)
            if target is not None and target.kind == "class":
                return Binding("instance", target.ref)
        return None

    # -- name lookup ---------------------------------------------------------

    def lookup(self, module: str, dotted: str, cls: str | None,
               local_env: dict[str, Binding]) -> Binding | None:
        """Resolve a dotted name in a function scope: local bindings
        first, then the enclosing class (``self.x``), then module
        scope, then across imports."""
        sc = self.scans.get(module)
        if sc is None:
            return None
        parts = dotted.split(".")
        head, rest = parts[0], parts[1:]
        if head == "self" and cls is not None:
            if len(rest) == 1:
                return self.method(("class", (module, cls)), rest[0]) \
                    or local_env.get(f"self.{rest[0]}")
            return None
        b = local_env.get(head)
        if b is None:
            b = self._module_binding(sc, head)
        for seg in rest:
            if b is None:
                return None
            b = self._attr_of(b, seg)
        return b

    def _attr_of(self, b: Binding, attr: str) -> Binding | None:
        if b.kind == "module":
            tgt = self.resolve_module(b.ref)
            if tgt is None:
                return None
            sub = self.resolve_module(f"{b.ref}.{attr}")
            if sub is not None:
                return Binding("module", sub)
            return self._module_binding(self.scans[tgt], attr)
        if b.kind in ("class", "instance"):
            return self.method(("class", b.ref), attr)
        return None

    def method(self, class_binding, name: str) -> Binding | None:
        if class_binding is None:
            return None
        _kind, (mod, cls) = class_binding[0], class_binding[1]
        sc = self.scans.get(mod)
        if sc is None or cls not in sc.classes:
            return None
        key = sc.classes[cls].get(name)
        if key is not None:
            return Binding("func", key)
        # single-level base-class walk (bases named in the same graph)
        for node in sc.tree.body:
            if isinstance(node, ast.ClassDef) and node.name == cls:
                for base in node.bases:
                    bname = dotted_name(base)
                    if bname is None:
                        continue
                    bb = self.lookup(mod, bname, None, {})
                    if bb is not None and bb.kind == "class":
                        got = self.method(("class", bb.ref), name)
                        if got is not None:
                            return got
        return None

    # -- call resolution -----------------------------------------------------

    def resolve_call(self, call: ast.Call, module: str, cls: str | None,
                     local_env: dict[str, Binding]) -> Binding | None:
        """The function a call ultimately invokes, or None.  Partials
        resolve to their underlying function (the partial's bound args
        stay on the returned binding); unresolvable receivers fall back
        to the unique-method-definition heuristic."""
        name = dotted_name(call.func)
        if name is None:
            return None
        b = self.lookup(module, name, cls, local_env)
        if b is not None and b.kind in ("func", "partial"):
            return b
        if b is not None and b.kind == "class":
            init = self.method(("class", b.ref), "__init__")
            return init
        # receiver-type heuristic: x.m() with unknown x but m defined by
        # exactly one class in the graph
        if "." in name:
            meth = name.rsplit(".", 1)[-1]
            owners = self._method_owners.get(meth, [])
            if len(owners) == 1 and not meth.startswith("__"):
                return Binding("func", owners[0])
        return None

    def func(self, key: FuncKey) -> FuncDef | None:
        return self.funcs.get(key)


def graph_for_paths(paths: Iterable[str | Path]) -> CallGraph:
    from .engine import iter_python_files
    sources = []
    for f in iter_python_files(paths):
        try:
            sources.append((str(f), Path(f).read_text()))
        except (OSError, UnicodeDecodeError):
            continue
    return CallGraph(sources)
