"""dalint CLI, the port's copy of ``distributedarrays_tpu/analysis/
__main__.py``.

    python -m distributedarrays_tpu_torch.analysis lint [paths...]
    python -m distributedarrays_tpu_torch.analysis rules [--json]
    python -m distributedarrays_tpu_torch.analysis effects <module:fn>
    python -m distributedarrays_tpu_torch.analysis verify-spmd [paths...]
    python -m distributedarrays_tpu_torch.analysis verify-protocols \
        [--ps 2,3,4,8] [--max-states N] [--no-mutants] [--quiet]
    python -m distributedarrays_tpu_torch.analysis locks [paths...]

``lint`` exits 0 when every finding is suppressed (or none exist), 1
otherwise — the CI gate.  Default paths are the port's own lint surface:
``distributedarrays_tpu_torch chip_smoke.py``.  Output
formats: ``--format=text`` (default), ``json`` (one object per finding),
``github`` (workflow-command annotations rendered inline on PR diffs).
``--warn-unused-suppressions`` reports ``# dalint: disable=`` comments
that silence nothing (code DAL100, on in CI so justified suppressions
cannot rot); ``--changed`` lints only files that differ from the git
merge base (plus uncommitted/untracked) — the pre-commit fast mode.
Full-catalog runs reuse the content-hash result cache at
``build/dalint_torch_cache.json`` (``--no-cache`` bypasses it; the summary
line reports hit/miss counts).

Exit-code contract, uniform across the gate verbs (``lint``,
``verify-spmd``, ``locks``): **0** = clean (every finding suppressed or
none exist), **1** = active findings (or a truncated/failed proof),
**2** = the gate could not run honestly (no targets resolved, bad
usage, ``--changed`` without a merge base) — distinct from 1 so CI
never confuses "bugs found" with "nothing was checked".

``effects`` prints one function's interprocedural collective effect
signature (``analysis.effects``); ``verify-spmd`` is the cross-file
static SPMD divergence + collective-contract gate (DAL010/011/012 over
the package and ``chip_smoke.py``); ``locks`` runs the cross-file
lock-order / blocking-under-lock analysis (``analysis.locks``) and prints
the acquisition graph.  ``verify-protocols`` model-checks the port's
cross-process protocols (``ops/ring_schedules.py``: ``peer_call``'s region
copy, K12's cross-process reduce-scatter, the two-slot rings of K9 and
K13-K15, the tp/dp all-reduce) over every interleaving of the processes
(``analysis.protocol``) and refutes the seeded mutants; it keeps JAX's
exit codes: 0 proved, 1 a violation, a missed mutant or an exhausted
state budget, 2 when it could not run.  ``rules --json``
gives each code one line on what it catches in the port
(``rules.PORT_SCOPE``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from .engine import lint_file, unused_suppressions
from .rules import PORT_SCOPE, RULES

DEFAULT_TARGETS = ["distributedarrays_tpu_torch", "chip_smoke.py"]

_SEV_GH = {"error": "error", "warning": "warning", "info": "notice"}


def _emit(findings, fmt: str) -> None:
    if fmt == "json":
        print(json.dumps([{
            "path": f.path, "line": f.line, "col": f.col,
            "code": f.code, "severity": f.severity,
            "message": f.message, "suppressed": f.suppressed,
        } for f in findings], indent=2))
        return
    for f in findings:
        if fmt == "github":
            # workflow commands; GitHub renders them inline on the diff
            msg = f.message.replace("%", "%25").replace("\r", "%0D") \
                           .replace("\n", "%0A")
            print(f"::{_SEV_GH.get(f.severity, 'warning')} "
                  f"file={f.path},line={f.line},col={max(f.col, 1)},"
                  f"title={f.code}::{msg}")
        else:
            print(f.format())


def _changed_files(base: str | None) -> tuple[list[str] | None, str | None]:
    """``(paths, error)``: paths differing from the merge base with
    ``base`` (or the first of origin/main, origin/master, main, master
    that resolves), plus uncommitted and untracked files.  ``error``
    is a message when the mode cannot run honestly — git unavailable,
    or no merge base resolved (a typo'd ``--base``, a default branch
    outside the fallback chain): linting only the uncommitted files
    then would silently pass bad committed ones."""
    def git(*args):
        try:
            r = subprocess.run(["git", *args], capture_output=True,
                               text=True, timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            return None
        return r.stdout.strip() if r.returncode == 0 else None

    if git("rev-parse", "--git-dir") is None:
        return None, "--changed needs a git checkout"
    candidates = ([base] if base else
                  ["origin/main", "origin/master", "main", "master"])
    merge_base = None
    for cand in candidates:
        merge_base = git("merge-base", "HEAD", cand)
        if merge_base:
            break
    if merge_base is None:
        return None, ("--changed found no merge base (tried "
                      + ", ".join(candidates)
                      + "); pass --base REF for this checkout")
    out: set[str] = set()
    committed = git("diff", "--name-only", merge_base, "HEAD")
    if committed:
        out.update(committed.splitlines())
    for extra in (git("diff", "--name-only", "HEAD"),
                  git("ls-files", "--others", "--exclude-standard")):
        if extra:
            out.update(extra.splitlines())
    # deleted/renamed-away paths still appear in the diffs; linting
    # them would fail every commit that removes a .py file
    return sorted(p for p in out
                  if p.endswith(".py") and Path(p).exists()), None


def _cmd_lint(args) -> int:
    select = args.select.split(",") if args.select else None
    if args.changed:
        changed, err = _changed_files(args.base)
        if changed is None:
            print(f"dalint: {err}", file=sys.stderr)
            return 2
        scope = args.paths or [p for p in DEFAULT_TARGETS
                               if Path(p).exists()]
        roots = [Path(p).resolve() for p in scope]
        files = []
        for c in changed:
            rc = Path(c).resolve()
            if any(rc == r or r in rc.parents for r in roots):
                files.append(c)
        if not files:
            print("dalint: no changed files under the lint surface "
                  "(clean by construction)")
            return 0
        paths = files
    else:
        paths = args.paths or [p for p in DEFAULT_TARGETS
                               if Path(p).exists()]
        if not paths:
            # zero resolved targets must NOT read as a clean gate (e.g.
            # the bare module invoked outside the repo root without
            # arguments)
            print("dalint: no lint targets found (run from the repo "
                  "root or pass explicit paths)", file=sys.stderr)
            return 2

    from .engine import iter_python_files, lint_source
    # the content-hash cache covers full-catalog runs only (--select
    # subsets change the finding set; see analysis/cache.py)
    cache = None
    if not args.no_cache and select is None:
        from .cache import LintCache
        cache = LintCache()
    findings = []
    for f in iter_python_files(paths):
        try:
            src = Path(f).read_text()
        except (OSError, UnicodeDecodeError) as e:
            from .engine import Finding
            findings.append(Finding(str(f), 1, 0, "DAL000", "error",
                                    f"unreadable file: {e}"))
            continue
        hit = cache.lookup(str(f), src) if cache is not None else None
        if hit is not None:
            per_file, dal100 = hit
        else:
            per_file = lint_source(src, str(f), select)
            dal100 = unused_suppressions(
                src, str(f), per_file,
                select if select is not None else None)
            if cache is not None:
                cache.store(str(f), src, per_file, dal100)
        findings.extend(per_file)
        if args.warn_unused_suppressions:
            findings.extend(dal100)
    if cache is not None:
        cache.save()
    findings.sort(key=lambda x: (x.path, x.line, x.col, x.code))
    active = [f for f in findings if not f.suppressed]
    shown = findings if args.show_suppressed else active
    _emit(shown, args.format)
    n_sup = sum(1 for f in findings if f.suppressed)
    if args.format != "json":
        cache_note = cache.counters if cache is not None else "cache: off"
        print(f"dalint: {len(active)} finding(s), {n_sup} suppressed, "
              f"{len(paths)} path(s), {cache_note}")
    return 1 if active else 0


def _cmd_effects(args) -> int:
    from . import effects

    try:
        print(effects.signature_for(args.target, args.paths or None))
    except ValueError as e:
        print(f"effects: {e}", file=sys.stderr)
        return 2
    return 0


def _cmd_verify_spmd(args) -> int:
    from . import effects
    from .engine import iter_python_files

    paths = args.paths or [p for p in effects.DEFAULT_EFFECT_TARGETS
                           if Path(p).exists()]
    if not paths:
        print("verify-spmd: no analysis targets found (run from the "
              "repo root or pass explicit paths)", file=sys.stderr)
        return 2
    report = effects.analyze_paths(paths)
    findings = list(report.findings)
    # DAL100 integration: a DAL010/011/012 suppression in the swept
    # files must silence a finding of this very sweep, or it has rotted
    if args.warn_unused_suppressions:
        by_path: dict[str, list] = {}
        for f in report.findings:
            by_path.setdefault(f.path, []).append(f)
        for f in iter_python_files(paths):
            try:
                src = Path(f).read_text()
            except (OSError, UnicodeDecodeError):
                continue
            findings.extend(unused_suppressions(
                src, str(f), by_path.get(str(f), []),
                ("DAL010", "DAL011", "DAL012")))
    findings.sort(key=lambda x: (x.path, x.line, x.col, x.code))
    active = [f for f in findings if not f.suppressed]
    shown = findings if args.show_suppressed else active
    _emit(shown, args.format)
    if args.format != "json":
        n_sup = sum(1 for f in findings if f.suppressed)
        extra = ", TRUNCATED (analysis budget hit — findings " \
                "incomplete)" if report.truncated else ""
        print(f"verify-spmd: {len(active)} finding(s), {n_sup} "
              f"suppressed, {report.functions} function(s), "
              f"{report.contexts} context(s){extra}")
    # a truncated sweep proved nothing for the un-analyzed remainder —
    # fail closed so CI cannot go green on a partial proof
    return 1 if active or report.truncated else 0


def _cmd_verify_protocols(args) -> int:
    from . import protocol

    try:
        ps = tuple(int(x) for x in args.ps.split(",")) if args.ps \
            else protocol.DEFAULT_PS
    except ValueError:
        print(f"verify-protocols: bad --ps {args.ps!r}", file=sys.stderr)
        return 2
    if not ps or min(ps) < 2:
        print("verify-protocols: every p must be at least 2",
              file=sys.stderr)
        return 2
    kw = {}
    if args.max_states is not None:
        kw["max_states"] = args.max_states
    report = protocol.verify_protocols(ps=ps, mutants=not args.no_mutants,
                                       **kw)
    print(protocol.format_report(
        report, verbose_counterexamples=not args.quiet))
    return 0 if report["ok"] else 1


def _cmd_locks(args) -> int:
    from . import locks

    paths = args.paths or [p for p in locks.DEFAULT_LOCK_TARGETS
                           if Path(p).exists()]
    if not paths:
        print("locks: no analysis targets found (run from the repo "
              "root or pass explicit paths)", file=sys.stderr)
        return 2
    report = locks.analyze_paths(paths)
    active = [f for f in report.findings if not f.suppressed]
    shown = report.findings if args.show_suppressed else active
    _emit(shown, args.format)
    if args.format != "json":
        print(locks.format_graph(report))
        n_sup = sum(1 for f in report.findings if f.suppressed)
        print(f"locks: {len(active)} finding(s), {n_sup} suppressed, "
              f"{len(paths)} path(s)")
    return 1 if active else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m distributedarrays_tpu_torch.analysis",
        description="dalint: framework-aware static analysis")
    sub = parser.add_subparsers(dest="cmd")

    lint = sub.add_parser("lint", help="lint files/directories")
    lint.add_argument("paths", nargs="*", help="files or directories "
                      "(default: distributedarrays_tpu_torch chip_smoke.py)")
    lint.add_argument("--select", default=None,
                      help="comma-separated rule codes to run (e.g. "
                           "DAL001,DAL005)")
    lint.add_argument("--show-suppressed", action="store_true",
                      help="also print findings silenced by "
                           "`# dalint: disable=` comments")
    lint.add_argument("--format", choices=("text", "json", "github"),
                      default="text",
                      help="output format (github = workflow-command "
                           "annotations rendered inline on PR diffs)")
    lint.add_argument("--warn-unused-suppressions", action="store_true",
                      help="report disable= comments that silence "
                           "nothing (DAL100; on in CI)")
    lint.add_argument("--changed", action="store_true",
                      help="lint only files differing from the git "
                           "merge base (+ uncommitted/untracked) — "
                           "pre-commit fast mode")
    lint.add_argument("--base", default=None,
                      help="merge-base ref for --changed (default: "
                           "origin/main, origin/master, main, master)")
    lint.add_argument("--no-cache", action="store_true",
                      help="bypass the content-hash result cache "
                           "(build/dalint_torch_cache.json)")

    rules_p = sub.add_parser("rules", help="print the rule catalog")
    rules_p.add_argument("--json", action="store_true",
                         help="machine-readable catalog for editor/"
                              "tooling integration")

    eff = sub.add_parser(
        "effects",
        help="print a function's interprocedural collective effect "
             "signature")
    eff.add_argument("target", help="module:function (or "
                                    "path/to/file.py:function, "
                                    "module:Class.method)")
    eff.add_argument("paths", nargs="*",
                     help="analysis surface (default: "
                          "distributedarrays_tpu_torch chip_smoke.py)")

    vs = sub.add_parser(
        "verify-spmd",
        help="cross-file static SPMD divergence + collective-contract "
             "gate (DAL010/011/012)")
    vs.add_argument("paths", nargs="*",
                    help="files or directories (default: "
                         "distributedarrays_tpu_torch chip_smoke.py)")
    vs.add_argument("--format", choices=("text", "json", "github"),
                    default="text")
    vs.add_argument("--show-suppressed", action="store_true")
    vs.add_argument("--warn-unused-suppressions", action="store_true",
                    help="report DAL010/011/012 disable= comments that "
                         "silence nothing in this sweep (DAL100)")

    vp = sub.add_parser(
        "verify-protocols",
        help="model-check the cross-process protocols and refute the "
             "seeded mutants")
    vp.add_argument("--ps", default="",
                    help="comma-separated process counts (default 2,3,4,8)")
    vp.add_argument("--max-states", type=int, default=None,
                    help="state budget a schedule (a run that hits it "
                         "fails)")
    vp.add_argument("--no-mutants", action="store_true")
    vp.add_argument("--quiet", action="store_true",
                    help="no counterexample traces")

    lk = sub.add_parser(
        "locks",
        help="cross-file lock-order + blocking-under-lock analysis")
    lk.add_argument("paths", nargs="*",
                    help="files or directories (default: "
                         "distributedarrays_tpu_torch)")
    lk.add_argument("--format", choices=("text", "json", "github"),
                    default="text")
    lk.add_argument("--show-suppressed", action="store_true")

    args = parser.parse_args(argv)
    if args.cmd == "rules":
        if args.json:
            print(json.dumps([{
                "code": code, "severity": rule.severity,
                "title": rule.title, "port": PORT_SCOPE[code],
            } for code, rule in sorted(RULES.items())] + [{
                "code": "DAL100", "severity": "warning",
                "title": "unused suppression", "port": PORT_SCOPE["DAL100"],
            }], indent=2))
        else:
            for code, rule in sorted(RULES.items()):
                print(f"{code} [{rule.severity}] {rule.title}")
        return 0
    if args.cmd == "lint":
        return _cmd_lint(args)
    if args.cmd == "effects":
        return _cmd_effects(args)
    if args.cmd == "verify-spmd":
        return _cmd_verify_spmd(args)
    if args.cmd == "verify-protocols":
        return _cmd_verify_protocols(args)
    if args.cmd == "locks":
        return _cmd_locks(args)
    parser.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
