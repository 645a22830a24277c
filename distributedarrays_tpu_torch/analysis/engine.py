"""dalint engine: parsing, suppression handling, and rule dispatch.

The port's copy of ``distributedarrays_tpu/analysis/engine.py``, unchanged
but for this paragraph.  The engine is deliberately stdlib-only (``ast`` +
``re``): linting a tree must not require torch or a card, must start fast,
and must be importable from CI without pulling the device runtime.

Suppression syntax (checked per physical line of the finding):

    x = risky_thing()   # dalint: disable=DAL002 — gather is intentional

Multiple codes separate with commas (``disable=DAL001,DAL003``).  A
whole-file opt-out uses ``# dalint: disable-file=CODE`` on any line
(conventionally in the module docstring area).  Everything after the code
list is free-form justification — reviewers should expect one.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Iterable, Sequence


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding, anchored to a source position.

    ``suppressed`` marks findings matched by an inline or file-level
    ``# dalint: disable`` comment; the CLI hides them by default and they
    never affect the exit code.
    """

    path: str
    line: int
    col: int
    code: str
    severity: str
    message: str
    suppressed: bool = False

    def format(self) -> str:
        tail = "  (suppressed)" if self.suppressed else ""
        return (f"{self.path}:{self.line}:{self.col}: {self.code} "
                f"[{self.severity}] {self.message}{tail}")


_DISABLE_LINE = re.compile(r"#\s*dalint:\s*disable=([A-Z0-9,\s]+)")
_DISABLE_FILE = re.compile(r"#\s*dalint:\s*disable-file=([A-Z0-9,\s]+)")


def _codes(group: str) -> set[str]:
    return {c.strip() for c in group.split(",") if c.strip()}


def _comment_lines(lines: Sequence[str]) -> dict[int, str] | None:
    """Map line number -> comment text for REAL comment tokens only, so
    a docstring that *quotes* the suppression syntax neither silences
    findings nor trips the DAL100 unused-suppression check.  None when
    the source can't be tokenized (syntax errors — the caller falls
    back to the raw-line scan, which can only over-suppress a file the
    lint run already reports as broken)."""
    import io
    import tokenize

    out: dict[int, str] = {}
    try:
        toks = tokenize.generate_tokens(
            io.StringIO("\n".join(lines) + "\n").readline)
        for tok in toks:
            if tok.type == tokenize.COMMENT:
                out.setdefault(tok.start[0], tok.string)
    except (tokenize.TokenError, SyntaxError, IndentationError,
            ValueError):
        return None
    return out


def parse_suppressions(lines: Sequence[str]) -> tuple[dict, set]:
    """Per-line and file-level suppression sets from raw source lines."""
    comments = _comment_lines(lines)
    if comments is None:
        comments = dict(enumerate(lines, 1))
    per_line: dict[int, set[str]] = {}
    whole_file: set[str] = set()
    for lineno, text in sorted(comments.items()):
        m = _DISABLE_FILE.search(text)
        if m:
            whole_file |= _codes(m.group(1))
            # fall through: a disable-file comment may carry a same-line
            # disable=DAL100 keeper (docs/analysis.md), and the regexes
            # cannot cross-match ("disable=" never matches "disable-")
        m = _DISABLE_LINE.search(text)
        if m:
            per_line.setdefault(lineno, set()).update(_codes(m.group(1)))
    return per_line, whole_file


def lint_source(src: str, path: str = "<string>",
                select: Iterable[str] | None = None) -> list[Finding]:
    """Lint one source string; returns ALL findings, suppressed ones
    flagged (callers filter on ``.suppressed``)."""
    from . import rules  # late import: rules imports Finding from here

    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 1, e.offset or 0, "DAL000",
                        "error", f"syntax error: {e.msg}")]
    lines = src.splitlines()
    per_line, whole_file = parse_suppressions(lines)
    wanted = set(select) if select is not None else None
    out: list[Finding] = []
    for code, rule in rules.RULES.items():
        if wanted is not None and code not in wanted:
            continue
        for line, col, message in rule.check(tree, path, lines):
            suppressed = (code in whole_file
                          or code in per_line.get(line, ()))
            out.append(Finding(path, line, col, code, rule.severity,
                               message, suppressed))
    out.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return out


def unused_suppressions(src: str, path: str, findings: list[Finding],
                        checked_codes: Iterable[str] | None = None
                        ) -> list[Finding]:
    """Suppression comments that silenced nothing (code ``DAL100``).

    A per-line ``disable=CODE`` is *used* when some finding of that code
    anchors to that physical line; a ``disable-file=CODE`` when any
    finding of that code exists in the file.  With a ``--select`` subset
    active, codes outside ``checked_codes`` are skipped — their rules
    never ran, so nothing can be concluded.  Codes that name no known
    rule are always reported (a typo'd suppression protects nothing).
    ``findings`` must be the UNFILTERED list from :func:`lint_source`
    (suppressed entries included)."""
    from . import rules

    lines = src.splitlines()
    per_line, whole_file = parse_suppressions(lines)
    checked = set(checked_codes) if checked_codes is not None \
        else set(rules.RULES)
    used_line = {(f.line, f.code) for f in findings}
    used_file = {f.code for f in findings}

    def emit(lineno: int, code: str, text: str) -> Finding:
        # DAL100 findings accept the ordinary suppression syntax too
        sup = ("DAL100" in whole_file
               or "DAL100" in per_line.get(lineno, ()))
        return Finding(path, lineno, 0, "DAL100", "warning", text, sup)

    out: list[Finding] = []
    for lineno in sorted(per_line):
        for code in sorted(per_line[lineno]):
            if code == "DAL100":
                continue
            known = code in rules.RULES
            if known and code not in checked:
                continue
            if not known or (lineno, code) not in used_line:
                why = ("unknown rule code" if not known
                       else "no finding of that code on this line")
                out.append(emit(lineno, code,
                                f"unused suppression disable={code}: "
                                f"{why} — remove the comment (or fix "
                                f"the code if it was a typo)"))
    # anchor file-level reports at their comment's line so a same-line
    # disable=DAL100 keeper (docs/analysis.md) can suppress them
    comments = _comment_lines(lines)
    if comments is None:
        comments = dict(enumerate(lines, 1))
    file_comment_line: dict[str, int] = {}
    for lineno, text in sorted(comments.items()):
        m = _DISABLE_FILE.search(text)
        if m:
            for code in _codes(m.group(1)):
                file_comment_line.setdefault(code, lineno)
    for code in sorted(whole_file):
        if code == "DAL100":
            continue
        known = code in rules.RULES
        if known and code not in checked:
            continue
        if not known or code not in used_file:
            why = ("unknown rule code" if not known
                   else "no finding of that code in this file")
            out.append(emit(file_comment_line.get(code, 1), f"{code}",
                            f"unused suppression disable-file="
                            f"{code}: {why} — remove the comment"))
    return out


def lint_file(path: str | Path,
              select: Iterable[str] | None = None) -> list[Finding]:
    p = Path(path)
    try:
        src = p.read_text()
    except (OSError, UnicodeDecodeError) as e:
        return [Finding(str(p), 1, 0, "DAL000", "error",
                        f"unreadable file: {e}")]
    return lint_source(src, str(p), select)


def iter_python_files(paths: Iterable[str | Path]) -> list[Path]:
    """Expand files/directories into a sorted, de-duplicated .py file list."""
    seen: dict[Path, None] = {}
    for raw in paths:
        p = Path(raw)
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                seen.setdefault(f, None)
        else:
            seen.setdefault(p, None)
    return list(seen)


def lint_paths(paths: Iterable[str | Path],
               select: Iterable[str] | None = None) -> list[Finding]:
    """Lint every .py file under ``paths`` (files or directories)."""
    out: list[Finding] = []
    for f in iter_python_files(paths):
        out.extend(lint_file(f, select))
    return out
