"""Content-hash incremental result cache for the dalint sweep.

The port's copy of ``distributedarrays_tpu/analysis/cache.py``: its own
file, ``build/dalint_torch_cache.json``, salted with the port's
``analysis/`` sources.

Linting is pure: findings for a file depend only on its source text and
the analysis code itself.  That makes results cacheable by content
hash — ``tools/dalint``, the ``--changed`` pre-commit mode, and the CI
lint leg skip re-analysis of unchanged files and pay only for the diff.
The cache lives at ``build/dalint_torch_cache.json`` (the repo's scratch
directory, never committed) and is salted with a digest of the
``analysis/`` package sources, so editing a rule or the engine
invalidates every entry at once — a stale cache can hide a finding, a
salted one cannot.

Only full-catalog runs are cached (``--select`` subsets bypass it: the
finding set depends on which rules ran, and per-subset entries would
multiply the file for a mode used interactively).  DAL100
unused-suppression results are stored alongside so
``--warn-unused-suppressions`` hits too.  ``--no-cache`` is the escape
hatch; corrupt or unwritable cache files degrade to cache-off, never to
an error — the cache is an accelerator, not a dependency.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from pathlib import Path

from .engine import Finding

__all__ = ["LintCache", "default_cache_path", "analysis_salt"]

_VERSION = 1


def default_cache_path() -> Path:
    return Path("build") / "dalint_torch_cache.json"


def analysis_salt() -> str:
    """Digest over the ``analysis/`` package sources: any change to a
    rule, the engine, or the interprocedural analyses invalidates the
    whole cache."""
    h = hashlib.sha256()
    pkg = Path(__file__).parent
    for f in sorted(pkg.glob("*.py")):
        try:
            h.update(f.name.encode())
            h.update(f.read_bytes())
        except OSError:
            h.update(b"?")
    return h.hexdigest()


def _src_hash(src: str) -> str:
    return hashlib.sha256(src.encode("utf-8", "surrogatepass")).hexdigest()


def _pack(findings) -> list:
    return [[f.path, f.line, f.col, f.code, f.severity, f.message,
             f.suppressed] for f in findings]


def _unpack(rows) -> list:
    return [Finding(p, ln, col, code, sev, msg, sup)
            for p, ln, col, code, sev, msg, sup in rows]


class LintCache:
    """Per-file lint results keyed by source content hash."""

    def __init__(self, path: str | Path | None = None):
        self.path = Path(path) if path is not None \
            else default_cache_path()
        self.salt = analysis_salt()
        self.hits = 0
        self.misses = 0
        self._dirty = False
        self._files: dict[str, dict] = {}
        try:
            raw = json.loads(self.path.read_text())
            if (isinstance(raw, dict) and raw.get("version") == _VERSION
                    and raw.get("salt") == self.salt
                    and isinstance(raw.get("files"), dict)):
                self._files = raw["files"]
        except (OSError, ValueError):
            pass

    def lookup(self, path: str, src: str):
        """``(findings, dal100)`` for an unchanged file, else None."""
        entry = self._files.get(path)
        if entry is None or entry.get("hash") != _src_hash(src):
            self.misses += 1
            return None
        try:
            out = (_unpack(entry["findings"]), _unpack(entry["dal100"]))
        except (KeyError, TypeError, ValueError):
            self.misses += 1
            return None
        self.hits += 1
        return out

    def store(self, path: str, src: str, findings, dal100) -> None:
        self._files[path] = {"hash": _src_hash(src),
                             "findings": _pack(findings),
                             "dal100": _pack(dal100)}
        self._dirty = True

    def save(self) -> None:
        """Atomic best-effort write; failures degrade to cache-off."""
        if not self._dirty:
            return
        payload = json.dumps({"version": _VERSION, "salt": self.salt,
                              "files": self._files})
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                       prefix=".dalint_cache.")
            try:
                with os.fdopen(fd, "w") as fh:
                    fh.write(payload)
                os.replace(tmp, self.path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        except OSError:
            pass

    @property
    def counters(self) -> str:
        return f"cache: {self.hits} hit / {self.misses} miss"
