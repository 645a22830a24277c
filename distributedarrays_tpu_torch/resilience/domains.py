"""Failure-domain topology: rank -> domain, and buddy placement.

PyTorch counterpart of ``distributedarrays_tpu/resilience/domains.py``
(its whole ``__all__``).  A domain is the unit that fails together (a
host); the reshard planner classifies each exchange as intra- or
cross-domain against it, and replica placement puts a rank's buddy in
another domain.

- :func:`topology` is the process-wide :class:`DomainTopology`.  The port
  has one controller process, so the default is one domain holding every
  rank of the rank table: what the JAX default (one domain per JAX process)
  collapses to on a single-controller mesh.  :func:`configure` or
  ``DA_TPU_DOMAINS`` carve the ranks into synthetic domains.
- :func:`buddy_map`, :func:`is_cross_domain` and :func:`majority_side` are
  pure functions of their arguments and the topology, as in JAX.

``DA_TPU_DOMAINS`` takes comma-separated group sizes (``"5,3"`` gives
ranks 0-4 | 5-7) or a JSON list of rank groups (``"[[0,2],[1,3]]"``).
The JAX module's journal event on ``configure`` is left out with the rest
of the telemetry core.
"""

from __future__ import annotations

import json
import os
import threading

from .. import layout as L

__all__ = ["DomainTopology", "topology", "configure", "reset",
           "domain_of", "domains", "buddy_map", "is_cross_domain",
           "majority_side"]

_DOMAINS_ENV = "DA_TPU_DOMAINS"


class DomainTopology:
    """An immutable rank -> failure-domain assignment (JAX
    ``domains.py:54``).  ``groups`` is a list of rank lists; a domain's id
    is its group's position.  Every rank appears in at most one group."""

    def __init__(self, groups: list[list[int]]):
        cleaned: list[list[int]] = []
        seen: set[int] = set()
        for g in groups:
            ranks = sorted(int(r) for r in g)
            if not ranks:
                continue
            dup = set(ranks) & seen
            if dup or len(set(ranks)) != len(ranks):
                raise ValueError(
                    f"rank(s) {sorted(dup) or ranks} assigned to more than "
                    f"one failure domain in {groups}")
            seen |= set(ranks)
            cleaned.append(ranks)
        if not cleaned:
            raise ValueError("domain topology needs at least one non-empty "
                             "rank group")
        self._groups = cleaned
        self._dom_of = {r: i for i, g in enumerate(cleaned) for r in g}

    def key(self) -> tuple:
        """A hashable form of the assignment (the plan cache keys on it)."""
        return tuple(tuple(g) for g in self._groups)

    def ranks(self) -> list[int]:
        """Every rank the topology covers, ascending."""
        return sorted(self._dom_of)

    def domains(self) -> dict[int, list[int]]:
        """Domain id -> its ranks (ascending)."""
        return {i: list(g) for i, g in enumerate(self._groups)}

    def domain_of(self, rank: int) -> int:
        try:
            return self._dom_of[int(rank)]
        except KeyError:
            raise KeyError(f"rank {rank} is not in the domain topology "
                           f"(covered: {self.ranks()})") from None

    def live_domains(self, live_ranks) -> dict[int, list[int]]:
        """Domain id -> its live ranks (domains with none left out)."""
        live = {int(r) for r in live_ranks}
        out: dict[int, list[int]] = {}
        for i, g in enumerate(self._groups):
            alive = [r for r in g if r in live]
            if alive:
                out[i] = alive
        return out

    def __repr__(self):
        return f"DomainTopology({self._groups})"


_topo: DomainTopology | None = None
_lock = threading.Lock()


def _from_env(spec: str) -> DomainTopology:
    s = spec.strip()
    if s.startswith("["):
        return DomainTopology(json.loads(s))
    sizes = [int(x) for x in s.split(",") if x.strip()]
    groups, start = [], 0
    for n in sizes:
        groups.append(list(range(start, start + n)))
        start += n
    return DomainTopology(groups)


def _default() -> DomainTopology:
    """One domain holding every rank of the table: the port runs one
    controller process (JAX ``domains.py:125``, single-controller)."""
    return DomainTopology([L.all_ranks() or [0]])


def topology() -> DomainTopology:
    """The process-wide topology: an explicit :func:`configure` wins, else
    ``DA_TPU_DOMAINS``, else the one-domain default (JAX
    ``domains.py:143``).  The default is derived from the rank table on
    each call, so it covers the ranks of the latest ``init``."""
    global _topo
    if _topo is None:
        env = os.environ.get(_DOMAINS_ENV)
        if not env:
            # follows the rank table, which init() may rebuild
            return _default()
        with _lock:
            if _topo is None:
                _topo = _from_env(env)
    return _topo


def configure(groups) -> DomainTopology:
    """Install an explicit topology, a list of rank groups or an env-style
    string (JAX ``domains.py:155``)."""
    global _topo
    topo = _from_env(groups) if isinstance(groups, str) \
        else DomainTopology(groups)
    with _lock:
        _topo = topo
    return topo


def reset() -> None:
    """Forget the configured topology; the next :func:`topology` derives
    it again from the environment or the default (JAX ``domains.py:176``)."""
    global _topo
    with _lock:
        _topo = None


def domain_of(rank: int) -> int:
    return topology().domain_of(rank)


def domains() -> dict[int, list[int]]:
    return topology().domains()


def buddy_map(live_ranks=None, topo: DomainTopology | None = None) -> dict:
    """Replica placement: live rank -> buddy rank (JAX ``domains.py:192``).

    With two or more live domains every buddy lives in another domain than
    its owner, round-robin over the other domains' live ranks.  With one
    live domain it is the next live rank in ring order, and a lone rank
    buddies itself.  Ranks outside the topology buddy within the uncovered
    set.  ``live_ranks=None`` means every rank of the table (the port has
    no elastic manager, which JAX asks here)."""
    topo = topo or topology()
    if live_ranks is None:
        live_ranks = L.all_ranks()
    live = sorted({int(r) for r in live_ranks})
    if not live:
        return {}
    dom_live = topo.live_domains(live)
    out: dict[int, int] = {}
    for dom, ranks in dom_live.items():
        others = [r for d, rs in sorted(dom_live.items()) if d != dom
                  for r in rs]
        for i, r in enumerate(ranks):
            if others:
                out[r] = others[i % len(others)]
            elif len(ranks) > 1:
                out[r] = ranks[(i + 1) % len(ranks)]
            else:
                out[r] = r
    uncovered = [r for r in live if r not in topo._dom_of]
    for i, r in enumerate(uncovered):
        out[r] = uncovered[(i + 1) % len(uncovered)]
    return out


def is_cross_domain(bmap: dict, topo: DomainTopology | None = None) -> bool:
    """True when every buddy pair in ``bmap`` spans two domains (JAX
    ``domains.py:234``)."""
    topo = topo or topology()
    for r, b in bmap.items():
        try:
            if topo.domain_of(r) == topo.domain_of(b):
                return False
        except KeyError:
            return False
    return bool(bmap)


def majority_side(groups, observer: int, expected_total: int | None = None,
                  coordinator: int | None = None) -> dict:
    """The quorum rule (JAX ``domains.py:247``): the observer's side
    continues when it holds a strict majority of ``expected_total`` ranks
    (default: every rank in ``groups``), or exactly half with the
    ``coordinator`` (default: the lowest rank).  Returns ``{"verdict":
    "quorum" | "minority", "side": [...], "lost": [...]}``."""
    comps = [sorted(int(r) for r in g) for g in groups if g]
    allr = sorted(r for g in comps for r in g)
    total = int(expected_total) if expected_total is not None else len(allr)
    coord = int(coordinator) if coordinator is not None \
        else (min(allr) if allr else 0)
    side = next((g for g in comps if int(observer) in g), [int(observer)])
    lost = [r for r in allr if r not in side]
    quorum = 2 * len(side) > total or \
        (2 * len(side) == total and coord in side)
    return {"verdict": "quorum" if quorum else "minority",
            "side": side, "lost": lost}
