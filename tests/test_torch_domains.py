"""The port's failure-domain topology against the JAX package's
(``resilience/domains.py``): ``configure``, ``DA_TPU_DOMAINS`` in both
grammars, ``buddy_map``, ``is_cross_domain`` and ``majority_side`` over a
table of topologies."""

import pytest

from distributedarrays_tpu import telemetry as JT
from distributedarrays_tpu.resilience import domains as JD
from distributedarrays_tpu_torch.resilience import domains as TD

from _torch_port import port_ranks  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _quiet_jax_telemetry():
    # the JAX package's telemetry keeps one bounded event buffer (8192
    # events) per process, which its own tests read by offset; the calls
    # these parity tests make into the JAX package stay out of it
    was = JT.enabled()
    JT.disable()
    yield
    if was:
        JT.enable()


TOPOLOGIES = ["4,4", "5,3", "2,2,2,2", "8", "1,7", "[[0,2,4,6],[1,3,5,7]]",
              "[[0,1],[2,3],[4,5,6,7]]", "[[3],[0,1,2],[4,5]]"]
LIVE = [None, [0, 1, 2, 3, 4, 5, 6, 7], [0, 1, 5], [4, 5, 6, 7], [2], [],
        [0, 1, 2, 3, 4, 5, 6, 7, 9]]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("DA_TPU_DOMAINS", raising=False)
    TD.reset()
    JD.reset()
    yield
    TD.reset()
    JD.reset()


@pytest.mark.parametrize("spec", TOPOLOGIES)
def test_configure_like_jax(spec):
    t, j = TD.configure(spec), JD.configure(spec)
    assert t.domains() == j.domains() == TD.domains()
    assert t.ranks() == j.ranks()
    for r in range(8):
        if r in j.ranks():
            assert TD.domain_of(r) == JD.domain_of(r)
        else:
            with pytest.raises(KeyError):
                TD.domain_of(r)
    assert t.live_domains([0, 3, 6]) == j.live_domains([0, 3, 6])


@pytest.mark.parametrize("spec", TOPOLOGIES)
def test_env_grammar_like_jax(spec, monkeypatch):
    monkeypatch.setenv("DA_TPU_DOMAINS", spec)
    TD.reset()
    JD.reset()
    assert TD.topology().domains() == JD.topology().domains()
    assert TD.topology() is TD.topology()        # read once until reset


@pytest.mark.parametrize("live", LIVE)
@pytest.mark.parametrize("spec", TOPOLOGIES)
def test_buddy_map_like_jax(spec, live):
    t, j = TD.configure(spec), JD.configure(spec)
    if live is None:
        live = list(range(8))       # JAX's default asks its elastic manager
    bt, bj = TD.buddy_map(live, t), JD.buddy_map(live, j)
    assert bt == bj
    assert TD.is_cross_domain(bt, t) == JD.is_cross_domain(bj, j)


def test_buddy_map_defaults_to_the_rank_table():
    TD.configure("4,4")
    JD.configure("4,4")
    assert TD.buddy_map() == JD.buddy_map(range(8))


def test_default_is_one_domain_of_the_table():
    import distributedarrays_tpu_torch as tdat
    assert TD.topology().domains() == {0: list(range(8))}
    assert TD.topology().domains() == JD.topology().domains()
    tdat.init(nranks=4, device="cpu")
    assert TD.topology().domains() == {0: [0, 1, 2, 3]}


@pytest.mark.parametrize("bad", [[[0, 1], [1, 2]], [[]], [[3, 3]]])
def test_topology_rejects_like_jax(bad):
    with pytest.raises(ValueError):
        JD.DomainTopology(bad)
    with pytest.raises(ValueError):
        TD.DomainTopology(bad)


MAJORITY = [
    ([[0, 1, 2, 3, 4], [5, 6, 7]], 0, None, None),
    ([[0, 1, 2, 3, 4], [5, 6, 7]], 6, None, None),
    ([[0, 1, 2, 3], [4, 5, 6, 7]], 5, None, None),
    ([[0, 1, 2, 3], [4, 5, 6, 7]], 1, None, None),
    ([[0, 1, 2, 3], [4, 5, 6, 7]], 5, None, 4),
    ([[1, 2], [3]], 3, 8, None),
    ([[1, 2, 3, 4, 5]], 2, 8, None),
    ([[0], [1], [2]], 9, None, None),
    ([[2, 3], [0, 1]], 0, 4, 3),
]


@pytest.mark.parametrize("groups,observer,total,coord", MAJORITY)
def test_majority_side_like_jax(groups, observer, total, coord):
    assert TD.majority_side(groups, observer, total, coord) == \
        JD.majority_side(groups, observer, total, coord)
