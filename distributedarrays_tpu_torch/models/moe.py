"""Expert parallelism: top-k mixture of experts with all-to-all dispatch.

PyTorch counterpart of ``distributedarrays_tpu/models/moe.py``
(``init_moe_params``, ``make_ep_mesh``, ``moe_forward``,
``reference_moe``), written in rank-list form over the ranks of ``mesh``
(``make_ep_mesh``): one expert a rank, as JAX's ``P('ep')`` gives.  The
port's parameters are ``{"Wg": [...], "W1": [...], "W2": [...]}``, one
tensor a rank on its device: the router ``(H, E)`` (replicated, a copy a
rank), and rank ``e``'s expert ``(H, F)`` and ``(F, H)``
(``params_from_reference`` / ``params_to_reference`` cross to and from the
JAX dict).

On each rank, over its ``n`` local tokens (JAX ``moe.py:63-130``):

- router softmax, top-k by a stable descending sort (``lax.top_k`` gives
  the lower index first on ties, which ``torch.topk`` does not promise);
  the gates are renormalized over the k picks only when k > 1;
- capacity positions slot-major (every token's first pick claims capacity
  before any second pick), ``keep = pos < capacity``;
- dispatch into an ``(E, C, H)`` buffer with ``index_put_(...,
  accumulate=True)``: a dropped slot is clipped onto position ``C - 1`` and
  adds zeros there;
- the exchange out to the experts and the one back are all-to-alls over
  dim 0 of the contiguous ``(E, C, H)`` buffers: on CUDA tensors one
  ``ops.cuda_collectives.ring_all_to_all`` each (K11, one copy launch a
  card), on CPU tensors its plain version;
- the expert is JAX's two-matrix FFN ``gelu(x @ W1) @ W2`` with the tanh
  GELU (``jax.nn.gelu``'s default);
- the combine is the gated sum over kept slots; a token none of whose
  slots was kept passes through unchanged;
- the aux loss ``E * sum_e f_e P_e`` a rank, summed over ranks
  (``preduce``) and divided by E.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..layout import device_of
from ..ops.cuda_collectives import ring_all_to_all
from ..parallel.collectives import preduce, spmd_mesh

__all__ = ["moe_forward", "init_moe_params", "make_ep_mesh",
           "reference_moe", "params_from_reference", "params_to_reference"]


def make_ep_mesh(n_experts: int) -> list[int]:
    """The first ``n_experts`` ranks: expert ``e`` lives on rank ``e``."""
    return spmd_mesh(n_experts)


def init_moe_params(generator: torch.Generator | None, n_experts: int,
                    hidden: int, ffn: int, dtype=torch.float32,
                    ranks=None) -> dict:
    """Router ``normal * sqrt(2 / hidden)`` (a copy on every rank) and
    expert ``e``'s FFN weights (``W1 * sqrt(2 / hidden)``, ``W2 *
    sqrt(2 / ffn)``) on rank ``ranks[e]`` (default: the first
    ``n_experts`` ranks), drawn from ``generator`` on its device."""
    ranks = make_ep_mesh(n_experts) if ranks is None else list(ranks)
    gdev = generator.device if generator is not None else "cpu"
    s1 = torch.tensor(math.sqrt(2.0 / hidden), dtype=dtype)
    s2 = torch.tensor(math.sqrt(2.0 / ffn), dtype=dtype)

    def draw(shape, sc):
        x = torch.randn(shape, generator=generator, device=gdev)
        return x.to(dtype) * sc.to(gdev)
    Wg = draw((hidden, n_experts), s1)
    W1, W2 = [], []
    for e in range(n_experts):
        dev = device_of(ranks[e])
        W1.append(draw((hidden, ffn), s1).to(dev))
        W2.append(draw((ffn, hidden), s2).to(dev))
    return {"Wg": [Wg.to(device_of(r)) for r in ranks], "W1": W1, "W2": W2}


def params_from_reference(np_params: dict, ranks) -> dict:
    """The JAX parameter dict (numpy ``Wg (H, E)``, ``W1 (E, H, F)``,
    ``W2 (E, F, H)``) as the port's per-rank tensors on ``ranks``."""
    Wg = torch.from_numpy(np.array(np_params["Wg"]))
    return {"Wg": [Wg.to(device_of(r)) for r in ranks],
            "W1": [torch.from_numpy(np.array(np_params["W1"][e])).to(
                device_of(r)) for e, r in enumerate(ranks)],
            "W2": [torch.from_numpy(np.array(np_params["W2"][e])).to(
                device_of(r)) for e, r in enumerate(ranks)]}


def params_to_reference(params: dict) -> dict:
    """The port's per-rank tensors as the JAX parameter dict (numpy)."""
    return {"Wg": params["Wg"][0].detach().cpu().numpy(),
            "W1": np.stack([t.detach().cpu().numpy() for t in params["W1"]]),
            "W2": np.stack([t.detach().cpu().numpy() for t in params["W2"]])}


def _expert_ffn(x, W1, W2):
    return F.gelu(x @ W1, approximate="tanh") @ W2


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last dim, the lower index
    first on ties."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _route_topk(x, Wg, n_experts: int, k: int, capacity: int):
    """Expert ids, gates, capacity positions and keep masks ``(n, k)``, and
    the aux ingredients ``f_e``, ``P_e`` over the local tokens (JAX
    ``moe.py:63``)."""
    n = x.shape[0]
    probs = torch.softmax(x @ Wg, dim=-1)
    gate, eidx = _top_k(probs, k)
    if k > 1:
        gate = gate / torch.sum(gate, dim=-1, keepdim=True)
    flat_e = eidx.T.reshape(-1)                         # slot-major
    onehot = F.one_hot(flat_e, n_experts)
    pos = (torch.cumsum(onehot, dim=0) - 1)[
        torch.arange(k * n, device=x.device), flat_e].reshape(k, n).T
    keep = pos < capacity
    f_e = torch.mean(F.one_hot(eidx[:, 0], n_experts).to(probs.dtype), dim=0)
    P_e = torch.mean(probs, dim=0)
    return eidx, gate, pos, keep, f_e, P_e


def moe_forward(params, x, mesh, capacity: int | None = None, k: int = 1,
                capacity_factor: float = 2.0, return_aux: bool = False,
                _all_to_all=None):
    """Route the ``(N, H)`` batch ``x`` (a tensor or array; rank ``r``
    takes rows ``r N / E`` onward) through the expert-parallel layer on the
    ranks ``mesh``: the ``(N, H)`` output on ``mesh[0]``'s device, and with
    ``return_aux`` the aux loss (a 0-d tensor there) too.  ``capacity``
    (slots a rank an expert) defaults to ``ceil(capacity_factor * k *
    n_local / E)``.  ``_all_to_all`` replaces the exchange (the plain
    ``pall_to_all`` on the card, to hold K11 against it)."""
    E = len(mesh)
    if len(params["W1"]) != E:
        raise ValueError(f"params have {len(params['W1'])} experts, mesh "
                         f"has {E}")
    xt = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    N = int(xt.shape[0])
    if N % E:
        raise ValueError(f"token count {N} must be divisible by the {E} "
                         f"expert ranks")
    if not 1 <= k <= E:
        raise ValueError(f"k must be in [1, {E}], got {k}")
    n_local = N // E
    if capacity is None:
        capacity = max(1, int(np.ceil(capacity_factor * k * n_local / E)))
    if capacity <= 0:
        raise ValueError(f"capacity must be positive, got {capacity}")
    xs = [xt[r * n_local:(r + 1) * n_local].to(device_of(p))
          for r, p in enumerate(mesh)]
    exchange = ring_all_to_all if _all_to_all is None else _all_to_all
    C = int(capacity)
    routes, bufs = [], []
    for r, xr in enumerate(xs):
        eidx, gate, pos, keep, f_e, P_e = _route_topk(
            xr, params["Wg"][r], E, k, C)
        posc = torch.clamp(pos, 0, C - 1)
        buf = torch.zeros((E, C, xr.shape[1]), dtype=xr.dtype,
                          device=xr.device)
        for j in range(k):
            buf.index_put_((eidx[:, j], posc[:, j]),
                           xr * keep[:, j, None].to(xr.dtype),
                           accumulate=True)
        routes.append((eidx, gate, posc, keep, f_e, P_e))
        bufs.append(buf)
    recv = exchange(bufs, 0, 0)
    del bufs
    ys = [_expert_ffn(rv.reshape(E * C, -1), params["W1"][q],
                      params["W2"][q]).reshape(E, C, -1)
          for q, rv in enumerate(recv)]
    del recv
    back = exchange(ys, 0, 0)
    del ys
    outs, auxes = [], []
    for r, xr in enumerate(xs):
        eidx, gate, posc, keep, f_e, P_e = routes[r]
        out = torch.zeros_like(xr)
        for j in range(k):
            yi = back[r][eidx[:, j], posc[:, j]]
            out = out + torch.where(keep[:, j, None],
                                    gate[:, j, None] * yi, 0.0)
        outs.append(torch.where(keep.any(dim=-1)[:, None], out, xr))
        auxes.append(E * torch.sum(f_e * P_e))
    aux = preduce(auxes)[0] / E
    home = device_of(mesh[0])
    out = torch.cat([o.to(home) for o in outs])
    return (out, aux) if return_aux else out


def reference_moe(params, x, capacity_per_rank_expert: int, n_ranks: int,
                  k: int = 1) -> torch.Tensor:
    """Dense oracle of the top-k routing and the slot-major capacity (JAX
    ``moe.py:161``), in float32 on the router's device, token by token."""
    Wg = params["Wg"][0].float()
    dev = Wg.device
    x = (x if isinstance(x, torch.Tensor)
         else torch.from_numpy(np.asarray(x))).to(dev, torch.float32)
    E = Wg.shape[1]
    out = torch.zeros_like(x)
    n_local = x.shape[0] // n_ranks
    for r in range(n_ranks):
        xs = x[r * n_local:(r + 1) * n_local]
        pz = torch.softmax(xs @ Wg, dim=-1)
        top = torch.argsort(-pz, dim=-1, stable=True)[:, :k].cpu().numpy()
        gates = torch.gather(pz, 1, torch.from_numpy(top).to(dev))
        if k > 1:
            gates = gates / gates.sum(-1, keepdim=True)
        counts = {e: 0 for e in range(E)}
        kept = np.zeros((n_local, k), bool)
        for j in range(k):                       # slot-major priority
            for i in range(n_local):
                ei = int(top[i, j])
                if counts[ei] < capacity_per_rank_expert:
                    counts[ei] += 1
                    kept[i, j] = True
        for i in range(n_local):
            if not kept[i].any():
                out[r * n_local + i] = xs[i]
                continue
            acc = torch.zeros(x.shape[1], dtype=torch.float32, device=dev)
            for j in range(k):
                if kept[i, j]:
                    ei = int(top[i, j])
                    h = _expert_ffn(xs[i:i + 1],
                                    params["W1"][ei].to(dev, torch.float32),
                                    params["W2"][ei].to(dev, torch.float32))
                    acc += gates[i, j] * h[0]
            out[r * n_local + i] = acc
    return out
