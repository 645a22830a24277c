"""Continuous-batching decode engine: prefill/decode disaggregated serving.

PyTorch counterpart of ``distributedarrays_tpu/serve/decode.py`` (its whole
``__all__``).  Where the port differs:

- :class:`TinyLM` draws its tables from ``np.random.default_rng(seed)``
  exactly as JAX's does, so both packages hold the same weights; its
  ``qkv`` and ``logits`` take a ``device`` and then compute in torch
  there (elementwise float32, bit for bit the numpy rows);
- the engine computes on a device: the first live rank's for prefill,
  and for a decode step the device :meth:`PagedKVCache.read` gathers the
  sequence's K/V on (the owner of its first page).  Its loop thread makes
  that its current CUDA device;
- decode attention (:func:`_decode_attention`, numpy on the host in JAX)
  is plain torch in float32 on that device: it has no Pallas kernel;
- prefill calls the port's ``ring_attention_prefill``, which is the ring
  kernel K9 on two or more ranks for a causal prompt of at least
  ``min_ring_tokens`` tokens, and ``reference_attention`` otherwise (and
  with ``use_ring_prefill=False``), both on the device tensors.  A kernel
  that fails raises through the recovery loop; nothing falls back.

Autoregressive decode over resident per-sequence state.  A
:class:`DecodeEngine` owns a :class:`~.kvcache.PagedKVCache` and runs a
scheduler loop forming two *disaggregated batch classes* per round:

- **prefill** — compute-bound: the whole prompt's attention in one shot,
  dispatched through the ring-attention prefill entry
  (``models.ring_attention.ring_attention_prefill``) with K/V written
  back into cache pages.  Stamped with
  ``perf.attention_cost`` (O(s²) flops over O(s) bytes) so the roofline
  doctor classifies it compute-bound.
- **decode** — HBM-bound: one token per sequence per round, a single
  query row attending the sequence's entire gathered page set.  Stamped
  with ``perf.decode_step_cost`` (~0.5 flop/byte) so the doctor shows
  the memory-bound regime next to prefill's compute-bound one.

Scheduling: a per-round **token budget** is spent on the decode batch
first (latency: admitted sequences keep streaming), then on prefills
picked by **strict priority classes** and, within a class,
**weighted-fair queuing** between tenants (start-time fair queuing on
virtual finish tags — a saturated pair of tenants with weights 1 and 3
sees ~1:3 prefill service).  Results stream through
:class:`TokenStream` futures; cancellation frees the sequence's pages
immediately.

Resilience: every dispatch runs under ``recovery.run_with_recovery``
with the elastic device manager — an injected device loss mid-decode
probes, shrinks (re-laying the registered cache pages onto survivors),
and retries the step; sequences evicted under HBM pressure re-enter the
prefill class and rebuild their pages **bit-identically** (the toy
model's K/V rows are pure per-token functions — and for real models the
same holds given the token history).  A minority-partition verdict
drains the engine typed, matching the server's behavior.

``attach()`` registers the engine as a :class:`~.server.Server`
endpoint (payload = prompt or ``{"prompt": ..., "tenant": ...,
"priority": ..., "max_new_tokens": ..., "deadline_s": ...}``), wiring
the cache's ``idle_evictable_bytes`` into the server's admission
controller so HBM sheds ship an eviction-aware ``retry_after``.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
import time
import math
from typing import Any, Callable

import numpy as np
import torch

from .. import layout as L
from .. import telemetry as _tm
from ..resilience import elastic, faults as _fl, recovery
from ..telemetry import perf as _perf
from .errors import (Cancelled, DeadlineExceeded, Draining, Overloaded,
                     Rejected, RequestFailed, ServeError)
from .kvcache import KVCacheConfig, PagedKVCache
from .server import _SLO_BUCKETS

__all__ = ["DecodeConfig", "DecodeEngine", "TokenStream", "TinyLM",
           "WeightedFairQueue"]


# ---------------------------------------------------------------------------
# toy model
# ---------------------------------------------------------------------------


class TinyLM:
    """Deterministic single-layer toy decode model for tests and benches.

    The K/V projections are *elementwise* over per-token rows
    (embedding + positional table, scaled per channel), so a sequence's
    K/V rows are a pure function of ``(token, position)`` — an evicted
    sequence's re-prefilled cache is bit-identical to the original
    incremental writes, which is what lets the acceptance soak demand
    bit-equality between an evicted run and an unevicted oracle.  The
    attention itself is real (stable softmax over the full context), so
    the cache contents actually matter."""

    def __init__(self, vocab: int = 64, heads: int = 4, head_dim: int = 8,
                 max_pos: int = 4096, seed: int = 0):
        rng = np.random.default_rng(seed)
        e = heads * head_dim
        self.vocab = int(vocab)
        self.heads = int(heads)
        self.head_dim = int(head_dim)
        self.max_pos = int(max_pos)
        # scales picked so argmax decoding actually wanders the vocab
        # (a flat toy model emits one token forever, which would let a
        # broken cache pass the bit-identity oracle tests)
        self.emb = rng.standard_normal((vocab, e)).astype(np.float32)
        self.pos = (rng.standard_normal((max_pos, e)) * 2.0).astype(
            np.float32)
        self.wq = (0.5 + rng.random(e)).astype(np.float32)
        self.wk = (0.5 + rng.random(e)).astype(np.float32)
        self.wv = (0.5 + rng.random(e)).astype(np.float32)
        self._on: dict = {}           # device -> the tables as tensors

    def _tables(self, device) -> dict:
        """The tables as float32 tensors on ``device`` (copied once)."""
        t = self._on.get(device)
        if t is None:
            t = self._on[device] = {
                k: torch.from_numpy(getattr(self, k)).to(device)
                for k in ("emb", "pos", "wq", "wk", "wv")}
        return t

    def qkv(self, tokens, pos0: int, device=None):
        """Per-token q/k/v rows ``(n, heads, head_dim)`` for ``tokens``
        occupying positions ``pos0..pos0+n``: numpy arrays, or float32
        tensors on ``device`` (the same values bit for bit).  Row ``i``
        depends only on ``(tokens[i], pos0 + i)``, so batch size never
        changes a row."""
        idx = np.asarray(tokens, np.int64)
        if pos0 + len(idx) > self.max_pos:
            raise ServeError(f"sequence length {pos0 + len(idx)} exceeds "
                             f"the model's max_pos {self.max_pos}")
        shape = (-1, self.heads, self.head_dim)
        if device is None:
            x = self.emb[idx % self.vocab] + self.pos[pos0:pos0 + len(idx)]
            return ((x * self.wq).reshape(shape),
                    (x * self.wk).reshape(shape),
                    (x * self.wv).reshape(shape))
        t = self._tables(device)
        rows = torch.from_numpy(idx % self.vocab).to(device)
        x = t["emb"][rows] + t["pos"][pos0:pos0 + len(idx)]
        return ((x * t["wq"]).reshape(shape), (x * t["wk"]).reshape(shape),
                (x * t["wv"]).reshape(shape))

    def logits(self, out):
        """Vocabulary logits for one attention output row ``(heads,
        head_dim)`` (a fixed-shape GEMV): numpy for a host row, a float32
        tensor on the row's device for a tensor."""
        if isinstance(out, torch.Tensor):
            return self._tables(out.device)["emb"] @ out.float().reshape(-1)
        return self.emb @ np.asarray(out, np.float32).reshape(-1)


def _argmax(logits) -> int:
    """The first index of the largest logit (numpy's and torch's rule)."""
    if isinstance(logits, torch.Tensor):
        return int(torch.argmax(logits))
    return int(np.argmax(logits))


def _decode_attention(q, K, V) -> torch.Tensor:
    """One decode step: the ``(h, d)`` query row against the whole resident
    context ``(ctx, h, d)``, a stable softmax in float32 torch on K's
    device.  The query is the sequence's last token, so it attends every
    cached row including its own (no mask at the frontier).  JAX computes
    this in numpy on the host, where the float64 scale promotes the
    scores to float64; the port stays in float32."""
    K = torch.as_tensor(K).float()
    V = torch.as_tensor(V).float().to(K.device)
    q = torch.as_tensor(q).float().to(K.device)
    s = torch.einsum("hd,khd->hk", q / math.sqrt(q.shape[-1]), K)
    s = s - s.amax(-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("hk,khd->hd", p, V)


# ---------------------------------------------------------------------------
# streaming futures
# ---------------------------------------------------------------------------


class TokenStream:
    """Streaming handle for one decode sequence.

    Iterate for tokens as they land, ``result()`` for the full list,
    ``cancel()`` to abandon — cancellation frees the sequence's KV pages
    *immediately* and resolves the stream with
    :class:`~.errors.Cancelled`.  ``add_listener(fn)`` subscribes an
    ``fn(kind, value)`` callback (``("token", t)`` per token, one final
    ``("done", error_or_None)``), replaying history first — the asyncio
    adapter's bridge."""

    def __init__(self, seq_id: int, tenant: str, prompt_len: int,
                 cancel_fn: Callable[[int], bool]):
        self.seq_id = int(seq_id)
        self.tenant = tenant
        self.prompt_len = int(prompt_len)
        self._cancel_fn = cancel_fn
        self._cv = threading.Condition()
        self._tokens: list[int] = []
        self._done = False
        self._error: BaseException | None = None
        self._listeners: list[Callable[[str, Any], None]] = []

    # engine side -----------------------------------------------------------

    def _push(self, tok: int) -> None:
        with self._cv:
            if self._done:
                return
            self._tokens.append(int(tok))
            self._cv.notify_all()
            for fn in self._listeners:
                fn("token", int(tok))

    def _finish(self, error: BaseException | None = None) -> None:
        with self._cv:
            if self._done:
                return
            self._done = True
            self._error = error
            self._cv.notify_all()
            for fn in self._listeners:
                fn("done", error)
            self._listeners.clear()

    # client side -----------------------------------------------------------

    def add_listener(self, fn: Callable[[str, Any], None]) -> None:
        with self._cv:
            for t in self._tokens:
                fn("token", t)
            if self._done:
                fn("done", self._error)
            else:
                self._listeners.append(fn)

    def cancel(self) -> bool:
        """Abandon the sequence; pages free before this returns."""
        return self._cancel_fn(self.seq_id)

    def done(self) -> bool:
        with self._cv:
            return self._done

    def error(self) -> BaseException | None:
        with self._cv:
            return self._error

    @property
    def tokens(self) -> list[int]:
        with self._cv:
            return list(self._tokens)

    def __iter__(self):
        i = 0
        while True:
            with self._cv:
                while i >= len(self._tokens) and not self._done:
                    self._cv.wait(0.05)
                if i < len(self._tokens):
                    t = self._tokens[i]
                    i += 1
                else:
                    if self._error is not None:
                        raise self._error
                    return
            yield t

    def result(self, timeout: float | None = None) -> list[int]:
        """Block for completion; the generated tokens, or the typed
        error the sequence ended with."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while not self._done:
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise TimeoutError(
                        f"sequence {self.seq_id} still running after "
                        f"{timeout:g}s")
                self._cv.wait(0.05 if left is None else min(left, 0.05))
            if self._error is not None:
                raise self._error
            return list(self._tokens)


# ---------------------------------------------------------------------------
# weighted-fair queuing
# ---------------------------------------------------------------------------


class WeightedFairQueue:
    """Strict priority classes; start-time fair queuing within a class.

    ``push`` assigns a virtual finish tag ``max(vtime, tenant_last) +
    cost / weight``; ``pop`` serves the (priority, finish-tag) minimum
    and advances virtual time.  Under saturation each tenant's served
    cost converges to its weight share — the classic SCFQ bound.  Not
    thread-safe (the engine calls it under its own lock)."""

    def __init__(self):
        self._vtime = 0.0
        self._tenant_vf: dict[str, float] = {}
        self._heap: list = []
        self._n = itertools.count()

    def push(self, item, *, tenant: str, cost: float,
             weight: float = 1.0, priority: int = 0) -> None:
        vf = max(self._vtime, self._tenant_vf.get(tenant, 0.0)) \
            + float(cost) / max(float(weight), 1e-9)
        self._tenant_vf[tenant] = vf
        heapq.heappush(self._heap, (int(priority), vf, next(self._n), item))

    def pop(self):
        prio, vf, _, item = heapq.heappop(self._heap)
        self._vtime = max(self._vtime, vf)
        return item

    def __len__(self) -> int:
        return len(self._heap)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DecodeConfig:
    """Scheduler knobs.  ``token_budget`` is the per-round spend across
    both batch classes: the decode batch (1 token per ready sequence)
    takes what it needs first — admitted sequences keep streaming under
    load — and prefills consume the rest at prompt-length cost (the
    head-of-line prefill always runs, even oversized, so long prompts
    cannot starve)."""

    max_new_tokens: int = 16
    token_budget: int = 256
    max_decode_batch: int = 8
    max_prefill_seqs: int = 2
    max_sequences: int = 64            # admission bound on live sequences
    default_deadline_s: float = 30.0
    eos_token: int | None = None
    use_ring_prefill: bool = True
    min_ring_tokens: int | None = None
    poll_s: float = 0.02               # idle loop wait
    retry_after_s: float = 0.05
    drain_timeout_s: float = 30.0


@dataclasses.dataclass
class _Seq:
    seq_id: int
    tenant: str
    priority: int
    tokens: list[int]
    prompt_len: int
    max_new: int
    deadline: float
    stream: TokenStream
    enqueued: float
    state: str = "prefill"       # prefill | active | done/failed/cancelled
    inflight: bool = False
    generated: int = 0
    re_prefill: bool = False     # evicted at least once: rebuild-only
    last_step: float = 0.0
    first_token_at: float | None = None


class DecodeEngine:
    """Continuous-batching decode over a paged KV cache.  See the module
    docstring for the scheduling and resilience contracts."""

    def __init__(self, model: TinyLM | None = None,
                 cache: PagedKVCache | None = None,
                 config: DecodeConfig | None = None, *,
                 policy: recovery.RetryPolicy | None = None,
                 devices=None, name: str = "decode"):
        self.model = model or TinyLM()
        if cache is None:
            cache = PagedKVCache(KVCacheConfig(
                heads=self.model.heads, head_dim=self.model.head_dim))
        self.cache = cache
        self.config = config or DecodeConfig()
        self.name = name
        self._policy = policy
        self._devices = devices if devices is not None else elastic.manager()
        self._lock = threading.RLock()
        self._seqs: dict[int, _Seq] = {}
        self._prefill = WeightedFairQueue()
        self._weights: dict[str, float] = {}
        self._service: dict[str, float] = {}   # per-tenant tokens served
        self._ids = itertools.count(1)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._draining = False
        self._closed = False

    # -- admission -----------------------------------------------------------

    def set_weight(self, tenant: str, weight: float) -> None:
        """WFQ weight for ``tenant`` (default 1.0; higher = more prefill
        service under contention)."""
        with self._lock:
            self._weights[tenant] = float(weight)

    def submit(self, prompt, *, tenant: str = "default", priority: int = 0,
               deadline_s: float | None = None,
               max_new_tokens: int | None = None) -> TokenStream:
        """Admit one sequence; returns its :class:`TokenStream` or
        raises a typed rejection (:class:`Draining`,
        :class:`Overloaded` with ``retry_after``, :class:`Rejected` for
        prompts the pool can never hold)."""
        if isinstance(prompt, torch.Tensor):
            prompt = prompt.detach().cpu().numpy()
        toks = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not toks:
            raise ServeError("empty prompt")
        _tm.count("serve.decode.submitted", tenant=tenant)
        max_new = int(self.config.max_new_tokens if max_new_tokens is None
                      else max_new_tokens)
        budget = (self.config.default_deadline_s if deadline_s is None
                  else float(deadline_s))
        with self._lock:
            if self._draining or self._closed:
                _tm.count("serve.shed", reason="draining", tenant=tenant)
                raise Draining(tenant=tenant)
            if self.cache.pages_for(len(toks) + max_new) > \
                    self.cache.capacity_pages():
                _tm.count("serve.shed", reason="kv", tenant=tenant)
                raise Rejected(
                    f"prompt of {len(toks)} tokens (+{max_new} new) "
                    f"exceeds the cache's {self.cache.capacity_pages()} "
                    "page capacity", reason="kv", tenant=tenant)
            if len(self._seqs) >= self.config.max_sequences:
                ra = self.config.retry_after_s
                _tm.count("serve.shed", reason="queue", tenant=tenant)
                raise Overloaded(
                    f"{len(self._seqs)} live sequences at bound "
                    f"{self.config.max_sequences}; retry in {ra:.3f}s",
                    retry_after=ra, reason="queue", tenant=tenant)
            sid = next(self._ids)
            now = time.monotonic()
            stream = TokenStream(sid, tenant, len(toks), self.cancel)
            seq = _Seq(seq_id=sid, tenant=tenant, priority=int(priority),
                       tokens=toks, prompt_len=len(toks), max_new=max_new,
                       deadline=now + budget, stream=stream, enqueued=now)
            self._seqs[sid] = seq
            self._prefill.push(sid, tenant=tenant, cost=float(len(toks)),
                               weight=self._weights.get(tenant, 1.0),
                               priority=int(priority))
            self._ensure_loop()
        self._wake.set()
        return stream

    def cancel(self, seq_id: int) -> bool:
        """Abandon a sequence: pages return to the pool before this
        returns; the stream resolves :class:`~.errors.Cancelled`."""
        with self._lock:
            seq = self._seqs.pop(seq_id, None)
            if seq is None:
                return False
            seq.state = "cancelled"
            self.cache.release(seq_id)
            _tm.count("serve.decode.cancelled", tenant=seq.tenant)
        seq.stream._finish(Cancelled(f"sequence {seq_id} cancelled"))
        return True

    # -- server integration --------------------------------------------------

    def attach(self, server, name: str | None = None, *,
               max_batch: int | None = None, flush_s: float | None = None):
        """Register this engine as a batched :class:`~.server.Server`
        endpoint and wire the cache's reclaimable-bytes signal into the
        server's admission controller (HBM sheds then ship an
        eviction-aware ``retry_after``).  The endpoint resolves each
        payload to its :class:`TokenStream` — admission is the server's
        job; token generation streams through the engine loop."""
        name = name or self.name

        def _fn(payloads: list) -> list:
            return [self._submit_payload(p) for p in payloads]

        ep = server.register(name, _fn, max_batch=max_batch,
                             flush_s=flush_s,
                             key_fn=lambda _p: ("decode", name))
        server.set_reclaimable(self.cache.idle_evictable_bytes)
        return ep

    def _submit_payload(self, p) -> TokenStream:
        if isinstance(p, dict):
            return self.submit(
                p["prompt"], tenant=p.get("tenant", "default"),
                priority=p.get("priority", 0),
                deadline_s=p.get("deadline_s"),
                max_new_tokens=p.get("max_new_tokens"))
        return self.submit(p)

    # -- scheduler loop ------------------------------------------------------

    def _ensure_loop(self) -> None:
        with self._lock:
            if self._thread is not None or self._closed:
                return
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"serve-decode-{self.name}")
            self._thread.start()

    def _device(self) -> torch.device:
        """Where the engine computes: the first live rank's device."""
        return L.device_of(self._devices.live_ranks()[0])

    def _loop(self) -> None:
        dev = self._device()
        if dev.type == "cuda":
            torch.cuda.set_device(dev)   # this thread's kernels and streams
        while not self._stop.is_set():
            try:
                did = self._round()
            except Exception:  # noqa: BLE001 — the loop must not die silent
                _tm.count("serve.decode.loop_errors")
                did = False
            if not did:
                with self._lock:
                    if (self._draining or self._closed) \
                            and not self._seqs:
                        return
                self._wake.wait(self.config.poll_s)
                self._wake.clear()

    def _round(self) -> bool:
        """One scheduling round: deadline sweep, budget eviction sweep,
        decode batch, then prefill picks under the remaining token
        budget.  Returns whether any work was dispatched."""
        finished: list[tuple[TokenStream, BaseException | None]] = []
        with self._lock:
            now = time.monotonic()
            for s in list(self._seqs.values()):
                if s.inflight or s.state not in ("prefill", "active"):
                    continue
                if now > s.deadline:
                    stage = "decode" if s.state == "active" else "prefill"
                    finished.append(self._finish_locked(
                        s, DeadlineExceeded(
                            f"sequence {s.seq_id} deadline expired after "
                            f"{s.generated} tokens", stage=stage)))
            for sid in self.cache.maybe_evict():
                self._on_evicted_locked(sid)
            budget = self.config.token_budget
            ready = [s for s in self._seqs.values()
                     if s.state == "active" and not s.inflight]
            ready.sort(key=lambda s: (s.priority, s.last_step))
            dec = ready[:max(0, min(self.config.max_decode_batch, budget))]
            for s in dec:
                s.inflight = True
                self.cache.pin(s.seq_id)
            budget -= len(dec)
            pre: list[_Seq] = []
            while len(self._prefill) and \
                    len(pre) < self.config.max_prefill_seqs:
                sid = self._prefill.pop()
                s = self._seqs.get(sid)
                if s is None or s.state != "prefill" or s.inflight:
                    continue
                cost = len(s.tokens)
                if pre and cost > budget:
                    # head-of-line (first pick) always runs; later picks
                    # respect the round budget — push back for next round
                    self._prefill.push(
                        sid, tenant=s.tenant, cost=float(cost),
                        weight=self._weights.get(s.tenant, 1.0),
                        priority=s.priority)
                    break
                s.inflight = True
                pre.append(s)
                budget -= cost
        for stream, err in finished:
            stream._finish(err)
        if dec:
            self._dispatch_decode(dec)
        if pre:
            self._dispatch_prefill(pre)
        return bool(dec or pre or finished)

    # -- bookkeeping (engine lock held) --------------------------------------

    def _finish_locked(self, s: _Seq, error: BaseException | None):
        """Terminal transition: release pages, drop the record; the
        caller fires the stream OUTSIDE the lock."""
        s.state = "failed" if error is not None else "done"
        self._seqs.pop(s.seq_id, None)
        self.cache.release(s.seq_id)
        if error is None:
            _tm.count("serve.decode.completed", tenant=s.tenant)
            _tm.observe("serve.decode.request_s",
                        time.monotonic() - s.enqueued, endpoint=self.name)
        else:
            _tm.count("serve.decode.failed", tenant=s.tenant,
                      kind=type(error).__name__)
        return (s.stream, error)

    def _on_evicted_locked(self, sid: int) -> None:
        """An eviction (budget sweep or allocation pressure) freed this
        sequence's pages: it re-enters the prefill class and rebuilds —
        bit-identically, since K/V are a function of the token history."""
        s = self._seqs.get(sid)
        if s is None or s.state not in ("prefill", "active"):
            return
        s.state = "prefill"
        s.re_prefill = True
        _tm.count("serve.decode.evicted", tenant=s.tenant)
        self._prefill.push(sid, tenant=s.tenant, cost=float(len(s.tokens)),
                           weight=self._weights.get(s.tenant, 1.0),
                           priority=s.priority)

    def _served_locked(self, tenant: str, cost: float) -> None:
        self._service[tenant] = self._service.get(tenant, 0.0) + cost

    # -- dispatch: decode (HBM-bound) ----------------------------------------

    def _dispatch_decode(self, batch: list[_Seq]) -> None:
        model = self.model
        ctx_total = sum(len(s.tokens) for s in batch)
        t0 = time.monotonic()
        try:
            with _tm.span("serve.decode", endpoint=self.name,
                          size=len(batch),
                          **_perf.decode_step_cost(
                              ctx_total, model.heads, model.head_dim,
                              4, new_tokens=len(batch))):
                def _run():
                    # chaos site: a fault plan can down a device
                    # mid-step; recovery probes, shrinks (re-laying the
                    # cache pages onto survivors) and re-invokes
                    _fl.check("serve.decode", size=len(batch))
                    outs = []
                    for s in batch:
                        try:
                            K, V = self.cache.read(s.seq_id)
                        except ServeError:
                            # cancelled mid-flight: its pages are gone
                            outs.append(None)
                            continue
                        qr, _, _ = model.qkv([s.tokens[-1]],
                                             len(s.tokens) - 1, K.device)
                        out = _decode_attention(qr[0], K, V)
                        outs.append(_argmax(model.logits(out)))
                    return outs
                toks = recovery.run_with_recovery(
                    _run, policy=self._policy, devices=self._devices,
                    stop_event=self._stop)
        except recovery.MinorityPartitionExit as e:
            self._partition_drain(batch, e)
            return
        except Exception as e:  # noqa: BLE001 — typed onto the streams
            self._fail_batch(batch, e)
            return
        self._apply_decode(batch, toks, time.monotonic() - t0)

    def _apply_decode(self, batch: list[_Seq], toks: list,
                      dt: float) -> None:
        dev = self._device()
        finished = []
        pushes: list[tuple[TokenStream, int]] = []
        with self._lock:
            for s, t in zip(batch, toks):
                s.inflight = False
                s.last_step = time.monotonic()
                self.cache.unpin(s.seq_id)
                if s.state != "active" or t is None:
                    continue
                pos = len(s.tokens)
                s.tokens.append(int(t))
                s.generated += 1
                self._served_locked(s.tenant, 1.0)
                pushes.append((s.stream, int(t)))
                _tm.count("serve.decode.tokens", tenant=s.tenant)
                if _tm.enabled():
                    _tm.observe("serve.decode.token_s", dt,
                                endpoint=self.name)
                    _tm.observe("serve.slo.request_s", dt,
                                buckets=_SLO_BUCKETS,
                                endpoint=f"{self.name}.decode")
                done = (s.generated >= s.max_new
                        or (self.config.eos_token is not None
                            and int(t) == self.config.eos_token))
                if done:
                    finished.append(self._finish_locked(s, None))
                    continue
                _, kr, vr = self.model.qkv([int(t)], pos, dev)
                try:
                    for sid in self.cache.ensure(s.seq_id, pos + 1,
                                                 tenant=s.tenant):
                        self._on_evicted_locked(sid)
                    self.cache.write(s.seq_id, pos, kr, vr)
                except Overloaded:
                    # the pool cannot hold even this sequence's next
                    # page: it joins the evicted set and rebuilds when
                    # pressure clears (the emitted token stands)
                    self.cache.release(s.seq_id)
                    self._on_evicted_locked(s.seq_id)
        for stream, t in pushes:
            stream._push(t)
        for stream, err in finished:
            stream._finish(err)
        self._wake.set()

    # -- dispatch: prefill (compute-bound) -----------------------------------

    def _dispatch_prefill(self, batch: list[_Seq]) -> None:
        for s in batch:
            self._prefill_one(s)
        self._wake.set()

    def _prefill_one(self, s: _Seq) -> None:
        model = self.model
        ntok = len(s.tokens)
        # capacity first, OUTSIDE the recovery closure: a typed
        # Overloaded is backpressure, not a transient to retry
        try:
            with self._lock:
                for sid in self.cache.ensure(s.seq_id, ntok + 1,
                                             tenant=s.tenant):
                    self._on_evicted_locked(sid)
                self.cache.pin(s.seq_id)
        except Overloaded:
            # every page is pinned by in-flight work: stay queued; the
            # next round's eviction/completions free room
            with self._lock:
                s.inflight = False
                if s.state == "prefill":
                    _tm.count("serve.decode.kv_wait", tenant=s.tenant)
                    self._prefill.push(
                        s.seq_id, tenant=s.tenant, cost=float(ntok),
                        weight=self._weights.get(s.tenant, 1.0),
                        priority=s.priority)
            return
        except Rejected as e:
            with self._lock:
                finished = self._finish_locked(s, e)
            finished[0]._finish(finished[1])
            return
        rebuild = s.re_prefill
        t0 = time.monotonic()
        try:
            with _tm.span("serve.prefill", endpoint=self.name, ntok=ntok,
                          rebuild=rebuild,
                          **_perf.attention_cost(
                              ntok, model.heads, model.head_dim, 4,
                              causal=True)):
                def _run():
                    # chaos site: device loss mid-prefill probes,
                    # shrinks, and re-invokes this closure
                    _fl.check("serve.prefill", ntok=ntok)
                    qr, kr, vr = model.qkv(s.tokens, 0, self._device())
                    first = None
                    if not rebuild:
                        if self.config.use_ring_prefill:
                            from ..models.ring_attention import \
                                ring_attention_prefill
                            out = ring_attention_prefill(
                                qr, kr, vr, causal=True,
                                procs=self._devices.live_ranks(),
                                min_ring_tokens=self.config
                                .min_ring_tokens)
                        else:
                            from ..models.ring_attention import \
                                reference_attention
                            out = reference_attention(qr, kr, vr, True)
                        first = _argmax(model.logits(out[-1]))
                    return kr, vr, first
                kr, vr, first = recovery.run_with_recovery(
                    _run, policy=self._policy, devices=self._devices,
                    stop_event=self._stop)
        except recovery.MinorityPartitionExit as e:
            self._partition_drain([s], e)
            return
        except Exception as e:  # noqa: BLE001 — typed onto the stream
            self._fail_batch([s], e)
            return
        dt = time.monotonic() - t0
        finished = []
        push = None
        with self._lock:
            s.inflight = False
            s.last_step = time.monotonic()
            self.cache.unpin(s.seq_id)
            if s.state != "prefill":
                return
            try:
                # the K/V write-back: all rows the closure computed
                # (prompt on a fresh prefill; prompt + generated on a
                # rebuild — bit-identical to the incremental original)
                self.cache.write(s.seq_id, 0, kr, vr)
                if first is not None:
                    pos = len(s.tokens)
                    s.tokens.append(first)
                    s.generated += 1
                    _, k1, v1 = model.qkv([first], pos, kr.device)
                    self.cache.write(s.seq_id, pos, k1, v1)
                    push = (s.stream, first)
                    s.first_token_at = time.monotonic()
                    self._served_locked(s.tenant, float(ntok) + 1.0)
                    _tm.count("serve.decode.tokens", tenant=s.tenant)
                    if _tm.enabled():
                        ttft = s.first_token_at - s.enqueued
                        _tm.observe("serve.decode.ttft_s", ttft,
                                    endpoint=self.name)
                        _tm.observe("serve.slo.request_s", dt,
                                    buckets=_SLO_BUCKETS,
                                    endpoint=f"{self.name}.prefill")
                else:
                    self._served_locked(s.tenant, float(ntok))
                s.state = "active"
                if s.generated >= s.max_new or \
                        (self.config.eos_token is not None and s.tokens
                         and s.tokens[-1] == self.config.eos_token
                         and s.generated > 0):
                    finished.append(self._finish_locked(s, None))
            except ServeError as e:
                finished.append(self._finish_locked(s, e))
        if push is not None:
            push[0]._push(push[1])
        for stream, err in finished:
            stream._finish(err)

    # -- failure paths -------------------------------------------------------

    def _fail_batch(self, batch: list[_Seq], exc: Exception) -> None:
        finished = []
        with self._lock:
            for s in batch:
                s.inflight = False
                self.cache.unpin(s.seq_id)
                if s.state not in ("prefill", "active"):
                    continue
                err = exc if isinstance(exc, ServeError) else RequestFailed(
                    f"decode dispatch failed after recovery gave up "
                    f"(seq={s.seq_id}): {type(exc).__name__}: {exc}")
                if err is not exc:
                    err.__cause__ = exc
                finished.append(self._finish_locked(s, err))
        for stream, err in finished:
            stream._finish(err)

    def _partition_drain(self, batch: list[_Seq],
                         e: recovery.MinorityPartitionExit) -> None:
        """Minority side of a partition: drain typed (clients fail over,
        they do not wait out a timeout)."""
        with self._lock:
            self._draining = True
        _tm.count("serve.partition_drains")
        if _tm.enabled():
            extra = {"incident": e.incident} if e.incident else {}
            _tm.event("serve", "partition_drain", side=e.side, lost=e.lost,
                      endpoint=self.name, **extra)
        finished = []
        with self._lock:
            for s in list(self._seqs.values()):
                err = Draining("decode engine lost partition quorum; "
                               "draining")
                err.__cause__ = e
                finished.append(self._finish_locked(s, err))
        for stream, err in finished:
            stream._finish(err)
        self._wake.set()

    # -- lifecycle -----------------------------------------------------------

    def drain(self, timeout: float | None = None) -> bool:
        """Stop admitting; let live sequences finish.  True when the
        engine emptied within ``timeout``."""
        with self._lock:
            self._draining = True
        self._wake.set()
        deadline = time.monotonic() + (self.config.drain_timeout_s
                                       if timeout is None else timeout)
        while time.monotonic() < deadline:
            with self._lock:
                if not self._seqs:
                    return True
            time.sleep(0.01)
        with self._lock:
            return not self._seqs

    def close(self, *, drain: bool = True,
              timeout: float | None = None) -> None:
        """Shut down: optionally drain, stop the loop, fail whatever is
        left typed (:class:`Draining`), release the cache."""
        if drain:
            self.drain(timeout)
        with self._lock:
            self._closed = True
            self._draining = True
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(2.0)
        finished = []
        with self._lock:
            for s in list(self._seqs.values()):
                finished.append(self._finish_locked(
                    s, Draining("decode engine closed before this "
                                "sequence completed")))
        for stream, err in finished:
            stream._finish(err)
        self.cache.close()

    def __enter__(self) -> "DecodeEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            states: dict[str, int] = {}
            for s in self._seqs.values():
                states[s.state] = states.get(s.state, 0) + 1
            return {
                "sequences": len(self._seqs),
                "states": states,
                "prefill_queued": len(self._prefill),
                "service_by_tenant": dict(self._service),
                "cache": self.cache.stats(),
                "draining": self._draining,
                "closed": self._closed,
            }
