"""Multi-tenant async serving layer over resident sharded model state.

PyTorch counterpart of ``distributedarrays_tpu/serve`` (its whole
``__all__``): admission, continuous batching, deadlines, typed errors,
drain, the paged KV cache over port DArrays and the decode engine, whose
prefill runs the ring attention kernel (K9) on two or more ranks.

Quick use::

    from distributedarrays_tpu_torch import serve

    srv = serve.Server(serve.ServeConfig(max_batch=8, max_queue=64))
    srv.register("score", lambda xs: [score_one(x) for x in xs])
    fut = srv.submit("score", x, tenant="team-a", deadline_s=0.5)
    y = fut.result()          # result, or a typed ServeError
    srv.close()               # graceful: stop admitting, flush, stop

LLM decode (paged KV cache + continuous batching)::

    eng = serve.DecodeEngine()            # toy model; pass your own
    eng.attach(srv, "decode")             # server admission fronts it
    stream = srv.submit("decode", [1, 2, 3]).result()
    for tok in stream:                    # tokens as they land
        ...

The JAX package's docs/serving.md walks through the architecture, the
admission and shedding knobs and the deadline semantics, which this
package keeps.  Asyncio front-end: ``serve.aio``.
"""

from . import aio
from .admission import AdmissionController, LatencyWindow, TokenBucket
from .batching import BatchQueue, Request, payload_key
from .decode import (DecodeConfig, DecodeEngine, TinyLM, TokenStream,
                     WeightedFairQueue)
from .errors import (Cancelled, DeadlineExceeded, Draining, Overloaded,
                     QuotaExceeded, Rejected, RequestFailed, ServeError)
from .kvcache import KVCacheConfig, PagedKVCache
from .server import Endpoint, ServeConfig, Server, install_sigterm

__all__ = [
    "Server", "ServeConfig", "Endpoint", "install_sigterm",
    "AdmissionController", "LatencyWindow", "TokenBucket",
    "BatchQueue", "Request", "payload_key",
    "KVCacheConfig", "PagedKVCache",
    "DecodeConfig", "DecodeEngine", "TinyLM", "TokenStream",
    "WeightedFairQueue", "aio",
    "ServeError", "Rejected", "Overloaded", "QuotaExceeded", "Draining",
    "DeadlineExceeded", "Cancelled", "RequestFailed",
]
