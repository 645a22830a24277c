"""Asyncio front-end for the serving layer.

PyTorch counterpart of ``distributedarrays_tpu/serve/aio.py`` (the same
three calls).

The server and engine are thread-based (dispatch loops own the GIL story
near the device runtime); a web front-end is usually an event loop.
This module is the bridge, with the same typed-error contract:

- :func:`submit` — awaitable wrapper over ``Server.submit`` (the
  ``concurrent.futures.Future`` adapted via ``asyncio.wrap_future``;
  typed rejections raise immediately in the caller's task).
- :func:`stream_tokens` — async iterator over a
  :class:`~.decode.TokenStream`: tokens are forwarded from the engine
  thread onto the event loop via ``loop.call_soon_threadsafe`` (history
  replays first, so a late subscriber misses nothing).  Cancelling the
  consuming task cancels the *sequence* — its KV pages free immediately.
- :func:`generate` — the end-to-end decode call: submit through the
  server's admission gates, await the stream handle, then yield tokens.

No event loop is ever blocked: every wait point is an ``await``.
"""

from __future__ import annotations

import asyncio
from typing import Any, AsyncIterator

from .decode import TokenStream

__all__ = ["submit", "stream_tokens", "generate"]


async def submit(server, endpoint: str, payload: Any, **kw) -> Any:
    """Awaitable ``Server.submit``: returns the resolved result or
    raises the typed ``ServeError`` the request ended with.  Admission
    rejections (``Overloaded``/``QuotaExceeded``/``Draining``) raise
    right here, before any await."""
    fut = server.submit(endpoint, payload, **kw)
    return await asyncio.wrap_future(fut)


async def stream_tokens(stream: TokenStream,
                        *, cancel_on_exit: bool = True
                        ) -> AsyncIterator[int]:
    """Async-iterate a :class:`TokenStream`.  The engine thread's
    pushes land on the event loop threadsafe; a typed terminal error
    re-raises in the consumer.  When the consuming task is cancelled
    (client disconnect), the sequence is cancelled too — pages free
    immediately — unless ``cancel_on_exit=False``."""
    loop = asyncio.get_running_loop()
    q: asyncio.Queue = asyncio.Queue()

    def _cb(kind: str, value) -> None:
        loop.call_soon_threadsafe(q.put_nowait, (kind, value))

    stream.add_listener(_cb)
    try:
        while True:
            kind, value = await q.get()
            if kind == "token":
                yield value
            else:               # ("done", error_or_None)
                if value is not None:
                    raise value
                return
    finally:
        if cancel_on_exit and not stream.done():
            stream.cancel()


async def generate(server, prompt, *, endpoint: str = "decode",
                   tenant: str = "default", **kw) -> AsyncIterator[int]:
    """Submit a decode request through the server's admission gates and
    stream its tokens.  ``kw`` passes through to ``Server.submit``
    (``deadline_s``, ``trace_id``, ...); the payload may be a bare
    prompt or a dict with per-sequence knobs."""
    handle = await submit(server, endpoint, prompt, tenant=tenant, **kw)
    if not isinstance(handle, TokenStream):
        raise TypeError(f"endpoint {endpoint!r} did not return a "
                        f"TokenStream (got {type(handle).__name__}); "
                        "is a DecodeEngine attached?")
    async for tok in stream_tokens(handle):
        yield tok
