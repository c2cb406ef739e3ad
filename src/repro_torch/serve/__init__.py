"""Async evaluation serving on the tokenized (``RunBuffer``) path.

The paper makes single evaluations cheap; this package makes MANY concurrent
evaluations cheap: an asyncio service that interns each qrel once (bounded
LRU of evaluators), coalesces concurrent requests for the same collection
into one batched backend call, and answers over stdio or TCP JSON-lines.

    >>> import asyncio
    >>> from repro_torch.serve import EvaluationService
    >>> async def demo():
    ...     svc = EvaluationService(device='cpu')
    ...     svc.register_qrel('t', {'q1': {'d1': 1}}, ('recip_rank',))
    ...     res = await svc.evaluate('t', run={'q1': {'d1': 1.0}})
    ...     return res.per_query['q1']['recip_rank']
    >>> asyncio.run(demo())
    1.0

See ``docs/SERVING.md`` for the request lifecycle, coalescing windows,
cache-eviction and backpressure semantics, and the wire protocol (frame
limits, error codes, auth, rate limiting — :mod:`repro_torch.serve.wire`);
``python -m repro_torch.serve --help`` for the front-end flags.  The client side
of the protocol lives in :mod:`repro_torch.client` (persistent connections,
pipelining, reconnect-with-retry).
"""

from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.cache import LRUCache
from repro_torch.serve.frontend import (handle_line, handle_request, main,
                                  serve_protocol, serve_stdio, serve_tcp)
from repro_torch.serve.service import EvaluationService, ServeResult
from repro_torch.serve.wire import (DEFAULT_FRAME_LIMIT, ERROR_CODES,
                              OversizedFrame, ProtocolError, TokenBucket,
                              iter_frames)

__all__ = [
    "EvaluationService",
    "ServeResult",
    "MicroBatcher",
    "LRUCache",
    "handle_request",
    "handle_line",
    "serve_tcp",
    "serve_protocol",
    "serve_stdio",
    "main",
    "DEFAULT_FRAME_LIMIT",
    "ERROR_CODES",
    "OversizedFrame",
    "ProtocolError",
    "TokenBucket",
    "iter_frames",
]
