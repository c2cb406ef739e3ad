"""Client library for the ``repro_torch.serve`` evaluation service.

The serving thesis (docs/SERVING.md) only pays off if clients keep ONE
connection open and keep it full: the server coalesces whatever is in
flight *together*, so a connect-per-request client never batches.  This
package is the supported way to talk to the service:

* :class:`~repro_torch.client.aio.AsyncEvalClient` — asyncio-native, pipelined,
  request-id correlated, with automatic reconnect-and-retry for idempotent
  operations;
* :class:`~repro_torch.client.sync.EvalClient` — the blocking facade (private
  loop thread) with :meth:`~repro_torch.client.sync.EvalClient.evaluate_many`
  and :meth:`~repro_torch.client.sync.EvalClient.submit` for pipelining;
* the error taxonomy (:mod:`repro_torch.client.errors`): ``ServerError`` /
  ``AuthError`` (the server said no), ``ConnectionLostError`` (the wire
  died, retries exhausted), ``ProtocolError`` (unintelligible peer).

Transports: TCP (``connect(host, port)``) and a private stdio subprocess
(``spawn_stdio()``), both speaking the same JSON-lines protocol with the
same frame limit (``repro_torch.serve.wire.DEFAULT_FRAME_LIMIT``, 64 MiB — large
qrel/run payloads are first-class, not a crash).

>>> from repro_torch.serve.testing import ServerThread
>>> from repro_torch.client import EvalClient
>>> with ServerThread(service_kw={'device': 'cpu'}) as srv:
...     _ = srv.register_qrel('web', {'q1': {'d1': 1}}, ('recip_rank',))
...     with EvalClient(srv.host, srv.port) as client:
...         client.ping()
...         res = client.evaluate('web', run={'q1': {'d1': 1.0}})
'pong'
>>> res.per_query['q1']['recip_rank']
1.0
"""

from repro_torch.client.aio import AsyncEvalClient, EvalResult, IDEMPOTENT_OPS
from repro_torch.client.errors import (AuthError, ClientError,
                                 ConnectionLostError, DeadlineExceededError,
                                 ProtocolError, ServerError,
                                 WorkerUnavailableError)
from repro_torch.client.sync import EvalClient

__all__ = [
    "AsyncEvalClient",
    "EvalClient",
    "EvalResult",
    "IDEMPOTENT_OPS",
    "ClientError",
    "ServerError",
    "AuthError",
    "ConnectionLostError",
    "DeadlineExceededError",
    "ProtocolError",
    "WorkerUnavailableError",
]
