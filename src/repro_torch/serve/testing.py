"""A real TCP evaluation server on a background thread, for sync drivers.

Tests, benchmarks, and the ``client-smoke`` verify step all need the same
thing: a live socket endpoint speaking the serve protocol while the driving
code stays synchronous.  :class:`ServerThread` boots an event loop on a
daemon thread, creates the :class:`~repro_torch.serve.service.EvaluationService`
*inside* that loop (the service is single-loop by design), starts the TCP
front-end on an ephemeral port, and tears everything down gracefully —
stop accepting, drain in-flight batches — on :meth:`close`.

    >>> from repro_torch.serve.testing import ServerThread
    >>> with ServerThread(service_kw={"device": "cpu"}) as srv:
    ...     _ = srv.register_qrel("t", {"q1": {"d1": 1}}, ("map",))
    ...     isinstance(srv.port, int)
    True
"""

from __future__ import annotations

import asyncio
import threading
from typing import Optional

from repro_torch.serve.frontend import close_server, serve_tcp
from repro_torch.serve.service import EvaluationService


class ServerThread:
    """Run ``EvaluationService`` + ``serve_tcp`` on a private loop thread.

    Keyword arguments split by destination: ``service_kw`` goes to the
    :class:`EvaluationService` constructor, everything else in ``tcp_kw``
    to :func:`serve_tcp` (``limit``, ``auth_token``, ``rate_limit``,
    ``burst``).  The server listens on ``127.0.0.1`` at an ephemeral port
    (:attr:`port`).  Start-up waits at most 30 s and :meth:`close` at most
    30 s for the drain (of which at most ``CLOSE_TIMEOUT`` for connected
    clients to hang up) plus 10 s for the thread; every :meth:`call` takes
    its own timeout.
    """

    def __init__(self, *, service_kw: Optional[dict] = None, **tcp_kw):
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="repro-torch-serve-thread")
        self._thread.start()

        async def boot():
            service = EvaluationService(**(service_kw or {}))
            server = await serve_tcp(service, "127.0.0.1", 0, **tcp_kw)
            return service, server

        try:
            self.service, self._server = self.call(boot(), timeout=30)
        except BaseException:
            # a service that failed to start (CUDA asked for on a host
            # without it, say) leaves no loop thread behind
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(10)
            self._loop.close()
            raise
        self.host = "127.0.0.1"
        self.port = self._server.sockets[0].getsockname()[1]

    def _run(self) -> None:
        asyncio.set_event_loop(self._loop)
        self._loop.run_forever()

    # -- sync facade ---------------------------------------------------------

    def call(self, coro, timeout: float = 60):
        """Run a coroutine on the server loop; block for its result."""
        return asyncio.run_coroutine_threadsafe(coro, self._loop).result(
            timeout)

    def register_qrel(self, *args, **kw) -> dict:
        async def _do():
            return self.service.register_qrel(*args, **kw)
        return self.call(_do())

    def register_run(self, *args, **kw) -> dict:
        async def _do():
            return self.service.register_run(*args, **kw)
        return self.call(_do())

    def stats(self) -> dict:
        async def _do():
            return self.service.stats()
        return self.call(_do())

    def close(self) -> None:
        """Graceful shutdown: stop accepting, drain, stop the loop."""
        if self._thread.is_alive():
            async def _shutdown():
                # at most CLOSE_TIMEOUT for clients to hang up (3.12's
                # wait_closed would wait on a connected client for ever)
                await close_server(self._server)
                await self.service.drain()
                # let connection handlers run their finally blocks before
                # the loop stops (bounded: an idle client's never ends)
                others = [t for t in asyncio.all_tasks()
                          if t is not asyncio.current_task()]
                if others:
                    await asyncio.wait(others, timeout=1)
            self.call(_shutdown(), timeout=30)
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(10)
        if not self._loop.is_running():
            self._loop.close()

    def __enter__(self) -> "ServerThread":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
