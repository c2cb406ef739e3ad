"""A live cluster (router + worker subprocesses) on a background thread.

The cluster analogue of :class:`repro_torch.serve.testing.ServerThread`,
for synchronous callers (tests, ``chip_smoke.py``): boots a
:class:`~repro_torch.serve.cluster.router.Router` and its worker pool on a
private event-loop thread, exposes the router's TCP endpoint, and tears
the whole tree down gracefully on :meth:`close` (listener → router drain
→ SIGTERM to every worker), with every wait bounded.

    >>> from repro_torch.serve.cluster.testing import ClusterThread
    >>> args = ["--device", "cpu"]
    >>> with ClusterThread(2, worker_args=args) as c:  # doctest: +SKIP
    ...     c.owner_of("robust04") in c.worker_names
    True

(Skipped in doctest runs: booting a worker costs a torch import; the real
coverage lives in ``tests/test_torch_cluster.py``.)
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import signal
import threading
from typing import List, Optional, Sequence, Tuple

from repro_torch.serve.cluster.router import Router
from repro_torch.serve.frontend import close_server, serve_protocol

#: seconds :meth:`ClusterThread.close` gives the whole graceful shutdown
SHUTDOWN_TIMEOUT = 120.0


class ClusterThread:
    """Run a router + worker pool on a private loop thread.

    ``worker_args`` go on every worker's command line (``["--device",
    "cpu"]`` off the card: a worker's default device is CUDA);
    ``router_kw`` goes to the :class:`Router` constructor (``retries``,
    ``health_interval``, ``replication``, ...); remaining keywords in
    ``tcp_kw`` go to :func:`serve_protocol` (``limit``, ``auth_token``,
    ``rate_limit``, ``burst``).  The router listens on ``127.0.0.1`` at an
    ephemeral :attr:`port`.

    Bounds: the boot waits at most ``boot_timeout`` seconds; every
    :meth:`call` takes its own timeout; :meth:`close` waits at most
    ``CLOSE_TIMEOUT`` (:mod:`repro_torch.serve.frontend`) for connected
    clients to hang up, then the router's drain (30 s for in-flight
    requests, then at most 15 s for each worker's own SIGTERM drain before
    a SIGKILL), all of it within :data:`SHUTDOWN_TIMEOUT`, then 10 s to
    join the thread.  A worker process still alive after that is
    SIGKILLed, so none outlives :meth:`close`.
    """

    def __init__(self, n_workers: int = 2, *,
                 worker_args: Sequence[str] = (),
                 router_kw: Optional[dict] = None, boot_timeout: float = 120,
                 **tcp_kw):
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="repro-torch-cluster-thread")
        self._thread.start()
        self.router: Optional[Router] = None
        self._server = None

        async def boot():
            # published before start() so that close() finds the workers
            # of a boot that failed or timed out
            self.router = Router(n_workers, worker_args=worker_args,
                                 **(router_kw or {}))
            await self.router.start()
            self._server = await serve_protocol(self.router.handle,
                                                "127.0.0.1", 0, **tcp_kw)

        try:
            self.call(boot(), timeout=boot_timeout)
        except BaseException:
            self.close()
            raise
        self.host = "127.0.0.1"
        self.port = self._server.sockets[0].getsockname()[1]

    def _run(self) -> None:
        asyncio.set_event_loop(self._loop)
        self._loop.run_forever()

    # -- sync facade ---------------------------------------------------------

    def call(self, coro, timeout: float = 60):
        """Run a coroutine on the cluster loop; block for its result."""
        return asyncio.run_coroutine_threadsafe(coro, self._loop).result(
            timeout)

    def stats(self) -> dict:
        return self.call(self.router.stats())

    def health(self) -> dict:
        async def _do():
            return self.router.health()
        return self.call(_do())

    @property
    def worker_names(self) -> Tuple[str, ...]:
        return tuple(self.router.worker_names)

    def owner_of(self, qrel_id: str) -> str:
        """Which worker owns ``qrel_id`` (for aiming fault injection)."""
        return self.router.owner_of(qrel_id)

    def replicas_of(self, qrel_id: str) -> Tuple[str, ...]:
        """The full replica set of ``qrel_id``, primary first."""
        return tuple(self.router.replicas_of(qrel_id))

    def kill_worker(self, name: str) -> int:
        """SIGKILL a worker process (fault injection); returns its pid."""
        async def _do():
            proc = self.router._slots[name].proc
            pid = proc.proc.pid
            proc.kill()
            return pid
        return self.call(_do())

    def pause_worker(self, name: str) -> None:
        """SIGSTOP a worker (hung-but-alive fault injection)."""
        async def _do():
            self.router._slots[name].proc.pause()
        self.call(_do())

    def resume_worker(self, name: str) -> None:
        """SIGCONT a paused worker."""
        async def _do():
            self.router._slots[name].proc.resume()
        self.call(_do())

    def add_worker(self, name: Optional[str] = None) -> str:
        return self.call(self.router.add_worker(name), timeout=120)

    def remove_worker(self, name: str) -> None:
        self.call(self.router.remove_worker(name), timeout=120)

    # -- lifecycle -----------------------------------------------------------

    def _worker_processes(self) -> List[asyncio.subprocess.Process]:
        if self.router is None:
            return []
        slots = list(self.router._slots.values())
        return [s.proc.proc for s in slots if s.proc.proc is not None]

    def close(self) -> None:
        """Stop accepting, drain the router, SIGTERM workers, stop loop."""
        if self._thread.is_alive():
            async def _shutdown():
                if self._server is not None:
                    await close_server(self._server)
                if self.router is not None:
                    await self.router.drain()
                others = [t for t in asyncio.all_tasks()
                          if t is not asyncio.current_task()]
                if others:
                    await asyncio.wait(others, timeout=1)

            procs = self._worker_processes()
            try:
                self.call(_shutdown(), timeout=SHUTDOWN_TIMEOUT)
            finally:
                self._loop.call_soon_threadsafe(self._loop.stop)
                self._thread.join(10)
                for proc in procs:  # a drain that failed or timed out
                    if proc.returncode is None:
                        with contextlib.suppress(ProcessLookupError):
                            os.kill(proc.pid, signal.SIGKILL)
        if not self._loop.is_running():
            self._loop.close()

    def __enter__(self) -> "ClusterThread":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
