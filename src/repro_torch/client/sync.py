"""``EvalClient`` — the blocking facade over :class:`AsyncEvalClient`.

For scripts, notebooks, and training loops that are not asyncio-native.
The client owns a private event loop on a daemon thread; every method is
the corresponding :class:`~repro_torch.client.aio.AsyncEvalClient` coroutine run
to completion on that loop.  Pipelining still works two ways:

* :meth:`evaluate_many` — submit a whole batch, block for all results
  (in flight together → coalesced server-side);
* :meth:`submit` — enqueue ONE evaluation and immediately get a
  ``concurrent.futures.Future``, for callers managing their own depth.

>>> from repro_torch.serve.testing import ServerThread
>>> from repro_torch.client import EvalClient
>>> with ServerThread(service_kw={'device': 'cpu'}) as srv:
...     _ = srv.register_qrel('web', {'q1': {'d1': 1, 'd2': 0}}, ('map',))
...     with EvalClient(srv.host, srv.port) as client:
...         res = client.evaluate('web', run={'q1': {'d1': 2.0, 'd2': 1.0}})
>>> res.per_query['q1']['map']
1.0
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import threading
from typing import List, Optional, Sequence

from repro_torch.client.aio import AsyncEvalClient, EvalResult
from repro_torch.serve.wire import DEFAULT_FRAME_LIMIT


class EvalClient:
    """Synchronous persistent-connection client (thread-confined loop).

    ``EvalClient(host, port)`` connects over TCP;
    :meth:`EvalClient.spawn_stdio` runs a private ``python -m repro_torch.serve``
    subprocess instead.  Constructor keywords (``token``, ``retries``,
    ``frame_limit``) are forwarded to :class:`AsyncEvalClient`; ``timeout``
    bounds every blocking call.
    """

    def __init__(self, host: Optional[str] = None,
                 port: Optional[int] = None, *, timeout: float = 120.0,
                 _defer: bool = False, **kw):
        if not _defer and (host is None or port is None):
            raise ValueError("EvalClient(host, port) both required "
                             "(or use EvalClient.spawn_stdio)")
        self._timeout = float(timeout)
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="repro-torch-client-loop")
        self._thread.start()
        self._async: Optional[AsyncEvalClient] = None
        if not _defer:
            try:
                self._async = self._call(AsyncEvalClient.connect(host, port,
                                                                 **kw))
            except BaseException:
                self.close()  # reap the loop thread; nothing connected
                raise

    @classmethod
    def spawn_stdio(cls, argv: Optional[Sequence[str]] = None, *,
                    timeout: float = 120.0, **kw) -> "EvalClient":
        """Spawn a stdio server subprocess and connect to its pipes."""
        client = cls(timeout=timeout, _defer=True)
        try:
            client._async = client._call(AsyncEvalClient.spawn_stdio(argv,
                                                                     **kw))
        except BaseException:
            client.close()
            raise
        return client

    def _run(self) -> None:
        asyncio.set_event_loop(self._loop)
        self._loop.run_forever()

    def _call(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self._loop).result(
            self._timeout)

    # -- session-API mirror (blocking) ----------------------------------------

    def ping(self) -> str:
        return self._call(self._async.ping())

    def health(self) -> dict:
        return self._call(self._async.health())

    def stats(self) -> dict:
        return self._call(self._async.stats())

    def register_qrel(self, qrel_id: str, qrel, measures=None,
                      relevance_level=None, backend=None,
                      judged_docs_only=None,
                      timeout: Optional[float] = None) -> dict:
        return self._call(self._async.register_qrel(
            qrel_id, qrel, measures=measures,
            relevance_level=relevance_level, backend=backend,
            judged_docs_only=judged_docs_only, timeout=timeout))

    def register_run(self, qrel_id: str, run_id: str, run=None,
                     tokens=None, timeout: Optional[float] = None) -> dict:
        return self._call(self._async.register_run(qrel_id, run_id, run=run,
                                                   tokens=tokens,
                                                   timeout=timeout))

    def evaluate(self, qrel_id: str, run=None, tokens=None,
                 run_ref: Optional[str] = None, scores=None,
                 timeout: Optional[float] = None) -> EvalResult:
        """Evaluate one run.  ``timeout`` (seconds) maps to the request's
        ``deadline_ms``; past it the call raises
        :class:`repro_torch.client.DeadlineExceededError`."""
        return self._call(self._async.evaluate(
            qrel_id, run=run, tokens=tokens, run_ref=run_ref, scores=scores,
            timeout=timeout))

    def evaluate_many(self, qrel_id: str, runs=None, *,
                      run_ref: Optional[str] = None,
                      scores_list=None) -> List[EvalResult]:
        """Pipeline a batch on the one connection; block for all results."""
        return self._call(self._async.evaluate_many(
            qrel_id, runs, run_ref=run_ref, scores_list=scores_list))

    def submit(self, qrel_id: str, run=None, tokens=None,
               run_ref: Optional[str] = None,
               scores=None) -> "concurrent.futures.Future[EvalResult]":
        """Enqueue one evaluation without blocking (manual pipelining)."""
        return asyncio.run_coroutine_threadsafe(
            self._async.evaluate(qrel_id, run=run, tokens=tokens,
                                 run_ref=run_ref, scores=scores),
            self._loop)

    def compare(self, qrel_id: str, runs=None,
                run_refs: Optional[Sequence[str]] = None,
                measure: str = "map", *, tests=None,
                n_permutations: Optional[int] = None,
                seed: Optional[int] = None, alpha: Optional[float] = None,
                run_names: Optional[Sequence[str]] = None,
                timeout: Optional[float] = None) -> dict:
        """Paired significance tests across K runs (see the async client)."""
        return self._call(self._async.compare(
            qrel_id, runs=runs, run_refs=run_refs, measure=measure,
            tests=tests, n_permutations=n_permutations, seed=seed,
            alpha=alpha, run_names=run_names, timeout=timeout))

    def drop_qrel(self, qrel_id: str,
                  timeout: Optional[float] = None) -> bool:
        return self._call(self._async.drop_qrel(qrel_id, timeout=timeout))

    @property
    def transport_stats(self) -> dict:
        """Client-side counters: requests sent, retries, reconnects."""
        return dict(self._async.transport_stats)

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        if self._thread.is_alive():
            if self._async is not None:
                self._call(self._async.aclose())
                self._async = None
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(10)
        if not self._loop.is_running():
            self._loop.close()

    def __enter__(self) -> "EvalClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
