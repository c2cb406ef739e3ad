"""``AsyncEvalClient`` — the asyncio persistent-connection client.

One client = one JSON-lines connection to a ``repro_torch.serve`` front-end (TCP
or a spawned stdio subprocess) with:

* **request-id correlation** — every request carries a fresh ``id``; a
  background reader task resolves responses to their waiters, so responses
  may arrive in ANY order;
* **pipelining** — any number of requests may be in flight on the one
  connection (just ``asyncio.gather`` the calls, or use
  :meth:`evaluate_many`); that is what lets the server's micro-batcher
  coalesce them into fewer backend calls;
* **reconnect-with-retry** — if the TCP connection drops before a response
  arrives, idempotent requests (everything except ``drop_qrel``) are
  re-sent on a fresh connection with exponential backoff, re-authenticating
  first when a token is configured;
* **session-API helpers** — :meth:`register_qrel`, :meth:`register_run`,
  :meth:`evaluate` (``run=`` | ``tokens=`` | ``run_ref=`` + ``scores=``)
  mirror :class:`repro_torch.serve.service.EvaluationService` one to one.

>>> import asyncio
>>> from repro_torch.serve import EvaluationService, serve_tcp
>>> from repro_torch.client import AsyncEvalClient
>>> async def demo():
...     svc = EvaluationService(window=0.005, device='cpu')
...     svc.register_qrel('web', {'q1': {'d1': 1, 'd2': 0}}, ('map',))
...     server = await serve_tcp(svc, '127.0.0.1', 0)
...     port = server.sockets[0].getsockname()[1]
...     async with await AsyncEvalClient.connect('127.0.0.1', port) as c:
...         a, b = await c.evaluate_many('web', runs=[
...             {'q1': {'d1': 9.0, 'd2': 1.0}},
...             {'q1': {'d1': 0.0, 'd2': 1.0}}])  # pipelined → coalesced
...     server.close(); await server.wait_closed()
...     return a.per_query['q1']['map'], b.per_query['q1']['map']
>>> asyncio.run(demo())
(1.0, 0.5)
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import re
import sys
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.client.errors import (ClientError, ConnectionLostError,
                                 DeadlineExceededError, ProtocolError,
                                 error_from_response)
from repro_torch.serve.wire import DEFAULT_FRAME_LIMIT

#: ops safe to re-send after a connection loss: they either replace state
#: (register_*) or read it.  ``drop_qrel`` is excluded — its *result* is
#: not idempotent (a retry of a delivered drop reports ``dropped: false``).
IDEMPOTENT_OPS = frozenset({
    "register_qrel", "register_run", "evaluate", "compare", "stats", "ping",
    "health", "auth",
})

#: ``repro_torch.serve`` front-ends build responses as ``{"id": rid, ...}`` and
#: ``json.dumps`` preserves dict insertion order, so every correlatable
#: response line starts with its id.  Matching it here lets the read loop
#: resolve :meth:`AsyncEvalClient.forward` waiters without parsing the
#: (possibly multi-megabyte) body — the cluster router's fan-out path.
_ID_PREFIX = re.compile(rb'^\{"id":\s*(-?\d+)\s*,')


class EvalResult(NamedTuple):
    """One evaluation: pytrec_eval-style per-query values + aggregates."""

    per_query: Dict[str, Dict[str, float]]
    aggregates: Dict[str, float]


def _jsonable(obj):
    """Recursively convert numpy arrays/scalars for JSON encoding."""
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    return obj


class AsyncEvalClient:
    """A persistent JSON-lines connection to an evaluation server.

    Construct via :meth:`connect` (TCP) or :meth:`spawn_stdio` (a private
    ``python -m repro_torch.serve`` subprocess).  All request methods may be
    called concurrently — that is the point: in-flight requests pipeline on
    the one connection and coalesce server-side.

    ``retries`` bounds automatic re-sends of idempotent requests after a
    connection loss (TCP only; a dead stdio subprocess is not revivable).
    ``frame_limit`` must match the server's ``--max-frame-mb`` — requests
    larger than it raise locally instead of poisoning the stream.
    """

    def __init__(self, host: Optional[str] = None,
                 port: Optional[int] = None, *,
                 token: Optional[str] = None, retries: int = 2,
                 backoff: float = 0.05,
                 frame_limit: int = DEFAULT_FRAME_LIMIT):
        self._host = host
        self._port = port
        self._token = token
        self._retries = int(retries)
        self._backoff = float(backoff)
        self._frame_limit = int(frame_limit)
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._reader_task: Optional[asyncio.Task] = None
        self._proc = None  # stdio transport: the server subprocess
        self._conn_lock = asyncio.Lock()
        # rid -> (future, raw): `raw` waiters (forward()) get the response
        # line as bytes, everyone else the parsed object
        self._pending: Dict[int, Tuple[asyncio.Future, bool]] = {}
        self._next_id = 0
        self._closed = False
        #: client-side counters: requests sent, retries, reconnects
        self.transport_stats = {"requests": 0, "retries": 0, "reconnects": 0}

    # -- construction --------------------------------------------------------

    @classmethod
    async def connect(cls, host: str, port: int, **kw) -> "AsyncEvalClient":
        """Open a TCP connection (and authenticate, if ``token=`` given)."""
        client = cls(host, port, **kw)
        try:
            await client._ensure_connected()
        except BaseException:
            await client.aclose()  # don't leak the half-open connection
            raise
        return client

    @classmethod
    async def spawn_stdio(cls, argv: Optional[Sequence[str]] = None,
                          **kw) -> "AsyncEvalClient":
        """Spawn ``python -m repro_torch.serve`` and speak over its pipes.

        ``argv`` is the full command line (defaults to
        ``[sys.executable, "-m", "repro_torch.serve"]``); extra server flags
        (``--qrel``, ``-m``, ...) go there.  The subprocess is private to
        this client and exits when the client closes (stdin EOF → the
        server drains and stops).
        """
        client = cls(**kw)
        argv = list(argv) if argv else [sys.executable, "-m", "repro_torch.serve"]
        proc = await asyncio.create_subprocess_exec(
            *argv, stdin=asyncio.subprocess.PIPE,
            stdout=asyncio.subprocess.PIPE, limit=client._frame_limit)
        client._proc = proc
        client._reader, client._writer = proc.stdout, proc.stdin
        client._start_reader()
        if client._token is not None:
            try:
                await client._auth()
            except BaseException:
                await client.aclose()
                raise
        return client

    # -- connection management -----------------------------------------------

    @property
    def _connected(self) -> bool:
        return self._writer is not None and not self._writer.is_closing()

    async def _ensure_connected(self) -> None:
        if self._closed:
            raise ClientError("client is closed")
        if self._connected:
            return
        async with self._conn_lock:
            if self._connected or self._closed:
                return
            if self._host is None or self._port is None:
                raise ConnectionLostError(
                    "stdio transport lost (subprocess exited); "
                    "spawn_stdio again")
            old_task = self._reader_task
            reader, writer = await asyncio.open_connection(
                self._host, self._port, limit=self._frame_limit)
            if old_task is not None:
                # retire the previous generation: its read loop fails its
                # own pending futures (their requests then retry here)
                old_task.cancel()
                self.transport_stats["reconnects"] += 1
            self._reader, self._writer = reader, writer
            self._pending = {}  # futures are per connection generation
            self._start_reader()
            if self._token is not None:
                await self._auth()

    def _start_reader(self) -> None:
        self._reader_task = asyncio.get_running_loop().create_task(
            self._read_loop(self._reader, self._writer, self._pending))

    async def _read_loop(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter,
                         pending: Dict[int, Tuple[asyncio.Future, bool]],
                         ) -> None:
        """Resolve responses to their waiting futures by request id.

        ``pending`` is THIS connection generation's future map — a dying
        loop must never touch futures registered on a successor connection.
        Lines whose id prefix matches a ``raw`` waiter are handed over as
        bytes without JSON-parsing the body (:meth:`forward`).
        """
        exc: ClientError = ConnectionLostError("connection closed by server")
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                if not line.endswith(b"\n"):
                    # a line missing its terminator at EOF is a TORN tail
                    # (the peer died / the stream was cut mid-response) —
                    # never hand it to a waiter as if it were a response
                    exc = ConnectionLostError(
                        "connection cut mid-response (torn frame)")
                    break
                m = _ID_PREFIX.match(line)
                if m is not None:
                    ent = pending.pop(int(m.group(1)), None)
                    if ent is not None and ent[1]:  # raw waiter: no parse
                        if not ent[0].done():
                            ent[0].set_result(line.rstrip(b"\r\n"))
                        continue
                else:
                    ent = None
                try:
                    msg = json.loads(line)
                    if not isinstance(msg, dict):
                        raise ValueError("response must be a JSON object")
                except ValueError as e:
                    raise ProtocolError(
                        f"bad response line from server: {e}: "
                        f"{line[:120]!r}") from e
                if ent is not None:
                    if not ent[0].done():
                        ent[0].set_result(msg)
                else:
                    self._dispatch(msg, pending)
        except (ConnectionError, OSError, asyncio.IncompleteReadError) as e:
            exc = ConnectionLostError(f"connection lost: {e}")
        except ValueError as e:  # response line over the reader's limit
            exc = ProtocolError(f"response exceeds frame limit: {e}")
        except ProtocolError as e:
            exc = e
        except asyncio.CancelledError:
            exc = ConnectionLostError("connection closed")
            raise
        finally:
            if self._writer is writer:  # nobody reconnected us yet
                self._writer = None
            with contextlib.suppress(ConnectionError, OSError,
                                     RuntimeError):
                writer.close()
            for fut, _raw in pending.values():
                if not fut.done():
                    fut.set_exception(exc)
            pending.clear()

    @staticmethod
    def _dispatch(msg: dict,
                  pending: Dict[int, Tuple[asyncio.Future, bool]]) -> None:
        rid = msg.get("id")
        ent = pending.pop(rid, None) if rid is not None else None
        if ent is None and rid is None and len(pending) == 1:
            # the server could not read an id (e.g. frame_too_large); with
            # exactly one request outstanding the correlation is unambiguous
            _, ent = pending.popitem()
        if ent is not None and not ent[0].done():
            # a raw waiter resolved here (null-id error path) gets the
            # parsed object; forward() re-encodes that rare case
            ent[0].set_result(msg)
        # anything else: an unsolicited/late line — drop it

    async def _auth(self) -> None:
        resp = await self._send_and_wait("auth", {"token": self._token})
        self._check(resp)

    # -- the request engine --------------------------------------------------

    async def _send_and_wait(self, op: str, payload: dict) -> dict:
        """One raw send on the current connection; no retry, no checks."""
        rid = self._next_id
        self._next_id += 1
        data = json.dumps({"op": op, "id": rid, **payload}).encode() + b"\n"
        if len(data) > self._frame_limit:
            raise ClientError(
                f"request is {len(data)} bytes but the frame limit is "
                f"{self._frame_limit}; raise frame_limit= here and "
                f"--max-frame-mb on the server")
        fut = asyncio.get_running_loop().create_future()
        pending = self._pending  # this connection generation's map
        pending[rid] = (fut, False)
        self.transport_stats["requests"] += 1
        try:
            self._writer.write(data)
            await self._writer.drain()
            return await fut
        finally:
            pending.pop(rid, None)

    @staticmethod
    def _check(resp: dict):
        if resp.get("ok"):
            return resp.get("result")
        raise error_from_response(resp)

    async def _request(self, op: str, _timeout: Optional[float] = None,
                       **fields):
        """Send ``op``; retry idempotent ops across reconnects.

        ``_timeout`` (seconds) is the per-call deadline: it is sent to the
        server as ``deadline_ms`` (routers/workers enforce it and answer
        ``deadline_exceeded``, mapped to :class:`DeadlineExceededError`)
        AND enforced locally with a small grace period as a backstop for a
        server too hung to even say so.
        """
        if _timeout is not None:
            if not _timeout > 0:
                raise ValueError(f"timeout must be > 0 s, got {_timeout}")
            fields["deadline_ms"] = float(_timeout) * 1e3
        payload = _jsonable({k: v for k, v in fields.items()
                             if v is not None})
        retryable = op in IDEMPOTENT_OPS and self._host is not None
        # local backstop: give the server the full budget plus slack to
        # answer deadline_exceeded itself (its error names the culprit)
        backstop = None if _timeout is None else \
            asyncio.get_running_loop().time() + _timeout + 1.0
        attempt = 0
        while True:
            try:
                # reconnecting is part of the attempt: a refused/dropped
                # reconnect consumes a retry and backs off like any other
                # transport failure (AuthError et al. are not caught here)
                await self._ensure_connected()
                if backstop is None:
                    resp = await self._send_and_wait(op, payload)
                else:
                    remaining = backstop \
                        - asyncio.get_running_loop().time()
                    if remaining <= 0:
                        raise asyncio.TimeoutError()
                    resp = await asyncio.wait_for(
                        self._send_and_wait(op, payload), remaining)
            except asyncio.TimeoutError:
                raise DeadlineExceededError(
                    f"op {op!r} got no answer within its {_timeout}s "
                    "timeout (local backstop); the server may still be "
                    "working on it", code="deadline_exceeded") from None
            except (ConnectionError, OSError) as exc:
                # covers ConnectionLostError from the reader loop and
                # raw socket errors from connect/write/drain
                if not retryable or attempt >= self._retries:
                    if isinstance(exc, ClientError):
                        raise
                    raise ConnectionLostError(
                        f"connection lost: {exc}") from exc
                attempt += 1
                self.transport_stats["retries"] += 1
                await asyncio.sleep(self._backoff * (2 ** (attempt - 1)))
                continue
            return self._check(resp)

    async def forward(self, frame: bytes) -> bytes:
        """Relay a pre-encoded request frame; return the raw response frame.

        This is the cluster router's hot path: the router has already
        parsed the client's request line (it needed ``op`` and ``qrel_id``
        to route it), so re-encoding the — possibly multi-megabyte — run
        payload just to send it on would double the serialization bill.
        Instead the original frame is forwarded verbatim with a fresh
        connection-local id *appended* before the closing brace; JSON
        object keys are last-one-wins on decode, so the spliced id shadows
        the client's without rewriting the body.  The response comes back
        as bytes, still carrying the spliced id (callers rewrite it; see
        ``repro_torch.serve.cluster.router``), and is matched to its waiter by
        the id *prefix* of the line — no JSON parse on either direction.

        One attempt, no retry: the router owns retry policy (it knows
        which ops are idempotent).  Raises :class:`ConnectionLostError`
        (a ``ConnectionError``) if the transport dies first.
        """
        frame = frame.strip()
        if not frame.endswith(b"}"):
            raise ClientError(
                f"forward() needs one JSON object frame, got {frame[:80]!r}")
        await self._ensure_connected()
        rid = self._next_id
        self._next_id += 1
        data = b'%s,"id":%d}\n' % (frame[:-1], rid)
        if len(data) > self._frame_limit:
            raise ClientError(
                f"request is {len(data)} bytes but the frame limit is "
                f"{self._frame_limit}; raise frame_limit= here and "
                f"--max-frame-mb on the server")
        fut = asyncio.get_running_loop().create_future()
        pending = self._pending
        pending[rid] = (fut, True)
        self.transport_stats["requests"] += 1
        try:
            self._writer.write(data)
            await self._writer.drain()
            resp = await fut
        finally:
            pending.pop(rid, None)
        if isinstance(resp, dict):  # null-id error line, resolved parsed
            return json.dumps(resp).encode()
        return resp

    # -- session-API mirror --------------------------------------------------

    async def ping(self) -> str:
        return await self._request("ping")

    async def health(self) -> dict:
        """The server's cheap liveness probe (``status``, ``in_flight``)."""
        return await self._request("health")

    async def stats(self) -> dict:
        """Server-side counters (coalescing, cache, backpressure)."""
        return await self._request("stats")

    async def register_qrel(self, qrel_id: str, qrel, measures=None,
                            relevance_level=None, backend=None,
                            judged_docs_only=None,
                            timeout: Optional[float] = None) -> dict:
        """Intern a qrel server-side; returns the collection info dict.

        ``measures`` accepts either dialect (``"map"`` / ``"nDCG@10"``);
        ``judged_docs_only`` mirrors trec_eval's ``-J``.  ``timeout``
        (seconds) becomes the request's ``deadline_ms``; past it the call
        raises :class:`DeadlineExceededError`.
        """
        return await self._request(
            "register_qrel", _timeout=timeout, qrel_id=qrel_id, qrel=qrel,
            measures=measures, relevance_level=relevance_level,
            backend=backend, judged_docs_only=judged_docs_only)

    async def register_run(self, qrel_id: str, run_id: str, run=None,
                           tokens=None,
                           timeout: Optional[float] = None) -> dict:
        """Pin a tokenized run server-side for ``run_ref`` rescoring."""
        return await self._request("register_run", _timeout=timeout,
                                   qrel_id=qrel_id, run_id=run_id, run=run,
                                   tokens=tokens)

    async def evaluate(self, qrel_id: str, run=None, tokens=None,
                       run_ref: Optional[str] = None, scores=None,
                       timeout: Optional[float] = None) -> EvalResult:
        """Evaluate one run (``run=`` | ``tokens=`` | ``run_ref=+scores=``).

        Concurrent calls pipeline on the connection and coalesce
        server-side into fewer backend calls.  ``timeout`` (seconds) maps
        to the wire's ``deadline_ms``: the server answers (or this client
        raises) :class:`DeadlineExceededError` once the budget is gone.
        """
        result = await self._request("evaluate", _timeout=timeout,
                                     qrel_id=qrel_id, run=run,
                                     tokens=tokens, run_ref=run_ref,
                                     scores=scores)
        return EvalResult(result["per_query"], result["aggregates"])

    async def evaluate_many(self, qrel_id: str, runs=None, *,
                            run_ref: Optional[str] = None,
                            scores_list=None) -> List[EvalResult]:
        """Pipeline a batch of evaluations (all in flight at once).

        Either ``runs`` (a sequence of dict runs) or ``run_ref`` +
        ``scores_list`` (one pinned run, many score sets).
        """
        if (runs is None) == (scores_list is None):
            raise ValueError("need exactly one of runs/scores_list")
        if runs is not None:
            coros = [self.evaluate(qrel_id, run=r) for r in runs]
        else:
            coros = [self.evaluate(qrel_id, run_ref=run_ref, scores=s)
                     for s in scores_list]
        return list(await asyncio.gather(*coros))

    async def compare(self, qrel_id: str, runs=None,
                      run_refs: Optional[Sequence[str]] = None,
                      measure: str = "map", *, tests=None,
                      n_permutations: Optional[int] = None,
                      seed: Optional[int] = None,
                      alpha: Optional[float] = None,
                      run_names: Optional[Sequence[str]] = None,
                      timeout: Optional[float] = None) -> dict:
        """Paired significance tests across K >= 2 runs on one measure.

        Exactly one of ``runs`` (``{name: run}`` mapping or sequence of dict
        runs) or ``run_refs`` (server-side ``register_run`` names) selects
        the systems.  Returns the server's bundle: ``run_names``, ``qids``,
        per-run ``means``, the ``t``/``p``/``p_holm``/``p_bonferroni``
        matrices (plus ``p_permutation*`` with ``tests=["t",
        "permutation"]``), and the Holm-corrected ``significant`` mask at
        ``alpha``.  Omitted keyword arguments use the server defaults.
        """
        return await self._request(
            "compare", _timeout=timeout, qrel_id=qrel_id, runs=runs,
            run_refs=run_refs,
            measure=measure, tests=list(tests) if tests is not None else None,
            n_permutations=n_permutations, seed=seed, alpha=alpha,
            run_names=run_names)

    async def drop_qrel(self, qrel_id: str,
                        timeout: Optional[float] = None) -> bool:
        """Release a collection; NOT retried on connection loss."""
        result = await self._request("drop_qrel", _timeout=timeout,
                                     qrel_id=qrel_id)
        return bool(result["dropped"])

    # -- lifecycle -----------------------------------------------------------

    async def aclose(self) -> None:
        """Close the connection (stdio: EOF → the server drains and exits)."""
        self._closed = True
        writer, task, proc = self._writer, self._reader_task, self._proc
        self._writer = None
        if writer is not None:
            with contextlib.suppress(ConnectionError, OSError,
                                     RuntimeError):
                writer.close()
                await writer.wait_closed()
        if proc is not None:
            try:
                await asyncio.wait_for(proc.wait(), timeout=30)
            except asyncio.TimeoutError:  # pragma: no cover - safety net
                proc.kill()
                await proc.wait()
        if task is not None:
            task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await task

    async def __aenter__(self) -> "AsyncEvalClient":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.aclose()
