"""JSON-lines front-ends for the evaluation service: stdio and TCP.

One request per line, one JSON object per response line::

    {"op": "register_qrel", "id": 1, "qrel_id": "web",
     "qrel": {"q1": {"d1": 1}}, "measures": ["map"]}
    {"op": "evaluate", "id": 2, "qrel_id": "web",
     "run": {"q1": {"d1": 1.0}}}

Responses echo the request ``id`` (responses may arrive out of order —
requests are handled concurrently so the service can coalesce them)::

    {"id": 1, "ok": true, "result": {...}}
    {"id": 2, "ok": true, "result": {"per_query": {...}, "aggregates": {...}}}
    {"id": 3, "ok": false, "error": "unknown qrel_id 'nope': ...",
     "code": "not_found"}

Operations: ``register_qrel``, ``register_run``, ``evaluate``,
``compare`` (paired significance tests across K runs — see
:meth:`EvaluationService.compare`), ``drop_qrel``, ``stats``, ``ping``,
``health`` (the cheap liveness probe used by the cluster router's health
checks), ``auth``.  Field names mirror the keyword arguments of
:class:`repro_torch.serve.service.EvaluationService`.

Every failure is a *response*, never a dead socket: unparseable lines,
unknown ops, missing fields, and even request lines longer than the frame
limit (``--max-frame-mb``, default 64 MiB — the asyncio 64 KiB default
rejected any real qrel payload) come back as ``ok: false`` objects with a
machine-readable ``code`` from :data:`repro_torch.serve.wire.ERROR_CODES`, and
the connection keeps serving.

TCP hardening knobs: ``--auth-token`` requires each connection to open
with ``{"op": "auth", "token": ...}`` before other requests (a wrong token
is an error response — the connection may retry); ``--rate-limit`` /
``--burst`` throttle each connection through a token bucket (excess
requests are *delayed*, never dropped).  On SIGINT/SIGTERM the server
stops accepting, finishes in-flight batches
(:meth:`EvaluationService.drain`), and exits cleanly, within a few
seconds even while clients stay connected (:func:`close_server`).

Front-ends::

    python -m repro_torch.serve --qrel tests/fixtures/conformance.qrel -m map
    python -m repro_torch.serve --tcp 127.0.0.1:9090 --auth-token s3cret ...
    python -m repro_torch.serve --device cpu ...   # default: --device cuda

The default front-end reads stdin and writes stdout (one process per
client); ``--tcp`` serves any number of concurrent connections, and requests
from DIFFERENT connections coalesce into the same backend batches.  The
``-m`` / ``-l`` measure flags are shared with the one-shot CLI
(:func:`repro_torch.cli.add_measure_args`).  ``repro_torch.client`` is the library
speaking this protocol (persistent connections, pipelining, retry).
"""

from __future__ import annotations

import argparse
import asyncio
import hmac
import json
import signal
import sys
from typing import Optional, Sequence, Tuple

from repro_torch.serve.service import EvaluationService, ServeResult
from repro_torch.serve.wire import (DEFAULT_FRAME_LIMIT, OversizedFrame,
                              ProtocolError, TokenBucket, iter_frames)

#: required fields per operation, checked before dispatch so the client
#: sees "op 'evaluate' requires field 'qrel_id'" instead of a bare KeyError
REQUIRED_FIELDS = {
    "register_qrel": ("qrel_id", "qrel"),
    "register_run": ("qrel_id", "run_id"),
    "evaluate": ("qrel_id",),
    "compare": ("qrel_id",),
    "drop_qrel": ("qrel_id",),
    "stats": (),
    "ping": (),
    "health": (),
    "auth": ("token",),
}


def _error(rid, message: str, code: str) -> dict:
    return {"id": rid, "ok": False, "error": message, "code": code}


def _exc_message(exc: BaseException) -> str:
    # KeyError('x') stringifies as "'x'" — unwrap single string args
    if len(exc.args) == 1 and isinstance(exc.args[0], str):
        return exc.args[0]
    return str(exc)


def _check_request(req: dict) -> str:
    """Validate op + required fields; returns the op.  Raises ProtocolError."""
    op = req.get("op")
    if op not in REQUIRED_FIELDS:
        raise ProtocolError(
            f"unknown op {op!r} (expected one of "
            f"{'/'.join(sorted(REQUIRED_FIELDS))})", code="unknown_op")
    for field in REQUIRED_FIELDS[op]:
        if field not in req:
            raise ProtocolError(
                f"op {op!r} requires field {field!r}", code="missing_field")
    return op


def _relevance_level(req: dict):
    """The protocol's one typing rule for ``relevance_level``: a number.

    Ints and floats both pass straight through — the single int→float
    conversion lives in :class:`repro_torch.core.RelevanceEvaluator`, exactly as
    for the CLI's ``-l`` flag (no lossy ``int()`` truncation here).
    """
    level = req.get("relevance_level", 1)
    if isinstance(level, bool) or not isinstance(level, (int, float)):
        raise ProtocolError(
            "op 'register_qrel' field 'relevance_level' must be a number "
            f"like the CLI's -l flag, got {type(level).__name__}: {level!r}",
            code="invalid")
    return level


def _deadline_seconds(req: dict) -> Optional[float]:
    """Validate the optional ``deadline_ms`` field → seconds (or None)."""
    ms = req.get("deadline_ms")
    if ms is None:
        return None
    if isinstance(ms, bool) or not isinstance(ms, (int, float)) or ms <= 0:
        raise ProtocolError(
            "field 'deadline_ms' must be a positive number of "
            f"milliseconds, got {ms!r}", code="invalid")
    return float(ms) / 1e3


async def handle_request(service: EvaluationService, req: dict) -> dict:
    """Execute one decoded protocol request; never raises.

    A request may carry ``deadline_ms``: the budget the *caller* is still
    willing to wait.  Past it the op is cancelled and answered with a
    ``deadline_exceeded`` error — each attempt gets the full budget from
    its arrival here (end-to-end enforcement, including queueing and
    retries, is the cluster router's job).
    """
    rid = req.get("id")
    try:
        op = _check_request(req)
        budget = _deadline_seconds(req)
        if budget is None:
            return await _dispatch_request(service, op, req)
        try:
            return await asyncio.wait_for(
                _dispatch_request(service, op, req), budget)
        except asyncio.TimeoutError:
            return _error(
                rid, f"op {op!r} missed its 'deadline_ms' budget "
                f"({req['deadline_ms']} ms) on the server",
                "deadline_exceeded")
    except ProtocolError as exc:
        return _error(rid, str(exc), exc.code)


async def _dispatch_request(service: EvaluationService, op: str,
                            req: dict) -> dict:
    """The per-op dispatch behind :func:`handle_request`; never raises."""
    rid = req.get("id")
    try:
        if op == "register_qrel":
            result = service.register_qrel(
                req["qrel_id"], req["qrel"], measures=req.get("measures"),
                relevance_level=_relevance_level(req),
                backend=req.get("backend"),
                judged_docs_only=bool(req.get("judged_docs_only", False)))
        elif op == "register_run":
            result = service.register_run(
                req["qrel_id"], req["run_id"], run=req.get("run"),
                tokens=req.get("tokens"))
        elif op == "evaluate":
            res: ServeResult = await service.evaluate(
                req["qrel_id"], run=req.get("run"),
                tokens=req.get("tokens"), run_ref=req.get("run_ref"),
                scores=req.get("scores"))
            result = {"per_query": res.per_query,
                      "aggregates": res.aggregates}
        elif op == "compare":
            result = await service.compare(
                req["qrel_id"], runs=req.get("runs"),
                run_refs=req.get("run_refs"),
                measure=req.get("measure", "map"),
                tests=tuple(req.get("tests", ("t",))),
                n_permutations=req.get("n_permutations", 2000),
                seed=req.get("seed", 0), alpha=req.get("alpha", 0.05),
                run_names=req.get("run_names"))
        elif op == "drop_qrel":
            result = {"dropped": service.drop_qrel(req["qrel_id"])}
        elif op == "stats":
            result = service.stats()
        elif op == "health":
            # the cheap liveness/readiness probe (cluster health checks hit
            # this on a timer): counters only, no evaluation machinery
            st = service.stats()
            result = {"status": "ok", "in_flight": st["in_flight"],
                      "collections": st["collections"]}
        elif op == "auth":
            # an unauthenticated front-end accepts any token (no-op), so
            # clients configured with a token work against open servers;
            # the TCP front-end intercepts this op when a token is set
            result = {"authenticated": True}
        else:  # op == "ping"
            result = "pong"
    except asyncio.CancelledError:
        raise  # deadline (or shutdown) cancellation must propagate
    except ProtocolError as exc:
        return _error(rid, str(exc), exc.code)
    except KeyError as exc:  # unknown qrel_id / run_ref from the service
        return _error(rid, _exc_message(exc), "not_found")
    except (TypeError, ValueError) as exc:
        return _error(rid, _exc_message(exc), "invalid")
    except Exception as exc:  # noqa: BLE001 — protocol errors go to the client
        return _error(rid, f"{type(exc).__name__}: {exc}", "internal")
    return {"id": rid, "ok": True, "result": result}


def _decode(line: str) -> Tuple[Optional[dict], Optional[dict]]:
    """Parse one request line → ``(request, None)`` or ``(None, error)``."""
    try:
        req = json.loads(line)
        if not isinstance(req, dict):
            raise ValueError("request must be a JSON object")
    except ValueError as exc:
        return None, _error(None, f"bad request line: {exc}", "bad_request")
    return req, None


async def handle_line(service: EvaluationService, line: str) -> str:
    """One protocol line in, one JSON response line out."""
    req, err = _decode(line)
    if err is not None:
        return json.dumps(err)
    return json.dumps(await handle_request(service, req))


def _oversized_error(frame: OversizedFrame) -> dict:
    return _error(
        None,
        f"request line exceeds the frame limit ({frame.limit} bytes); "
        f"raise --max-frame-mb or split the payload", "frame_too_large")


# -- TCP ---------------------------------------------------------------------


async def serve_protocol(handler, host: str = "127.0.0.1", port: int = 0,
                         *, limit: int = DEFAULT_FRAME_LIMIT,
                         auth_token: Optional[str] = None,
                         rate_limit: Optional[float] = None,
                         burst: Optional[float] = None):
    """TCP JSON-lines listener around an arbitrary async request handler.

    The connection machinery — chunked framing with ``frame_too_large``
    *responses* for oversized lines, per-connection auth interception,
    token-bucket read throttling, one task per request line so slow
    requests never block the reader, write-lock-serialized responses,
    graceful teardown — is identical for the evaluation front-end
    (:func:`serve_tcp`) and the cluster router
    (:mod:`repro_torch.serve.cluster`); only what *handles* a decoded
    request differs.  ``handler(req, raw)`` receives the parsed request object and
    the raw frame bytes, and returns either a response ``dict`` (JSON
    encoded here) or pre-encoded response ``bytes`` — one JSON object, no
    newline — written verbatim (the router's fan-out path returns worker
    response frames untouched to skip a decode/encode round trip).
    ``handler`` must never raise.
    """

    async def client(reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        wlock = asyncio.Lock()
        tasks = set()
        authed = auth_token is None
        bucket = (TokenBucket(rate_limit, burst)
                  if rate_limit is not None else None)

        async def send(payload) -> None:
            body = (payload if isinstance(payload, bytes)
                    else json.dumps(payload).encode())
            try:
                async with wlock:
                    writer.write(body + b"\n")
                    await writer.drain()
            except (ConnectionError, OSError):
                # client went away before reading its response — the
                # evaluation already happened; nothing useful to raise
                # (an unretrieved task exception would just spam stderr)
                pass

        async def one(raw: bytes) -> None:
            nonlocal authed
            req, err = _decode(raw.decode("utf-8", "replace"))
            if err is not None:
                await send(err)
                return
            if auth_token is not None and req.get("op") == "auth":
                if "token" not in req:  # same code as _check_request gives
                    await send(_error(req.get("id"),
                                      "op 'auth' requires field 'token'",
                                      "missing_field"))
                    return
                ok = hmac.compare_digest(str(req["token"]), auth_token)
                # `authed` flips BEFORE this task's first await: requests
                # pipelined right behind a good auth line see it set.
                authed = authed or ok
                await send({"id": req.get("id"), "ok": True,
                            "result": {"authenticated": True}} if ok else
                           _error(req.get("id"), "bad auth token",
                                  "bad_auth"))
                return
            if not authed:
                await send(_error(
                    req.get("id"),
                    "authentication required: send "
                    '{"op": "auth", "token": ...} first', "auth_required"))
                return
            await send(await handler(req, raw))

        try:
            async for raw in iter_frames(reader, limit):
                if isinstance(raw, OversizedFrame):
                    await send(_oversized_error(raw))
                    continue
                if not raw.strip():
                    continue
                if bucket is not None:
                    # throttle by delaying the READ of further requests:
                    # pipelined floods smear out at `rate_limit` req/s
                    await bucket.acquire()
                t = asyncio.get_running_loop().create_task(one(raw))
                tasks.add(t)
                t.add_done_callback(tasks.discard)
        except (ConnectionError, OSError, asyncio.IncompleteReadError):
            pass  # peer vanished mid-line; no one left to tell
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # noqa: BLE001 — reader bug: answer, then close
            await send(_error(None,
                              f"connection error: {type(exc).__name__}: "
                              f"{exc}", "internal"))
        finally:
            if tasks:
                await asyncio.gather(*tasks, return_exceptions=True)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    return await asyncio.start_server(client, host, port, limit=limit)


#: seconds a shutdown waits for connected clients to hang up.  Since
#: Python 3.12.1 ``asyncio.Server.wait_closed()`` waits until every open
#: connection has closed, so one idle client would hold the process open
#: for as long as it stays connected.
CLOSE_TIMEOUT = 2.0


async def close_server(server) -> bool:
    """Stop accepting, then wait at most ``CLOSE_TIMEOUT`` seconds for the
    open connections to close; True if they all did.

    Connections still open after the wait keep being served: their
    handlers answer the request lines they read (the caller drains the
    service next) until the event loop cancels them at exit.
    """
    server.close()
    try:
        await asyncio.wait_for(server.wait_closed(), CLOSE_TIMEOUT)
    except asyncio.TimeoutError:
        return False
    return True


async def serve_tcp(service: EvaluationService, host: str = "127.0.0.1",
                    port: int = 0, *, limit: int = DEFAULT_FRAME_LIMIT,
                    auth_token: Optional[str] = None,
                    rate_limit: Optional[float] = None,
                    burst: Optional[float] = None):
    """Start the TCP front-end; returns the ``asyncio`` server object.

    Each connection is a JSON-lines stream.  Every request line becomes its
    own task, so slow evaluations never block the connection's reader — and
    concurrent requests (same or different connections) coalesce in the
    service's micro-batcher.  Pass ``port=0`` for an ephemeral port
    (``server.sockets[0].getsockname()[1]``).

    ``limit`` bounds the request line length (default 64 MiB; oversized
    lines get a ``frame_too_large`` error response, not a dead socket).
    ``auth_token`` requires each connection to send ``{"op": "auth",
    "token": ...}`` before anything else; ``rate_limit``/``burst`` give
    each connection a token bucket whose exhaustion *delays* reads.
    """

    async def handler(req: dict, raw: bytes) -> dict:
        return await handle_request(service, req)

    return await serve_protocol(handler, host, port, limit=limit,
                                auth_token=auth_token,
                                rate_limit=rate_limit, burst=burst)


# -- stdio -------------------------------------------------------------------


async def serve_stdio(service: EvaluationService, in_stream=None,
                      out_stream=None, *,
                      limit: int = DEFAULT_FRAME_LIMIT) -> None:
    """JSON-lines over stdin/stdout until EOF (one process per client).

    stdio is a trusted local transport: no auth, no rate limit.  ``limit``
    still applies (oversized lines answer ``frame_too_large``) so both
    front-ends enforce the same frame contract.
    """
    loop = asyncio.get_running_loop()
    in_stream = sys.stdin if in_stream is None else in_stream
    out_stream = sys.stdout if out_stream is None else out_stream
    wlock = asyncio.Lock()
    tasks = set()

    async def emit(resp: str) -> None:
        async with wlock:
            out_stream.write(resp + "\n")
            out_stream.flush()

    async def one(line: str) -> None:
        await emit(await handle_line(service, line))

    while True:
        line = await loop.run_in_executor(None, in_stream.readline)
        if not line:
            break
        if not line.strip():
            continue
        body = line[:-1] if line.endswith("\n") else line
        # the limit is in BYTES, matching the TCP framing exactly
        nbytes = len(body) if body.isascii() else len(body.encode("utf-8"))
        if nbytes > limit:
            await emit(json.dumps(_oversized_error(
                OversizedFrame(nbytes, limit))))
            continue
        t = loop.create_task(one(line))
        tasks.add(t)
        t.add_done_callback(tasks.discard)
    if tasks:
        await asyncio.gather(*tasks, return_exceptions=True)
    await service.drain()


# -- entry point -------------------------------------------------------------


def _parse_hostport(spec: str) -> Tuple[str, int]:
    host, _, port = spec.rpartition(":")
    return host or "127.0.0.1", int(port)


def build_service(args) -> EvaluationService:
    """Service + optional default collection from parsed CLI args."""
    from repro_torch import cli
    from repro_torch.core import trec

    service = EvaluationService(
        max_collections=args.max_collections,
        window=args.window_ms / 1e3, max_batch=args.max_batch,
        max_pending=args.max_pending, backend=args.backend,
        device=args.device)
    if args.qrel:
        info = service.register_qrel(
            args.qrel_id, trec.load_qrel(args.qrel),
            measures=cli.resolve_measures(args.measures),
            relevance_level=args.level,
            judged_docs_only=args.judged_docs_only)
        print(f"registered qrel {info['qrel_id']!r}: "
              f"{info['n_queries']} queries, backend={info['backend']}",
              file=sys.stderr, flush=True)
    return service


def main(argv: Optional[Sequence[str]] = None) -> int:
    from repro_torch import cli

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description="Async evaluation service speaking JSON-lines over "
                    "stdio (default) or TCP.")
    ap.add_argument("--tcp", metavar="HOST:PORT",
                    help="serve TCP instead of stdio (port 0 = ephemeral)")
    ap.add_argument("--qrel", metavar="PATH",
                    help="pre-register this TREC qrel file at startup")
    ap.add_argument("--qrel-id", default="default", metavar="ID",
                    help="collection id for --qrel (default: 'default')")
    cli.add_measure_args(ap)
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "single", "sharded"),
                    help="evaluation backend (auto: sharded iff on CUDA "
                         "with >1 card)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where every collection is evaluated (default "
                         "cuda; raises without it: pass --device cpu)")
    ap.add_argument("--window-ms", type=float, default=2.0, metavar="MS",
                    help="coalescing window in milliseconds (default 2)")
    ap.add_argument("--max-batch", type=int, default=64, metavar="N",
                    help="flush a window early at N pending requests")
    ap.add_argument("--max-collections", type=int, default=8, metavar="N",
                    help="LRU capacity for resident collections")
    ap.add_argument("--max-pending", type=int, default=256, metavar="N",
                    help="in-flight request cap (backpressure)")
    ap.add_argument("--max-frame-mb", type=float,
                    default=DEFAULT_FRAME_LIMIT / 2**20, metavar="MB",
                    help="request line length limit in MiB (default 64; "
                         "oversized lines get an error response)")
    ap.add_argument("--auth-token", default=None, metavar="TOKEN",
                    help="require TCP connections to authenticate via "
                         "{'op': 'auth', 'token': TOKEN} before anything "
                         "else (stdio is trusted)")
    ap.add_argument("--rate-limit", type=float, default=None, metavar="N",
                    help="per-connection token-bucket budget in requests/s "
                         "(TCP only; excess requests are delayed)")
    ap.add_argument("--burst", type=float, default=None, metavar="N",
                    help="token-bucket burst capacity "
                         "(default: max(1, rate))")
    args = ap.parse_args(argv)
    limit = max(1, int(args.max_frame_mb * 2**20))

    async def run() -> None:
        service = build_service(args)
        if args.tcp:
            host, port = _parse_hostport(args.tcp)
            server = await serve_tcp(
                service, host, port, limit=limit,
                auth_token=args.auth_token, rate_limit=args.rate_limit,
                burst=args.burst)
            addr = server.sockets[0].getsockname()
            print(f"serving on {addr[0]}:{addr[1]}", file=sys.stderr,
                  flush=True)
            stop = asyncio.Event()
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGINT, signal.SIGTERM):
                try:
                    loop.add_signal_handler(sig, stop.set)
                except (NotImplementedError, RuntimeError):
                    pass  # platform without signal handlers (Windows loop)
            try:
                await stop.wait()
            finally:
                # graceful drain: stop accepting (waiting at most
                # CLOSE_TIMEOUT for clients to hang up: an idle client
                # would hold 3.12's wait_closed forever), give request lines
                # already read a beat to enter the service, finish in-flight
                # batches
                await close_server(server)
                await asyncio.sleep(0.05)
                await service.drain()
                # then let handler tasks finish WRITING those responses
                # (bounded: a connected-but-idle client's handler never
                # ends on its own; asyncio.run cancels it on the way out)
                others = [t for t in asyncio.all_tasks()
                          if t is not asyncio.current_task()]
                if others:
                    await asyncio.wait(others, timeout=1.0)
                print("drained; exiting", file=sys.stderr, flush=True)
        else:
            await serve_stdio(service, limit=limit)

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
