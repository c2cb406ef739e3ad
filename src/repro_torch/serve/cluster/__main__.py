"""``python -m repro_torch.serve.cluster`` — boot a router + worker pool.

The router listens on ``--host``/``--port`` speaking the exact same
JSON-lines protocol as a single ``python -m repro_torch.serve`` server
(clients and the ``repro_torch.client`` library work unchanged), and fans
requests out to ``--workers`` supervised ``repro_torch.serve`` subprocesses
by consistent-hashed ``qrel_id``::

    python -m repro_torch.serve.cluster --workers 2 --device cpu
    python -m repro_torch.serve.cluster --workers 2   # --device cuda

Router-level knobs (``--auth-token``, ``--rate-limit``, ``--burst``,
``--max-frame-mb``) guard the public listener; the worker knobs
(``--device``, ``--backend``, ``--window-ms``, ``--max-batch``,
``--max-collections``, ``--max-pending``) pass through to every worker's
command line.  ``--device`` is ``cuda`` unless told otherwise, and a
worker asked for CUDA on a host without it fails to start.

Robustness knobs: ``--replication R`` gives every collection a replica
set of R workers (fan-out registrations, balanced reads, instant
failover); ``--state-dir DIR`` makes the registration journal durable so
a full cluster restart against the same DIR recovers every acknowledged
collection; ``--breaker-failures`` / ``--breaker-cooldown`` tune the
per-worker circuit breaker and ``--hedge-fraction`` when deadline-carrying
requests hedge to a sibling.

SIGINT/SIGTERM drain gracefully: stop accepting (waiting at most
``CLOSE_TIMEOUT`` seconds for connected clients to hang up), answer
in-flight requests (at most 30 s), then SIGTERM each worker so it runs
its own drain (at most 15 s each before a SIGKILL).
"""

from __future__ import annotations

import argparse
import asyncio
import signal
import sys
from typing import Optional, Sequence

from repro_torch.serve.cluster.router import Router
from repro_torch.serve.frontend import close_server, serve_protocol
from repro_torch.serve.wire import DEFAULT_FRAME_LIMIT


def build_router(args, *, frame_limit: int) -> Router:
    """A :class:`Router` from parsed CLI args (worker flags passed through)."""
    worker_args = [
        "--device", args.device,
        "--backend", args.backend,
        "--window-ms", str(args.window_ms),
        "--max-batch", str(args.max_batch),
        "--max-collections", str(args.max_collections),
        "--max-pending", str(args.max_pending),
    ]
    return Router(args.workers, worker_args=worker_args,
                  replicas=args.replicas, replication=args.replication,
                  retries=args.retries,
                  health_interval=args.health_interval,
                  frame_limit=frame_limit, state_dir=args.state_dir,
                  breaker_failures=args.breaker_failures,
                  breaker_cooldown=args.breaker_cooldown,
                  hedge_fraction=args.hedge_fraction)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve.cluster",
        description="Consistent-hash router over a pool of "
                    "repro_torch.serve worker processes (same JSON-lines "
                    "protocol).")
    ap.add_argument("--workers", type=int, default=2, metavar="N",
                    help="worker processes in the pool (default 2)")
    ap.add_argument("--host", default="127.0.0.1",
                    help="router listen address (default 127.0.0.1)")
    ap.add_argument("--port", type=int, default=0,
                    help="router listen port (default 0 = ephemeral)")
    ap.add_argument("--replicas", type=int, default=64, metavar="N",
                    help="virtual nodes per worker on the hash ring")
    ap.add_argument("--replication", type=int, default=1, metavar="R",
                    help="replica set size per collection: registrations "
                         "fan out to R workers, reads balance across "
                         "them and fail over instantly (default 1)")
    ap.add_argument("--state-dir", default=None, metavar="DIR",
                    help="durable registration journal directory; a "
                         "restarted cluster pointed at the same DIR "
                         "recovers every acknowledged collection")
    ap.add_argument("--retries", type=int, default=3, metavar="N",
                    help="transparent retries of idempotent ops across "
                         "worker restarts")
    ap.add_argument("--health-interval", type=float, default=1.0,
                    metavar="S", help="seconds between worker health "
                    "probes (default 1)")
    ap.add_argument("--breaker-failures", type=int, default=3, metavar="N",
                    help="consecutive transport failures that open a "
                         "worker's circuit breaker (default 3)")
    ap.add_argument("--breaker-cooldown", type=float, default=1.0,
                    metavar="S", help="seconds an open breaker waits "
                    "before its half-open probe (default 1)")
    ap.add_argument("--hedge-fraction", type=float, default=0.5,
                    metavar="F", help="share of a request's deadline_ms "
                    "budget that elapses before an idempotent request is "
                    "hedged to a sibling replica (default 0.5)")
    # router-level hardening (the semantics of python -m repro_torch.serve)
    ap.add_argument("--max-frame-mb", type=float,
                    default=DEFAULT_FRAME_LIMIT / 2**20, metavar="MB",
                    help="request line length limit in MiB (default 64)")
    ap.add_argument("--auth-token", default=None, metavar="TOKEN",
                    help="require connections to authenticate first")
    ap.add_argument("--rate-limit", type=float, default=None, metavar="N",
                    help="per-connection token-bucket budget in requests/s")
    ap.add_argument("--burst", type=float, default=None, metavar="N",
                    help="token-bucket burst capacity (default max(1, rate))")
    # worker pass-through knobs
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where every worker evaluates (default cuda; a "
                         "worker raises without it: pass --device cpu)")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "single", "sharded"),
                    help="worker evaluation backend")
    ap.add_argument("--window-ms", type=float, default=2.0, metavar="MS",
                    help="worker coalescing window in milliseconds")
    ap.add_argument("--max-batch", type=int, default=64, metavar="N",
                    help="worker early-flush batch size")
    ap.add_argument("--max-collections", type=int, default=8, metavar="N",
                    help="worker LRU capacity for resident collections")
    ap.add_argument("--max-pending", type=int, default=256, metavar="N",
                    help="worker in-flight request cap")
    args = ap.parse_args(argv)
    limit = max(1, int(args.max_frame_mb * 2**20))

    async def run() -> None:
        router = build_router(args, frame_limit=limit)
        await router.start()
        server = await serve_protocol(
            router.handle, args.host, args.port, limit=limit,
            auth_token=args.auth_token, rate_limit=args.rate_limit,
            burst=args.burst)
        addr = server.sockets[0].getsockname()
        print(f"serving on {addr[0]}:{addr[1]}", file=sys.stderr,
              flush=True)
        print(f"cluster: {args.workers} worker(s) "
              f"{', '.join(router.worker_names)}", file=sys.stderr,
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
            # stop accepting (an idle client would hold 3.12's
            # wait_closed forever: bounded), give already-read lines a
            # beat to enter handle(), answer in-flight, then cascade to
            # the workers
            await close_server(server)
            await asyncio.sleep(0.05)
            await router.drain()
            others = [t for t in asyncio.all_tasks()
                      if t is not asyncio.current_task()]
            if others:
                await asyncio.wait(others, timeout=1.0)
            print("drained; exiting", file=sys.stderr, flush=True)

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
