"""Chaos harness: seeded, declarative fault schedules for the cluster.

The robustness claims in ``repro_torch.serve.cluster`` — replica failover,
journal replay, circuit breaking, deadline enforcement — are only worth
anything if they hold under *combinations* of faults arriving at awkward
times.  This module makes those combinations reproducible: a
:class:`ChaosSchedule` is a plain list of :class:`ChaosEvent` (fault
``kind`` on worker ``w`` at relative time ``t``), either written by hand
or generated from a seed (:meth:`ChaosSchedule.random`), and a
:class:`ChaosInjector` replays it against a live router on its own event
loop.  ``tests/test_torch_cluster.py`` drives seeded schedules and asserts
the two invariants the cluster promises:

* every response that IS delivered is bit-identical to an in-process
  evaluation (garbage is never relayed — errors are typed protocol
  errors);
* no acknowledged registration is ever lost, whatever the schedule did.

Fault kinds:

* ``kill`` — SIGKILL the worker process (crash; supervisor restarts it);
* ``hang`` — SIGSTOP for ``duration`` seconds, then SIGCONT (alive but
  unresponsive; the router's *health probe*, not the supervisor, must
  notice — and SIGKILL it onto the restart path if the hang outlives the
  probe timeout);
* ``delay`` — add ``duration`` seconds of latency to every response chunk
  flowing through the worker's :class:`FaultProxy` (slow worker: feeds
  deadlines, hedging, and the circuit breaker), for ``duration`` seconds;
* ``truncate`` — cut the worker's next response off mid-frame and sever
  the connection (torn bytes on the wire: the router's client must treat
  the partial line as a connection loss, never as a response).

``delay`` / ``truncate`` need the wire interposed: create a
:class:`ProxyManager` and pass its :meth:`~ProxyManager.wrap` as the
router's ``wrap_endpoint`` so every worker generation is reached through
a fresh-targeted :class:`FaultProxy`::

    proxies = ProxyManager()
    cluster = ClusterThread(2, router_kw=dict(
        replication=2, wrap_endpoint=proxies.wrap))
    schedule = ChaosSchedule.random(seed=7, workers=cluster.worker_names)
    injector, fut = inject(cluster, schedule, proxies)
    ...drive traffic...
    fut.result()          # schedule fully applied
"""

from __future__ import annotations

import asyncio
import contextlib
import random
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from repro_torch.serve.frontend import close_server

#: the fault vocabulary, in the order `ChaosSchedule.random` samples it
FAULT_KINDS = ("kill", "hang", "delay", "truncate")

_CHUNK = 1 << 16


class ChaosEvent(NamedTuple):
    """One scheduled fault: ``kind`` hits ``worker`` at ``t`` seconds.

    ``t`` is relative to :meth:`ChaosInjector.run` starting; ``duration``
    only applies to ``hang`` (how long the process stays stopped) and
    ``delay`` (added per-chunk latency AND how long it stays in effect).
    """

    t: float
    kind: str
    worker: str
    duration: float = 0.25


class ChaosSchedule:
    """An ordered, declarative fault schedule (what hits whom, when)."""

    def __init__(self, events: Sequence[ChaosEvent]):
        for ev in events:
            if ev.kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {ev.kind!r} "
                                 f"(expected one of {FAULT_KINDS})")
        self.events: List[ChaosEvent] = sorted(events, key=lambda e: e.t)

    @classmethod
    def random(cls, seed: int, workers: Sequence[str], *,
               n_events: int = 6, horizon: float = 3.0,
               kinds: Sequence[str] = FAULT_KINDS,
               max_duration: float = 0.4) -> "ChaosSchedule":
        """A seeded schedule: same seed + workers → same faults, always.

        >>> s = ChaosSchedule.random(7, ["w0", "w1"], n_events=3)
        >>> s.events == ChaosSchedule.random(7, ["w0", "w1"],
        ...                                  n_events=3).events
        True
        >>> all(e.kind in FAULT_KINDS and e.worker in ("w0", "w1")
        ...     for e in s)
        True
        """
        rng = random.Random(seed)
        events = [ChaosEvent(t=round(rng.uniform(0.05, horizon), 3),
                             kind=rng.choice(list(kinds)),
                             worker=rng.choice(list(workers)),
                             duration=round(rng.uniform(0.05, max_duration),
                                            3))
                  for _ in range(n_events)]
        return cls(events)

    def __iter__(self):
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)

    def __repr__(self) -> str:
        return f"ChaosSchedule({self.events!r})"


# -- wire interposition ------------------------------------------------------


class FaultProxy:
    """A TCP interposer between the router and ONE worker's endpoint.

    Relays bytes both ways untouched until told otherwise:

    * ``delay`` (seconds) — sleep before relaying each worker→router
      chunk (a slow worker without touching the worker);
    * ``truncate_next`` — relay only HALF of the next worker→router chunk
      and then sever both sides of the connection: the router's client
      sees a torn frame followed by EOF.  One-shot.

    The flags are plain attributes read in the data path, so tests may
    set them from any thread; the proxy itself lives on the router's
    event loop (created by :meth:`ProxyManager.wrap`).
    """

    def __init__(self, name: str):
        self.name = name
        self.target: Optional[Tuple[str, int]] = None
        self.host: Optional[str] = None
        self.port: Optional[int] = None
        self.delay = 0.0
        self.truncate_next = False
        self.counters = {"connections": 0, "truncated": 0,
                         "delayed_chunks": 0}
        self._server: Optional[asyncio.AbstractServer] = None
        self._tasks: set = set()

    async def start(self) -> "FaultProxy":
        assert self._server is None, "proxy already started"
        self._server = await asyncio.start_server(self._handle,
                                                  "127.0.0.1", 0)
        sock = self._server.sockets[0].getsockname()
        self.host, self.port = sock[0], sock[1]
        return self

    def set_target(self, host: str, port: int) -> None:
        """Point at the current worker generation's real endpoint."""
        self.target = (host, port)

    async def _handle(self, creader: asyncio.StreamReader,
                      cwriter: asyncio.StreamWriter) -> None:
        if self.target is None:
            cwriter.close()
            return
        try:
            ureader, uwriter = await asyncio.open_connection(*self.target)
        except OSError:
            cwriter.close()  # worker (re)starting: refuse like it would
            return
        self.counters["connections"] += 1
        loop = asyncio.get_running_loop()
        up = loop.create_task(self._pump_up(creader, uwriter))
        down = loop.create_task(self._pump_down(ureader, cwriter))
        self._tasks.update((up, down))
        try:
            done, pending = await asyncio.wait(
                (up, down), return_when=asyncio.FIRST_COMPLETED)
            for t in pending:
                t.cancel()
            await asyncio.gather(up, down, return_exceptions=True)
        finally:
            self._tasks.difference_update((up, down))
            for w in (cwriter, uwriter):
                with contextlib.suppress(ConnectionError, OSError,
                                         RuntimeError):
                    w.close()

    async def _pump_up(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        """router → worker: always relayed untouched."""
        with contextlib.suppress(ConnectionError, OSError):
            while True:
                chunk = await reader.read(_CHUNK)
                if not chunk:
                    return
                writer.write(chunk)
                await writer.drain()

    async def _pump_down(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        """worker → router: where delay and truncation strike."""
        with contextlib.suppress(ConnectionError, OSError):
            while True:
                chunk = await reader.read(_CHUNK)
                if not chunk:
                    return
                if self.delay > 0:
                    self.counters["delayed_chunks"] += 1
                    await asyncio.sleep(self.delay)
                if self.truncate_next:
                    self.truncate_next = False
                    self.counters["truncated"] += 1
                    writer.write(chunk[:max(1, len(chunk) // 2)])
                    with contextlib.suppress(ConnectionError, OSError):
                        await writer.drain()
                    return  # sever the connection mid-frame
                writer.write(chunk)
                await writer.drain()

    async def aclose(self) -> None:
        """Stop accepting, cut every relay, then wait (bounded) for the
        listener to close.

        The relays go first: since Python 3.12.1 ``Server.wait_closed()``
        waits for every open connection, and the relay tasks are what hold
        them open.
        """
        if self._server is not None:
            self._server.close()
        for t in list(self._tasks):
            t.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()
        if self._server is not None:
            await close_server(self._server)
            self._server = None


class ProxyManager:
    """One :class:`FaultProxy` per worker name, wired in as the router's
    ``wrap_endpoint`` hook.

    The proxy for a name persists across worker generations — each
    restart re-targets it — so its listen port is stable and fault flags
    survive the restart they usually caused.
    """

    def __init__(self):
        self.proxies: Dict[str, FaultProxy] = {}

    async def wrap(self, name: str, host: str, port: int,
                   ) -> Tuple[str, int]:
        proxy = self.proxies.get(name)
        if proxy is None:
            proxy = await FaultProxy(name).start()
            self.proxies[name] = proxy
        proxy.set_target(host, port)
        return proxy.host, proxy.port

    def __getitem__(self, name: str) -> FaultProxy:
        return self.proxies[name]

    def __contains__(self, name: str) -> bool:
        return name in self.proxies

    async def aclose(self) -> None:
        for proxy in self.proxies.values():
            await proxy.aclose()
        self.proxies.clear()


# -- applying a schedule -----------------------------------------------------


class ChaosInjector:
    """Replays a :class:`ChaosSchedule` against a live router.

    Runs on the router's event loop (see :func:`inject` for driving it
    from a synchronous test through :class:`ClusterThread`).  ``applied``
    records what actually fired; ``skipped`` what could not (unknown
    worker, or a wire fault with no proxy for it).
    """

    def __init__(self, router, proxies: Optional[ProxyManager] = None):
        self.router = router
        self.proxies = proxies
        self.applied: List[ChaosEvent] = []
        self.skipped: List[ChaosEvent] = []
        self._cleanups: List[asyncio.Task] = []

    async def run(self, schedule: ChaosSchedule) -> List[ChaosEvent]:
        """Apply every event at its scheduled offset; returns ``applied``.

        Resolves only after trailing effects (hang resumes, delay
        windows) have been undone, so a completed run leaves no fault
        standing.
        """
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        for ev in schedule:
            await asyncio.sleep(max(0.0, t0 + ev.t - loop.time()))
            self._apply(ev)
        if self._cleanups:
            await asyncio.gather(*self._cleanups, return_exceptions=True)
        return self.applied

    def _apply(self, ev: ChaosEvent) -> None:
        loop = asyncio.get_running_loop()
        slot = self.router._slots.get(ev.worker)
        if ev.kind in ("kill", "hang") and slot is None:
            self.skipped.append(ev)
            return
        if ev.kind in ("delay", "truncate") and (
                self.proxies is None or ev.worker not in self.proxies):
            self.skipped.append(ev)
            return
        if ev.kind == "kill":
            slot.proc.kill()
        elif ev.kind == "hang":
            slot.proc.pause()
            self._cleanups.append(loop.create_task(
                self._resume_later(slot, ev.duration)))
        elif ev.kind == "delay":
            proxy = self.proxies[ev.worker]
            proxy.delay = max(proxy.delay, ev.duration)
            self._cleanups.append(loop.create_task(
                self._clear_delay_later(proxy, ev.duration)))
        else:  # truncate
            self.proxies[ev.worker].truncate_next = True
        self.applied.append(ev)

    @staticmethod
    async def _resume_later(slot, duration: float) -> None:
        await asyncio.sleep(duration)
        # if the health probe already SIGKILLed the hung generation this
        # is a no-op on a dead pid — both outcomes are valid recoveries
        slot.proc.resume()

    @staticmethod
    async def _clear_delay_later(proxy: FaultProxy,
                                 duration: float) -> None:
        await asyncio.sleep(duration)
        proxy.delay = 0.0


def inject(cluster, schedule: ChaosSchedule,
           proxies: Optional[ProxyManager] = None):
    """Start a schedule against a :class:`ClusterThread` from sync code.

    Returns ``(injector, future)``: the concurrent future resolves (with
    ``injector.applied``) once every event has fired and its trailing
    effects are undone.
    """
    injector = ChaosInjector(cluster.router, proxies)
    fut = asyncio.run_coroutine_threadsafe(injector.run(schedule),
                                           cluster._loop)
    return injector, fut
