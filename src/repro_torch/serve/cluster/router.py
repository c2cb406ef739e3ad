"""The cluster router: replicated consistent-hash fan-out over workers.

Topology (one router process, N worker processes)::

    clients ──TCP──▶ Router ──┬──▶ worker w0  (repro_torch.serve, own port)
      JSON-lines    (ring)    ├──▶ worker w1
                              └──▶ worker w…

Every collection (``qrel_id``) is owned by a **replica set** of
``replication`` distinct workers — the first R nodes met walking the
:class:`~repro_torch.serve.cluster.ring.HashRing` clockwise from the key's
hash.  ``register_qrel`` / ``register_run`` fan out to every *ready*
replica before acking (replicas that are down catch up from the journal
when they restart); read ops (``evaluate`` / ``compare``) are balanced
across live replicas with **power-of-two-choices** on in-flight counts,
filtered through a per-worker circuit breaker
(:class:`~repro_torch.serve.cluster.breaker.CircuitBreaker`).  ``evaluate`` /
``compare`` ride the raw fan-out path (:meth:`AsyncEvalClient.forward`):
the router parses each request line once for routing, then relays the
original bytes with a spliced internal id and relays the response bytes
back with the client's id restored — no second serialization of
multi-megabyte payloads.

Durability: with ``state_dir`` set, every acknowledged registration is
appended to an on-disk JSONL journal
(:class:`~repro_torch.serve.cluster.journal.RegistrationJournal`) *before* the
client sees the ack, so a whole-cluster restart against the same
``--state-dir`` recovers every acknowledged collection.  ``drop_qrel``
prunes the journal — in memory AND on disk — the moment any replica
acknowledges it, so neither a restarted sibling's replay nor a cluster
restart can resurrect a dropped collection.

Deadlines: a request may carry ``deadline_ms``; the router enforces it
end-to-end (a late answer becomes a ``deadline_exceeded`` error response)
and, for idempotent ops with a live sibling, fires a **hedged** second
request once ``hedge_fraction`` of the budget has elapsed without an
answer — first response wins.

Fault model:

* a worker crash fails that worker's in-flight futures immediately; the
  router **fails over to a sibling replica at once** (no waiting for the
  restart) while the supervisor restarts the process with exponential
  backoff and replays the journal before marking it ready again;
* **idempotent** ops (``evaluate``, ``compare``, ``register_*``, reads)
  retry transparently; a replica answering ``not_found`` for a journaled
  collection (it missed a registration while restarting) is *healed* —
  re-registered from the journal — and the request retried;
* **non-idempotent** ``drop_qrel`` fans out to every ready replica: it
  succeeds if ANY replica acknowledges (so with R >= 2 a single dead
  replica no longer forces ``worker_unavailable``), and only when every
  replica is down/unreachable does the caller get the machine-readable
  ``worker_unavailable`` error;
* repeated transport failures trip a worker's circuit breaker (closed →
  open → half-open probe), which removes it from the balancing candidate
  set until a probe succeeds;
* a periodic ``health`` probe per worker catches hung-but-alive processes
  and kills them onto the same restart path.

Membership changes (:meth:`Router.add_worker` / :meth:`Router.remove_worker`)
rebalance replica sets with journal replay: collections gaining a replica
are registered on it *before* the ring swaps (requests never see a gap)
and replicas leaving a set are best-effort dropped after.

:meth:`Router.drain` cascades: wait for router-level in-flight requests,
then stop every worker via SIGTERM → the worker's own
``EvaluationService.drain`` machinery.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import random
import re
import sys
import time
from typing import Dict, List, Optional, Sequence, Set

from repro_torch.client.errors import ServerError
from repro_torch.serve.cluster.breaker import CircuitBreaker
from repro_torch.serve.cluster.journal import RegistrationJournal
from repro_torch.serve.cluster.ring import HashRing
from repro_torch.serve.cluster.worker import WorkerProcess
from repro_torch.serve.frontend import _check_request, _error
from repro_torch.serve.wire import DEFAULT_FRAME_LIMIT, ProtocolError

#: responses from our own front-ends lead with their id (dict insertion
#: order survives json.dumps), so the id can be rewritten by prefix splice
_RESPONSE_ID = re.compile(rb'^\{"id":\s*(?:-?\d+|null)\s*,')

#: ops fanned out as raw bytes (hot path) and retried across restarts
_RAW_OPS = frozenset({"evaluate", "compare"})

#: ops handled with a parsed round trip, journaled, and retried
_CONTROL_OPS = frozenset({"register_qrel", "register_run"})

#: marker for a forwarded worker response that reports a missing
#: collection — for journaled collections this means the replica missed a
#: registration (e.g. it restarted before the journal had it) and should
#: be healed rather than believed
_NOT_FOUND_MARK = b'"code": "not_found"'


def _rewrite_id(resp: bytes, rid) -> bytes:
    """Restore the client's request id on a forwarded response frame."""
    rid_b = json.dumps(rid).encode()
    m = _RESPONSE_ID.match(resp)
    if m is not None:
        return b'{"id": ' + rid_b + b"," + resp[m.end():]
    try:  # rare: a response shape we don't recognise — parse and patch
        msg = json.loads(resp)
        msg["id"] = rid
        return json.dumps(msg).encode()
    except ValueError:  # pragma: no cover - garbage from a worker
        return resp


class _Slot:
    """One worker position on the ring (stable name, restartable process)."""

    __slots__ = ("name", "proc", "ready", "restarts", "supervisor",
                 "health_task", "breaker", "inflight")

    def __init__(self, name: str, proc: WorkerProcess,
                 breaker: CircuitBreaker):
        self.name = name
        self.proc = proc
        self.ready = asyncio.Event()
        self.restarts = 0
        self.supervisor: Optional[asyncio.Task] = None
        self.health_task: Optional[asyncio.Task] = None
        self.breaker = breaker
        self.inflight = 0  # requests this slot is currently answering


class Router:
    """Replicated consistent-hash router over supervised serve workers.

    ``worker_args`` is appended to every worker's command line (measure
    flags, ``--window-ms``, ``--backend``, ...).  ``replication`` sizes
    each collection's replica set (capped at the pool size); ``retries``
    bounds transparent re-sends of idempotent requests across worker
    failures; ``ready_timeout`` bounds how long a request waits for ANY
    replica to come (back) up before giving up with
    ``worker_unavailable``, and each worker generation's banner and first
    ``ping`` (its default, 30 s, covers a generation's torch import plus
    its CUDA context on the card).  ``state_dir`` makes the registration
    journal durable; ``breaker_failures`` / ``breaker_cooldown``
    parameterize each worker's circuit breaker; ``hedge_fraction`` is the
    share of a ``deadline_ms`` budget that elapses before an idempotent
    request is hedged to a sibling replica.  ``rng_seed`` pins the
    power-of-two-choices sampling (tests); ``wrap_endpoint`` is an async
    hook ``(name, host, port) -> (host, port)`` interposed between the
    router and each worker generation (the chaos harness's proxy
    injection point).
    """

    def __init__(self, n_workers: int = 2, *,
                 worker_args: Sequence[str] = (), replicas: int = 64,
                 replication: int = 1, retries: int = 3,
                 ready_timeout: float = 30.0, start_timeout: float = 60.0,
                 health_interval: float = 1.0, health_timeout: float = 5.0,
                 backoff: float = 0.25, max_backoff: float = 4.0,
                 frame_limit: int = DEFAULT_FRAME_LIMIT,
                 state_dir: Optional[str] = None,
                 breaker_failures: int = 3, breaker_cooldown: float = 1.0,
                 hedge_fraction: float = 0.5,
                 rng_seed: Optional[int] = None, wrap_endpoint=None):
        if n_workers < 1:
            raise ValueError(f"need at least one worker, got {n_workers}")
        if not 0.0 < hedge_fraction <= 1.0:
            raise ValueError(
                f"hedge_fraction must be in (0, 1], got {hedge_fraction}")
        self._n_initial = int(n_workers)
        self._worker_args = [str(a) for a in worker_args]
        self._replication = max(1, int(replication))
        self._retries = int(retries)
        self._ready_timeout = float(ready_timeout)
        self._start_timeout = float(start_timeout)
        self._health_interval = float(health_interval)
        self._health_timeout = float(health_timeout)
        self._backoff = float(backoff)
        self._max_backoff = float(max_backoff)
        self._frame_limit = int(frame_limit)
        self._breaker_failures = int(breaker_failures)
        self._breaker_cooldown = float(breaker_cooldown)
        self._hedge_fraction = float(hedge_fraction)
        self._rng = random.Random(rng_seed)
        self._wrap_endpoint = wrap_endpoint
        self._ring = HashRing(replicas=replicas)
        self._slots: Dict[str, _Slot] = {}
        self._next_slot = 0
        #: the registration journal: replayed onto restarted workers and
        #: onto new replica-set members at rebalance; durable on disk when
        #: ``state_dir`` is set (recovered in this constructor).
        self._journal = RegistrationJournal(state_dir,
                                            frame_limit=frame_limit)
        self._inflight = 0
        self._closing = False
        self.counters = {
            "requests": 0, "forwarded": 0, "worker_retries": 0,
            "worker_unavailable": 0, "restarts": 0, "health_failures": 0,
            "replayed_collections": 0, "rebalanced_collections": 0,
            "failovers": 0, "hedges": 0, "hedge_wins": 0,
            "deadline_exceeded": 0, "healed_replicas": 0,
        }

    # -- pool lifecycle ------------------------------------------------------

    def _new_slot(self, name: Optional[str] = None) -> _Slot:
        if name is None:
            name = f"w{self._next_slot}"
        self._next_slot += 1
        if name in self._slots:
            raise ValueError(f"worker {name!r} already exists")
        slot = _Slot(
            name,
            WorkerProcess(name, extra_args=self._worker_args,
                          frame_limit=self._frame_limit,
                          wrap_endpoint=self._wrap_endpoint),
            CircuitBreaker(failures=self._breaker_failures,
                           cooldown=self._breaker_cooldown))
        self._slots[name] = slot
        loop = asyncio.get_running_loop()
        slot.supervisor = loop.create_task(self._supervise(slot))
        slot.health_task = loop.create_task(self._health_loop(slot))
        return slot

    async def start(self) -> None:
        """Spawn the initial pool and wait until every worker is ready.

        With a durable ``state_dir``, the journal was already recovered in
        the constructor — each worker's first :meth:`_replay` (before it
        is marked ready) re-registers every acknowledged collection, so
        the cluster accepts traffic only once recovery is complete.
        """
        slots = [self._new_slot() for _ in range(self._n_initial)]
        for slot in slots:
            self._ring.add(slot.name)
        try:
            await asyncio.wait_for(
                asyncio.gather(*(s.ready.wait() for s in slots)),
                self._start_timeout)
        except asyncio.TimeoutError:
            stderr = {s.name: list(s.proc.last_stderr)[-3:]
                      for s in slots if not s.ready.is_set()}
            await self.drain()
            raise RuntimeError(
                f"cluster failed to start within {self._start_timeout}s; "
                f"unready workers: {stderr}") from None

    async def _supervise(self, slot: _Slot) -> None:
        """Keep one slot populated: start → ready → wait for death → redo."""
        backoff = self._backoff
        while not self._closing:
            try:
                await slot.proc.start(ready_timeout=self._ready_timeout)
                await self._replay(slot)
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # startup/replay failed: back off
                if self._closing:
                    return
                # a failed REPLAY leaves a live half-started generation
                # behind — put it down, or the next start() refuses to
                # spawn over it and this loop wedges forever
                slot.proc.kill()
                with contextlib.suppress(Exception):
                    await slot.proc.wait()
                if slot.proc.client is not None:
                    with contextlib.suppress(Exception):
                        await slot.proc.client.aclose()
                print(f"[cluster] worker {slot.name} start failed: {exc}; "
                      f"retrying in {backoff:.2f}s", file=sys.stderr,
                      flush=True)
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, self._max_backoff)
                continue
            backoff = self._backoff
            slot.breaker.record_success()  # fresh generation: close it
            slot.ready.set()
            await slot.proc.wait()  # blocks for this generation's lifetime
            slot.ready.clear()
            if slot.proc.client is not None:
                # fail the dead generation's pending futures NOW so raw
                # forwards waiting on them retry instead of hanging
                with contextlib.suppress(Exception):
                    await slot.proc.client.aclose()
            if self._closing:
                return
            slot.restarts += 1
            self.counters["restarts"] += 1
            print(f"[cluster] worker {slot.name} exited "
                  f"(rc={slot.proc.proc.returncode}); restarting in "
                  f"{backoff:.2f}s", file=sys.stderr, flush=True)
            await asyncio.sleep(backoff)

    async def _health_loop(self, slot: _Slot) -> None:
        """Probe a ready worker with the cheap ``health`` op on a timer.

        ``proc.wait`` in the supervisor catches crashes instantly; this
        loop catches the *hung-but-alive* worker (e.g. SIGSTOP), which
        gets SIGKILLed onto the same restart-and-replay path.
        """
        while not self._closing:
            await asyncio.sleep(self._health_interval)
            if self._closing or not slot.ready.is_set():
                continue
            client = slot.proc.client
            try:
                await asyncio.wait_for(client.health(),
                                       self._health_timeout)
            except asyncio.CancelledError:
                raise
            except Exception:
                if self._closing or not slot.ready.is_set():
                    continue
                self.counters["health_failures"] += 1
                slot.breaker.record_failure()
                print(f"[cluster] worker {slot.name} failed its health "
                      "check; killing for restart", file=sys.stderr,
                      flush=True)
                slot.ready.clear()
                slot.proc.kill()

    async def _replay(self, slot: _Slot, ring: Optional[HashRing] = None,
                      only: Optional[Sequence[str]] = None) -> int:
        """Re-register journaled collections replicated on ``slot``.

        ``ring`` defaults to the live ring; rebalancing passes the *next*
        ring so moved collections land on their future replicas before the
        swap.  ``only`` restricts to the listed qrel ids.
        """
        ring = ring if ring is not None else self._ring
        client = slot.proc.client
        n = 0
        for qrel_id in (list(self._journal) if only is None else only):
            entry = self._journal.get(qrel_id)
            if entry is None or slot.name not in ring.owners(
                    qrel_id, self._replication):
                continue
            await client._request("register_qrel", **entry["qrel"])
            for run_payload in entry["runs"].values():
                await client._request("register_run", **run_payload)
            n += 1
        if n:
            self.counters["replayed_collections"] += n
        return n

    # -- membership changes --------------------------------------------------

    async def add_worker(self, name: Optional[str] = None) -> str:
        """Grow the pool by one worker; rebalance moved replica sets.

        The new worker is started and loaded with every collection whose
        grown replica set includes it *before* the ring is swapped, so
        routing never sees a replica without its data; replicas leaving a
        set drop their copies afterwards (best effort — a failed drop only
        wastes cache).
        """
        slot = self._new_slot(name)
        try:
            await asyncio.wait_for(slot.ready.wait(), self._start_timeout)
        except asyncio.TimeoutError:
            await self._retire_slot(slot)
            self._slots.pop(slot.name, None)
            raise RuntimeError(
                f"new worker {slot.name} failed to become ready; "
                f"stderr: {list(slot.proc.last_stderr)[-3:]}") from None
        new_ring = self._ring.copy()
        new_ring.add(slot.name)
        R = self._replication
        old_sets = {q: self._ring.owners(q, R) for q in self._journal}
        moved = [q for q in self._journal
                 if slot.name in new_ring.owners(q, R)]
        await self._replay(slot, ring=new_ring, only=moved)
        self._ring = new_ring
        self.counters["rebalanced_collections"] += len(moved)
        for q in moved:
            new_set = set(new_ring.owners(q, R))
            for old_name in old_sets[q]:
                if old_name in new_set:
                    continue
                old = self._slots.get(old_name)
                if old is not None and old.ready.is_set():
                    with contextlib.suppress(Exception):
                        await old.proc.client._request("drop_qrel",
                                                       qrel_id=q)
        return slot.name

    async def remove_worker(self, name: str) -> None:
        """Shrink the pool; its replica memberships move to their heirs."""
        if name not in self._slots:
            raise KeyError(f"no worker named {name!r}")
        if len(self._slots) == 1:
            raise ValueError("cannot remove the last worker")
        slot = self._slots[name]
        new_ring = self._ring.copy()
        new_ring.remove(name)
        R = self._replication
        moved = []
        for q in self._journal:
            old_set = self._ring.owners(q, R)
            if name not in old_set:
                continue
            moved.append(q)
            for heir_name in new_ring.owners(q, R):
                if heir_name in old_set:
                    continue  # already a replica
                heir = self._slots[heir_name]
                if not await self._wait_ready(heir):
                    raise RuntimeError(
                        f"cannot rebalance {q!r}: worker {heir.name} is "
                        "down")
                await self._replay(heir, ring=new_ring, only=[q])
        self._ring = new_ring
        self.counters["rebalanced_collections"] += len(moved)
        del self._slots[name]
        await self._retire_slot(slot)

    async def _retire_slot(self, slot: _Slot) -> None:
        for task in (slot.health_task, slot.supervisor):
            if task is not None:
                task.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await task
        await slot.proc.stop()

    # -- request handling ----------------------------------------------------

    async def handle(self, req: dict, raw: bytes):
        """The :func:`repro_torch.serve.frontend.serve_protocol` handler.

        Returns a response dict, or raw response bytes for the fan-out
        path.  Never raises.
        """
        self.counters["requests"] += 1
        self._inflight += 1
        try:
            return await self._handle(req, raw)
        except Exception as exc:  # noqa: BLE001 — router bug: tell the client
            return _error(req.get("id"),
                          f"router error: {type(exc).__name__}: {exc}",
                          "internal")
        finally:
            self._inflight -= 1

    async def _handle(self, req: dict, raw: bytes):
        rid = req.get("id")
        try:
            op = _check_request(req)
        except ProtocolError as exc:
            return _error(rid, str(exc), exc.code)
        if op == "ping":
            return {"id": rid, "ok": True, "result": "pong"}
        if op == "health":
            return {"id": rid, "ok": True, "result": self.health()}
        if op == "auth":
            # serve_protocol intercepts auth when the router has a token;
            # with no token configured, accept any (same as the worker
            # front-end) so token-configured clients work unchanged
            return {"id": rid, "ok": True,
                    "result": {"authenticated": True}}
        if op == "stats":
            return {"id": rid, "ok": True, "result": await self.stats()}
        deadline, err = self._parse_deadline(req)
        if err is not None:
            return err
        qrel_id = str(req["qrel_id"])
        if op == "drop_qrel":
            return await self._drop(qrel_id, req, deadline)
        if op in _CONTROL_OPS:
            return await self._control(op, qrel_id, req, deadline)
        assert op in _RAW_OPS, op
        return await self._forward(qrel_id, raw, rid, deadline)

    # -- deadlines -----------------------------------------------------------

    def _parse_deadline(self, req: dict):
        """``deadline_ms`` → absolute loop deadline (or an error response)."""
        ms = req.get("deadline_ms")
        if ms is None:
            return None, None
        if isinstance(ms, bool) or not isinstance(ms, (int, float)) \
                or ms <= 0:
            return None, _error(
                req.get("id"), "field 'deadline_ms' must be a positive "
                f"number of milliseconds, got {ms!r}", "invalid")
        loop = asyncio.get_running_loop()
        return loop.time() + float(ms) / 1e3, None

    def _deadline_error(self, rid, op: str):
        self.counters["deadline_exceeded"] += 1
        return _error(
            rid, f"op {op!r} missed its 'deadline_ms' budget at the "
            "router; the work may still complete on a worker",
            "deadline_exceeded")

    @staticmethod
    def _expired(deadline: Optional[float]) -> bool:
        return (deadline is not None
                and asyncio.get_running_loop().time() >= deadline)

    async def _bounded(self, coro, deadline: Optional[float]):
        """Await ``coro`` within the deadline budget (TimeoutError past it)."""
        if deadline is None:
            return await coro
        remaining = deadline - asyncio.get_running_loop().time()
        if remaining <= 0:
            coro.close()
            raise asyncio.TimeoutError()
        return await asyncio.wait_for(coro, remaining)

    # -- replica selection ---------------------------------------------------

    def _replica_names(self, qrel_id: str,
                       ring: Optional[HashRing] = None) -> List[str]:
        ring = ring if ring is not None else self._ring
        return ring.owners(qrel_id, self._replication)

    def _replica_slots(self, qrel_id: str) -> List[_Slot]:
        return [self._slots[n] for n in self._replica_names(qrel_id)
                if n in self._slots]

    def _pick_slot(self, slots: Sequence[_Slot],
                   exclude: Set[str] = frozenset()) -> Optional[_Slot]:
        """Power-of-two-choices over live replicas, breaker-filtered.

        Candidates are the ready replicas not in ``exclude`` whose breaker
        admits traffic; if the breakers exclude everyone, availability
        wins over precision and all ready replicas are candidates again.
        Two candidates are sampled and the one with fewer in-flight
        requests is chosen (one candidate short-circuits).
        """
        ready = [s for s in slots
                 if s.ready.is_set() and s.name not in exclude]
        if not ready:
            return None
        allowed = [s for s in ready if s.breaker.would_allow()]
        pool = allowed or ready
        if len(pool) == 1:
            choice = pool[0]
        else:
            a, b = self._rng.sample(pool, 2)
            choice = a if a.inflight <= b.inflight else b
        choice.breaker.allow()  # consume the half-open probe slot, if any
        return choice

    async def _wait_any_ready(self, slots: Sequence[_Slot],
                              deadline: Optional[float]) -> bool:
        """Block until ANY of ``slots`` is ready (bounded)."""
        if not slots:
            return False
        if any(s.ready.is_set() for s in slots):
            return True
        timeout = self._ready_timeout
        if deadline is not None:
            timeout = min(
                timeout,
                max(0.0, deadline - asyncio.get_running_loop().time()))
        waiters = [asyncio.get_running_loop().create_task(s.ready.wait())
                   for s in slots]
        try:
            done, _pending = await asyncio.wait(
                waiters, timeout=timeout,
                return_when=asyncio.FIRST_COMPLETED)
            return bool(done)
        finally:
            for t in waiters:
                t.cancel()
            await asyncio.gather(*waiters, return_exceptions=True)

    def _unavailable(self, rid, qrel_id: str, op: str, attempts: int):
        self.counters["worker_unavailable"] += 1
        names = self._replica_names(qrel_id)
        return _error(
            rid, f"worker(s) {names!r} (replica set of qrel_id "
            f"{qrel_id!r}) unavailable; op {op!r} not completed after "
            f"{attempts} attempt(s)", "worker_unavailable")

    # -- the raw fan-out path (evaluate / compare) ---------------------------

    async def _forward_once(self, slot: _Slot, raw: bytes) -> bytes:
        slot.inflight += 1
        try:
            return await slot.proc.client.forward(raw)
        finally:
            slot.inflight -= 1

    async def _forward_recorded(self, slot: _Slot, raw: bytes) -> bytes:
        try:
            resp = await self._forward_once(slot, raw)
        except (ConnectionError, OSError):
            slot.breaker.record_failure()
            raise
        slot.breaker.record_success()
        return resp

    async def _hedged_forward(self, slot: _Slot, sibling: Optional[_Slot],
                              raw: bytes, deadline: float) -> bytes:
        """Primary attempt on ``slot``; hedge to ``sibling`` near the
        deadline; first successful response wins, the loser is cancelled.

        Raises ``asyncio.TimeoutError`` when the budget runs out, or the
        last transport error when every launched attempt failed.
        """
        loop = asyncio.get_running_loop()
        tasks: Dict[asyncio.Task, _Slot] = {
            loop.create_task(self._forward_once(slot, raw)): slot}
        hedge_at = loop.time() \
            + (deadline - loop.time()) * self._hedge_fraction
        hedged = False
        last_exc: Optional[BaseException] = None
        try:
            while tasks:
                now = loop.time()
                if now >= deadline:
                    raise asyncio.TimeoutError()
                horizon = deadline if (hedged or sibling is None) \
                    else min(hedge_at, deadline)
                done, _pending = await asyncio.wait(
                    set(tasks), timeout=max(0.0, horizon - now),
                    return_when=asyncio.FIRST_COMPLETED)
                if not done:
                    if hedged or sibling is None:
                        raise asyncio.TimeoutError()  # horizon == deadline
                    hedged = True  # near the deadline: fire the hedge
                    self.counters["hedges"] += 1
                    tasks[loop.create_task(
                        self._forward_once(sibling, raw))] = sibling
                    continue
                for t in done:
                    s = tasks.pop(t)
                    exc = t.exception()
                    if exc is None:
                        s.breaker.record_success()
                        if s is sibling:
                            self.counters["hedge_wins"] += 1
                        return t.result()
                    s.breaker.record_failure()
                    last_exc = exc
            if last_exc is not None:
                raise last_exc
            raise asyncio.TimeoutError()
        finally:
            for t in tasks:
                t.cancel()

    @staticmethod
    def _is_not_found(resp: bytes) -> bool:
        return b'"ok": false' in resp[:48] and _NOT_FOUND_MARK in resp

    async def _heal(self, slot: _Slot, qrel_id: str) -> None:
        """Re-register a journaled collection a replica turned out to miss."""
        entry = self._journal.get(qrel_id)
        if entry is None or slot.proc.client is None:
            return
        client = slot.proc.client
        await client._request("register_qrel", **entry["qrel"])
        for run_payload in entry["runs"].values():
            await client._request("register_run", **run_payload)
        self.counters["healed_replicas"] += 1

    async def _forward(self, qrel_id: str, raw: bytes, rid,
                       deadline: Optional[float] = None):
        """Raw fan-out: p2c replica choice, instant failover, hedging."""
        attempts = self._retries + 1
        failed: Set[str] = set()
        healed: Set[str] = set()  # replicas already re-registered once
        for attempt in range(attempts):
            if self._expired(deadline):
                return self._deadline_error(rid, "evaluate/compare")
            slots = self._replica_slots(qrel_id)
            slot = self._pick_slot(slots, exclude=failed)
            if slot is None:
                # every replica is down or already failed this request:
                # forgive past failures (a restart may be back) and wait
                failed.clear()
                if not await self._wait_any_ready(slots, deadline):
                    if self._expired(deadline):
                        return self._deadline_error(rid,
                                                    "evaluate/compare")
                    break
                continue
            try:
                if deadline is None:
                    resp = await self._forward_recorded(slot, raw)
                else:
                    sibling = self._pick_slot(
                        slots, exclude=failed | {slot.name})
                    resp = await self._hedged_forward(slot, sibling, raw,
                                                      deadline)
            except asyncio.TimeoutError:
                return self._deadline_error(rid, "evaluate/compare")
            except (ConnectionError, OSError):
                self.counters["worker_retries"] += 1
                if any(s.ready.is_set() for s in slots
                       if s.name not in failed and s.name != slot.name):
                    # a sibling replica is live: fail over immediately
                    failed.add(slot.name)
                    self.counters["failovers"] += 1
                else:
                    # no live sibling: keep this replica eligible and give
                    # the supervisor a beat to observe the death (its
                    # `ready` flag may be stale for an instant)
                    await asyncio.sleep(min(0.05 * 2 ** attempt, 1.0))
                continue
            if (slot.name not in healed and self._is_not_found(resp)
                    and qrel_id in self._journal):
                # THIS replica missed a registration (restart raced the
                # journal, or its LRU evicted the collection): heal it
                # and retry instead of relaying a lie — each replica gets
                # healed at most once per request
                healed.add(slot.name)
                with contextlib.suppress(Exception):
                    await self._bounded(self._heal(slot, qrel_id), deadline)
                continue
            self.counters["forwarded"] += 1
            return _rewrite_id(resp, rid)
        return self._unavailable(rid, qrel_id, "evaluate/compare", attempts)

    # -- journaled control ops (register_*) ----------------------------------

    async def _control(self, op: str, qrel_id: str, req: dict,
                       deadline: Optional[float] = None):
        """``register_*``: fan out to every ready replica, journal, ack.

        The ack requires at least one replica to hold the registration;
        replicas that are down (or die mid-request) catch up from the
        journal when their restart replays it.  A *rejected* registration
        (ServerError — bad measures, malformed qrel) is returned verbatim
        and never journaled.
        """
        rid = req.get("id")
        payload = {k: v for k, v in req.items() if k not in ("op", "id")}
        attempts = self._retries + 1
        acked: Set[str] = set()
        result = None
        for attempt in range(attempts):
            if self._expired(deadline):
                return self._deadline_error(rid, op)
            for name in self._replica_names(qrel_id):
                if name in acked:
                    continue
                slot = self._slots.get(name)
                if slot is None or not slot.ready.is_set():
                    continue  # journal replay covers it after restart
                try:
                    result = await self._bounded(
                        slot.proc.client._request(op, **payload), deadline)
                except asyncio.TimeoutError:
                    if acked:
                        break  # already durable on a replica: ack below
                    return self._deadline_error(rid, op)
                except (ConnectionError, OSError):
                    slot.breaker.record_failure()
                    self.counters["worker_retries"] += 1
                    continue
                except ServerError as exc:
                    return _error(rid, exc.args[0], exc.code)
                slot.breaker.record_success()
                acked.add(name)
            if acked:
                # journal BEFORE acking: once the client sees ok, a worker
                # restart, a rebalance, or (durable) a cluster restart
                # must be able to reproduce the registration.
                if op == "register_qrel":
                    self._journal.record_qrel(qrel_id, payload)
                else:
                    self._journal.record_run(qrel_id, str(req["run_id"]),
                                             payload)
                return {"id": rid, "ok": True, "result": result}
            if not await self._wait_any_ready(self._replica_slots(qrel_id),
                                              deadline):
                if self._expired(deadline):
                    return self._deadline_error(rid, op)
                break
        return self._unavailable(rid, qrel_id, op, attempts)

    # -- drop (non-idempotent) -----------------------------------------------

    async def _drop(self, qrel_id: str, req: dict,
                    deadline: Optional[float] = None):
        """``drop_qrel``: fan out to every ready replica, prune the journal.

        Succeeds when ANY replica acknowledges — with R >= 2 a single dead
        replica no longer forces ``worker_unavailable``.  The journal is
        pruned (memory + durable log) the moment one replica answers, so
        neither a dead sibling's restart replay nor a cluster restart can
        resurrect the dropped collection.  Only when NO replica can be
        reached does the caller get ``worker_unavailable`` — the drop is
        never retried behind their back.
        """
        rid = req.get("id")
        slots = self._replica_slots(qrel_id)
        ready = [s for s in slots if s.ready.is_set()]
        if not ready:
            self.counters["worker_unavailable"] += 1
            names = [s.name for s in slots]
            return _error(
                rid, f"all replicas {names!r} of qrel_id {qrel_id!r} are "
                "down; 'drop_qrel' is not retried — re-send once a "
                "replica is back if the drop still matters",
                "worker_unavailable")
        dropped = False
        reached = False
        first_err: Optional[ServerError] = None
        for slot in ready:
            if not slot.ready.is_set():
                # it died while an earlier replica answered, and its
                # supervisor closed its client: unreachable, like a
                # transport error (repro.serve.cluster's router calls the
                # closed client and answers "internal" here)
                continue
            try:
                result = await self._bounded(
                    slot.proc.client._request("drop_qrel",
                                              qrel_id=req["qrel_id"]),
                    deadline)
            except asyncio.TimeoutError:
                # ambiguous (the drop may have landed); surface the
                # deadline, do NOT prune — the caller decides
                return self._deadline_error(rid, "drop_qrel")
            except ServerError as exc:
                reached = True
                if first_err is None:
                    first_err = exc
            except (ConnectionError, OSError):
                slot.breaker.record_failure()
            else:
                slot.breaker.record_success()
                reached = True
                dropped = dropped or bool(result.get("dropped"))
        if not reached:
            self.counters["worker_unavailable"] += 1
            return _error(
                rid, f"every live replica of qrel_id {qrel_id!r} died "
                "during 'drop_qrel'; the drop may or may not have "
                "happened", "worker_unavailable")
        # at least one replica answered: the drop is authoritative — prune
        # so no replay (sibling restart OR durable cluster restart) can
        # resurrect the collection
        self._journal.record_drop(qrel_id)
        if first_err is not None and not dropped:
            return _error(rid, first_err.args[0], first_err.code)
        return {"id": rid, "ok": True, "result": {"dropped": dropped}}

    async def _wait_ready(self, slot: _Slot) -> bool:
        if slot.ready.is_set():
            return True
        try:
            await asyncio.wait_for(slot.ready.wait(), self._ready_timeout)
            return True
        except asyncio.TimeoutError:
            return False

    # -- introspection -------------------------------------------------------

    def health(self) -> dict:
        """Local (no worker round trip) cluster liveness snapshot."""
        workers = [{
            "name": s.name, "ready": s.ready.is_set(),
            "generation": s.proc.generation, "restarts": s.restarts,
            "pid": s.proc.proc.pid if s.proc.proc is not None else None,
            "breaker": s.breaker.state, "inflight": s.inflight,
        } for s in self._slots.values()]
        ready = sum(1 for w in workers if w["ready"])
        return {"status": "ok" if ready == len(workers) else "degraded",
                "workers": workers, "ready": ready,
                "replication": self._replication,
                "collections": len(self._journal)}

    async def stats(self) -> dict:
        """Aggregated worker stats + router counters.

        Top-level ``requests``/``backend_calls`` sum over live workers so
        existing coalescing assertions read the same keys as against a
        single server.
        """
        workers: Dict[str, Optional[dict]] = {}
        for name, slot in self._slots.items():
            if slot.ready.is_set():
                try:
                    workers[name] = await slot.proc.client.stats()
                    continue
                except Exception:
                    pass
            workers[name] = None
        live = [w for w in workers.values() if w is not None]
        return {
            "requests": sum(w.get("requests", 0) for w in live),
            "backend_calls": sum(w.get("backend_calls", 0) for w in live),
            "collections": sorted(
                {c for w in live for c in w.get("collections", ())}),
            "router": {**self.counters, "workers": len(self._slots),
                       "ready": sum(1 for w in workers.values()
                                    if w is not None),
                       "replication": self._replication,
                       "journal_collections": len(self._journal),
                       "journal": self._journal.stats(),
                       "breakers": {n: s.breaker.stats()
                                    for n, s in self._slots.items()}},
            "workers": workers,
        }

    @property
    def worker_names(self) -> Sequence[str]:
        return tuple(self._slots)

    def owner_of(self, qrel_id: str) -> str:
        """The primary replica of ``qrel_id`` (fault-injection aid)."""
        return self._ring.owner(str(qrel_id))

    def replicas_of(self, qrel_id: str) -> List[str]:
        """The full replica set of ``qrel_id``, primary first."""
        return self._replica_names(str(qrel_id))

    # -- drain ---------------------------------------------------------------

    async def quiesce(self, timeout: float = 30.0) -> bool:
        """Wait for router-level in-flight requests to finish."""
        deadline = time.monotonic() + timeout
        while self._inflight and time.monotonic() < deadline:
            await asyncio.sleep(0.002)
        return self._inflight == 0

    async def drain(self, *, timeout: float = 30.0) -> None:
        """Answer what's in flight, then cascade shutdown to the workers.

        The caller must already have closed the listener (new connections
        refused); this waits for in-flight requests, then stops
        supervision and SIGTERMs every worker so each runs its own drain.
        """
        self._closing = True
        await self.quiesce(timeout)
        for slot in list(self._slots.values()):
            await self._retire_slot(slot)
        self._slots.clear()
