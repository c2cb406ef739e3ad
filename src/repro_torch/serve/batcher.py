"""Time/size-windowed coalescing of concurrent evaluation requests.

The paper's core argument is that evaluation overhead is dominated by fixed
per-call costs; the serving corollary is that N concurrent requests for the
same collection should pay those costs ONCE.  :class:`MicroBatcher` is the
piece that makes this happen: requests submitted for the same key within a
short window (or until a size cap fills) are flushed together as one list,
and the caller's flush function turns the whole list into one backend
``evaluate_buffers`` call.

Semantics:

* the FIRST item arriving for an idle key opens that key's window; a flush
  fires ``window`` seconds later with everything that accumulated;
* reaching ``max_batch`` pending items flushes immediately (the timer for
  that generation is cancelled) — latency is thus bounded by ``window`` and
  batch size by ``max_batch``;
* each flush calls ``flush_fn(key, items)`` — an async callable returning
  one result per item, in order.  Results (or the raised exception) are
  fanned back out to every waiter;
* cancellation fans out too: ``asyncio.CancelledError`` is a
  ``BaseException``, so it is handled on its own path — a cancelled flush
  (or a timer cancelled mid-window at teardown) cancels every coalesced
  waiter's future and re-raises, instead of leaving them pending forever;
* ``window=0`` still coalesces: the flush is scheduled as a task, so every
  request already sitting in the event-loop's ready queue joins the batch.

The batcher is asyncio-native and single-loop; it holds no threads of its
own.  Backend work belonging in a thread (jit dispatch, numpy scatter) is
the flush function's business (`asyncio.to_thread`), not the batcher's.
"""

from __future__ import annotations

import asyncio
from typing import Any, Awaitable, Callable, Dict, List, Tuple

FlushFn = Callable[[str, List[Any]], Awaitable[List[Any]]]


class MicroBatcher:
    """Coalesce per-key submissions into windowed flush calls.

    >>> import asyncio
    >>> async def demo():
    ...     async def flush(key, items):  # one "backend call" per flush
    ...         return [f"{key}:{x}" for x in items]
    ...     mb = MicroBatcher(flush, window=0.005, max_batch=8)
    ...     out = await asyncio.gather(*(mb.submit('k', i) for i in range(3)))
    ...     return out, mb.flushes
    >>> asyncio.run(demo())
    (['k:0', 'k:1', 'k:2'], 1)
    """

    def __init__(self, flush_fn: FlushFn, window: float = 0.002,
                 max_batch: int = 64):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._flush_fn = flush_fn
        self.window = float(window)
        self.max_batch = int(max_batch)
        #: pending per key: list of (item, future) awaiting the next flush
        self._pending: Dict[str, List[Tuple[Any, asyncio.Future]]] = {}
        self._timers: Dict[str, asyncio.Task] = {}
        self._inflight = 0  # claimed batches whose flush has not finished
        self.flushes = 0  # completed flush calls (the backend-call count)
        self.submitted = 0

    async def submit(self, key: str, item: Any) -> Any:
        """Queue ``item`` under ``key``; resolves with its flush result."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        slot = self._pending.setdefault(key, [])
        slot.append((item, fut))
        self.submitted += 1
        if len(slot) >= self.max_batch:
            self._flush_now(key)
        elif key not in self._timers:
            self._timers[key] = loop.create_task(self._timed_flush(key))
        return await fut

    async def _timed_flush(self, key: str) -> None:
        # Leave the timer registry BEFORE flushing: once a flush is in
        # progress it must not be cancellable by a size-cap flush of the
        # next generation, or its waiters would never resolve.
        try:
            if self.window > 0:
                await asyncio.sleep(self.window)
        except asyncio.CancelledError:
            # Cancelled while waiting out the window.  Two callers do this:
            # ``_flush_now`` (which has ALREADY claimed the batch — our key
            # may even belong to a newer generation by now) and external
            # teardown (which has not).  Only if we are still the registered
            # timer is the pending batch ours to clean up; claim it and
            # cancel its waiters so no submit() awaits a flush that will
            # never come.  Either way the cancellation keeps propagating.
            if self._timers.get(key) is asyncio.current_task():
                del self._timers[key]
                for _, fut in self._pending.pop(key, []):
                    if not fut.done():
                        fut.cancel()
            raise
        self._timers.pop(key, None)
        # Claim the batch and mark it in flight in the same loop step the
        # timer leaves the registry, so idle() never sees a gap between
        # "timer gone" and "flush running" (drain relies on this).
        batch = self._pending.pop(key, [])
        self._inflight += 1
        try:
            await self._do_flush(key, batch)
        finally:
            self._inflight -= 1

    def _flush_now(self, key: str) -> None:
        """Size cap reached: cancel the window timer, flush immediately.

        The batch is claimed synchronously HERE — if it were left for the
        flush task to pop, requests arriving before that task runs would
        pile into the same batch and ``max_batch`` would not actually bound
        the coalesced size.
        """
        timer = self._timers.pop(key, None)
        if timer is not None:
            timer.cancel()
        batch = self._pending.pop(key, [])
        self._inflight += 1  # claimed here, released when the task finishes
        asyncio.get_running_loop().create_task(self._guarded_flush(key, batch))

    async def _guarded_flush(self, key: str, batch) -> None:
        try:
            await self._do_flush(key, batch)
        finally:
            self._inflight -= 1

    async def _do_flush(self, key: str, batch) -> None:
        if not batch:
            return
        items = [item for item, _ in batch]
        try:
            results = await self._flush_fn(key, items)
            if len(results) != len(items):
                raise RuntimeError(
                    f"flush returned {len(results)} results for "
                    f"{len(items)} items")
        except asyncio.CancelledError:
            # CancelledError is a BaseException (py3.8+), so the Exception
            # clause below never sees it.  A cancelled flush — the flush_fn
            # was cancelled, or the flush task itself was — must still fan
            # out to its waiters, or every submit() coalesced into this
            # batch awaits a future nobody will ever resolve.  Then
            # re-raise: cancellation must keep propagating to the task.
            for _, fut in batch:
                if not fut.done():
                    fut.cancel()
            raise
        except Exception as exc:  # noqa: BLE001 — fan the error out to waiters
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(exc)
            return
        finally:
            self.flushes += 1
        for (_, fut), res in zip(batch, results):
            if not fut.done():
                fut.set_result(res)

    def pending_count(self, key: str) -> int:
        return len(self._pending.get(key, ()))

    def idle(self) -> bool:
        """True when no batch is accumulating, timed, or mid-flush."""
        return (not self._pending and not self._timers
                and self._inflight == 0)
