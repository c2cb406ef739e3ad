"""Spans around calls into the program, and the reduction of a trace.

A traced run wraps the program's public functions that its entry calls
(``Spans.wrap``): each wrapped call synchronises the device on both sides,
adds its host-clock seconds to the span of its name, and opens a profiler
range ``evalbench.<name>``. The profiler's trace of a short steady part of
the run is reduced here to device busy time, kernel time, the heaviest
device operations and the idle gaps by what the host was doing.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Tuple

RANGE_PREFIX = "evalbench."


class Spans:
    """Host-clock seconds by span name, one entry a wrapped call."""

    def __init__(self, device):
        self.device = device
        self.seconds: Dict[str, List[float]] = defaultdict(list)
        self._undo = []

    def _sync(self):
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    @contextmanager
    def span(self, name: str):
        from torch.profiler import record_function

        self._sync()
        t0 = time.perf_counter()
        with record_function(RANGE_PREFIX + name):
            yield
            self._sync()
        self.seconds[name].append(time.perf_counter() - t0)

    def wrap(self, owner, attr: str, name: str) -> None:
        """Time every call of ``owner.attr`` as span ``name`` until
        :meth:`unwrap`."""
        fn = getattr(owner, attr)
        had = attr in vars(owner) if hasattr(owner, "__dict__") else True

        def timed(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, fn, had))

    def unwrap(self) -> None:
        for owner, attr, fn, had in reversed(self._undo):
            if had:
                setattr(owner, attr, fn)
            else:
                delattr(owner, attr)
        self._undo.clear()


def _is_copy_or_fill(event) -> bool:
    """A copy, a memset, or a kernel that only fills a tensor with one
    value (torch's ``FillFunctor``, ``fill_``)."""
    kind = str(event.activity_type()) if hasattr(event,
                                                 "activity_type") else ""
    name = event.name()
    return ("memcpy" in kind.lower() or "memset" in kind.lower()
            or name.startswith("Memcpy") or name.startswith("Memset")
            or "FillFunctor" in name or name.startswith("fill_"))


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def reduce_trace(prof, top: int = 10) -> dict:
    """Device time from a ``torch.profiler.profile`` of the traced part.

    Returns ``busy_s`` (the union of every device operation's interval),
    ``kernel_s`` (the summed durations of kernels, with copies, memsets
    and fill kernels left out), ``device_ops`` (the ``top`` heaviest
    operations by name, summed) and ``idle_gaps`` (the device's idle time inside the traced part,
    summed by the innermost ``evalbench.*`` range open on the host at
    the gap's middle).
    """
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    dev, ranges = [], []
    for e in events:
        if e.name().startswith(RANGE_PREFIX):
            # a range shows on the device's timeline too, as an
            # annotation spanning its kernels: only the host's counts
            if e.device_type() == DeviceType.CUDA:
                continue
            ranges.append((e.start_ns(), e.end_ns(),
                           e.name()[len(RANGE_PREFIX):]))
        elif e.device_type() == DeviceType.CUDA and e.duration_ns() > 0 \
                and not e.is_user_annotation():
            dev.append(e)
    busy = _union([(e.start_ns(), e.end_ns()) for e in dev])
    by_name: Dict[str, float] = defaultdict(float)
    kernel_ns = 0
    for e in dev:
        by_name[e.name()[:160]] += e.duration_ns() / 1e9
        if not _is_copy_or_fill(e):
            kernel_ns += e.duration_ns()
    ranges.sort()
    starts = [r[0] for r in ranges]
    gaps: Dict[str, float] = defaultdict(float)
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) / 2
        label = "outside calls"
        # ranges nest (a call holds its densify and measure): the
        # innermost open one is among the last few that started
        i = bisect.bisect_right(starts, mid) - 1
        for r in ranges[max(i - 3, 0):i + 1][::-1]:
            if r[1] >= mid:
                label = r[2]
                break
        gaps[label] += (b - a) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": sum(e - s for s, e in busy) / 1e9,
            "kernel_s": kernel_ns / 1e9,
            "device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle],
            "n_device_events": len(dev)}
