"""One run of one cell: set-up, the measured window, the check, the line.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration file and the configuration's kind
(``kinds/<kind>.py``), ``traffic/<traffic>.json``, ``entries/<entry>.py``
and ``metrics/<metric>.py``, end-to-end and per-layer alike. So a later
cell that reuses an entry is data only.

A run: the kind makes the inputs from the seed; the entry builds the
program's session from them (the ingest); set-up warms every shape the
window uses and checks the route the calls take; then the session is
called in a closed loop until ``seconds`` have passed. With ``trace`` on,
the program's functions that the entry names are timed as spans, and a
short profiled part follows the window. Then the device's peak memory is
read, the program's state is freed, and the kind's reference checks a
sample of the window's outputs drawn from the seed, plus the last one.
"""

from __future__ import annotations

import gc
import json
import statistics
import sys
import time
import types
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from evalbench import HERE, check, found, spans as spans_mod

#: profiled part of a traced run: at least this many calls and seconds
PROFILE_CALLS, PROFILE_SECONDS = 3, 2.0
#: calls before the window, the route's check among them: every shape a
#: call uses is then allocated and every kernel built
WARM_CALLS = 2
#: top-level module names the run's process may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of ``BENCHMARK.json`` with its files loaded by name."""

    def __init__(self, name: str, root: Path, bench: Optional[dict] = None):
        bench = bench or load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.spec = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.cfg = load_json(root / configs[self.spec["config"]]["file"])
        self.traffic = load_json(HERE / "traffic"
                                 / f"{self.spec['traffic']}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]


class Context(types.SimpleNamespace):
    """What an entry's session is built from."""


def _route(session, expect: str) -> None:
    """Run one call with the measure core's two routes counted, and check
    that the traffic's route (``sort`` or ``topk``) is the one taken."""
    from repro_torch.core import measures
    from repro_torch.kernels import topk as topk_kernel

    seen = {"sort": 0, "topk": 0}
    orig = {"sort": measures.compute_measures,
            "topk": measures.compute_measures_topk}

    def counted(route):
        def fn(*a, **k):
            seen[route] += 1
            return orig[route](*a, **k)
        return fn

    launches = topk_kernel.LAUNCHES
    measures.compute_measures = counted("sort")
    measures.compute_measures_topk = counted("topk")
    try:
        session.call(0)
    finally:
        measures.compute_measures = orig["sort"]
        measures.compute_measures_topk = orig["topk"]
    other = "topk" if expect == "sort" else "sort"
    if not seen[expect] or seen[other]:
        raise RuntimeError(f"route: expected only {expect!r}, the call "
                           f"took {seen}")
    b2 = topk_kernel.LAUNCHES - launches
    if session.device.type == "cuda" and (b2 > 0) != (expect == "topk"):
        raise RuntimeError(f"route {expect!r}: {b2} top-k kernel launches")


def p95(values) -> float:
    """The 95th percentile, by Python's ``statistics.quantiles``."""
    if len(values) < 2:
        return float(values[0])
    return float(statistics.quantiles(values, n=20)[-1])


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        started: float, alter: Optional[Callable] = None) -> dict:
    """One run; returns the result line as a dict (``correct`` last
    decided, ``checks`` last in it). ``alter(session, ctx)`` may put a
    fault or the control in the session's place before the window (the
    harness's own tests, ``calibrate.py``)."""
    import torch

    dev = torch.device(device)
    traffic = cell.traffic
    kind = found("kinds", cell.cfg["kind"])
    inputs = kind.inputs(cell.cfg, traffic, seed)
    ctx = Context(cfg=cell.cfg, traffic=traffic, device=dev, **inputs)
    session = found("entries", traffic["entry"]).Session(ctx)
    _route(session, traffic["route"])
    for i in range(1, WARM_CALLS):
        session.call(i)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if alter is not None:
        alter(session, ctx)
    gc.collect()  # start the window with no set-up garbage pending
    setup_s = time.perf_counter() - started

    spans = spans_mod.Spans(dev)
    if trace:
        session.instrument(spans)
    rng = np.random.default_rng([int(seed), 2])
    timed_events = dev.type == "cuda"
    sample = last = None
    latencies, events = [], []
    failed, i = 0, 0
    t0 = time.perf_counter()
    while True:
        c0 = time.perf_counter()
        if timed_events:
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            pair[0].record()
        try:
            if trace:
                with spans.span("call"):
                    out = session.call(i)
            else:
                out = session.call(i)
        except Exception as exc:  # a failed call fails the run
            print(f"call {i} raised {exc!r}", file=sys.stderr)
            failed += 1
            out = None
        if timed_events:
            pair[1].record()
            events.append(pair)
        latencies.append(time.perf_counter() - c0)
        # a seeded reservoir of one output of the window, and the last
        if rng.integers(0, i + 1) == 0:
            sample = (i, out)
        last = (i, out)
        i += 1
        if out is None or time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    calls = i
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    event_ms = [a.elapsed_time(b) for a, b in events]

    record = {"ingest_s": session.ingest_s,
              "spans": {k: list(v) for k, v in spans.seconds.items()},
              "latencies_s": latencies, "event_ms": event_ms,
              "calls": calls, "rankings": calls * session.rankings_per_call,
              "window_s": window_s, "setup_s": setup_s,
              "core_bytes": session.core_bytes()}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1}
    breakdown = None
    if trace:
        prof_record = _profiled(session, spans, dev, calls)
        record.update(prof_record)
        device_info["busy_s"] = prof_record["trace"]["busy_s"]
        device_info["window_s"] = prof_record["traced_window_s"]
        breakdown = {"device_ops": prof_record["trace"]["device_ops"],
                     "idle_gaps": prof_record["trace"]["idle_gaps"]}
    spans.unwrap()
    device_info["memory_peak_bytes"] = (
        int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda"
        else 0)

    # free the program's state before the reference runs
    values = {j: (session.score_sets(j),
                  session.values(out) if out is not None else None)
              for j, out in (sample, last)}
    session.release()
    del sample, last, out, session, ctx
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    readings = kind.readings(cell.cfg, traffic, inputs, values)
    correct, checks = check.judge(readings, traffic["limits"])
    correct = correct and failed == 0

    # each metric's reader returns None where it finds nothing to read
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = found("metrics", m["name"]).read(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    lat_ms = sorted(t * 1e3 for t in latencies)
    line = {"correct": bool(correct), "attempted": calls, "failed": failed,
            "metrics": metrics, "device": device_info,
            "window": {"seconds": window_s, "calls": calls,
                       "call_ms_min": lat_ms[0],
                       "call_ms_median": statistics.median(lat_ms),
                       "call_ms_max": lat_ms[-1]}}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return line


def _profiled(session, spans, dev, first: int) -> dict:
    """A short steady part under ``torch.profiler``, after the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    n = 0
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        while n < PROFILE_CALLS or time.perf_counter() - t0 < PROFILE_SECONDS:
            with spans.span("call"):
                session.call(first + n)
            n += 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        traced = time.perf_counter() - t0
    return {"trace": spans_mod.reduce_trace(prof), "traced_calls": n,
            "traced_window_s": traced}


def forbidden_modules():
    """Loaded modules whose top-level name is forbidden in the run."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})
