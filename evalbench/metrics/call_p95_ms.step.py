"""95th percentile of the eval step's latency over every step of the
traced run's window, in ms: CUDA events recorded before the step and
after its corpus means are back on the host."""

from evalbench.harness import p95


def read(record):
    ev = record["event_ms"]
    return p95(ev) if ev else None
