"""95th percentile of the host-clock latency of every call of the traced
run's window, in ms (each call ends with the results on the host)."""

from evalbench.harness import p95


def read(record):
    lat = record["latencies_s"]
    return p95(lat) * 1e3 if lat else None
