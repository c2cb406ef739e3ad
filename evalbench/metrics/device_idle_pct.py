"""Share of the profiled part of the traced run in which no operation ran
on the card: 100 less the union of kernel, copy and fill time over the
part's wall time."""


def read(record):
    t = record.get("trace")
    if not t or not record.get("traced_window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / record["traced_window_s"])
