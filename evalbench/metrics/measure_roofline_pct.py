"""The measure core's least time over the device time of every kernel the
profiled calls launched (copies, memsets and kernels that only fill a
tensor left out: ``spans._is_copy_or_fill``), in percent. The
least time is the bytes the core needs (``yardstick.core_bytes``: every
unpadded input byte read once, the output written once) at the card's
published memory bandwidth."""

from evalbench import yardstick


def read(record):
    t = record.get("trace")
    if not t or not t["kernel_s"] or not record.get("traced_calls"):
        return None
    per_call = t["kernel_s"] / record["traced_calls"]
    return 100.0 * yardstick.least_seconds(record["core_bytes"]) / per_call
