"""Mean ms a call spends in the measure core (``compute_measures`` or
``compute_measures_topk``; for the step entry, the step), by the
synchronised host clock."""


def read(record):
    s = record["spans"].get("measure")
    return sum(s) / record["calls"] * 1e3 if s else None
