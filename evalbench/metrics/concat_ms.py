"""Mean ms a call spends in ``concat_run_buffers``: the host stacking of a
sweep group's runs on the query axis, before they are densified
(synchronised host clock)."""


def read(record):
    s = record["spans"].get("concat")
    return sum(s) / record["calls"] * 1e3 if s else None
