"""Mean ms of a call outside the host's preparation of the batch (the
stacking of a sweep's runs, densify) and the measure core: the table's
copy back and the per-query dicts (synchronised host clock)."""


def read(record):
    sp = record["spans"]
    if not sp.get("call") or not sp.get("densify") or not sp.get("measure"):
        return None
    rest = (sum(sp["call"]) - sum(sp["densify"]) - sum(sp["measure"])
            - sum(sp.get("concat", ())))
    return rest / record["calls"] * 1e3
