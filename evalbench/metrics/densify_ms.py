"""Mean ms a call spends in ``batch_from_buffer``: the host scatter into
the padded batch and its copy to the card (synchronised host clock)."""


def read(record):
    s = record["spans"].get("densify")
    return sum(s) / record["calls"] * 1e3 if s else None
