"""Query rankings (one query of one run) evaluated in the window, over
the window's whole length by the host clock."""


def read(record):
    return record["rankings"] / record["window_s"]
