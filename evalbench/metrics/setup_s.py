"""Seconds from the process's start to the window: imports, the inputs
made from the seed, the program's ingest and the warm calls."""


def read(record):
    return record["setup_s"]
