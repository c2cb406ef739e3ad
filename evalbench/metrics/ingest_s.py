"""Seconds of the ingest in set-up: the evaluator's construction (qrel
interning) and the run's tokenization (``buffer_from_arrays``), by the
host clock."""


def read(record):
    return record["ingest_s"]
