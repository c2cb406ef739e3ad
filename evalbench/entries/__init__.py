"""Timed entries into the program: one module a kind of call.

A traffic file names its entry (``"entry": "evaluate_buffer"``), and the
harness loads ``entries/<entry>.py`` by that name. Each module defines a
``Session(ctx)`` with:

* ``device``: the torch device it drives;
* ``ingest_s``: host seconds of the evaluator's construction and the
  run's tokenization;
* ``rankings_per_call``: query rankings one call evaluates;
* ``call(i)``: the i-th timed call, returning the program's output;
* ``score_sets(i)``: the indices into the score pool that call i used;
* ``values(out)``: the output as numbers the reference can check;
* ``core_bytes()``: the least bytes one call's measure core moves;
* ``instrument(spans)``: wrap the program's functions that a traced run
  times;
* ``release()``: drop every tensor the program holds.
"""

import numpy as np


def buffer_order(buf, run_qid, pool) -> np.ndarray:
    """The score pool in a run buffer's flat order.

    ``buffer_from_arrays`` groups the rows by query in ``buf.qids`` order,
    each query's rows in their input order; fresh scores must follow
    that order. Every query of the run is judged here, so no row is
    dropped (checked).
    """
    run_qid = np.asarray(run_qid)
    # the run lists each query's rows together: one group a query
    head = np.flatnonzero(np.concatenate(
        [[True], run_qid[1:] != run_qid[:-1]]))
    sizes = np.diff(np.append(head, len(run_qid)))
    pos = {q: i for i, q in enumerate(buf.qids)}
    group = np.array([pos[q] for q in run_qid[head].tolist()])
    if len(set(group.tolist())) != len(group) or not np.array_equal(
            np.bincount(group, weights=sizes, minlength=len(buf.qids)),
            np.asarray(buf.counts)):
        raise ValueError("the run's queries are split, or the buffer "
                         "dropped rows of the run")
    perm = np.argsort(np.repeat(group, sizes), kind="stable")
    return np.ascontiguousarray(pool[:, perm])
