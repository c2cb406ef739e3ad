"""The check fails a run whose timed path is broken underneath: each
fault is planted in the session before the window, and the rest of the
run is driven as on the card (on the CPU, at a tiny size)."""

import time

import numpy as np
import pytest

from evalbench import found, harness
from evalbench.tests.conftest import cell_names, tiny_cell


def stale(session, ctx):
    """A call that returns the previous call's answer: state unchanged."""
    call = session.call
    prev = {"out": call(1)}  # a warm call's answer: even the window's
    # first call returns stale work

    def fn(i):
        out = call(i)
        old = prev["out"]
        prev["out"] = out
        return old
    session.call = fn


def half_left_out(session, ctx):
    """Half of the batch left out: the step averages over the rest; the
    other entries return only the first half of the queries."""
    if hasattr(session, "batch"):
        qm = session.batch.query_mask.clone()
        real = int(qm.sum())
        qm[real // 2:] = False
        session.batch = session.batch._replace(query_mask=qm)
        return
    call = session.call

    def fn(i):
        out = call(i)
        if isinstance(out, dict):
            qids = list(out)[: len(out) // 2]
            return {q: out[q] for q in qids}
        return out._replace(qids=out.qids[: len(out.qids) // 2],
                            table=out.table[:, : len(out.qids) // 2])
    session.call = fn


def one_answer_altered(session, ctx):
    """One value changed by 0.01 where it is produced."""
    call = session.call

    def fn(i):
        out = call(i)
        if isinstance(out, dict):
            q = next(iter(out))
            k = next(iter(out[q]))
            out[q] = {**out[q], k: out[q][k] + 0.01}
            return out
        if isinstance(out, np.ndarray):
            out = out.copy()
            out[0] += 0.01
            return out
        table = out.table.copy()
        table[0, 0, 0] += 0.01
        return out._replace(table=table)
    session.call = fn


@pytest.mark.parametrize("fault", [stale, half_left_out, one_answer_altered])
@pytest.mark.parametrize("name", cell_names())
def test_planted_fault_is_not_correct(name, fault):
    cell = tiny_cell(name)
    line = harness.run(cell, 2**31 + 21, 0.3, False, "cpu",
                       time.perf_counter(), alter=fault)
    assert not line["correct"], (fault.__name__, line["checks"])


@pytest.mark.parametrize("name", cell_names())
def test_control_is_not_correct(name):
    cell = tiny_cell(name)
    control = found("kinds", cell.cfg["kind"]).control
    line = harness.run(cell, 2**31 + 31, 0.3, False, "cpu",
                       time.perf_counter(), alter=control)
    assert not line["correct"], line["checks"]
