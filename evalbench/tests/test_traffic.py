"""Every cell of BENCHMARK.json runs end to end on the CPU at a tiny size,
and the reference finds its outputs correct."""

import time

import pytest

from evalbench import harness
from evalbench.tests.conftest import cell_names, tiny_cell


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", cell_names())
def test_cell_runs_correct_on_cpu(name, trace):
    cell = tiny_cell(name)
    line = harness.run(cell, 2**31 + 11, 0.3, bool(trace), "cpu",
                       time.perf_counter())
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert list(line)[-1] == "checks"
    want = cell.per_layer if trace else cell.end_to_end
    got = set(line["metrics"])
    # the card's trace has nothing to read on the CPU
    device_only = {"measure_roofline_pct", "call_p95_ms.step"}
    assert {m["name"] for m in want} - device_only <= got
    for m in line["metrics"].values():
        assert m["value"] == m["value"]  # not NaN


@pytest.mark.cuda
@pytest.mark.parametrize("name", cell_names())
def test_cell_runs_correct_on_the_card(name, cuda_device):
    cell = tiny_cell(name)
    line = harness.run(cell, 2**31 + 12, 0.5, True, cuda_device,
                       time.perf_counter())
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0
