"""Shared set-up of the benchmark's own tests: the checkout's ``src`` and
root on the path, and tiny cuts of the configurations for CPU runs.

Run them with ``PYTHONPATH=src python -m pytest -q evalbench/tests``; the
tests marked ``cuda`` run on a card (``-m cuda``) and skip without one.
"""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: each configuration cut to a size a CPU test holds; every key kept
TINY = {
    "msmarco-dev": {
        "queries": 40, "qid": {"style": "decimal", "below": 2000},
        "docno": {"style": "decimal", "below": 5000},
        "relevant": {"histogram": [[1, 34], [2, 4], [3, 2]]},
        "candidates": {"depth": 600, "total": 21000}},
    "robust04": {
        "queries": 6, "qid": {"style": "ranges", "ranges": [[301, 306]]},
        "relevant": {"total": 60, "spread": 0.9, "min": 3, "max": 30},
        "judged": {"total": 900, "spread": 0.35, "max": 256,
                   "min_nonrelevant": 20},
        "candidates": {"depth": 100, "total": 600},
        "docno": {"style": "trec45", "sources": [
            {"style": "FBIS", "docs": 600}, {"style": "FR94", "docs": 500},
            {"style": "FT", "docs": 700}, {"style": "LA", "docs": 400}]}},
}


def tiny_cell(name):
    """The cell ``name`` of BENCHMARK.json on its configuration cut to a
    tiny size (and a sweep cut to 4 runs)."""
    from evalbench import harness

    cell = harness.Cell(name, ROOT)
    cell.cfg = {**copy.deepcopy(cell.cfg), **TINY[cell.spec["config"]]}
    if "runs_per_call" in cell.traffic:
        cell.traffic = {**cell.traffic, "runs_per_call": 4, "score_sets": 6}
    return cell


def cell_names():
    import json

    with open(ROOT / "BENCHMARK.json") as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
