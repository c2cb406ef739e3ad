"""A new configuration, traffic mix or per-layer metric is found by its
name in BENCHMARK.json, with no edit to any file the benchmark has. The
new mixes here are the three on MS MARCO dev left out of BENCHMARK.json
while the host's speed spreads their runs too widely: rescoring with the
paper's measures, the top-100 rescoring mix, which takes the top-k
route, and the eval step in a training loop."""

import json
import shutil
import subprocess
import sys

import pytest

from evalbench.tests.conftest import ROOT, TINY

PAPER_MEASURES = ["map", "ndcg", "ndcg_cut", "P", "recall", "recip_rank",
                  "Rprec", "bpref", "success", "map_cut"]

MIXES = {
    "rescore": {
        "entry": "evaluate_buffer", "measures": PAPER_MEASURES,
        "route": "sort", "score_sets": 3,
        "limits": {"max_gap": 2e-4, "missing": 0}},
    "rescore-top100": {
        "entry": "evaluate_buffer",
        "measures": ["ndcg_cut.10", "P.10", "recall.100", "map_cut.100"],
        "route": "topk", "score_sets": 3,
        "limits": {"max_gap": 2e-4, "missing": 0}},
    "inloop": {
        "entry": "eval_step", "engine": "sorted",
        "measures": PAPER_MEASURES, "route": "sort", "score_sets": 3,
        "limits": {"max_gap": 5e-5, "missing": 0}},
}

SCRIPT = r"""
import json, sys, time
from pathlib import Path
root = Path.cwd()
sys.path[:0] = [str(root), sys.argv[1]]
from evalbench import harness
cell = harness.Cell(sys.argv[2], root)
line = harness.run(cell, 5, 0.2, True, "cpu", time.perf_counter())
print(json.dumps({"correct": line["correct"], "metrics": line["metrics"],
                  "queries": cell.cfg["queries"],
                  "measures": cell.traffic["measures"]}))
"""


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_new_files_are_found_by_name(tmp_path, mix):
    shutil.copytree(ROOT / "evalbench", tmp_path / "evalbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = {**json.loads((ROOT / "evalbench/configs/msmarco-dev.json")
                        .read_text()), **TINY["msmarco-dev"],
           "name": "tiny-docs", "queries": 40}
    (tmp_path / "evalbench/configs/tiny-docs.json").write_text(
        json.dumps(cfg))
    (tmp_path / f"evalbench/traffic/{mix}.json").write_text(
        json.dumps(MIXES[mix]))
    (tmp_path / "evalbench/metrics/calls_made.py").write_text(
        "def read(record):\n    return float(record['calls'])\n")
    name = f"tiny-docs.{mix}"
    bench["configs"].append({"name": "tiny-docs", "source": "test",
                             "file": "evalbench/configs/tiny-docs.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": name, "config": "tiny-docs",
                               "traffic": mix, "chips": 1, "why": "test"})
    bench["per_layer"] += [
        {"name": "calls_made", "unit": "calls", "better": "higher",
         "source": "program_counter", "layer": "session entry",
         "moves": "rankings_per_s", "workloads": [name]},
        {"name": "call_p95_ms.session", "unit": "ms", "better": "lower",
         "source": "host_clock", "layer": "session entry",
         "moves": "rankings_per_s", "workloads": [name]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT / "src"),
                          name], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["queries"] == 40
    assert res["measures"] == MIXES[mix]["measures"]
    assert res["metrics"]["calls_made"]["value"] >= 1
    assert res["metrics"]["call_p95_ms.session"]["value"] > 0
