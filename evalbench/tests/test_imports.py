"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program under test. Each check runs in a
fresh interpreter, so what another test imported does not count."""

import json
import subprocess
import sys

from evalbench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

RUN_EVERYTHING = r"""
import json, sys, time
from pathlib import Path
sys.path[:0] = [str(Path.cwd()), str(Path.cwd() / "src")]
import importlib, pkgutil
import evalbench
from evalbench import harness, load_module
from evalbench.tests.conftest import cell_names, tiny_cell
for m in ("run", "calibrate", "harness", "data", "check", "spans",
          "yardstick", "entries", "reference", "reference.trec_eval"):
    importlib.import_module("evalbench." + m)
for name in cell_names():
    cell = tiny_cell(name)
    harness.run(cell, 9, 0.2, True, "cpu", time.perf_counter())
    for d in ("entries", "metrics", "kinds", "docnos"):
        for f in sorted((evalbench.HERE / d).glob("*.py")):
            if f.name != "__init__.py":
                load_module(f, "probe_" + f.stem.replace(".", "_"))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE_ONLY = r"""
import json, sys
from pathlib import Path
sys.path[:0] = [str(Path.cwd()), str(Path.cwd() / "src")]
import evalbench.reference.trec_eval
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(script):
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    loaded = _top_level(RUN_EVERYTHING)
    assert "repro_torch" in loaded  # the program was driven
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level(REFERENCE_ONLY)
    assert not loaded & (FORBIDDEN | {"repro_torch", "torch"})
