"""The serialize-invoke-parse workflow the paper benchmarks against (RQ1).

Steps, exactly as §1 of the paper describes:
  (1) serialize the in-memory run + qrels to disk files (TREC formats);
  (2) invoke the evaluator through the operating system (subprocess);
  (3) read the evaluation output back from the child's stdout.

Per the paper's experimental setup, the run is written *without sorting* (the
evaluator sorts internally) and the stdout is read into a Python string but
not parsed further (parsing strategies add variance).
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Mapping, Sequence

from repro_torch.core import trec


def serialize_invoke_parse(
    run: Mapping[str, Mapping[str, float]],
    qrel: Mapping[str, Mapping[str, int]],
    workdir: str,
    measures: Sequence[str] = ("map", "ndcg"),
    python: str | None = None,
    timeout: float = 300.0,
) -> str:
    """Run the full workflow once; returns the child's stdout as a string.

    The child gets at most ``timeout`` seconds
    (``subprocess.TimeoutExpired`` past it, the child killed).
    """
    qrel_path = os.path.join(workdir, "eval.qrel")
    run_path = os.path.join(workdir, "eval.run")
    # (1) serialize
    trec.save_qrel(qrel_path, qrel)
    trec.save_run(run_path, run)
    # (2) invoke through the OS
    cmd = [python or sys.executable, "-m",
           "repro_torch.baselines.trec_eval_cli", "-q"]
    for m in measures:
        cmd += ["-m", m]
    cmd += [qrel_path, run_path]
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          check=True, timeout=timeout)
    # (3) parse: read stdout into a Python string (paper stops here too)
    return proc.stdout
