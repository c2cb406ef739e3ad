"""The port's baselines against the JAX package's, on the CPU.

``repro_torch.baselines`` is the paper's comparison side: the pure-Python
trec_eval engine, the native-Python NDCG of RQ2, the file-based CLI that
RQ1's serialize-invoke-parse workflow spawns, and that workflow.  Each must
give exactly what the JAX package's copy gives on the conformance fixtures
and on ``synthesize_run`` data from a seed, and the CLI's process must run
with torch, numpy and JAX all unimportable (its start-up is what RQ1
charges to the subprocess).
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.baselines import native_ndcg as jax_native
from repro.baselines import pure_eval as jax_pure
from repro.baselines import trec_eval_cli as jax_cli
from repro.baselines import workflow as jax_workflow
from repro.data.synthetic_ir import synthesize_run as jax_synthesize

from repro_torch.baselines import native_ndcg, pure_eval, trec_eval_cli
from repro_torch.baselines import workflow
from repro_torch.core import RelevanceEvaluator, trec
from repro_torch.data.synthetic_ir import synthesize_run

from test_torch_measures import single_torch_thread  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
QREL = os.path.join(FIXTURES, "conformance.qrel")
RUN = os.path.join(FIXTURES, "conformance.run")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ALL_TREC = ("map", "ndcg", "ndcg_cut", "P", "recall", "recip_rank", "Rprec",
            "bpref", "success", "map_cut", "num_ret", "num_rel",
            "num_rel_ret")


def _graded_case(seed, nq=6, nd=40):
    """A run with ties and unjudged docs against a graded qrel (-1..3)."""
    rng = np.random.default_rng(seed)
    run, qrel = {}, {}
    for q in range(nq):
        docs = [f"d{rng.integers(0, 3 * nd)}" for _ in range(nd)]
        run[f"q{q}"] = {d: float(rng.integers(0, 8)) for d in docs}
        judged = rng.choice(3 * nd, nd, replace=False)
        qrel[f"q{q}"] = {f"d{j}": int(rng.integers(-1, 4)) for j in judged}
    return run, qrel


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """(name, run, qrel, run path, qrel path) for the conformance fixtures,
    a ``synthesize_run`` grid point and a graded case."""
    out = [("conformance", trec.load_run(RUN), trec.load_qrel(QREL), RUN,
            QREL)]
    tmp = tmp_path_factory.mktemp("baselines")
    run, qrel = synthesize_run(7, 30, seed=3)
    assert (run, qrel) == jax_synthesize(7, 30, seed=3)
    for name, (r, q) in (("synthetic", (run, qrel)),
                         ("graded", _graded_case(5))):
        rp, qp = str(tmp / f"{name}.run"), str(tmp / f"{name}.qrel")
        trec.save_run(rp, r)
        trec.save_qrel(qp, q)
        out.append((name, trec.load_run(rp), trec.load_qrel(qp), rp, qp))
    return out


@pytest.mark.parametrize("level", [1, 2])
def test_pure_eval_matches_jax(cases, level):
    for name, run, qrel, _, _ in cases:
        got = pure_eval.evaluate(run, qrel, ALL_TREC, level)
        assert got == jax_pure.evaluate(run, qrel, ALL_TREC, level), name


def test_pure_eval_agrees_with_the_port_evaluator(cases):
    """The independent oracle: pure Python (float64) against the port's
    measure core (float32), every value within 2e-4."""
    measures = ("map", "ndcg", "P", "recall", "recip_rank", "Rprec",
                "bpref", "success", "num_ret", "num_rel", "num_rel_ret")
    for name, run, qrel, _, _ in cases:
        want = pure_eval.evaluate(run, qrel, measures)
        got = RelevanceEvaluator(qrel, measures, device="cpu").evaluate(run)
        assert set(got) == set(want), name
        for q, row in want.items():
            for k, v in row.items():
                assert got[q][k] == pytest.approx(v, abs=2e-4, rel=2e-4), \
                    (name, q, k)


@pytest.mark.parametrize("depth", [1, 3, 10, 100, 1000])
def test_native_ndcg_matches_jax(depth):
    run, qrel = synthesize_run(1, depth, seed=depth)
    graded = {d: (i % 4) - 1 for i, d in enumerate(qrel["q0"])}
    for rels in (qrel["q0"], graded):
        got = native_ndcg.ndcg(run["q0"], rels)
        assert got == jax_native.ndcg(run["q0"], rels)
        assert got == pure_eval.evaluate_query(run["q0"], rels,
                                               ("ndcg",))["ndcg"]


@pytest.mark.parametrize("args", [
    ["-q", "-m", "map", "-m", "ndcg"],
    ["-m", "all_trec"],
    ["-q", "-l", "2", "-m", "P", "-m", "bpref"],
    [],
])
def test_trec_eval_cli_prints_what_the_jax_baseline_prints(cases, args):
    for name, _, _, run_path, qrel_path in cases:
        outs = []
        for main in (trec_eval_cli.main, jax_cli.main):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert main([*args, qrel_path, run_path]) == 0
            outs.append(buf.getvalue())
        assert outs[0] == outs[1], name
        assert outs[0]


def test_serialize_invoke_parse_matches_jax(tmp_path):
    run, qrel = synthesize_run(4, 25, seed=1)
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    mine.mkdir()
    theirs.mkdir()
    got = workflow.serialize_invoke_parse(run, qrel, str(mine),
                                          ("map", "ndcg", "P"), timeout=120)
    want = jax_workflow.serialize_invoke_parse(run, qrel, str(theirs),
                                               ("map", "ndcg", "P"))
    assert got == want
    assert got.count("\n") == (4 + 1) * (2 + 9)
    # the files it serialized are the JAX workflow's, byte for byte
    for f in ("eval.qrel", "eval.run"):
        assert (mine / f).read_bytes() == (theirs / f).read_bytes()


def test_baseline_child_imports_no_numerical_library():
    """``python -m repro_torch.baselines.trec_eval_cli`` with torch, numpy
    and JAX blocked in ``sys.modules``: it still prints the golden values
    (RQ1 must not charge a framework import to the subprocess)."""
    code = ("import runpy, sys\n"
            "for m in ('torch', 'numpy', 'jax'):\n"
            "    sys.modules[m] = None\n"
            "sys.argv = ['trec_eval_cli', '-q', '-m', 'map', '-m', 'ndcg', "
            f"{QREL!r}, {RUN!r}]\n"
            "try:\n"
            "    runpy.run_module('repro_torch.baselines.trec_eval_cli', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code in (0, None), e.code\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.splitlines()[:4] == [
        "map\tq1\t0.5000", "ndcg\tq1\t0.7763", "map\tq2\t0.5000",
        "ndcg\tq2\t0.6309"]
