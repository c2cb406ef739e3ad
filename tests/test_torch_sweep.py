"""The port's sweep and ``python -m repro_torch.compare``, on the CPU.

``evaluate_sweep`` must be bit-identical to K separate port
``evaluate_buffer`` calls (the JAX package's contract,
``tests/test_sweep.py``), with ragged depths and chunked dispatch groups; it
must match the JAX sweep on the same seeded runs (count columns exact, the
rest within atol = rtol = 2e-4), on both backends.  The compare CLI
byte-matches ``tests/fixtures/compare.golden`` plain and ``--sharded``,
through ``main()`` and through ``python -m repro_torch.compare`` with JAX
blocked, and prints what ``python -m repro.compare`` prints wherever the
values are deterministic.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

from repro import compare as jax_compare
from repro.core import RelevanceEvaluator as JaxEvaluator
from repro.core import evaluate_sweep as jax_sweep

from repro_torch import compare
from repro_torch.core import RelevanceEvaluator, evaluate_sweep
from repro_torch.core.sweep import SweepResult, common_qids

from test_sweep import MEASURES, _make_runs
from test_torch_measures import single_torch_thread  # noqa: F401
from test_torch_measures import assert_columns_match

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
QREL = os.path.join(FIXTURES, "conformance.qrel")
RUNS = [os.path.join(FIXTURES, n)
        for n in ("conformance.run", "sweep_b.run", "sweep_c.run")]
GOLDEN = os.path.join(FIXTURES, "compare.golden")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = "cpu"


@pytest.fixture(scope="module")
def ragged():
    qrel, runs = _make_runs(5, 10, 17, seed=2, ragged=True)
    return qrel, runs, RelevanceEvaluator(qrel, MEASURES, device=CPU)


def _assert_table_matches_per_run(result, ev, runs):
    for ki, run in enumerate(runs):
        want = ev.evaluate_buffer(
            ev.tokenize_run({q: run[q] for q in result.qids}))
        for qi, qid in enumerate(result.qids):
            for mi, key in enumerate(result.measure_keys):
                assert result.table[ki, qi, mi] == want[qid][key], \
                    (ki, qid, key)


def _assert_tables_match(got, want):
    assert got.measure_keys == want.measure_keys
    assert got.run_names == want.run_names and got.qids == want.qids
    assert_columns_match(
        {k: got.table[..., m].ravel() for m, k in enumerate(got.measure_keys)},
        {k: want.table[..., m].ravel()
         for m, k in enumerate(want.measure_keys)})


def test_sweep_bit_identical_to_separate_evaluations(ragged):
    qrel, runs, ev = ragged
    result = evaluate_sweep(ev, runs)
    assert result.table.shape == (5, 10, len(ev.measure_keys))
    assert result.run_names == tuple(f"run_{i}" for i in range(5))
    assert result.device == ev.device
    _assert_table_matches_per_run(result, ev, runs)


def test_chunked_dispatch_is_identical_to_one_shot(ragged):
    qrel, runs, ev = ragged
    one = evaluate_sweep(ev, runs)
    chunked_ev = RelevanceEvaluator(qrel, MEASURES, device=CPU)
    chunked_ev.chunk_queries = 23  # groups of 2 runs, then a remainder
    assert np.array_equal(evaluate_sweep(chunked_ev, runs).table, one.table)


@pytest.mark.parametrize("backend", ["single", "sharded"])
def test_sweep_matches_the_jax_sweep(ragged, backend):
    qrel, runs, ev = ragged
    got = evaluate_sweep(ev, runs, backend=backend)
    want = jax_sweep(JaxEvaluator(qrel, MEASURES), runs)
    _assert_tables_match(got, want)
    assert got.aggregates().keys() == want.aggregates().keys()
    for name, aggs in want.aggregates().items():
        for key, value in aggs.items():
            assert got.aggregates()[name][key] == pytest.approx(
                value, abs=2e-4, rel=2e-4), (name, key)


def test_sharded_backend_matches_single(ragged):
    _, runs, ev = ragged
    single = evaluate_sweep(ev, runs)
    sharded = evaluate_sweep(ev, runs, backend="sharded")
    _assert_tables_match(sharded, single)


def test_auto_backend_follows_the_evaluators_device(ragged, monkeypatch):
    """``"auto"`` never sends a CPU evaluator's sweep through the fused
    pipeline, however many CUDA devices are visible; with a CUDA device it
    follows the device count, as the JAX package's rule does."""
    import torch

    from repro_torch.distributed import select_backend

    _, runs, ev = ragged
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert select_backend("auto", device=CPU) == "single"
    assert select_backend("auto", device="cuda:0") == "sharded"
    assert select_backend("auto") == "sharded"
    auto = evaluate_sweep(ev, runs, backend="auto")
    assert np.array_equal(auto.table, evaluate_sweep(ev, runs).table)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert select_backend("auto", device="cuda:0") == "single"
    assert select_backend("sharded", device=CPU) == "sharded"


def test_buffer_path_mapping_names_and_measure_dialects(ragged):
    qrel, runs, ev = ragged
    qids = common_qids(ev._qid_index, runs)
    bufs = [ev.tokenize_run({q: r[q] for q in qids}) for r in runs]
    by_buf = evaluate_sweep(ev, {f"sys{i}": b for i, b in enumerate(bufs)})
    by_dict = evaluate_sweep(ev, runs)
    assert by_buf.run_names == tuple(f"sys{i}" for i in range(5))
    assert np.array_equal(by_buf.table, by_dict.table)
    assert np.array_equal(by_dict.measure("AP"), by_dict.measure("map"))
    assert np.array_equal(by_dict.measure("P@5"), by_dict.measure("P_5"))
    with pytest.raises(KeyError):
        by_dict.measure("ndcg_cut_10")
    pq = by_dict.per_query()
    m = by_dict.measure_keys.index("map")
    assert pq["run_0"][qids[0]]["map"] == float(by_dict.table[0, 0, m])


def test_sweep_validation(ragged):
    qrel, runs, ev = ragged
    with pytest.raises(ValueError):
        evaluate_sweep(ev, runs, measures=("map",))
    with pytest.raises(ValueError):
        evaluate_sweep(ev, runs, device=CPU)
    with pytest.raises(ValueError):
        evaluate_sweep(ev, [])
    with pytest.raises(ValueError):
        evaluate_sweep(ev, {"a": runs[0]}, run_names=["b"])
    with pytest.raises(ValueError):
        evaluate_sweep(ev, runs, run_names=["only_one"])
    with pytest.raises(ValueError):
        evaluate_sweep(ev, runs, backend="everywhere")
    buf = ev.tokenize_run(runs[0])
    with pytest.raises(TypeError):
        evaluate_sweep(ev, [buf, runs[1]])
    with pytest.raises(ValueError):
        evaluate_sweep(qrel, [{"nosuch": {"d0": 1.0}}], device=CPU)


def test_compare_report_matches_jax(ragged):
    qrel, runs, ev = ragged
    got = evaluate_sweep(ev, runs).compare("ndcg", tests=("t",))
    want = jax_sweep(JaxEvaluator(qrel, MEASURES), runs).compare("ndcg")
    assert got["run_names"] == want["run_names"]
    assert got["qids"] == want["qids"] and got["measure"] == "ndcg"
    np.testing.assert_allclose(got["t"], want["t"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["p"], want["p"], atol=1e-5)


def test_sweep_result_fields():
    assert SweepResult._fields == ("run_names", "qids", "measure_keys",
                                   "table", "device")


# -- the compare CLI ----------------------------------------------------------


def _cli(main, argv):
    buf = io.StringIO()
    assert main(argv, out=buf) == 0
    return buf.getvalue()


def _golden():
    with open(GOLDEN, newline="") as fh:
        return fh.read()


@pytest.mark.parametrize("extra", [[], ["--sharded"]])
def test_compare_cli_byte_matches_golden(extra):
    assert _cli(compare.main, ["--device", CPU, *extra, QREL, *RUNS]) == \
        _golden()


@pytest.mark.parametrize("argv", [
    ["-m", "map", "-m", "ndcg", "--alpha", "0.5"],
    ["-m", "nDCG@10", "-m", "P@5", "-l", "2"],
    ["-J", "-m", "AP"],
])
def test_compare_cli_prints_what_the_jax_cli_prints(argv):
    assert _cli(compare.main, ["--device", CPU, *argv, QREL, *RUNS]) == \
        _cli(jax_compare.main, [*argv, QREL, *RUNS])


def test_compare_cli_permutation_layout():
    """The permutation columns have the golden's layout; their values come
    from another generator than JAX's, so only the deterministic cells
    must agree."""
    argv = ["-m", "map", "-m", "ndcg", "--test", "both", "--permutations",
            "200"]
    got = _cli(compare.main, ["--device", CPU, *argv, QREL, *RUNS])
    want = _cli(jax_compare.main, [*argv, QREL, *RUNS])
    got_lines, want_lines = got.splitlines(), want.splitlines()
    assert len(got_lines) == len(want_lines)
    for g, w in zip(got_lines, want_lines):
        gc, wc = g.split("\t"), w.split("\t")
        assert len(gc) == len(wc)
        if not g.startswith("pair\t"):
            assert g == w
            continue
        assert gc[:7] == wc[:7] and gc[9:] == wc[9:]
        for cell in gc[7:9]:
            name, value = cell.split("=")
            assert name in ("p_perm", "p_perm_holm")
            assert 0.0 < float(value) <= 1.0


def test_compare_cli_errors(capsys):
    with pytest.raises(SystemExit):
        compare.main(["--device", CPU, QREL, RUNS[0]])
    with pytest.raises(SystemExit):
        compare.main(["--device", CPU, "-m", "nosuch", QREL, *RUNS])
    capsys.readouterr()


def test_python_dash_m_repro_torch_compare_runs_without_jax():
    """``python -m repro_torch.compare`` with ``jax`` blocked: byte-matches
    the golden, then imports the sweep, stats, ranked and RL modules, and
    no JAX or JAX-package module is loaded."""
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.argv = ['repro_torch.compare', '--device', 'cpu', "
        f"{QREL!r}, " + ", ".join(repr(r) for r in RUNS) + "]\n"
        "try:\n"
        "    runpy.run_module('repro_torch.compare', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "import repro_torch.stats, repro_torch.core.ranked, "
        "repro_torch.core.streaming, repro_torch.rl.qlearning, "
        "repro_torch.data.synthetic_ir\n"
        "bad = [m for m in sys.modules if m == 'repro' "
        "or m.startswith(('repro.', 'jax.', 'jaxlib'))]\n"
        "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout == _golden()
