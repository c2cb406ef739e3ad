"""``python -m repro_torch`` against the golden and the JAX package's CLI.

The port's CLI runs with ``--device cpu`` here.  Plain and ``--sharded``
output must byte-match ``tests/fixtures/conformance.golden``, and every
flag combination of ``tests/test_cli.py`` must print exactly what
``python -m repro`` prints.  One subprocess runs the CLI with JAX made
unimportable, which proves the port never needs it.
"""

import io
import json
import os
import subprocess
import sys

import pytest

from repro import cli as jax_cli

from repro_torch import cli

from test_torch_measures import single_torch_thread  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
QREL = os.path.join(FIXTURES, "conformance.qrel")
RUN = os.path.join(FIXTURES, "conformance.run")
GOLDEN = os.path.join(FIXTURES, "conformance.golden")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _run(main, argv):
    buf = io.StringIO()
    assert main(argv, out=buf) == 0
    return buf.getvalue()


def _port(argv):
    return _run(cli.main, ["--device", "cpu", *argv])


def _golden():
    with open(GOLDEN, newline="") as fh:
        return fh.read()


@pytest.mark.parametrize("extra", [[], ["--sharded"]])
def test_cli_byte_matches_golden(extra):
    assert _port([*extra, QREL, RUN]) == _golden()


@pytest.mark.parametrize("argv", [
    ["-q"],
    ["-q", "--sharded"],
    ["-m", "ndcg", "-m", "map"],
    ["-m", "P_5"],
    ["-m", "P_5", "-m", "P_10"],
    ["-q", "-m", "gm_map", "-m", "map"],
    ["-q", "-m", "nDCG@10", "-m", "AP", "-m", "RBP(p=0.8)", "-m", "R@5"],
    ["-m", "AP(rel=2)", "-m", "P(rel=2)@5"],
    ["-q", "-J", "-m", "map", "-m", "P.5,10", "-m", "Judged@5"],
    ["-q", "-l", "2", "-m", "map", "-m", "num_rel", "-m", "bpref"],
    ["-q", "-m", "iprec_at_recall", "-m", "err", "--sharded"],
])
def test_cli_prints_what_the_jax_cli_prints(argv):
    jax_argv = [a for a in argv if a != "--sharded"]
    assert _port([*argv, QREL, RUN]) == _run(jax_cli.main,
                                             [*jax_argv, QREL, RUN])


def test_cli_complete_flag(tmp_path):
    partial = tmp_path / "partial.run"
    partial.write_text("q1 Q0 APPLE 0 3.0 tag\n")
    for extra in ([], ["-c"]):
        argv = [*extra, "-m", "map", "-m", "num_rel", "-m", "gm_map", QREL,
                str(partial)]
        assert _port(argv) == _run(jax_cli.main, argv)


def test_cli_rejects_duplicates_and_unknown_measures(tmp_path, capsys):
    dup = tmp_path / "dup.run"
    dup.write_text("q1 Q0 APPLE 0 0.9 t\nq1 Q0 APPLE 1 0.8 t\n")
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu", QREL, str(dup)])
    assert "duplicate" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu", "-m", "nosuch", QREL, RUN])


def test_cli_tables_match_jax_cli():
    assert cli.FAMILY_ORDER == jax_cli.FAMILY_ORDER
    assert cli.INT_MEASURES == jax_cli.INT_MEASURES
    assert cli.SUM_MEASURES == jax_cli.SUM_MEASURES
    assert cli.AGGREGATE_ONLY == jax_cli.AGGREGATE_ONLY


def _without_jax(module, argv):
    """``python -c`` code running ``python -m <module> <argv>`` with
    ``jax`` blocked in ``sys.modules``."""
    return ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            f"sys.argv = [{module!r}, *{list(argv)!r}]\n"
            "try:\n"
            f"    runpy.run_module({module!r}, run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code in (0, None), e.code\n")


def test_python_dash_m_repro_torch_runs_without_jax(tmp_path):
    """``python -m repro_torch`` with ``jax`` blocked in ``sys.modules``:
    imports, evaluates and byte-matches the golden, loading neither JAX
    nor the JAX package; nor do the recsys slice's modules (registry,
    steps, models, the EmbeddingBag wrapper), the eval arch, the service
    and its client, the training slice (the optimizer, GatedGCN, the
    graph data, the weight and state converter), the LM slice (the
    transformer, MoE, the Markov data, the trainer and its checkpoints),
    the recsys and GNN ``train`` steps and the LM ``train``, ``prefill``
    and ``decode`` steps when imported and built after it, and
    ``examples/torch_train_lm.py --help``.  ``python -m
    repro_torch.baselines.trec_eval_cli`` prints what the JAX package's
    baseline prints, ``python -m repro_torch.serve --device cpu``
    answers over stdio, and ``python -m repro_torch.serve.cluster --help``
    prints its flags, ``--device`` among them, all with ``jax`` blocked
    too; ``repro_torch.serve.cluster`` imports without it.  So do ``python
    -m repro_torch.dev sharded-smoke``, ``python -m
    repro_torch.analysis.roofline --help``, ``python -m
    repro_torch.distributed.collectives`` on a one-rank gloo group, and
    ``python -m repro_torch.launch.dryrun --help`` and ``python -m
    repro_torch.launch.sharded_train --help``; ``distributed.sharding``,
    ``launch.mesh`` and ``launch.dryrun`` import without it."""
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.argv = ['repro_torch', '--device', 'cpu', '--sharded', "
        f"{QREL!r}, {RUN!r}]\n"
        "try:\n"
        "    runpy.run_module('repro_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "import repro_torch.core, repro_torch.kernels, "
        "repro_torch.distributed\n"
        "import repro_torch.launch.api, repro_torch.launch.steps, "
        "repro_torch.models.recsys, repro_torch.kernels.embedding_bag\n"
        "from repro_torch.launch.api import get_arch, list_archs\n"
        "import repro_torch.serve, repro_torch.client, "
        "repro_torch.baselines.workflow, repro_torch.serve.cluster, "
        "repro_torch.serve.cluster.testing\n"
        "import repro_torch.train.optimizer, repro_torch.models.gnn, "
        "repro_torch.data.graph_data, repro_torch.configs.gatedgcn, "
        "repro_torch.models.convert\n"
        "a = get_arch('xdeepfm')\n"
        "a.make_step(a.make_config(True), a.shapes['train_batch'], "
        "device='cpu')\n"
        "g = get_arch('gatedgcn')\n"
        "g.make_step(g.make_config(True), g.shapes['molecule'], "
        "device='cpu')\n"
        "import repro_torch.distributed.sharding, repro_torch.launch.mesh, "
        "repro_torch.launch.dryrun\n"
        "import repro_torch.models.transformer, repro_torch.models.moe, "
        "repro_torch.train.trainer, repro_torch.train.checkpoint, "
        "repro_torch.data.lm_data\n"
        "o = get_arch('qwen3-moe-235b-a22b')\n"
        "for s in ('train_4k', 'prefill_32k', 'decode_32k'):\n"
        "    o.make_step(o.make_config(True), o.shapes[s], device='cpu')\n"
        "assert list_archs() == ['arctic-480b', 'autoint', 'gatedgcn', "
        "'mind', 'nemotron-4-15b', 'olmo-1b', 'phi3-medium-14b', "
        "'pytrec-eval', 'qwen3-moe-235b-a22b', 'sasrec', 'xdeepfm']\n"
        "bad = [m for m in sys.modules if m == 'repro' "
        "or m.startswith(('repro.', 'jax.', 'jaxlib'))]\n"
        "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout == _golden()

    import contextlib
    from repro.baselines import trec_eval_cli as jax_baseline

    args = ["-q", "-m", "map", "-m", "ndcg", QREL, RUN]
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        assert jax_baseline.main(args) == 0
    out = subprocess.run(
        [sys.executable, "-c",
         _without_jax("repro_torch.baselines.trec_eval_cli", args)],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout == want.getvalue()

    lines = ['{"op": "ping", "id": 1}',
             '{"op": "evaluate", "id": 2, "qrel_id": "default", '
             '"run": {"q1": {"APPLE": 2.0, "banana": 1.0}}}']
    out = subprocess.run(
        [sys.executable, "-c",
         _without_jax("repro_torch.serve",
                      ["--device", "cpu", "--qrel", QREL, "-m", "map"])],
        input="\n".join(lines) + "\n", capture_output=True, text=True,
        env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    resp = {r["id"]: r for r in map(json.loads, out.stdout.splitlines())}
    assert resp[1] == {"id": 1, "ok": True, "result": "pong"}
    assert resp[2]["ok"] and "map" in resp[2]["result"]["per_query"]["q1"]

    out = subprocess.run(
        [sys.executable, "-c",
         _without_jax("repro_torch.serve.cluster", ["--help"])],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("usage: python -m repro_torch.serve.cluster")
    assert "--device {cuda,cpu}" in out.stdout

    example = os.path.join(os.path.dirname(__file__), "..", "examples",
                           "torch_train_lm.py")
    out = subprocess.run(
        [sys.executable, "-c",
         "import runpy, sys\n"
         "sys.modules['jax'] = None\n"
         f"sys.argv = [{example!r}, '--help']\n"
         "try:\n"
         f"    runpy.run_path({example!r}, run_name='__main__')\n"
         "except SystemExit as e:\n"
         "    assert e.code in (0, None), e.code\n"
         "bad = [m for m in sys.modules if m == 'repro' "
         "or m.startswith(('repro.', 'jax.', 'jaxlib'))]\n"
         "assert not bad, bad\n"],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "--device {cuda,cpu}" in out.stdout and "--ckpt-dir" in out.stdout

    # the tenth slice's entry points: the developer command's sharded
    # smoke (its child imports the port only), the roofline's --help and
    # the collectives' self-check on a one-rank gloo group
    for module, argv, expect in (
            ("repro_torch.dev", ["sharded-smoke", "--device", "cpu"],
             "sharded 2-shard smoke: OK"),
            ("repro_torch.analysis.roofline", ["--help"],
             "usage: python -m repro_torch.analysis.roofline"),
            ("repro_torch.distributed.collectives",
             ["--device", "cpu", "--store", str(tmp_path / "store"),
              "--rank", "0", "--world-size", "1"], '"world_size": 1'),
            # the eleventh slice's: the dry run's --help (its import pulls
            # in the sharding rules and the mesh)
            ("repro_torch.launch.dryrun", ["--help"],
             "usage: python -m repro_torch.launch.dryrun"),
            # the twelfth slice's: the sharded-train self-check's --help
            ("repro_torch.launch.sharded_train", ["--help"],
             "usage: python -m repro_torch.launch.sharded_train")):
        code = _without_jax(module, argv) + (
            "bad = [m for m in sys.modules if m == 'repro' "
            "or m.startswith(('repro.', 'jax.', 'jaxlib'))]\n"
            "assert not bad, bad\n")
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, env=env,
                             timeout=120)
        assert out.returncode == 0, (module, out.stderr[-2000:])
        assert expect in out.stdout, module
