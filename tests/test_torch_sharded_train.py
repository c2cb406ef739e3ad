"""Model-parallel training on a gloo group of 4 CPU processes, mesh (2, 2),
against the unsharded port steps and the JAX package.

One module-scoped spawn of ``python -m repro_torch.launch.sharded_train``
per rank (a ``FileStore`` under ``tmp_path``, a 60 s group timeout, every
process killed and the test failed past ``GROUP_TIMEOUT``) runs
``sharded_train.SMOKE_CASES``: the four recsys archs with their tables
row-sharded over ``model`` and the rows over ``data``; GatedGCN's node
and graph tasks on graphs whose n and e are no multiples of the mesh;
olmo, a phi3 variant whose 3 query heads do not split over the 2
``model`` ranks, and qwen3-moe and arctic with ``fsdp`` and the bfloat16
m / factored v state; each for 2 steps from the same weights (JAX's
init, carried in by ``--weights``) and a fresh optimizer state.  Then:

* each case's gathered parameters, m, v (factored ``r`` / ``c``), loss,
  grad_norm, lr and rank metrics equal the unsharded port step's (run
  in the same process; an MoE model on each data shard's rows in turn,
  as JAX's capacity is a data shard's) within atol = rtol = 2e-4, and
  each f32 leaf of m and v has the same norm within 1e-3: a gradient
  scaled by a mesh size shows in grad_norm and in these norms;
* the same against JAX's train step (``jax.jit`` of the arch's
  ``make_step`` without a mesh; for an MoE model its loss summed over
  the data shards' rows, then JAX's AdamW), the state carried across by
  ``models.convert.load_jax_opt_state``;
* each autograd collective's backward is its transpose: ``psum`` passes
  the cotangent through, ``fan_out`` sums it over the axes,
  ``all_gather`` reduce-scatters it, ``psum_scatter`` all-gathers it;
* a checkpoint saved under (2, 2) restores under (4, 1) (in the group)
  and under no mesh (here) with the saved values;
* a rank keeps its blocks, not the whole split parameters.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.common import smoke_shape as j_smoke_shape
from repro.core import sorting as JS
from repro.core import streaming as JSt
from repro.launch.api import get_arch as j_get_arch
from repro.models import gnn as JG
from repro.models import layers as JL
from repro.models import recsys as JR
from repro.models import transformer as JT
from repro.train import optimizer as JO

from repro_torch.launch import sharded_train as ST
from repro_torch.models.convert import flatten_params, load_jax_opt_state

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD, MESH = 4, "2x2"
N_DATA = 2
GROUP_TIMEOUT = 150  # seconds for the 4 processes, start to exit
TOL = 2e-4
NORM_TOL = 1e-3
TRAIN_CASES = [c for c in ST.SMOKE_CASES
               if c.split(":")[0] in ("recsys", "gnn", "lm")]
_INIT = {"xdeepfm": JR.xdeepfm_init, "sasrec": JR.sasrec_init,
         "autoint": JR.autoint_init, "mind": JR.mind_init}


def _jax_lm_config(arg):
    name, *fields = arg.split(":")
    over = {k: int(v) for k, v in (f.split("=") for f in fields)}
    return dataclasses.replace(j_get_arch(name).make_config(True), **over)


def _jax_params(case):
    """(tag, JAX parameter tree) of a case, from JAX's init."""
    kind, _, arg = case.partition(":")
    key = jax.random.PRNGKey(7)
    if kind == "recsys":
        return arg, _INIT[arg](key, j_get_arch(arg).make_config(True))
    if kind == "gnn":
        return f"gatedgcn_{arg}", JG.init_gatedgcn(
            key, j_get_arch("gatedgcn").make_config(True))
    _, _, tag = ST.lm_config(arg, "smoke")
    return tag, JT.init_transformer(key, _jax_lm_config(arg))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    out = tmp_path_factory.mktemp("weights")
    params = {}
    for case in TRAIN_CASES:
        tag, tree = _jax_params(case)
        np.savez(out / f"{tag}.npz",
                 **flatten_params(jax.tree.map(np.asarray, tree)))
        params[case] = tree
    return out, params


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, weights):
    """Every rank's saved results and JSON line from one gloo group."""
    tmp = tmp_path_factory.mktemp("st")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.sharded_train",
         "--device", "cpu", "--backend", "gloo", "--mesh", MESH,
         "--store", str(tmp / "store"), "--rank", str(r),
         "--world-size", str(WORLD), "--weights", str(weights[0]),
         "--out", str(tmp / "out")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=GROUP_TIMEOUT))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"the gloo group did not finish in {GROUP_TIMEOUT} s")
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return ([dict(np.load(tmp / "out" / f"rank{r}.npz"))
             for r in range(WORLD)],
            [json.loads(o.strip().splitlines()[-1]) for o, _ in outs],
            tmp / "out")


def _sub(out, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in out.items() if k.startswith(prefix + "/")}


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def test_every_rank_returns_the_same_results(ranks):
    """Each gathered result is the same on every rank (the collectives'
    own inputs and a rank's restored block differ by rank)."""
    outs = ranks[0]
    own = ("collectives/", "ckpt/restored/block/")
    for r in range(1, WORLD):
        assert outs[r].keys() == outs[0].keys()
        for k, v in outs[0].items():
            if not k.startswith(own):
                np.testing.assert_array_equal(outs[r][k], v, err_msg=k)


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_matches_the_unsharded_step(ranks, case):
    got = _sub(ranks[0][0], f"{case}/got")
    want = _sub(ranks[0][0], f"{case}/want")
    assert got.keys() == want.keys()
    assert "step1/grad_norm" in got and "step1/loss" in got
    for k in want:
        _close(got[k], want[k], f"{case} {k}")
    for k in want:  # no leaf's gradient scaled by a mesh size
        if k.startswith(("m/", "v/")) and got[k].dtype == np.float32:
            w = np.linalg.norm(want[k])
            if w > 0:
                assert abs(np.linalg.norm(got[k]) / w - 1) < NORM_TOL, k
    errors = ranks[1][0]["errors"][case]
    assert set(errors) == {"params", "m", "v", "metrics"}
    for group, e in errors.items():
        assert e["max_abs_err"] <= TOL * max(1.0, e["max_abs"]), group
    for group in ("m", "v"):  # each leaf at its own scale
        assert errors[group]["norm_gap"] < NORM_TOL, group


@pytest.mark.parametrize("case", [c for c in TRAIN_CASES
                                  if not c.startswith("gnn:")])
def test_a_rank_keeps_only_its_blocks(ranks, case):
    """After the steps a rank's laid-out model keeps its blocks and the
    replicated parameters, and no whole split parameter (the storage
    behind them is the blocks' size)."""
    for line in ranks[1]:
        held = line["held_bytes"][case]
        assert held["storage"] == held["blocks"], held


def _jax_recsys(case, jparams, inputs):
    name = case.split(":")[1]
    jarch = j_get_arch(name)
    rows = inputs["step0"][next(iter(inputs["step0"]))].shape[0]
    shape = j_smoke_shape(jarch.shapes["train_batch"], batch=rows)
    bundle = jarch.make_step(jarch.make_config(True), shape, None)
    init, _ = JO.adamw(JO.OptimizerConfig(lr=1e-3))
    step = jax.jit(bundle.step_fn)
    return init, [lambda p, s, i=i: step(p, s, jax.tree.map(
        jnp.asarray, inputs[f"step{i}"])) for i in range(ST.STEPS)]


def _jax_gnn(case, inputs):
    arg = case.split(":")[1]
    jarch = j_get_arch("gatedgcn")
    jcfg = jarch.make_config(True)
    if arg == "node":
        n, e = ST.GNN_SMOKE["node"]
        shape = j_smoke_shape(jarch.shapes["full_graph_sm"], n_nodes=n,
                              n_edges=e, d_feat=jcfg.d_in,
                              n_classes=jcfg.n_classes)
    else:
        ng, npg, epg = ST.GNN_SMOKE["graph"]
        shape = j_smoke_shape(jarch.shapes["molecule"], n_nodes=ng * npg,
                              n_edges=ng * epg, d_feat=jcfg.d_in,
                              n_classes=jcfg.n_classes, n_graphs=ng,
                              nodes_per_graph=npg, edges_per_graph=epg)
    step = jax.jit(jarch.make_step(jcfg, shape, None).step_fn)
    init, _ = JO.adamw(JO.OptimizerConfig(lr=1e-3))
    batch = jax.tree.map(jnp.asarray, inputs)
    return init, [lambda p, s: step(p, s, batch)] * ST.STEPS


def _jax_lm(case, inputs):
    """JAX's LM train step (an MoE model's loss summed over the data
    shards' rows, each shard's capacity its own, as the sharded step)."""
    arg = case.split(":", 1)[1]
    jcfg = _jax_lm_config(arg)
    ocfg = JO.OptimizerConfig(lr=3e-4, warmup_steps=50, decay_steps=20_000)
    if jcfg.moe is not None:
        ocfg = dataclasses.replace(ocfg, momentum_dtype="bfloat16",
                                   factored_v=True)
    init, update = JO.adamw(ocfg)
    shards = N_DATA if jcfg.moe is not None else 1

    @jax.jit
    def step(params, state, tokens, labels):
        n = tokens.shape[0] // shards

        def loss_fn(p):
            loss, ranks = 0.0, []
            for i in range(shards):
                logits = JT.logits_train(p, tokens[i * n:(i + 1) * n], jcfg)
                lab = labels[i * n:(i + 1) * n]
                loss = loss + JL.cross_entropy(logits, lab) / shards
                ranks.append(JS.gold_rank(logits, lab))
            return loss, jnp.concatenate(ranks)

        (loss, ranks), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        params, state, info = update(grads, state, params)
        return params, state, {"loss": loss, **info,
                               **JSt.rank_metrics(ranks.reshape(-1))}

    return init, [lambda p, s, i=i: step(
        p, s, jnp.asarray(inputs[f"step{i}/tokens"]),
        jnp.asarray(inputs[f"step{i}/labels"])) for i in range(ST.STEPS)]


def _nest_inputs(flat):
    out = {}
    for k, v in flat.items():
        head, _, rest = k.partition("/")
        if rest:
            out.setdefault(head, {})[rest] = v
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_matches_jax(ranks, weights, case):
    out = ranks[0][0]
    got = _sub(out, f"{case}/got")
    inputs = _sub(out, f"{case}/inputs")
    jparams = weights[1][case]
    kind = case.split(":")[0]
    if kind == "recsys":
        init, steps = _jax_recsys(case, jparams, _nest_inputs(inputs))
    elif kind == "gnn":
        init, steps = _jax_gnn(case, inputs)
    else:
        init, steps = _jax_lm(case, inputs)
    jp, js = jparams, init(jparams)
    for i, step in enumerate(steps):
        jp, js, metrics = step(jp, js)
        assert {f"step{i}/{k}" for k in metrics} == {
            k for k in got if k.startswith(f"step{i}/")}
        for k, v in metrics.items():
            _close(got[f"step{i}/{k}"], v, f"{case} step {i} {k} vs JAX")
    params = flatten_params(jax.tree.map(np.asarray, jp))
    for n, v in params.items():
        _close(got[f"params/{n}"], np.asarray(v, np.float32),
               f"{case} {n} vs JAX")
    state = load_jax_opt_state(jax.tree.map(np.asarray, jp),
                               jax.tree.map(np.asarray, js))
    assert int(state.step) == ST.STEPS
    for n, m in state.m.items():
        _close(got[f"m/{n}"], m.float().numpy(), f"{case} m {n} vs JAX")
        v = state.v[n]
        if isinstance(v, dict):
            for part in ("r", "c"):
                _close(got[f"v/{n}/{part}"], v[part].numpy(),
                       f"{case} v {n} {part} vs JAX")
        else:
            _close(got[f"v/{n}"], v.numpy(), f"{case} v {n} vs JAX")


def _coords(ranks):
    return [tuple(int(x) for x in o["collectives/coords"]) for o in ranks]


def _group(coords, r, tag):
    """The ranks of r's group along ``tag`` in axis order (data, model)."""
    keep = {"model": (0,), "data": (1,), "both": ()}[tag]
    return sorted((q for q in range(len(coords))
                   if all(coords[q][d] == coords[r][d] for d in keep)),
                  key=lambda q: coords[q])


@pytest.mark.parametrize("tag", ("model", "data", "both"))
@pytest.mark.parametrize("op", ("psum", "fan_out", "all_gather",
                                "psum_scatter"))
def test_collective_backward_is_its_transpose(ranks, tag, op):
    outs = ranks[0]
    coords = _coords(outs)
    for r in range(WORLD):
        group = _group(coords, r, tag)
        at = group.index(r)
        get = lambda q, k: outs[q][f"collectives/{tag}/{op}/{k}"]  # noqa
        if op == "psum":  # the whole cotangent to each partial sum
            want_y = sum(get(q, "x") for q in group)
            want_g = get(r, "ct")
        elif op == "fan_out":  # identity forward, cotangents summed
            want_y = get(r, "x")
            want_g = sum(get(q, "ct") for q in group)
        elif op == "all_gather":  # backward: a reduce-scatter
            want_y = np.concatenate([get(q, "x") for q in group])
            total = sum(get(q, "ct") for q in group)
            n = get(r, "x").shape[0]
            want_g = total[at * n:(at + 1) * n]
        else:  # psum_scatter; backward: an all-gather
            total = sum(get(q, "x") for q in group)
            n = get(r, "y").shape[0]
            want_y = total[at * n:(at + 1) * n]
            want_g = np.concatenate([get(q, "ct") for q in group])
        np.testing.assert_allclose(get(r, "y"), want_y, rtol=1e-6,
                                   atol=1e-6, err_msg=f"{op} {tag} y")
        np.testing.assert_allclose(get(r, "grad"), want_g, rtol=1e-6,
                                   atol=1e-6, err_msg=f"{op} {tag} grad")


def test_checkpoint_restores_under_other_meshes(ranks):
    from repro_torch.launch.api import get_arch
    from repro_torch.launch.steps import MODELS
    from repro_torch.train import checkpoint as C
    from repro_torch.train import optimizer as opt_lib

    outs, _, where = ranks
    saved = _sub(outs[0], "ckpt/saved")
    restored = _sub(outs[0], "ckpt/restored")
    assert tuple(outs[0]["ckpt/restored_mesh"]) == (WORLD, 1)
    assert int(saved["step"]) == 1
    for k, v in saved.items():  # under (4, 1)
        np.testing.assert_array_equal(restored[k], v, err_msg=k)
    for r in range(WORLD):  # (4, 1): `model` has one rank, holding all rows
        np.testing.assert_array_equal(outs[r]["ckpt/restored/block/table"],
                                      saved["params/table"])
    cfg = get_arch("xdeepfm").make_config(True)
    model = MODELS["xdeepfm"](cfg, device="cpu")  # under no mesh
    state = opt_lib.adamw(opt_lib.OptimizerConfig())[0](model)
    tree, _ = C.restore(str(where / "ckpt"), 1,
                        {"params": model, "opt_state": state})
    for n, p in tree["params"].named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      saved[f"params/{n}"], err_msg=n)
    st = tree["opt_state"]
    assert int(st.step) == 1
    for n in st.m:
        np.testing.assert_array_equal(st.m[n].numpy(), saved[f"m/{n}"])
        np.testing.assert_array_equal(st.v[n].numpy(), saved[f"v/{n}"])


def test_card_cases_are_the_full_widths():
    assert ST.CARD_CASES == ("recsys:xdeepfm", "lm:olmo-1b",
                             "gnn:full_graph_sm")
    assert ST.RECSYS_ROWS["card"] == 65_536
    assert ST.LM_SIZES["card"] == (1024, 2)
    assert ST.lm_config("olmo-1b", "card")[1].n_layers == 2


def test_each_rank_reports_its_cases(ranks):
    """The JSON lines carry each case's seconds and differences."""
    for line in ranks[1]:
        assert set(line["errors"]) == set(TRAIN_CASES)
        assert set(line["case_seconds"]) == set(TRAIN_CASES)
        assert torch.isfinite(torch.tensor(
            [e[k] for groups in line["errors"].values()
             for e in groups.values()
             for k in ("max_abs_err", "max_abs", "leaf_rel_err",
                       "norm_gap")])).all()
