"""The port's recsys serving slice against the JAX package, on the CPU.

Every (arch × shape) step the port has — xDeepFM, SASRec, AutoInt and
MIND at ``serve_p99``, ``serve_bulk`` and ``retrieval_cand``, smoke size —
runs on the same concrete inputs (``data/recsys_data`` from a seed) and the
same weights (the JAX init, carried across by ``load_jax_params``) as
``jax.jit`` of the JAX bundle's ``step_fn``.

Tolerances: scores within atol = rtol = 1e-4 (the CIN, attention and
capsule sums run in another order than XLA's); in-loop metrics within
2e-4, the repo's fused-vs-core tolerance; retrieval's top-k values within
1e-4 of JAX's and its indices exactly the port's ``topk_plain`` of the
port's own scores (near-ties may swap against JAX's scores).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.common import recsys_shapes as j_recsys_shapes
from repro.configs.common import smoke_shape as j_smoke_shape
from repro.data import recsys_data as JRD
from repro.launch.api import get_arch as j_get_arch
from repro.models import recsys as JR

from repro_torch.configs.common import recsys_shapes, smoke_shape
from repro_torch.data import recsys_data as RD
from repro_torch.kernels import topk as TK
from repro_torch.launch import steps as STEPS
from repro_torch.launch.api import get_arch, list_archs, to_device
from repro_torch.models import recsys as R
from repro_torch.models.convert import load_jax_params

from test_torch_measures import single_torch_thread  # noqa: F401

ARCHS = ("autoint", "mind", "sasrec", "xdeepfm")
SHAPES = {"serve_p99": {"batch": 4, "slate": 16},
          "serve_bulk": {"batch": 4},
          "retrieval_cand": {"n_candidates": 64, "topk": 8}}
TOL = 1e-4
METRIC_TOL = 2e-4
J_INIT = {"xdeepfm": JR.xdeepfm_init, "autoint": JR.autoint_init,
          "sasrec": JR.sasrec_init, "mind": JR.mind_init}
RETRIEVAL_SCORES = {"sasrec": R.sasrec_retrieval_scores,
                    "mind": R.mind_retrieval_scores}


def _n_items(name, cfg):
    return cfg.n_items if name == "sasrec" else cfg.table.vocab_per_field


def _batch(name, cfg, b, seed=0, step=0):
    n = _n_items(name, cfg)
    if name == "sasrec":
        return RD.seq_batch(RD.SeqDataConfig(n, cfg.seq_len, b, seed=seed),
                            step)
    if name == "mind":
        return RD.mind_batch(RD.SeqDataConfig(n, cfg.hist_len, b, seed=seed),
                             step)
    return RD.ctr_batch(RD.CTRDataConfig(cfg.table.n_fields, n, b,
                                         cfg.n_multi_hot, cfg.multi_hot_len,
                                         seed), step)


def _args(name, cfg, shape, seed=1):
    """Concrete numpy arguments after the params slot."""
    b = shape.get("batch")
    rng = np.random.default_rng(seed)
    n = _n_items(name, cfg)
    batch = _batch(name, cfg, b)
    if shape.kind == "retrieval":
        nc = shape.get("n_candidates")
        if name in ("xdeepfm", "autoint"):
            batch = {"ids": batch["ids"][:1]}
        return (batch, rng.integers(0, n, nc).astype(np.int32),
                (rng.random((b, nc)) < 0.1).astype(np.int32))
    if name in ("sasrec", "mind") and shape.get("slate"):
        s = shape.get("slate")
        return (batch, rng.integers(0, n, (b, s)).astype(np.int32),
                (rng.random((b, s)) < 0.2).astype(np.int32))
    return (batch,)


@functools.lru_cache(maxsize=None)
def _models(name):
    """(port module on the CPU, JAX params, config): the JAX init, carried
    across."""
    cfg = get_arch(name).make_config(True)
    jparams = J_INIT[name](jax.random.PRNGKey(0),
                           j_get_arch(name).make_config(True))
    model = STEPS.MODELS[name](cfg, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, jparams))
    return model, jparams, cfg


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("name", ARCHS)
def test_step_matches_jax(name, shape_name):
    model, jparams, cfg = _models(name)
    shape = smoke_shape(get_arch(name).shapes[shape_name],
                        **SHAPES[shape_name])
    jarch = j_get_arch(name)
    jshape = j_smoke_shape(jarch.shapes[shape_name], **SHAPES[shape_name])
    args = _args(name, cfg, shape)
    got = get_arch(name).make_step(cfg, shape, device="cpu").step_fn(
        model, *to_device(args, "cpu"))
    want = jax.jit(jarch.make_step(
        jarch.make_config(True), jshape, None).step_fn)(
            jparams, *jax.tree.map(jnp.asarray, args))
    if shape.kind == "retrieval":
        v, i, metrics = got
        jv, _, jmetrics = want
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=TOL,
                                   rtol=TOL)
        scores = _retrieval_scores(name, model, cfg, shape, args)
        pv, pi = TK.topk_plain(scores, shape.get("topk"))
        assert torch.equal(i, pi) and torch.equal(v, pv)
    elif isinstance(got, tuple):  # slate scores + in-loop metrics
        scores, metrics = got
        jscores, jmetrics = want
        np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                                   atol=TOL, rtol=TOL)
    else:
        assert got.shape == (shape.get("batch"),)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)
        return
    assert metrics.keys() == jmetrics.keys()
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   atol=METRIC_TOL, rtol=METRIC_TOL,
                                   err_msg=k)


@torch.inference_mode()
def _retrieval_scores(name, model, cfg, shape, args):
    batch, cand, _ = to_device(args, "cpu")
    if name in RETRIEVAL_SCORES:
        return RETRIEVAL_SCORES[name](model, {**batch, "candidates": cand},
                                      cfg)
    ids = batch["ids"].expand(cand.shape[0], -1).clone()
    ids[:, 0] = cand
    score = R.xdeepfm_score if name == "xdeepfm" else R.autoint_score
    return score(model, {"ids": ids}, cfg)[None, :]


@pytest.mark.parametrize("name", ARCHS)
def test_scores_in_row_chunks_match_one_call(name, monkeypatch):
    model, _, cfg = _models(name)
    shape = smoke_shape(get_arch(name).shapes["serve_bulk"], batch=11)
    step = get_arch(name).make_step(cfg, shape, device="cpu").step_fn
    args = to_device(_args(name, cfg, shape), "cpu")
    whole = step(model, *args)
    monkeypatch.setattr(R, "CHUNK_BYTES", 1)  # one row a chunk
    chunked = step(model, *args)
    torch.testing.assert_close(chunked, whole, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", ARCHS)
def test_param_specs_match_the_jax_pytree(name):
    cfg = get_arch(name).make_config(False)
    jcfg = j_get_arch(name).make_config(False)
    jshapes = jax.eval_shape(lambda: J_INIT[name](jax.random.PRNGKey(0),
                                                  jcfg))
    flat = {jax.tree_util.keystr(path, simple=True, separator="."): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(jshapes)}
    specs = STEPS.param_specs(name, cfg)
    assert {n: s.shape for n, s in specs.items()} == flat
    assert all(s.dtype == torch.float32 for s in specs.values())


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("smoke", [True, False])
def test_configs_and_shapes_match_jax(name, smoke):
    got = dataclasses.asdict(get_arch(name).make_config(smoke))
    want = dataclasses.asdict(j_get_arch(name).make_config(smoke))
    want.pop("unroll_layers", None)  # the JAX cost-probe switch
    assert got == want
    ours = get_arch(name).shapes
    theirs = j_get_arch(name).shapes
    assert {k: (v.kind, v.meta) for k, v in ours.items()} == \
        {k: (v.kind, v.meta) for k, v in theirs.items()}
    assert recsys_shapes(7)["serve_p99"].meta == \
        j_recsys_shapes(7)["serve_p99"].meta


def test_registry_lists_the_ported_archs():
    assert list_archs() == sorted(ARCHS + (
        "gatedgcn", "pytrec-eval", "olmo-1b", "phi3-medium-14b",
        "nemotron-4-15b", "qwen3-moe-235b-a22b", "arctic-480b"))
    with pytest.raises(KeyError):
        get_arch("gpt-5")


def test_recsys_data_is_byte_identical_to_jax():
    for seed, step in ((0, 0), (7, 3)):
        ctr = RD.CTRDataConfig(39, 1_000_000, 64, 3, 8, seed)
        jctr = JRD.CTRDataConfig(39, 1_000_000, 64, 3, 8, seed)
        seq = RD.SeqDataConfig(1_000_000, 50, 16, seed=seed)
        jseq = JRD.SeqDataConfig(1_000_000, 50, 16, seed=seed)
        for got, want in ((RD.ctr_batch(ctr, step),
                           JRD.ctr_batch(jctr, step)),
                          (RD.seq_batch(seq, step),
                           JRD.seq_batch(jseq, step)),
                          (RD.mind_batch(seq, step),
                           JRD.mind_batch(jseq, step))):
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                assert got[k].tobytes() == want[k].tobytes(), k
    it = RD.iterator(RD.seq_batch, RD.SeqDataConfig(100, 5, 2), 4)
    assert next(it)["items"].tobytes() == JRD.seq_batch(
        JRD.SeqDataConfig(100, 5, 2), 4)["items"].tobytes()


def test_load_jax_params_raises_on_missing_extra_and_misshaped_leaves():
    _, jparams, cfg = _models("xdeepfm")
    params = jax.tree.map(np.asarray, jparams)
    fresh = STEPS.MODELS["xdeepfm"](cfg, device="cpu")
    before = {n: p.clone() for n, p in fresh.named_parameters()}
    missing = dict(params, cin=params["cin"][:1])
    with pytest.raises(KeyError, match="cin.1"):
        load_jax_params(fresh, missing)
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(fresh, dict(params, other=np.zeros(3, np.float32)))
    with pytest.raises(ValueError, match="mlp_w.0"):
        load_jax_params(fresh, dict(params, mlp_w=[params["mlp_w"][0][:, :3],
                                                   *params["mlp_w"][1:]]))
    # nothing was copied before the error
    for n, p in fresh.named_parameters():
        assert torch.equal(p, before[n]), n
    sas = STEPS.MODELS["sasrec"](_models("sasrec")[2], device="cpu")
    sparams = jax.tree.map(np.asarray, _models("sasrec")[1])
    with pytest.raises(ValueError, match="blocks.wqkv"):
        load_jax_params(sas, dict(sparams, blocks=dict(
            sparams["blocks"], wqkv=sparams["blocks"]["wqkv"][:1])))


def test_train_kind_is_not_ported_yet():
    """The name predates the train kind's port: the step now builds for
    every recsys arch, with the optimizer state as its second argument
    (its parity with JAX is tests/test_torch_train.py's)."""
    for name in ARCHS:
        arch = get_arch(name)
        cfg = arch.make_config(True)
        bundle = arch.make_step(cfg, arch.shapes["train_batch"],
                                device="cpu")
        params, opt, inputs = bundle.arg_specs
        assert params == STEPS.param_specs(name, cfg)
        assert opt.m.keys() == params.keys()
        assert next(iter(inputs.values())).shape[0] == 65_536
        assert callable(bundle.init_opt)


def test_entry_points_default_to_cuda():
    arch = get_arch("sasrec")
    cfg = arch.make_config(True)
    if torch.cuda.is_available():
        bundle = arch.make_step(cfg, arch.shapes["serve_p99"])
        assert bundle.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        arch.make_step(cfg, arch.shapes["serve_p99"])
    with pytest.raises(RuntimeError, match="CUDA"):
        STEPS.MODELS["sasrec"](cfg)
