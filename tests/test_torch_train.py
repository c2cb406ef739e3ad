"""The port's training slice against the JAX package, on the CPU.

* ``train.optimizer``: the port's ``adamw`` update against
  ``repro.train.optimizer`` on the same numpy gradients, 5 steps, every
  schedule, with clipping engaged, float32 and bfloat16 momentum, with and
  without the factored second moment.  Parameters, m, v (or r / c), lr
  and grad_norm within rtol 1e-6; an entry near zero within 1e-6 of its
  leaf's largest magnitude (the f32 cosine or power may differ in the last
  bit between XLA and torch, and moves every entry by the same absolute
  amount).
* ``models.layers.cross_entropy`` and the recsys losses (``sasrec_loss``,
  ``mind_loss``, ``ctr_loss`` of xDeepFM and AutoInt) on carried weights.
* Each recsys arch's smoke ``train`` step from carried weights and
  carried optimizer state (``load_jax_opt_state``) against
  ``jax.jit(bundle.step_fn)`` for 3 steps: loss, grad_norm and lr within
  rtol = atol = 2e-4, every gradient leaf of the first step within rtol
  2e-4 plus atol 2e-4 · max|g| of ``jax.grad`` of the JAX loss (the port
  sums in another order), the parameters after 3 steps within 1e-5.
* The chunked gradient (the front end once, the dense part in row chunks)
  against one chunk.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.common import smoke_shape as j_smoke_shape
from repro.launch.api import get_arch as j_get_arch
from repro.models import layers as JL
from repro.models import recsys as JR
from repro.train import optimizer as JO

from repro_torch.configs.common import smoke_shape
from repro_torch.kernels import embedding_bag as EB
from repro_torch.launch.api import get_arch, to_device
from repro_torch.launch import steps as STEPS
from repro_torch.models import layers as L
from repro_torch.models import recsys as R
from repro_torch.models.convert import (flatten_params, load_jax_opt_state,
                                        load_jax_params)
from repro_torch.train import optimizer as O

from test_torch_measures import single_torch_thread  # noqa: F401
from test_torch_recsys import _batch, _models

ARCHS = ("autoint", "mind", "sasrec", "xdeepfm")
OPT_RTOL = 1e-6
TOL = 2e-4
BATCH = 8
J_LOSS = {
    "sasrec": lambda p, b, c: JR.sasrec_loss(p, b, c),
    "mind": lambda p, b, c: JR.mind_loss(p, b, c),
    "xdeepfm": lambda p, b, c: JR.ctr_loss(JR.xdeepfm_score, p, b, c)[0],
    "autoint": lambda p, b, c: JR.ctr_loss(JR.autoint_score, p, b, c)[0],
}
LOSS = {
    "sasrec": R.sasrec_loss,
    "mind": R.mind_loss,
    "xdeepfm": lambda p, b, c: R.ctr_loss(R.xdeepfm_score, p, b, c)[0],
    "autoint": lambda p, b, c: R.ctr_loss(R.autoint_score, p, b, c)[0],
}


def _close(got, want, what, rtol=OPT_RTOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


def _grads_close(got, want, what):
    """Each leaf within rtol TOL plus atol TOL · max|g| of that leaf."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        _close(got[k], w, f"{what} {k}", rtol=TOL)


# -- the optimizer -------------------------------------------------------------


def _opt_tree(rng):
    return {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": [rng.standard_normal((3,)).astype(np.float32),
                  rng.standard_normal((2, 3, 4)).astype(np.float32)],
            "c": np.float32(rng.standard_normal())}


def _to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in
            flatten_params(tree).items()}


@pytest.mark.parametrize("variant", ["float32", "bfloat16", "factored",
                                     "bfloat16_factored"])
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_adamw_matches_jax_on_shared_gradients(schedule, variant):
    kw = dict(lr=1e-2, schedule=schedule, warmup_steps=2, decay_steps=6,
              clip_norm=3.0, momentum_dtype=("bfloat16" if "bfloat16"
                                             in variant else "float32"),
              factored_v="factored" in variant)
    j_init, j_update = JO.adamw(JO.OptimizerConfig(**kw))
    init, update = O.adamw(O.OptimizerConfig(**kw))
    rng = np.random.default_rng(7)
    p0 = _opt_tree(rng)
    jp = jax.tree.map(jnp.asarray, p0)
    js = j_init(jp)
    params = _to_torch(p0)
    state = init(params)
    assert state.m.keys() == params.keys()
    j_update = jax.jit(j_update)
    clipped = False
    for step in range(5):
        g = _opt_tree(rng)
        jp, js, jinfo = j_update(jax.tree.map(jnp.asarray, g), js, jp)
        params, state, info = update(_to_torch(g), state, params)
        clipped |= float(jinfo["grad_norm"]) > kw["clip_norm"]
        _close(info["lr"], jinfo["lr"], f"lr {step}")
        _close(info["grad_norm"], jinfo["grad_norm"], f"grad_norm {step}")
        assert int(state.step) == int(js.step) == step + 1
        want = flatten_params(jax.tree.map(np.asarray, jp))
        for name in want:
            _close(params[name], want[name], f"{name} step {step}")
        carried = load_jax_opt_state(jax.tree.map(np.asarray, jp),
                                     jax.tree.map(np.asarray, js))
        for name in want:
            assert state.m[name].dtype == carried.m[name].dtype
            _close(state.m[name].float(), carried.m[name].float(),
                   f"m {name} step {step}")
            v, cv = state.v[name], carried.v[name]
            if isinstance(cv, dict):
                assert kw["factored_v"] and v.keys() == {"r", "c"}
                for part in ("r", "c"):
                    _close(v[part], cv[part], f"v.{part} {name}")
            else:
                _close(v, cv, f"v {name}")
    assert clipped  # the clip was engaged at least once


def test_schedule_and_global_norm_match_jax():
    for schedule in ("cosine", "linear", "constant"):
        cfg = dict(lr=2e-3, schedule=schedule, warmup_steps=10,
                   decay_steps=50, min_lr_ratio=0.2)
        got = O.make_schedule(O.OptimizerConfig(**cfg))
        want = JO.make_schedule(JO.OptimizerConfig(**cfg))
        for step in (0, 1, 9, 10, 11, 30, 50, 80):
            _close(got(torch.tensor(step, dtype=torch.int32)),
                   want(jnp.asarray(step, jnp.int32)), f"{schedule} {step}")
    tree = _opt_tree(np.random.default_rng(3))
    _close(O.global_norm(_to_torch(tree)),
           JO.global_norm(jax.tree.map(jnp.asarray, tree)), "global_norm")
    with pytest.raises(ValueError, match="schedule"):
        O.make_schedule(O.OptimizerConfig(schedule="step"))


def test_update_rejects_mismatched_gradients_and_leaf_order_is_jax():
    init, update = O.adamw(O.OptimizerConfig())
    params = {"w": torch.zeros(2), "b": torch.zeros(3)}
    with pytest.raises(KeyError, match="differ"):
        update({"w": torch.zeros(2)}, init(params), params)
    names = ["mlp_w.10", "mlp_w.2", "cin.0", "cin_out", "bias", "attn.1.wq",
             "attn.1.wk", "attn.0.wv"]
    tree = {"mlp_w": list(range(11)), "cin": [0], "cin_out": 0, "bias": 0,
            "attn": [{"wv": 0}, {"wq": 0, "wk": 0}]}
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    jax_order = [jax.tree_util.keystr(p, simple=True, separator=".")
                 for p, _ in leaves]
    got = O.leaf_order(names)
    assert got == [n for n in jax_order if n in names]


# -- losses ---------------------------------------------------------------------


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((6, 4, 9)) * 4).astype(np.float32)
    labels = rng.integers(0, 9, (6, 4)).astype(np.int32)
    mask = rng.random((6, 4)) < 0.5
    for m in (None, mask, np.zeros_like(mask)):
        got = L.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels),
                              None if m is None else torch.from_numpy(m))
        want = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                None if m is None else jnp.asarray(m))
        _close(got, want, f"cross_entropy mask={m is not None}", rtol=1e-6)


@pytest.mark.parametrize("name", ARCHS)
def test_recsys_loss_matches_jax(name):
    model, jparams, cfg = _models(name)
    batch = _batch(name, cfg, BATCH, seed=2)
    jcfg = j_get_arch(name).make_config(True)
    want = jax.jit(J_LOSS[name], static_argnums=2)(
        jparams, jax.tree.map(jnp.asarray, batch), jcfg)
    got = LOSS[name](model, to_device(batch, "cpu"), cfg)
    _close(got.detach(), want, f"{name} loss", rtol=TOL)
    if name in ("xdeepfm", "autoint"):
        score = R.xdeepfm_score if name == "xdeepfm" else R.autoint_score
        _, logits = R.ctr_loss(score, model, to_device(batch, "cpu"), cfg)
        assert logits.shape == (BATCH,)


# -- the train step -------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_step(name):
    jarch = j_get_arch(name)
    jshape = j_smoke_shape(jarch.shapes["train_batch"], batch=BATCH)
    return jax.jit(jarch.make_step(jarch.make_config(True), jshape,
                                   None).step_fn)


def _fresh(name):
    """A port module with the JAX init's weights, not shared with other
    tests (a train step updates it in place)."""
    _, jparams, cfg = _models(name)
    model = STEPS.MODELS[name](cfg, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, jparams))
    return model, jparams, cfg


@pytest.mark.parametrize("name", ARCHS)
def test_train_step_matches_jax_for_three_steps(name):
    model, jparams, cfg = _fresh(name)
    arch = get_arch(name)
    shape = smoke_shape(arch.shapes["train_batch"], batch=BATCH)
    bundle = arch.make_step(cfg, shape, device="cpu")
    j_init, _ = JO.adamw(JO.OptimizerConfig(lr=1e-3))
    jp, js = jparams, j_init(jparams)
    state = load_jax_opt_state(jax.tree.map(np.asarray, jp),
                               jax.tree.map(np.asarray, js))
    jcfg = j_get_arch(name).make_config(True)
    for step in range(3):
        batch = _batch(name, cfg, BATCH, seed=3, step=step)
        jbatch = jax.tree.map(jnp.asarray, batch)
        if step == 0:
            jgrads = jax.jit(jax.grad(J_LOSS[name]), static_argnums=2)(
                jp, jbatch, jcfg)
        jp, js, jmetrics = _jax_step(name)(jp, js, jbatch)
        model, state, metrics = bundle.step_fn(model, state,
                                               to_device(batch, "cpu"))
        assert metrics.keys() == jmetrics.keys() == {"loss", "grad_norm",
                                                     "lr"}
        for k in jmetrics:
            assert metrics[k].dim() == 0
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                       rtol=TOL, atol=TOL, err_msg=k)
        if step == 0:
            _grads_close({n: p.grad for n, p in model.named_parameters()},
                         flatten_params(jax.tree.map(np.asarray, jgrads)),
                         name)
    assert int(state.step) == 3
    want = flatten_params(jax.tree.map(np.asarray, jp))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], atol=1e-5,
                                   rtol=0, err_msg=n)


@pytest.mark.parametrize("name", ARCHS)
def test_chunked_gradient_matches_one_chunk(name):
    model, _, cfg = _fresh(name)
    batch = to_device(_batch(name, cfg, 11, seed=4), "cpu")
    grads = {}
    for rows in (None, 3):
        model.zero_grad(set_to_none=True)
        loss = R.loss_and_grad(name, model, batch, cfg, rows=rows)
        grads[rows] = (loss, {n: p.grad.clone()
                              for n, p in model.named_parameters()})
    (loss1, g1), (loss3, g3) = grads[None], grads[3]
    assert R.train_chunk_rows(name, cfg) >= 11  # None was one chunk
    torch.testing.assert_close(loss3, loss1, atol=1e-6, rtol=1e-6)
    for n in g1:
        torch.testing.assert_close(g3[n], g1[n], atol=1e-6, rtol=1e-5,
                                   msg=n)
    whole = LOSS[name](model, batch, cfg)
    torch.testing.assert_close(loss1, whole.detach(), atol=1e-6, rtol=1e-6)


def test_train_step_launches_b3_backward_once_per_step_shape(monkeypatch):
    """xDeepFM's multi-hot bags take the differentiable B3 entry under
    autograd (its plain backward on the CPU), and no table lookup is
    differentiated more than once however many chunks there are."""
    model, _, cfg = _fresh("xdeepfm")
    calls = []
    real = EB.embedding_bag_fixed_backward

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(EB, "embedding_bag_fixed_backward", spy)
    batch = to_device(_batch("xdeepfm", cfg, 9, seed=6), "cpu")
    R.loss_and_grad("xdeepfm", model, batch, cfg, rows=2)
    assert calls == [(9 * cfg.n_multi_hot, cfg.table.dim)]
    with torch.inference_mode():  # serving never records the Function
        R.xdeepfm_score(model, batch, cfg)
    assert len(calls) == 1


def test_load_jax_opt_state_carries_factored_bf16_state():
    """After one JAX step with bfloat16 m and a factored v, the carried
    state gives the port's next step JAX's next step."""
    _, jparams, cfg = _fresh("xdeepfm")
    kw = dict(lr=1e-2, warmup_steps=1, momentum_dtype="bfloat16",
              factored_v=True)
    j_init, j_update = JO.adamw(JO.OptimizerConfig(**kw))
    j_update = jax.jit(j_update)
    init, update = O.adamw(O.OptimizerConfig(**kw))
    rng = np.random.default_rng(11)

    def grads():
        return jax.tree.map(
            lambda x: (rng.standard_normal(x.shape) * 1e-2).astype(
                np.float32), jax.tree.map(np.asarray, jparams))

    jp, js, _ = j_update(grads(), j_init(jparams), jparams)
    carried = load_jax_opt_state(jax.tree.map(np.asarray, jp),
                                 jax.tree.map(np.asarray, js))
    assert carried.m["table"].dtype == torch.bfloat16
    assert set(carried.v["cin.0"]) == {"r", "c"}
    assert isinstance(carried.v["bias"], torch.Tensor)
    params = _to_torch(jax.tree.map(np.asarray, jp))
    g = grads()
    jp, js, jinfo = j_update(g, js, jp)
    params, _, info = update(_to_torch(g), carried, params)
    _close(info["grad_norm"], jinfo["grad_norm"], "grad_norm")
    for name, want in flatten_params(jax.tree.map(np.asarray, jp)).items():
        _close(params[name], want, name)
    with pytest.raises(ValueError, match="parameters"):
        load_jax_opt_state(jax.tree.map(np.asarray, jp),
                           (js.step, js.m[:-1], js.v))


def test_train_bundle_specs_and_init_opt():
    arch = get_arch("xdeepfm")
    cfg = arch.make_config(False)  # full width: specs only, on meta
    bundle = arch.make_step(cfg, arch.shapes["train_batch"], device="cpu")
    params, opt, inputs = bundle.arg_specs
    assert opt.m.keys() == params.keys() == opt.v.keys()
    assert opt.m["table"].shape == (39_000_000, 10)
    assert opt.step.dtype == torch.int32 and opt.step.shape == ()
    assert inputs["mh_ids"].shape == (65_536, 3, 8)
    small = arch.make_config(True)
    model = STEPS.MODELS["xdeepfm"](small, device="cpu")
    state = arch.make_step(small, smoke_shape(
        arch.shapes["train_batch"], batch=4), device="cpu").init_opt(model)
    assert int(state.step) == 0 and float(state.m["table"].abs().sum()) == 0
    assert dataclasses.is_dataclass(O.OptimizerConfig())
