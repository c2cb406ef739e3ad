"""The port's LM family against the JAX package, on the CPU.

* ``models.layers``: ``rope``, ``rmsnorm``, ``norm``, tanh-``gelu_ffn``,
  ``squared_relu_ffn``, ``swiglu`` and ``softmax_fp32`` within 1e-6
  (float32) of JAX's; ``rope`` and ``rmsnorm`` on bfloat16 input within
  one bfloat16 rounding.
* ``models.moe``: ``capacity`` and ``init_moe``'s shapes and types
  (float32 router in a bfloat16 block) equal to JAX's; ``moe_apply_local`` with
  dropped tokens (a capacity factor of 0.5) within 1e-5, and with tied
  router weights (a zero router: every probability equal, so the experts'
  choice and every capacity slot are decided by the lower index) equal to
  JAX's.
* ``models.transformer`` for each of the five smoke configs, JAX's
  ``init_transformer`` carried across with ``load_jax_params``:
  ``logits_train``, ``prefill`` (last logits and the cache padded to
  ``max_seq``; the bundle's prefill step the same) and two
  ``decode_step``s within atol = rtol = 2e-4; the
  ``train`` step of ``lm_step_bundle`` against ``jax.jit`` of JAX's, from
  JAX's zero optimizer state carried by ``load_jax_opt_state`` (bfloat16
  m and factored v for the MoE archs): loss, grad_norm, lr and the rank
  metrics within 2e-4, each leaf's gradient within rtol 2e-4 plus
  2e-4 · max|g| of ``jax.grad`` of JAX's loss, and each leaf's update
  (new minus old parameter, about lr · sign(g) on the first step) within
  1e-3 of its largest entry plus two float32 spacings of the parameter
  of the update JAX's AdamW makes from the port's gradients.  A decode position past the cache raises in
  the port, where JAX clamps it onto the last slot.
* ``configs``: every LM config (smoke and full), its shapes and its
  parameter names and shapes equal JAX's; ``list_archs()`` equals JAX's.
* ``data.lm_data.MarkovLM``: batches of steps 0-2 bit-identical to JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.common import smoke_shape as j_smoke_shape
from repro.data import lm_data as JD
from repro.launch.api import get_arch as j_get_arch
from repro.launch.api import list_archs as j_list_archs
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.train import optimizer as JO

from repro_torch.configs.common import smoke_shape
from repro_torch.data import lm_data as D
from repro_torch.launch.api import (ShapeSpec, TensorSpec, get_arch,
                                   list_archs, to_device)
from repro_torch.launch.steps import lm_step_bundle
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.convert import (flatten_params, load_jax_opt_state,
                                        load_jax_params)

from test_torch_measures import single_torch_thread  # noqa: F401

TOL = 2e-4
LM_ARCHS = ("olmo-1b", "phi3-medium-14b", "nemotron-4-15b",
            "qwen3-moe-235b-a22b", "arctic-480b")
B, S, MAX_SEQ = 2, 12, 16  # prefill S tokens into a cache of MAX_SEQ


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


def _tokens(cfg, seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.fixture(scope="module")
def carried():
    """Per arch: (port model, JAX params, port config, JAX config)."""
    out = {}
    for name in LM_ARCHS:
        cfg = get_arch(name).make_config(True)
        jcfg = j_get_arch(name).make_config(True)
        jparams = JT.init_transformer(jax.random.PRNGKey(1), jcfg)
        model = T.Transformer(cfg, device="cpu")
        load_jax_params(model, jax.tree.map(np.asarray, jparams))
        out[name] = (model, jparams, cfg, jcfg)
    return out


# -- layers ----------------------------------------------------------------------


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) * 3
    pos = rng.integers(0, 4000, (2, 5))
    for theta in (10_000.0, 500_000.0):
        _close(L.rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
               JL.rope(jnp.asarray(x), jnp.asarray(pos), theta),
               f"rope {theta}", 1e-5)
    h = rng.standard_normal((4, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    _close(L.rmsnorm(torch.from_numpy(h), torch.from_numpy(scale)),
           JL.rmsnorm(jnp.asarray(h), jnp.asarray(scale)), "rmsnorm", 1e-6)
    _close(L.norm(torch.from_numpy(h), None), JL.norm(jnp.asarray(h), None),
           "norm", 1e-6)
    w1, w2, w3 = (rng.standard_normal(s).astype(np.float32) / 4
                  for s in ((32, 48), (32, 48), (48, 32)))
    t = [torch.from_numpy(a) for a in (h, w1, w2, w3)]
    j = [jnp.asarray(a) for a in (h, w1, w2, w3)]
    _close(L.swiglu(*t), JL.swiglu(*j), "swiglu", 1e-5)
    _close(L.squared_relu_ffn(t[0], t[1], t[3]),
           JL.squared_relu_ffn(j[0], j[1], j[3]), "sq_relu", 1e-5)
    got = L.gelu_ffn(t[0], t[1], t[3])
    _close(got, JL.gelu_ffn(j[0], j[1], j[3]), "gelu (tanh)", 1e-5)
    exact = torch.nn.functional.gelu(t[0] @ t[1]) @ t[3]
    assert float((got - exact).abs().max()) > 1e-6  # not the exact form
    _close(L.softmax_fp32(t[0]), JL.softmax_fp32(j[0]), "softmax", 1e-6)
    # bfloat16 in, bfloat16 out: within one rounding of JAX's
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jb = jnp.asarray(x, jnp.bfloat16)
    got = L.rope(xb, torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(JL.rope(jb, jnp.asarray(pos)), np.float32),
           "rope bf16", 2 ** -7)
    got = L.rmsnorm(torch.from_numpy(h).to(torch.bfloat16),
                    torch.from_numpy(scale).to(torch.bfloat16))
    want = JL.rmsnorm(jnp.asarray(h, jnp.bfloat16),
                      jnp.asarray(scale, jnp.bfloat16))
    _close(got.float(), np.asarray(want, np.float32), "rmsnorm bf16", 2 ** -7)


# -- MoE -------------------------------------------------------------------------


def _moe_params(rng, d, cfg):
    e, f = cfg.n_experts, cfg.d_ff_expert
    return {"router": rng.standard_normal((d, e)).astype(np.float32),
            "w_gate": rng.standard_normal((e, d, f)).astype(np.float32) / 4,
            "w_up": rng.standard_normal((e, d, f)).astype(np.float32) / 4,
            "w_down": rng.standard_normal((e, f, d)).astype(np.float32) / 4}


def _moe_both(x, params, cfg):
    got = M.moe_apply_local(torch.from_numpy(x),
                            {k: torch.from_numpy(v) for k, v in
                             params.items()}, cfg)
    jcfg = JM.MoEConfig(**dataclasses.asdict(cfg))
    want = JM.moe_apply_local(jnp.asarray(x), jax.tree.map(jnp.asarray,
                                                          params),
                              jcfg, model_axis=None)
    return got.numpy(), np.asarray(want)


def test_capacity_matches_jax():
    for e, k, cf in ((8, 2, 2.0), (128, 8, 1.25), (128, 2, 1.25),
                     (8, 2, 0.1)):
        cfg = M.MoEConfig(e, k, 4, capacity_factor=cf)
        jcfg = JM.MoEConfig(e, k, 4, capacity_factor=cf)
        for t in (1, 2, 7, 8, 96, 4096):
            assert M.capacity(t, cfg) == JM.capacity(t, jcfg), (e, k, cf, t)


def test_init_moe_shapes_and_types_match_jax():
    cfg = M.MoEConfig(n_experts=8, top_k=2, d_ff_expert=12)
    jcfg = JM.MoEConfig(n_experts=8, top_k=2, d_ff_expert=12)
    want = jax.eval_shape(lambda: JM.init_moe(jax.random.PRNGKey(0), 16,
                                              jcfg, jnp.bfloat16))
    got = M.init_moe(torch.Generator().manual_seed(0), 16, cfg,
                     torch.bfloat16, "cpu")
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in got.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in want.items()}
    assert float(got["w_down"].float().std()) == pytest.approx(
        12 ** -0.5, rel=0.1)


def test_moe_with_dropped_tokens_matches_jax():
    rng = np.random.default_rng(2)
    cfg = M.MoEConfig(n_experts=8, top_k=2, d_ff_expert=12,
                      capacity_factor=0.5)
    x = rng.standard_normal((24, 16)).astype(np.float32)
    params = _moe_params(rng, 16, cfg)
    got, want = _moe_both(x, params, cfg)
    dropped = ~np.any(want != 0, axis=1)
    assert dropped.sum() > 0  # some tokens pass through the residual only
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[dropped] == 0).all()


def test_moe_with_tied_router_weights_matches_jax():
    """A zero router makes every probability 1/E: the top-k takes experts
    0..k-1 for every token, and each of them takes tokens 0..C-1 (ties to
    the lower index); the rest of the tokens get nothing.  A router with
    two equal columns ties two experts for every token."""
    rng = np.random.default_rng(3)
    cfg = M.MoEConfig(n_experts=8, top_k=2, d_ff_expert=12,
                      capacity_factor=1.0)
    x = rng.standard_normal((20, 16)).astype(np.float32)
    params = _moe_params(rng, 16, cfg)
    params["router"][:] = 0.0
    got, want = _moe_both(x, params, cfg)
    c = M.capacity(20, cfg)
    assert (want[:c] != 0).any(axis=1).all() and (want[c:] == 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    gate, idx = M.route(torch.from_numpy(x), torch.zeros(16, 8), cfg)
    assert (idx[:2] == torch.arange(c)).all() and (gate[2:] == 0).all()
    params = _moe_params(rng, 16, cfg)
    params["router"][:, 5] = params["router"][:, 1]
    got, want = _moe_both(x, params, cfg)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -- configs -----------------------------------------------------------------------


@pytest.mark.parametrize("name", LM_ARCHS)
def test_lm_configs_shapes_and_params_match_jax(name):
    arch, jarch = get_arch(name), j_get_arch(name)
    assert arch.family == jarch.family == "lm"
    for smoke in (True, False):
        got = dataclasses.asdict(arch.make_config(smoke))
        want = dataclasses.asdict(jarch.make_config(smoke))
        want.pop("unroll_layers")  # the JAX cost-probe switch
        assert got == want
        cfg, jcfg = arch.make_config(smoke), jarch.make_config(smoke)
        assert cfg.head_dim == jcfg.head_dim
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
    assert {k: (v.kind, v.meta, v.skip_reason)
            for k, v in arch.shapes.items()} == \
        {k: (v.kind, v.meta, v.skip_reason) for k, v in jarch.shapes.items()}
    jshapes = jax.eval_shape(lambda: JT.init_transformer(
        jax.random.PRNGKey(0), jarch.make_config(False)))
    want = {jax.tree_util.keystr(p, simple=True, separator="."):
            (leaf.shape, str(leaf.dtype))
            for p, leaf in jax.tree_util.tree_leaves_with_path(jshapes)}
    model = T.Transformer(arch.make_config(False), device="meta")
    assert {n: (tuple(p.shape), str(p.dtype).replace("torch.", ""))
            for n, p in model.named_parameters()} == want


def test_list_archs_matches_jax():
    assert list_archs() == j_list_archs()
    assert len(list_archs()) == 11


# -- the transformer ---------------------------------------------------------------


@pytest.mark.parametrize("name", LM_ARCHS)
def test_forward_prefill_and_decode_match_jax(carried, name):
    model, jparams, cfg, jcfg = carried[name]
    tokens = _tokens(cfg, 5, (B, S + 2))
    with torch.no_grad():
        logits = T.logits_train(model, torch.from_numpy(tokens), cfg)
    want = jax.jit(JT.logits_train, static_argnums=2)(
        jparams, jnp.asarray(tokens), jcfg)
    _close(logits, want, f"{name} logits_train")

    with torch.inference_mode():
        last, cache = T.prefill(model, torch.from_numpy(tokens[:, :S]), cfg,
                                max_seq=MAX_SEQ)
    jlast, jcache = jax.jit(
        lambda p, t: JT.prefill(p, t, jcfg, max_seq=MAX_SEQ))(
            jparams, jnp.asarray(tokens[:, :S]))
    _close(last, jlast, f"{name} prefill logits")
    assert cache["k"].shape == (cfg.n_layers, B, cfg.n_kv_heads, MAX_SEQ,
                                cfg.head_dim)
    for k in ("k", "v"):
        _close(cache[k], jcache[k], f"{name} prefill cache {k}")
        assert (cache[k][:, :, :, S:] == 0).all()
    # the bundle's prefill step is the same call
    arch = get_arch(name)
    blast, bcache = arch.make_step(cfg, smoke_shape(
        arch.shapes["prefill_32k"], seq_len=S, global_batch=B),
        device="cpu").step_fn(model, torch.from_numpy(tokens[:, :S]),
                              max_seq=MAX_SEQ)
    assert torch.equal(blast, last)
    assert all(torch.equal(bcache[k], cache[k]) for k in cache)

    jdecode = jax.jit(JT.decode_step, static_argnums=4)
    for pos in (S, S + 1):
        tok = tokens[:, pos]
        with torch.inference_mode():
            got, cache2 = T.decode_step(model, cache, torch.from_numpy(tok),
                                        pos, cfg)
        assert cache2 is cache  # written in place
        want, jcache = jdecode(jparams, jcache, jnp.asarray(tok), pos, jcfg)
        _close(got, want, f"{name} decode logits at {pos}")
        for k in ("k", "v"):
            _close(cache[k], jcache[k], f"{name} decode cache {k} at {pos}")


def test_decode_past_the_cache_raises_where_jax_clamps(carried):
    model, jparams, cfg, jcfg = carried["olmo-1b"]
    tokens = _tokens(cfg, 6, (B, 4))
    with torch.inference_mode():
        _, cache = T.prefill(model, torch.from_numpy(tokens), cfg)
        for pos in (4, -1):
            with pytest.raises(ValueError, match="outside the cache"):
                T.decode_step(model, cache, torch.from_numpy(tokens[:, 0]),
                              pos, cfg)
    # the reference writes past-the-end tokens onto the last slot
    _, jcache = JT.prefill(jparams, jnp.asarray(tokens), jcfg)
    _, clamped = JT.decode_step(jparams, jcache, jnp.asarray(tokens[:, 0]),
                                4, jcfg)
    changed = np.any(np.asarray(clamped["k"]) != np.asarray(jcache["k"]),
                     axis=(0, 1, 2, 4))
    assert changed.tolist() == [False, False, False, True]


def _jax_opt_cfg(name):
    if name in ("qwen3-moe-235b-a22b", "arctic-480b"):
        return JO.OptimizerConfig(lr=3e-4, warmup_steps=50,
                                  decay_steps=20_000,
                                  momentum_dtype="bfloat16", factored_v=True)
    return JO.OptimizerConfig(lr=3e-4, warmup_steps=50, decay_steps=20_000)


def _jax_loss(params, tokens, labels, cfg):
    return JL.cross_entropy(JT.logits_train(params, tokens, cfg), labels)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_train_step_matches_jax(carried, name):
    model, jparams, cfg, jcfg = carried[name]
    model = T.Transformer(cfg, device="cpu")  # updated in place: a copy
    load_jax_params(model, jax.tree.map(np.asarray, jparams))
    before = {n: _np(p).copy() for n, p in model.named_parameters()}
    arch, jarch = get_arch(name), j_get_arch(name)
    shape = smoke_shape(arch.shapes["train_4k"], seq_len=S, global_batch=B)
    jshape = j_smoke_shape(jarch.shapes["train_4k"], seq_len=S,
                           global_batch=B)
    bundle = arch.make_step(cfg, shape, device="cpu")
    jstep = jax.jit(jarch.make_step(jcfg, jshape, None).step_fn)
    jstate = JO.adamw(_jax_opt_cfg(name))[0](jparams)
    state = load_jax_opt_state(jax.tree.map(np.asarray, jparams),
                               jax.tree.map(np.asarray, jstate))
    assert jax.tree.map(lambda a: a.shape, state) == jax.tree.map(
        lambda a: a.shape, bundle.init_opt(model))
    data = D.MarkovLM(D.LMDataConfig(cfg.vocab_size, S, B, seed=4))
    batch = data.batch(0)
    jtok, jlab = jnp.asarray(batch["tokens"]), jnp.asarray(batch["labels"])
    jgrads = flatten_params(jax.tree.map(np.asarray, jax.jit(
        jax.grad(_jax_loss), static_argnums=3)(jparams, jtok, jlab, jcfg)))
    jp, _, jm = jstep(jparams, jstate, jtok, jlab)
    model, state, m = bundle.step_fn(model, state, to_device(batch, "cpu"))
    assert m.keys() == jm.keys() == {
        "loss", "grad_norm", "lr", "recip_rank", "ndcg", "success_1",
        "success_5", "success_10"}
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)
    assert int(state.step) == 1
    want = flatten_params(jax.tree.map(np.asarray, jp))
    assert want.keys() == jgrads.keys() == before.keys()
    for n, p in model.named_parameters():
        # each leaf's gradient within rtol 2e-4 + atol 2e-4 · max|g|
        g = np.asarray(jgrads[n], np.float32)
        np.testing.assert_allclose(_np(p.grad), g, rtol=TOL,
                                   atol=TOL * float(np.abs(g).max()),
                                   err_msg=f"{name} grad {n}")
    # the update: JAX's AdamW given the port's own gradients, from the same
    # state, moves each parameter as the port's step did (an update is
    # about lr · sign(g) = 6e-6 here, far below the parameters' scale, so
    # it is held to its own size: 1e-3 of the leaf's largest move plus two
    # float32 spacings of the parameter for the rounding of p - lr · delta)
    own = {n: p.grad.numpy() for n, p in model.named_parameters()}
    jq, _, _ = jax.jit(JO.adamw(_jax_opt_cfg(name))[1])(
        jax.tree_util.tree_map_with_path(
            lambda path, _: jnp.asarray(own[".".join(
                str(getattr(k, "key", getattr(k, "idx", k))) for k in path)]),
            jparams), jstate, jparams)
    jq = flatten_params(jax.tree.map(np.asarray, jq))
    for n, p in model.named_parameters():
        p0 = before[n]
        moved, jmoved = _np(p) - p0, np.asarray(jq[n], np.float32) - p0
        assert float(np.abs(jmoved).max()) > 0, n
        allow = 1e-3 * float(np.abs(jmoved).max()) + 2 * np.spacing(
            np.abs(p0))
        assert (np.abs(moved - jmoved) <= allow).all(), (
            name, n, float(np.abs(moved - jmoved).max()),
            float(np.abs(jmoved).max()))


def test_lm_bundle_specs_and_kinds():
    arch = get_arch("qwen3-moe-235b-a22b")
    cfg = arch.make_config(False)
    params, opt, batch = arch.make_step(cfg, arch.shapes["train_4k"],
                                        device="cpu").arg_specs
    assert batch["tokens"].shape == (256, 4096)
    assert params["layers.moe_gate"].shape == (94, 128, 4096, 1536)
    assert params["layers.router"].dtype == torch.float32
    assert opt.m["layers.wq"].dtype == torch.bfloat16  # memory-efficient
    assert set(opt.v["layers.wq"]) == {"r", "c"}
    _, cache, token, pos, gold = arch.make_step(
        cfg, arch.shapes["decode_32k"], device="cpu").arg_specs
    assert cache["k"].shape == (94, 128, 4, 32768, 64)
    assert token.shape == gold.shape == (128,)
    olmo = get_arch("olmo-1b")
    _, opt, _ = olmo.make_step(olmo.make_config(False),
                               olmo.shapes["train_4k"], device="cpu").arg_specs
    assert opt.m["embed"].dtype == torch.float32
    assert isinstance(opt.v["embed"], TensorSpec)
    with pytest.raises(ValueError, match="kind"):
        lm_step_bundle(cfg, ShapeSpec("x", "serve", ()), device="cpu")


# -- data --------------------------------------------------------------------------


def test_markov_lm_batches_are_bit_identical_to_jax():
    for args in ((512, 12, 2, 64, 0), (1000, 33, 5, 7, 3)):
        ours = D.MarkovLM(D.LMDataConfig(*args))
        theirs = JD.MarkovLM(JD.LMDataConfig(*args))
        assert ours.successors.tobytes() == theirs.successors.tobytes()
        for step in range(3):
            got, want = ours.batch(step), theirs.batch(step)
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype == np.int32
                assert got[k].tobytes() == want[k].tobytes(), (args, step, k)
        it, jit = ours.iterator(2), theirs.iterator(2)
        assert next(it)["labels"].tobytes() == next(jit)["labels"].tobytes()
