"""The port's optimizer-state partition specs against JAX's
``opt_state_partition_specs`` (``PartitionSpec`` → tuple), leaf for leaf
in ``jax.tree.leaves`` order, for olmo-1b, qwen3-moe (``fsdp`` and the
factored v, whose ``r`` drops the last axis and ``c`` the one before
it), xDeepFM (the table and ``linear`` row-sharded) and GatedGCN
(replicated), on the production mesh's axes; and the sharded AdamW's
global norm and factored update on blocks against the whole tensors.
Nothing is compiled: JAX's parameters are ``jax.eval_shape``'s.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.distributed import sharding as JSH
from repro.launch.api import get_arch as j_get_arch
from repro.models import gnn as JG
from repro.models import recsys as JR
from repro.models import transformer as JT
from repro.train import optimizer as JO

from repro_torch.distributed import sharding as SH
from repro_torch.launch.api import get_arch
from repro_torch.launch.steps import MODELS
from repro_torch.models import gnn as G
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as O

LM_OPT = JO.OptimizerConfig(lr=3e-4, warmup_steps=50, decay_steps=20_000)
FACTORED = dataclasses.replace(LM_OPT, momentum_dtype="bfloat16",
                               factored_v=True)
CASES = ("olmo-1b", "qwen3-moe-235b-a22b", "xdeepfm", "gatedgcn")
DATA = ("pod", "data")


def _tuple(spec):
    return tuple(spec)


def _jax(name, smoke):
    """(JAX's state specs as tuples, leaf shapes)."""
    key = jax.random.PRNGKey(0)
    cfg = j_get_arch(name).make_config(smoke)
    if name == "gatedgcn":
        shapes = jax.eval_shape(lambda: JG.init_gatedgcn(key, cfg))
        pspecs = jax.tree.map(lambda _: jax.sharding.PartitionSpec(),
                              shapes)
        ospecs = JO.opt_state_partition_specs(pspecs)
    elif name == "xdeepfm":
        shapes = jax.eval_shape(lambda: JR.xdeepfm_init(key, cfg))
        pspecs = jax.tree.map(lambda _: jax.sharding.PartitionSpec(),
                              shapes)
        shd = JSH.RecSysSharding(data_axes=DATA)
        pspecs["table"] = shd.p_table()
        pspecs["linear"] = jax.sharding.PartitionSpec(shd.model_axis)
        ospecs = JO.opt_state_partition_specs(pspecs)
    else:
        moe = cfg.moe is not None
        shapes = jax.eval_shape(lambda: JT.init_transformer(key, cfg))
        shd = JSH.LMSharding(data_axes=DATA, fsdp_experts=moe)
        pspecs = JT.param_partition_specs(cfg, shd)
        ospecs = JO.opt_state_partition_specs(
            pspecs, FACTORED if moe else LM_OPT, shapes)
    v = [{k: _tuple(s) for k, s in x.items()} if isinstance(x, dict)
         else _tuple(x) for x in ospecs.v]
    return ([_tuple(s) for s in ospecs.m], v, _tuple(ospecs.step),
            jax.tree.leaves(shapes))


def _port(name, smoke):
    cfg = get_arch(name).make_config(smoke)
    if name == "gatedgcn":
        model = G.GatedGCN(cfg, device="meta")
        specs = {n: () for n, _ in model.named_parameters()}
        ocfg = None
    elif name == "xdeepfm":
        model = MODELS[name](cfg, device="meta")
        specs = R.table_specs(model, name)
        ocfg = None
    else:
        moe = cfg.moe is not None
        model = T.Transformer(cfg, device="meta")
        specs = T.flat_partition_specs(cfg, SH.LMSharding(
            data_axes=DATA, fsdp_experts=moe))
        ocfg = O.OptimizerConfig(momentum_dtype="bfloat16",
                                 factored_v=True) if moe else None
    params = dict(model.named_parameters())
    return O.opt_state_partition_specs(specs, ocfg, params), params


@pytest.mark.parametrize("smoke", (True, False))
@pytest.mark.parametrize("name", CASES)
def test_opt_state_specs_equal_jax(name, smoke):
    jm, jv, jstep, jshapes = _jax(name, smoke)
    got, params = _port(name, smoke)
    names = O.leaf_order(params)
    assert [tuple(params[n].shape) for n in names] == [
        tuple(s.shape) for s in jshapes]
    assert got.step == jstep == ()
    assert [got.m[n] for n in names] == jm
    assert [got.v[n] for n in names] == jv
    if name == "qwen3-moe-235b-a22b":
        assert any(isinstance(x, dict) for x in jv)


def test_factored_specs_drop_the_trimmed_axis():
    specs = {"w": (None, "model", ("data",)), "b": ("model",)}
    params = {"w": torch.empty(2, 3, 4, device="meta"),
              "b": torch.empty(5, device="meta")}
    got = O.opt_state_partition_specs(specs, O.OptimizerConfig(
        factored_v=True), params)
    assert got.v["w"] == {"r": (None, "model"), "c": (None, ("data",))}
    assert got.v["b"] == ("model",)
    assert got.m == {"b": ("model",), "w": (None, "model", ("data",))}


class _Mesh:
    """The collectives' view of one rank of a (2, 2) mesh, where every
    all-reduce is the identity: a block's squares then count as the
    whole tensor's only if the code sums nothing it should not."""

    mesh_dim_names = ("data", "model")

    def size(self, dim):
        return 1

    def get_local_rank(self, name):
        return 0


def test_sharded_update_on_a_mesh_of_one_equals_the_plain_update():
    """AdamW through the sharded code (specs, split means, grouped
    norm) on a mesh whose axes have one rank is the plain update."""
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 6), "b": (3, 4, 5), "c": (7,)}
    specs = {"a": ("model", None), "b": (None, None, "data"), "c": ()}
    cfg = O.OptimizerConfig(factored_v=True, momentum_dtype="bfloat16")
    params = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for n, s in shapes.items()}
    grads = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for n, s in shapes.items()}
    mine = {n: p.clone() for n, p in params.items()}
    init, update = O.adamw(cfg)
    s_init, s_update = O.adamw(cfg, _Mesh(), specs, shapes)
    _, want, winfo = update(dict(grads), init(params), params)
    _, got, ginfo = s_update(dict(grads), s_init(mine), mine)
    for n in shapes:
        torch.testing.assert_close(mine[n], params[n], rtol=0, atol=0)
    for k in winfo:
        torch.testing.assert_close(ginfo[k], winfo[k], rtol=0, atol=0)
    assert got.v["b"].keys() == {"r", "c"}
