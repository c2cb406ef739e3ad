"""The port's sharding rules against the JAX package's, spec for spec.

Every spec method of ``LMSharding``, ``GNNSharding`` and
``RecSysSharding`` on the one-pod axes ``("data",)`` and the multi-pod
axes ``("pod", "data")``, with and without ``fsdp_experts`` (and both
``shard_cache_seq`` settings), equals ``tuple(P(...))`` of JAX's;
``param_partition_specs`` and ``cache_partition_specs`` of the five LM
smoke configs equal JAX's leaf for leaf.  ``placements`` turns a spec into
``Shard`` / ``Replicate`` by mesh axis, and ``local_bounds`` cuts blocks
by torch.chunk's rule (what a DTensor holds).  Nothing here compiles.
"""

import dataclasses
import types

import jax
import pytest
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.distributed import sharding as JS
from repro.launch.api import get_arch as j_get_arch
from repro.models import transformer as JT

from repro_torch.distributed import sharding as SH
from repro_torch.launch.api import get_arch
from repro_torch.launch.mesh import data_axes_of
from repro_torch.models import transformer as T

AXES = {"one_pod": ("data",), "multi_pod": ("pod", "data")}
LM_METHODS = ("act", "act_heads", "logits", "cache", "p_embed", "p_attn_in",
              "p_attn_out", "p_ffn_in", "p_ffn_out", "p_norm", "p_router",
              "p_expert_in", "p_expert_out")
GNN_METHODS = ("edges", "nodes", "p_weight")
RECSYS_METHODS = ("p_table", "p_dense", "act", "candidates")
LM_ARCHS = ("olmo-1b", "phi3-medium-14b", "nemotron-4-15b",
            "qwen3-moe-235b-a22b", "arctic-480b")


def _spec(p):
    return tuple(p)


@pytest.mark.parametrize("axes", AXES)
@pytest.mark.parametrize("fsdp", (False, True))
@pytest.mark.parametrize("seq", (True, False))
@pytest.mark.parametrize("method", LM_METHODS)
def test_lm_specs_match_jax(axes, fsdp, seq, method):
    kw = dict(data_axes=AXES[axes], fsdp_experts=fsdp, shard_cache_seq=seq)
    mine, theirs = SH.LMSharding(**kw), JS.LMSharding(**kw)
    assert getattr(mine, method)() == _spec(getattr(theirs, method)())
    assert mine.batch == theirs.batch
    assert mine.fsdp_axis() == theirs.fsdp_axis()


@pytest.mark.parametrize("axes", AXES)
@pytest.mark.parametrize("method", GNN_METHODS)
def test_gnn_specs_match_jax(axes, method):
    mine = SH.GNNSharding(data_axes=AXES[axes])
    theirs = JS.GNNSharding(data_axes=AXES[axes])
    assert getattr(mine, method)() == _spec(getattr(theirs, method)())
    assert mine.batch == theirs.batch


@pytest.mark.parametrize("axes", AXES)
@pytest.mark.parametrize("method", RECSYS_METHODS)
def test_recsys_specs_match_jax(axes, method):
    mine = SH.RecSysSharding(data_axes=AXES[axes])
    theirs = JS.RecSysSharding(data_axes=AXES[axes])
    assert getattr(mine, method)() == _spec(getattr(theirs, method)())
    assert mine.batch == theirs.batch


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tuple(tree)}


@pytest.mark.parametrize("name", LM_ARCHS)
@pytest.mark.parametrize("axes", AXES)
@pytest.mark.parametrize("fsdp", (False, True))
def test_param_and_cache_specs_match_jax(name, axes, fsdp):
    cfg, jcfg = get_arch(name).make_config(True), \
        j_get_arch(name).make_config(True)
    kw = dict(data_axes=AXES[axes], fsdp_experts=fsdp)
    mine = SH.LMSharding(**kw)
    theirs = JS.LMSharding(**kw)
    want = _leaves(jax.tree.map(
        lambda p: p, JT.param_partition_specs(jcfg, theirs),
        is_leaf=lambda x: isinstance(x, P)))
    assert _leaves(T.param_partition_specs(cfg, mine)) == want
    assert _leaves(T.cache_partition_specs(cfg, mine)) == _leaves(
        JT.cache_partition_specs(jcfg, theirs))
    # one spec per parameter of the port's model, of its rank
    model = T.Transformer(cfg, device="meta")
    specs = _leaves(T.param_partition_specs(cfg, mine))
    assert {n.replace(".", "/") for n, _ in model.named_parameters()} == \
        set(specs)
    for n, p in model.named_parameters():
        assert len(specs[n.replace(".", "/")]) == p.dim(), n


class _Mesh:
    """The parts of a DeviceMesh the rules read, at one coordinate."""

    def __init__(self, names, shape, coord):
        self.mesh_dim_names, self.shape, self.coord = names, shape, coord

    def size(self, dim=None):
        if dim is None:
            n = 1
            for s in self.shape:
                n *= s
            return n
        return self.shape[dim]

    def get_local_rank(self, name):
        return self.coord[self.mesh_dim_names.index(name)]


@pytest.mark.parametrize("names,shape", [
    (("data", "model"), (2, 4)), (("pod", "data", "model"), (2, 2, 4))])
def test_placements_follow_the_specs(names, shape):
    mesh = _Mesh(names, shape, (0,) * len(shape))
    shd = SH.LMSharding(data_axes=data_axes_of(mesh), fsdp_experts=True)
    assert SH.placements(shd.p_attn_in(), mesh) == (
        (Replicate(),) * (len(names) - 1) + (Shard(1),))
    assert SH.placements(shd.p_embed(), mesh) == (
        (Replicate(),) * (len(names) - 1) + (Shard(0),))
    assert SH.placements(shd.act(), mesh) == (
        (Shard(0),) * (len(names) - 1) + (Replicate(),))
    # experts over model, their F block over the last data axis
    assert SH.placements(shd.p_expert_in(), mesh)[-2:] == (Shard(2),
                                                          Shard(0))
    assert SH.placements((), mesh) == (Replicate(),) * len(names)
    with pytest.raises(ValueError, match="not in the mesh"):
        SH.placements(("expert",), mesh)


def test_local_bounds_cut_by_torch_chunk():
    # 56 heads' columns over 16 ranks: blocks of 4 heads, the last two
    # ranks empty (as GSPMD pads an uneven split)
    mesh = _Mesh(("data", "model"), (1, 16), (0, 15))
    assert SH.chunk_bounds(56, 16, 13) == (52, 56)
    assert SH.chunk_bounds(56, 16, 14) == (56, 56)
    assert SH.local_bounds((7, 56), (None, "model"), mesh) == [(0, 7),
                                                              (56, 56)]
    # a dimension over two axes: the first one major
    mesh = _Mesh(("pod", "data", "model"), (2, 2, 2), (1, 0, 1))
    assert SH.local_bounds((8, 6), (("pod", "data"), "model"), mesh) == [
        (4, 6), (3, 6)]


def test_data_axes_and_the_sharding_the_steps_build():
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert data_axes_of(mesh) == ("pod", "data")
    shd = SH.LMSharding(data_axes=data_axes_of(mesh))
    assert shd.batch == ("pod", "data")
    assert dataclasses.replace(shd, fsdp_experts=True).fsdp_axis() == "data"


def test_constrain_is_a_no_op_without_a_layout():
    """JAX's ``constrain`` with ``spec=None`` returns ``x``; so does the
    port's for a plain tensor, which has no layout to change."""
    import torch

    x = torch.arange(6.0).reshape(2, 3)
    assert SH.constrain(x, None) is x
    assert SH.constrain(x, ("data", None)) is x
