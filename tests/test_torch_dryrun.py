"""The port's dry run on fake meshes (2, 2) and (2, 2, 2), JAX's mini cells.

One subprocess (``jax`` blocked in ``sys.modules``) runs
``launch.dryrun.run_cell`` for the JAX package's three mini cells
(``tests/test_distributed.py``: qwen3-moe ``train_4k``, SASRec
``retrieval_cand``, GatedGCN ``molecule``) and xDeepFM's ``train_batch``
at 64 rows, on a fake group of 4 and then 8 ranks: as JAX's test does,
it replaces ``_mesh_for`` by one that builds the (2, 2) and (2, 2, 2)
meshes and each cell's shape by its mini ``smoke_shape``.  Then ``main``
writes the SASRec cell's files.
Each record must have JAX's layout; every cell is ``ok`` with
``collectives.total > 0``, ``cost["flops"] * n_chips`` within 1% of the
analytic global FLOPs (every matrix product the sharded step runs on any
rank: work replicated over an axis counted once per rank, as in JAX's
program; a train cell's forward and backward products), parameter bytes
(and a train cell's optimizer-state bytes) equal to the rank-0 blocks
that JAX's ``PartitionSpec``s imply on that mesh (from
``jax.eval_shape``, nothing compiled), ``kernel_calls`` counting B2, B3
and B3-bwd as ops, and ``roofline.analyze`` reads the records.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import pytest

from repro.distributed import sharding as JS
from repro.launch.api import get_arch as j_get_arch
from repro.models import gnn as JG
from repro.models import recsys as JR
from repro.models import transformer as JT
from repro.train import optimizer as JO

from repro_torch.analysis import roofline
from repro_torch.launch.api import get_arch

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CELLS = (
    ("qwen3-moe-235b-a22b", "train_4k", {"seq_len": 16, "global_batch": 8}),
    ("sasrec", "retrieval_cand", {"n_candidates": 64, "topk": 8}),
    ("gatedgcn", "molecule", {"n_nodes": 64, "n_edges": 128, "d_feat": 8,
                              "n_classes": 4, "n_graphs": 8}),
    ("xdeepfm", "train_batch", {"batch": 64}),
)
TRAIN_CELLS = ("qwen3-moe-235b-a22b", "gatedgcn", "xdeepfm")
MESHES = {"single": {"data": 2, "model": 2},
          "multi": {"pod": 2, "data": 2, "model": 2}}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    code = (
        "import json, sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch.launch.dryrun as dr\n"
        "from repro_torch.configs.common import smoke_shape\n"
        "from repro_torch.launch.api import get_arch\n"
        "from torch.distributed.device_mesh import init_device_mesh\n"
        "def mini(name, devices_per_pod=4):\n"
        "    shape = (2, 2, 2) if name == 'multi' else (2, 2)\n"
        "    dr._fake_group(2 ** len(shape))\n"
        "    names = ('pod', 'data', 'model')[-len(shape):]\n"
        "    return init_device_mesh('cpu', shape, mesh_dim_names=names)\n"
        "dr._mesh_for = mini\n"
        f"cells = {CELLS!r}\n"
        "for a, s, o in cells:\n"
        "    arch = get_arch(a)\n"
        "    arch.shapes = dict(arch.shapes)\n"
        "    arch.shapes[s] = smoke_shape(arch.shapes[s], **o)\n"
        "recs = [dr.run_cell(a, s, m, smoke=True)\n"
        "        for a, s, o in cells for m in ('single', 'multi')]\n"
        "assert dr.main(['--arch', 'sasrec', '--shape', 'retrieval_cand',\n"
        f"                '--smoke', '--out', {str(out)!r}]) == 0\n"
        "bad = [m for m in sys.modules if m == 'repro' "
        "or m.startswith(('repro.', 'jax.', 'jaxlib'))]\n"
        "assert not bad, bad\n"
        "print(json.dumps(recs))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    recs = json.loads(proc.stdout.strip().splitlines()[-1])
    files = {}
    for name in os.listdir(out):
        with open(out / name) as fh:
            files[name] = json.load(fh)
    return {(r["arch"], r["mesh"]): r for r in recs}, files


def _qwen3_train_flops(mesh):
    """Every product of the sharded train step: each data shard's tokens,
    the router replicated over ``model``, the experts' capacity from a
    data shard's tokens (JAX's), the logits of every position; backward
    twice the forward (each product's two operands get gradients), and
    the layers' forward once more with remat."""
    cfg = get_arch("qwen3-moe-235b-a22b").make_config(True)
    b, s = CELLS[0][2]["global_batch"], CELLS[0][2]["seq_len"]
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    e, k, fe = cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_ff_expert
    n_data = math.prod(v for a, v in mesh.items() if a != "model")
    t = b * s
    attn = 2 * t * d * (2 * h * hd + 2 * kv * hd) + 4 * b * h * s * s * hd
    router = 2 * t * d * e * mesh["model"]
    cap = int(cfg.moe.capacity_factor * (t // n_data) * k / e)
    experts = n_data * 3 * 2 * e * min(cap, t // n_data) * d * fe
    layers = cfg.n_layers * (attn + router + experts)
    return (3 + cfg.remat) * layers + 3 * 2 * t * d * cfg.vocab_size


def _gnn_molecule_flops(mesh):
    """The node and edge projections (backward: the weights' gradient
    only), each layer's node product and three edge products, the head;
    every node and edge on one rank only, so the mesh adds nothing."""
    cfg = get_arch("gatedgcn").make_config(True)
    o = CELLS[2][2]
    n, e, dd = o["n_nodes"], o["n_edges"], cfg.d_hidden
    inputs = 2 * n * o["d_feat"] * dd + 2 * e * cfg.d_edge_in * dd
    layer = 2 * n * dd * 2 * dd + 3 * 2 * e * dd * dd
    head = 2 * n * dd * o["n_classes"]
    return 2 * inputs + (3 + cfg.remat) * cfg.n_layers * layer + 3 * head


def _sasrec_retrieval_flops(mesh):
    """The user's encoder on every rank; each candidate block scored on
    every rank of the data axes."""
    cfg = get_arch("sasrec").make_config(True)
    d, s = cfg.embed_dim, cfg.seq_len
    chips = math.prod(mesh.values())
    encoder = cfg.n_blocks * (12 * s * d * d + 4 * s * s * d)
    nc = CELLS[1][2]["n_candidates"]
    return chips * encoder + chips // mesh["model"] * 2 * d * nc


def _block_bytes(shape, dtype, spec, mesh):
    """Rank 0's block under a JAX PartitionSpec (GSPMD: ceil(n / ways))."""
    n = jax.numpy.dtype(dtype).itemsize
    for i, size in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        n *= min(size, -(-size // math.prod(mesh[a] for a in axes)))
    return n


def _jax_specs(arch, mesh):
    """(JAX's parameter shapes, their specs as a tree of tuples) of a
    cell's arch on ``mesh``."""
    axes = tuple(a for a in mesh if a != "model")
    key = jax.random.PRNGKey(0)
    jcfg = j_get_arch(arch).make_config(True)
    P = jax.sharding.PartitionSpec
    if arch == "sasrec":
        shapes = jax.eval_shape(lambda: JR.sasrec_init(key, jcfg))
        specs = jax.tree.map(lambda _: P(), shapes)
        specs["item_emb"] = JS.RecSysSharding(axes).p_table()
    elif arch == "xdeepfm":
        shapes = jax.eval_shape(lambda: JR.xdeepfm_init(key, jcfg))
        specs = jax.tree.map(lambda _: P(), shapes)
        specs["table"] = JS.RecSysSharding(axes).p_table()
        specs["linear"] = P("model")
    elif arch == "gatedgcn":
        o = CELLS[2][2]
        jcfg = dataclasses.replace(jcfg, d_in=o["d_feat"],
                                   n_classes=o["n_classes"])
        shapes = jax.eval_shape(lambda: JG.init_gatedgcn(key, jcfg))
        specs = jax.tree.map(lambda _: P(), shapes)
    else:
        shapes = jax.eval_shape(lambda: JT.init_transformer(key, jcfg))
        specs = JT.param_partition_specs(
            jcfg, JS.LMSharding(data_axes=axes, fsdp_experts=True))
    return shapes, specs


def _tree_bytes(shapes, specs, mesh):
    leaves = jax.tree.leaves(shapes)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    return sum(_block_bytes(l.shape, l.dtype, tuple(sp), mesh)
               for l, sp in zip(leaves, spec_leaves))


def _jax_param_bytes(arch, mesh):
    return _tree_bytes(*_jax_specs(arch, mesh), mesh)


def _jax_opt_state_bytes(arch, mesh):
    """Rank 0's blocks of JAX's optimizer state (its init on the
    abstract parameters, laid out by ``opt_state_partition_specs``)."""
    shapes, specs = _jax_specs(arch, mesh)
    if arch == "qwen3-moe-235b-a22b":
        ocfg = JO.OptimizerConfig(momentum_dtype="bfloat16",
                                  factored_v=True)
        ospecs = JO.opt_state_partition_specs(specs, ocfg, shapes)
    else:
        ocfg = JO.OptimizerConfig()
        ospecs = JO.opt_state_partition_specs(specs)
    state = jax.eval_shape(JO.adamw(ocfg)[0], shapes)
    return _tree_bytes(state, ospecs, mesh)


FLOPS = {"qwen3-moe-235b-a22b": _qwen3_train_flops,
         "sasrec": _sasrec_retrieval_flops,
         "gatedgcn": _gnn_molecule_flops}


@pytest.mark.parametrize("mesh", MESHES)
def test_the_train_cells_are_ok(records, mesh):
    """JAX's own mini dry run compiles ``train_4k`` and ``molecule`` on a
    mesh; the port runs them (forward, backward, update)."""
    for arch in TRAIN_CELLS:
        rec = records[0][(arch, mesh)]
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["memory"]["opt_state_bytes"] > 0
        a = roofline.analyze(rec)
        assert a is not None and a["hlo_flops_global"] > 0


@pytest.mark.parametrize("arch", TRAIN_CELLS)
@pytest.mark.parametrize("mesh", MESHES)
def test_opt_state_bytes_are_the_jax_specs_blocks(records, arch, mesh):
    rec = records[0][(arch, mesh)]
    assert rec["memory"]["opt_state_bytes"] == _jax_opt_state_bytes(
        arch, MESHES[mesh])


@pytest.mark.parametrize("arch", list(FLOPS))
@pytest.mark.parametrize("mesh", MESHES)
def test_cell_has_jax_layout_and_collectives(records, arch, mesh):
    rec = records[0][(arch, mesh)]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh_shape"] == MESHES[mesh]
    assert rec["n_chips"] == math.prod(MESHES[mesh].values())
    assert rec["collectives"]["total"] > 0
    assert rec["collectives"]["total"] == sum(
        rec["collectives"][k] for k in ("all-reduce", "all-gather",
                                        "reduce-scatter", "all-to-all",
                                        "collective-permute"))
    mem = rec["memory"]
    assert {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
            "peak_bytes"} <= set(mem)
    assert mem["peak_bytes"] >= mem["argument_bytes"] > mem["param_bytes"]
    assert rec["cost"]["bytes accessed"] > 0
    assert "bytes accessed" in rec["cost_definitions"]


@pytest.mark.parametrize("arch", list(FLOPS))
@pytest.mark.parametrize("mesh", MESHES)
def test_flops_are_per_device(records, arch, mesh):
    rec = records[0][(arch, mesh)]
    want = FLOPS[arch](MESHES[mesh])
    got = rec["cost"]["flops"] * rec["n_chips"]
    assert abs(got - want) <= 0.01 * want, (got, want)


@pytest.mark.parametrize("arch", list(FLOPS))
@pytest.mark.parametrize("mesh", MESHES)
def test_param_bytes_are_the_jax_specs_blocks(records, arch, mesh):
    rec = records[0][(arch, mesh)]
    assert rec["memory"]["param_bytes"] == _jax_param_bytes(arch,
                                                            MESHES[mesh])


@pytest.mark.parametrize("mesh", MESHES)
def test_roofline_reads_the_records(records, mesh):
    for arch in FLOPS:
        a = roofline.analyze(records[0][(arch, mesh)])
        assert a is not None and a["dominant"] in ("compute", "memory",
                                                   "collective")
        assert a["hlo_flops_global"] > 0


def test_main_writes_one_file_a_cell(records):
    files = records[1]
    assert set(files) == {"sasrec__retrieval_cand__single.json",
                          "sasrec__retrieval_cand__multi.json"}
    for name, rec in files.items():
        assert rec["status"] == "ok"
        mesh = rec["mesh"]
        assert rec["cost"] == records[0][("sasrec", mesh)]["cost"]


@pytest.mark.parametrize("mesh", MESHES)
def test_the_kernels_are_counted_as_ops(records, mesh):
    """B3 on the rank's rows of the item table for the user's history and
    for the candidates' rows, B2 on the rank's candidate block and on the
    gathered pairs: each a call of a ``repro_torch::`` op; xDeepFM's train
    step: B3 and B3-bwd for the field lookups, the multi-hot bags and
    ``linear``."""
    rec = records[0][("sasrec", mesh)]
    assert rec["kernel_calls"] == {"embedding_bag_fixed": 2, "topk": 2}
    rec = records[0][("xdeepfm", mesh)]
    assert rec["kernel_calls"] == {"embedding_bag_fixed": 3,
                                   "embedding_bag_fixed_backward": 3}
