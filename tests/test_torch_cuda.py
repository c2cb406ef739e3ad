"""The CUDA kernels against their plain versions, on a GPU.

Edge shapes the smoke test's main path does not reach: one-rank rows,
rows shorter than every cutoff, both regimes of the fused-measure kernel
(a warp per row to D = 2,048, a block per row above) with Q off the
block's rows and above the persistent grid, D off a multiple of 4 and
rows off 16-byte alignment; tiles cut by D, k above D, several tiles
merged into the running top-k, heavy ties and signed zeros, NaN of
either sign after every number; the top-k's
split path (one to three rows of up to 10^6, misaligned rows, ascending
and all-equal scores); EmbeddingBag at odd widths, with empty bags, one
bag holding every lookup and no lookups, and its fixed-length entry and
the all-fields lookup bit for bit against the CPU, with an out-of-range id
trapping on the device; the hot-path wrappers (top-k, EmbeddingBag, the
fused measures) under ``torch.cuda.set_sync_debug_mode("error")``; smoke-size recsys steps
on the card against the CPU; training: B3's backward kernel (empty mask,
one bag, repeated rows, ``fields > 1``, rows either side of a slab edge,
V off a multiple of the slab, heavy slabs split among windows of
lookups, Zipf ids, E = 1, 16 and 33, NaN times 0) bit for
bit against the CPU and on two launches, one call launching it once
with no fill, its traps and refusals, the autograd Function, and smoke
recsys and GatedGCN train steps (no host sync) with every gradient against the CPU's; the five LM
smoke configs' ``train`` step (no host sync), ``prefill`` and four
``decode`` steps against the CPU's, and the trainer's per-step times
from CUDA events; and the experiment slice: the sweep on both
backends (``single`` bit-identical to separate evaluations, ``sharded``
through the fused kernel), significance on the card against the CPU,
permutation p-values unchanged by TF32 and drawn from a generator on the
card, the ranked engine against the sorted one, streaming, the Q-learning
environment and ``python -m repro_torch.compare``; the sharded
evaluator over the mesh ``["cuda:0"] * n`` bit-identical to one shard,
and int8 gradient compression on the card bit for bit the CPU's.  Run on
a machine with a GPU::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Elsewhere every test skips (unverified, not passed).  This file imports
neither JAX nor the JAX package, so it runs where only the port does.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import RelevanceEvaluator
from repro_torch.core import trec
from repro_torch.configs.common import smoke_shape
from repro_torch.configs.gatedgcn import shape_config
from repro_torch.data import graph_data as GD
from repro_torch.data import lm_data as LD
from repro_torch.data import recsys_data as RD
from repro_torch.distributed import ShardedEvaluator
from repro_torch.kernels import embedding_bag as EB
from repro_torch.kernels import fused_measures as FM
from repro_torch.kernels import topk as TK
from repro_torch.launch.api import ShapeSpec, get_arch, to_device
from repro_torch.launch.steps import MODELS
from repro_torch.models import embedding as E
from repro_torch.models.gnn import GatedGCN
from repro_torch.models.transformer import Transformer
from repro_torch.train.trainer import TrainConfig, Trainer

pytestmark = pytest.mark.cuda

TOL = 2e-4
EXACT = ("num_rel_ret", "Rprec", "recip_rank", "P_", "recall_", "success_",
         "judged_")
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these tests launch the kernels")
    return torch.device("cuda")


def _fused_inputs(q, d, seed):
    rng = np.random.default_rng(seed)
    rel = rng.integers(-1, 4, (q, d)).astype(np.float32)
    rel[rng.random((q, d)) < 0.5] = 0.0
    judged = (rng.random((q, d)) < 0.6).astype(np.float32)
    judged[rel != 0] = 1.0
    scal = np.zeros((q, FM.SCALAR_WIDTH), np.float32)
    scal[:, 0] = rng.integers(0, 40, q)
    scal[:, 1] = rng.integers(0, 40, q)
    scal[:, 2:12] = rng.random((q, 10)) * 10 + 1
    scal[0, :3] = 0.0
    return [torch.from_numpy(x) for x in (rel, judged, scal)]


def _assert_fused_matches(got, want):
    for c, name in enumerate(FM.COLUMNS):
        if name.startswith(EXACT):
            assert torch.equal(got[:, c], want[:, c]), name
        else:
            assert torch.allclose(got[:, c], want[:, c], atol=TOL,
                                  rtol=TOL), name
    assert not got[:, len(FM.COLUMNS):].any()


@pytest.mark.parametrize("q,d,level", [
    (1, 1, 1.0), (3, 8, 1.0), (5, 64, 2.0), (7, 1000, 1.0), (4, 1024, 1.0),
    (3, 1100, 1.0), (2, 5000, 1.0), (300, 2048, 1.0),
    # a warp per row: Q not a multiple of a block's 8 rows; Q above the
    # persistent grid's warps; the regime edge; D not a multiple of 4
    (13, 1024, 1.0), (20000, 64, 1.0), (6, 2048, 2.0), (7, 1023, 1.0),
    # a block per row: the regime edge, D not a multiple of 4, one row of
    # the deep corner, relevance level 2
    (5, 2049, 1.0), (3, 4099, 2.0), (1, 65536, 1.0), (9, 3000, 2.0),
])
def test_fused_kernel_matches_plain(cuda, q, d, level):
    args = [t.to(cuda) for t in _fused_inputs(q, d, q + d)]
    before = FM.LAUNCHES, FM.KERNEL_LAUNCHES
    got = FM.fused_measures(*args, level)
    # one call; the rank-term table's prologue too when rows are long
    assert (FM.LAUNCHES, FM.KERNEL_LAUNCHES) == (
        before[0] + 1, before[1] + (1 if d <= 2048 else 2))
    want = FM.fused_measures_plain(*args, level)
    torch.cuda.synchronize()
    _assert_fused_matches(got, want)


@pytest.mark.parametrize("q,d", [(9, 1024), (3, 4096)])
def test_fused_kernel_takes_rows_off_16_byte_alignment(cuda, q, d):
    """Contiguous views starting one float into their storage: the kernel
    takes scalar loads for them."""
    args = []
    for t in _fused_inputs(q, d, d):
        flat = torch.empty(t.numel() + 1, device=cuda)
        flat[1:] = t.reshape(-1).to(cuda)
        args.append(flat[1:].view(t.shape))
    got = FM.fused_measures(*args, 1.0)
    want = FM.fused_measures_plain(*args, 1.0)
    torch.cuda.synchronize()
    _assert_fused_matches(got, want)


@pytest.mark.parametrize("q,d,k,ties", [
    (3, 100, 10, True), (3, 5, 8, False), (4, 3000, 1000, True),
    (2, 2049, 1000, False), (5, 9000, 128, True), (3, 5000, 2000, True),
    (2, 20000, 4000, True), (64, 4096, 1, False),
])
def test_topk_kernel_matches_plain(cuda, q, d, k, ties):
    rng = np.random.default_rng(q * d + k)
    if ties:
        scores = rng.integers(0, 5, (q, d)).astype(np.float32)
        scores[rng.random((q, d)) < 0.1] = -0.0
    else:
        scores = rng.standard_normal((q, d)).astype(np.float32)
    scores[rng.random((q, d)) < 0.1] = -np.inf
    s = torch.from_numpy(scores).to(cuda)
    before = TK.LAUNCHES
    v, i = TK.topk(s, k)
    assert TK.LAUNCHES == before + 1
    pv, pi = TK.topk_plain(s, k)
    torch.cuda.synchronize()
    kk = min(k, d)
    assert torch.equal(i[:, :kk], pi[:, :kk])
    assert torch.equal(v[:, :kk], pv[:, :kk])
    assert bool((v[:, kk:] == -np.inf).all()) and bool((i[:, kk:] >= d).all())


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    s = torch.zeros((4, 64), device=cuda)
    with pytest.raises(ValueError):
        TK.topk(s.t(), 5)  # not contiguous
    with pytest.raises(ValueError):
        TK.topk(s.double(), 5)
    with pytest.raises(ValueError):
        TK.topk(s, 5000)
    rel, judged, scal = (t.to(cuda) for t in _fused_inputs(2, 16, 0))
    with pytest.raises(ValueError):
        FM.fused_measures(rel, judged, scal.cpu())
    with pytest.raises(ValueError):
        FM.fused_measures(rel.double(), judged, scal)


def test_evaluator_on_cuda_matches_cpu(cuda):
    qrel = trec.load_qrel(os.path.join(FIXTURES, "conformance.qrel"))
    run = trec.load_run(os.path.join(FIXTURES, "conformance.run"))
    measures = ["map", "ndcg", "P", "bpref", "recip_rank", "judged", "rbp",
                "num_ret", "iprec_at_recall"]
    cpu_ev = RelevanceEvaluator(qrel, measures, device="cpu")
    gpu_ev = RelevanceEvaluator(qrel, measures, device=cuda)
    cpu = cpu_ev.evaluate(run)
    for gpu in (gpu_ev.evaluate(run),
                ShardedEvaluator(gpu_ev).evaluate(run).per_query):
        assert gpu.keys() == cpu.keys()
        for qid in cpu:
            for k, v in cpu[qid].items():
                assert gpu[qid][k] == pytest.approx(v, abs=TOL, rel=TOL), \
                    (qid, k)


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_mesh_on_one_card_is_bit_identical_to_one_shard(cuda, n):
    """The mesh ``["cuda:0"] * n`` splits the query axis (a second card is
    not needed to exercise the split): every per-query row is the same
    bits as one shard's, each shard launches B1 once."""
    from repro_torch.data.synthetic_ir import synthesize_run

    run, qrel = synthesize_run(40, 300, seed=5)
    ev = RelevanceEvaluator(qrel, ["map", "ndcg", "P", "bpref", "num_ret",
                                   "iprec_at_recall"], device=cuda)
    one = ShardedEvaluator(ev, mesh=["cuda:0"]).evaluate(run)
    before = FM.LAUNCHES
    got = ShardedEvaluator(ev, mesh=["cuda:0"] * n).evaluate(run)
    assert FM.LAUNCHES - before == n
    assert got.per_query == one.per_query
    for k, v in one.aggregates.items():
        assert got.aggregates[k] == pytest.approx(v, abs=TOL, rel=TOL), k


def test_int8_compression_on_the_card_is_the_cpus(cuda):
    """quantize_int8 and compress_grads_int8 on the card: the int8
    payload, the scale and the error state bit for bit the CPU's (true
    divisions, round half to even)."""
    from repro_torch.train import compression as C

    rng = np.random.default_rng(4)
    g = {"w": (rng.standard_normal((300, 70)) * 3).astype(np.float32),
         "half": (rng.integers(-60, 60, 1000) + 0.5).astype(np.float32)}
    g["half"][0] = 127.0
    e = {"w": (rng.standard_normal((300, 70)) * 1e-2).astype(np.float32),
         "half": np.zeros(1000, np.float32)}
    cpu_g = {k: torch.from_numpy(v) for k, v in g.items()}
    cpu_e = {k: torch.from_numpy(v) for k, v in e.items()}
    gpu_g = {k: v.to(cuda) for k, v in cpu_g.items()}
    gpu_e = {k: v.to(cuda) for k, v in cpu_e.items()}
    want = C.compress_grads_int8(cpu_g, cpu_e)
    got = C.compress_grads_int8(gpu_g, gpu_e)
    for w_tree, g_tree in zip(want, got):
        for k in w_tree:
            assert torch.equal(g_tree[k].cpu(), w_tree[k]), k
    assert float(got[1]["half"]) == 1.0
    scale = torch.tensor(0.37)
    for k in g:
        w = C.quantize_int8(cpu_g[k], cpu_e[k], scale)
        o = C.quantize_int8(gpu_g[k], gpu_e[k], scale.to(cuda))
        assert all(torch.equal(a.cpu(), b) for a, b in zip(o, w)), k


@pytest.mark.parametrize("v,e,n_bags,l,case", [
    (50, 1, 7, 40, "random"), (1000, 10, 300, 2400, "random"),
    (77, 33, 12, 90, "unsorted"), (40, 10, 9, 12, "empty_bags"),
    (60, 10, 1, 500, "one_bag"), (30, 10, 5, 0, "no_lookups"),
])
def test_embedding_bag_kernel_matches_plain(cuda, v, e, n_bags, l, case):
    rng = np.random.default_rng(v + e + l)
    table = rng.standard_normal((v, e)).astype(np.float32)
    idx = rng.integers(0, v, l).astype(np.int32)
    w = rng.random(l).astype(np.float32)
    if case == "one_bag":
        seg = np.zeros(l, np.int32)
    elif case == "empty_bags":
        seg = rng.choice(np.array([1, 4, 5], np.int32), l)
    else:
        seg = rng.integers(0, n_bags, l).astype(np.int32)
    if case != "unsorted":
        seg = np.sort(seg)
    cpu = [torch.from_numpy(x) for x in (table, idx, seg, w)]
    dev = [t.to(cuda) for t in cpu]
    before = EB.LAUNCHES
    got = EB.embedding_bag(*dev[:3], n_bags, dev[3])
    assert EB.LAUNCHES == before + 1
    # the plain version on the CPU sums each bag in lookup order, as the
    # kernel does: bit-identical (== so that signed zeros compare equal)
    want = EB.embedding_bag_plain(*cpu[:3], n_bags, cpu[3])
    torch.cuda.synchronize()
    assert bool((got.cpu() == want).all())
    unweighted = EB.embedding_bag(*dev[:3], n_bags)
    assert bool((unweighted.cpu()
                 == EB.embedding_bag_plain(*cpu[:3], n_bags)).all())


def test_embedding_bag_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    table = torch.zeros((10, 4), device=cuda)
    idx = torch.tensor([1, 2], dtype=torch.int32, device=cuda)
    seg = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        EB.embedding_bag(table, idx + 9, seg, 2)  # row out of range
    with pytest.raises(ValueError):
        EB.embedding_bag(table, idx, seg + 1, 2)  # bag out of range
    with pytest.raises(ValueError):
        EB.embedding_bag(table.double(), idx, seg, 2)
    with pytest.raises(ValueError):
        EB.embedding_bag(table.t(), idx, seg, 2)  # not contiguous
    with pytest.raises(ValueError):
        EB.embedding_bag(table, idx.cpu(), seg, 2)


def _smoke_args(name, cfg, shape, seed=0):
    b = shape.get("batch")
    rng = np.random.default_rng(seed)
    n_items = cfg.n_items if name == "sasrec" else cfg.table.vocab_per_field
    if name == "sasrec":
        batch = RD.seq_batch(RD.SeqDataConfig(n_items, cfg.seq_len, b,
                                              seed=seed), 0)
    elif name == "mind":
        batch = RD.mind_batch(RD.SeqDataConfig(n_items, cfg.hist_len, b,
                                               seed=seed), 0)
    else:
        batch = RD.ctr_batch(RD.CTRDataConfig(
            cfg.table.n_fields, n_items, b, cfg.n_multi_hot,
            cfg.multi_hot_len, seed), 0)
    if shape.kind == "retrieval":
        nc = shape.get("n_candidates")
        if name in ("xdeepfm", "autoint"):
            batch = {"ids": batch["ids"][:1]}
        return (batch, rng.integers(0, n_items, nc).astype(np.int32),
                (rng.random((b, nc)) < 0.1).astype(np.int32))
    if name in ("sasrec", "mind"):
        s = shape.get("slate")
        return (batch, rng.integers(0, n_items, (b, s)).astype(np.int32),
                (rng.random((b, s)) < 0.2).astype(np.int32))
    return (batch,)


@pytest.mark.parametrize("name", ["xdeepfm", "sasrec", "autoint", "mind"])
@pytest.mark.parametrize("shape_name", ["serve_p99", "retrieval_cand"])
def test_recsys_step_on_cuda_matches_cpu(cuda, name, shape_name):
    arch = get_arch(name)
    cfg = arch.make_config(True)
    over = ({"batch": 4, "slate": 64} if shape_name == "serve_p99"
            else {"n_candidates": 5000, "topk": 100})
    shape = smoke_shape(arch.shapes[shape_name], **over)
    cpu_model = MODELS[name](cfg, device="cpu")
    gpu_model = MODELS[name](cfg, device=cuda)
    gpu_model.load_state_dict(cpu_model.state_dict())
    args = _smoke_args(name, cfg, shape)
    eb, tk = EB.LAUNCHES, TK.LAUNCHES
    got = arch.make_step(cfg, shape, device=cuda).step_fn(
        gpu_model, *to_device(args, cuda))
    torch.cuda.synchronize()
    if name == "xdeepfm" and shape_name == "serve_p99":
        assert EB.LAUNCHES == eb + 1  # every multi-hot field in one launch
    if shape_name == "retrieval_cand":
        assert TK.LAUNCHES == tk + 1
    want = arch.make_step(cfg, shape, device="cpu").step_fn(
        cpu_model, *to_device(args, "cpu"))
    if shape_name == "retrieval_cand":  # (top-k values, indices, metrics)
        got, want = (got[0], got[2]), (want[0], want[2])
    elif name in ("xdeepfm", "autoint"):  # scores only
        got, want = (got, {}), (want, {})
    assert torch.allclose(got[0].cpu(), want[0], atol=1e-4, rtol=1e-4)
    assert got[1].keys() == want[1].keys()
    for k, v in want[1].items():
        assert float(got[1][k]) == pytest.approx(float(v), abs=TOL), k


# -- the redesigned top-k: filtered, rows split across blocks ------------------


def _topk_scores(kind, q, d, rng):
    if kind == "ties":
        s = rng.integers(0, 5, (q, d)).astype(np.float32)
        s[rng.random((q, d)) < 0.1] = -0.0
        s[rng.random((q, d)) < 0.1] = -np.inf
        return s
    if kind == "ascending":  # every score passes the filter
        return np.tile(np.arange(d, dtype=np.float32), (q, 1))
    if kind == "equal":
        return np.full((q, d), 0.5, np.float32)
    return rng.standard_normal((q, d)).astype(np.float32)


def _on_card(scores, cuda, misaligned):
    """``scores`` on the card, its rows starting 4 bytes past a 16-byte
    boundary when ``misaligned`` (a contiguous view at offset 1)."""
    if not misaligned:
        return torch.from_numpy(scores).to(cuda)
    buf = torch.empty(scores.size + 1, dtype=torch.float32, device=cuda)
    view = buf[1:].view(scores.shape)
    view.copy_(torch.from_numpy(scores))
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


def _assert_topk_exact(v, i, s, k):
    pv, pi = TK.topk_plain(s, k)
    torch.cuda.synchronize()
    d = s.shape[1]
    kk = min(k, d)
    assert torch.equal(i[:, :kk], pi[:, :kk])
    assert torch.equal(v[:, :kk], pv[:, :kk])
    assert bool((v[:, kk:] == -np.inf).all()) and bool((i[:, kk:] >= d).all())


@pytest.mark.parametrize("q,d,k,kind,misaligned", [
    (1, 1_000_000, 1000, "normal", False),
    (3, 1_000_000, 1000, "ties", True),
    (1, 999_999, 1000, "ascending", True),
    (3, 300_001, 1000, "equal", False),
    (1, 65_537, 100, "normal", True),
    (3, 200_000, 4000, "ties", False),
])
def test_topk_split_path_matches_plain(cuda, q, d, k, kind, misaligned):
    s = _on_card(_topk_scores(kind, q, d, np.random.default_rng(d + k)),
                 cuda, misaligned)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert TK.splits(q, d, k, n_sm) > 1  # the two-pass launch
    before, kernels = TK.LAUNCHES, TK.KERNEL_LAUNCHES
    v, i = TK.topk(s, k)
    assert TK.LAUNCHES == before + 1  # one wrapper call, two kernels
    assert TK.KERNEL_LAUNCHES == kernels + 2
    _assert_topk_exact(v, i, s, k)


@pytest.mark.parametrize("q,d,k,n_splits", [
    (2, 4099, 1000, 5),    # chunks shorter than k, S does not divide D
    (2, 50, 200, 3),       # k > D: padded rows
    (3, 9001, 128, 200),   # many chunks
    (2, 7, 3, 7),          # one column a chunk
    (2, 10_000, 1000, 1),  # one pass
])
def test_topk_forced_splits_match_plain(cuda, q, d, k, n_splits,
                                        monkeypatch):
    monkeypatch.setattr(TK, "splits", lambda *_: n_splits)
    for kind in ("ties", "ascending", "equal"):
        s = _on_card(_topk_scores(kind, q, d, np.random.default_rng(d)),
                     cuda, misaligned=(d % 2 == 1))
        v, i = TK.topk(s, k)
        _assert_topk_exact(v, i, s, k)


def _nan_scores(q, d, rng):
    """Ties, +-inf and NaN of both signs and several payloads; row 1 all
    NaN (``test_torch_kernels.nan_rows``'s rows; that module imports
    JAX, this one none)."""
    s = rng.choice(np.array([0.0, -0.0, 1.0, 2.0], np.float32), size=(q, d))
    s[rng.random((q, d)) < 0.1] = np.inf
    s[rng.random((q, d)) < 0.1] = -np.inf
    nans = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFC00123],
                    np.uint32).view(np.float32)
    hit = rng.random((q, d)) < 0.15
    s[hit] = rng.choice(nans, size=int(hit.sum()))
    s[1] = nans[rng.integers(0, 4, d)]
    return s


@pytest.mark.parametrize("q,d,k,n_splits", [
    (300, 5000, 1000, 1),    # one pass, a block a row
    (2, 1_000_000, 1000, 0), # the split path as the wrapper chooses it
    (3, 4099, 100, 5),       # forced splits
    (4, 50, 200, 1),         # k > D: NaNs, then the padding
])
def test_topk_kernel_orders_nan_after_every_number(cuda, q, d, k, n_splits,
                                                   monkeypatch):
    """NaN of either sign after every number (-inf included) and before
    the padding, as topk_plain and the full sort order it: indices exact,
    values bit for bit."""
    if n_splits:
        monkeypatch.setattr(TK, "splits", lambda *_: n_splits)
    s = torch.from_numpy(_nan_scores(q, d, np.random.default_rng(d))).to(cuda)
    v, i = TK.topk(s, k)
    pv, pi = TK.topk_plain(s, k)
    torch.cuda.synchronize()
    kk = min(k, d)
    assert torch.equal(i[:, :kk], pi[:, :kk])
    assert torch.equal(v[:, :kk].view(torch.int32),
                       pv[:, :kk].view(torch.int32))
    assert bool(torch.isnan(v[1, :kk]).all())
    assert bool((v[:, kk:] == -np.inf).all()) and bool((i[:, kk:] >= d).all())


# -- EmbeddingBag's fixed-length entry and the all-fields lookup ---------------


@pytest.mark.parametrize("n,m,e,fields,weights", [
    (5000, 8, 10, 3, "mask"), (300, 1, 1, 1, "mask"),
    (257, 3, 33, 2, "none"), (0, 8, 10, 3, "mask"), (64, 8, 33, 1, "mask"),
    (100, 5, 10, 4, "mask"), (40, 16, 10, 1, "none"), (10, 0, 10, 1, "none"),
])
def test_embedding_bag_fixed_kernel_matches_cpu_plain(cuda, n, m, e, fields,
                                                      weights):
    rng = np.random.default_rng(n + m + e)
    field_rows = 97
    table = rng.standard_normal((fields * field_rows, e)).astype(np.float32)
    table[5, 0] = np.inf  # times a zero weight: NaN on both sides
    ids = rng.integers(0, field_rows, (n, m)).astype(np.int32)
    w = rng.random((n, m)) < 0.5 if weights == "mask" else None
    if w is not None and w.size:
        w.reshape(-1)[::3] = False
    cpu = [None if x is None else torch.from_numpy(x)
           for x in (table, ids, w)]
    dev = [None if x is None else x.to(cuda) for x in cpu]
    before = EB.LAUNCHES
    got = EB.embedding_bag_fixed(*dev, fields=fields, field_rows=field_rows)
    assert EB.LAUNCHES == before + (1 if n else 0)
    want = EB.embedding_bag_fixed_plain(*cpu, fields, field_rows)
    on_card = EB.embedding_bag_fixed_plain(*dev, fields, field_rows)
    torch.cuda.synchronize()
    for other in (want, on_card.cpu()):  # the sums run in one order
        nan = torch.isnan(other)
        assert torch.equal(torch.isnan(got.cpu()), nan)
        assert bool((got.cpu()[~nan] == other[~nan]).all())


@pytest.mark.parametrize("n,m,e", [(300, 1, 1), (100, 5, 10), (40, 16, 10)])
def test_embedding_bag_kernel_float_weights_match_cpu_plain(cuda, n, m, e):
    """Float weights on bags of m lookups go through the general entry; zero
    weights times a non-finite row give NaN there as in the plain version."""
    rng = np.random.default_rng(n + m + e)
    table = rng.standard_normal((97, e)).astype(np.float32)
    table[5, 0] = np.inf
    idx = rng.integers(0, 97, n * m).astype(np.int32)
    seg = np.repeat(np.arange(n, dtype=np.int32), m)
    w = rng.random(n * m).astype(np.float32)
    w[::3] = 0
    cpu = [torch.from_numpy(x) for x in (table, idx, seg, w)]
    dev = [t.to(cuda) for t in cpu]
    got = EB.embedding_bag(*dev[:3], n, dev[3]).cpu()
    want = EB.embedding_bag_plain(*cpu[:3], n, cpu[3])
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert bool((got[~nan] == want[~nan]).all())


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_multi_hot_lookup_all_on_cuda_matches_cpu(cuda, combiner):
    cfg = E.TableConfig(n_fields=5, vocab_per_field=1000, dim=10)
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.standard_normal(
        (cfg.total_rows, cfg.dim)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 1000, (512, 3, 8)).astype(
        np.int32))
    mask = torch.from_numpy(rng.random((512, 3, 8)) < 0.7)
    before = EB.LAUNCHES
    got = E.multi_hot_lookup_all(table.to(cuda), ids.to(cuda),
                                 mask.to(cuda), cfg, combiner)
    assert EB.LAUNCHES == before + 1
    want = E.multi_hot_lookup_all(table, ids, mask, cfg, combiner)
    for f in range(3):
        assert bool((want[:, f] == E.multi_hot_lookup(
            table, ids[:, f], mask[:, f], cfg, f, combiner)).all())
    assert bool((got.cpu() == want).all())


def test_hot_path_wrappers_do_not_synchronize(cuda):
    rng = np.random.default_rng(0)
    one_row = torch.from_numpy(rng.standard_normal((1, 200_000)).astype(
        np.float32)).to(cuda)
    rows = torch.from_numpy(rng.standard_normal((600, 5000)).astype(
        np.float32)).to(cuda)
    cfg = E.TableConfig(n_fields=4, vocab_per_field=100, dim=10)
    table = torch.randn(cfg.total_rows, cfg.dim, device=cuda)
    ids = torch.randint(0, 100, (64, 3, 8), dtype=torch.int32, device=cuda)
    mask = torch.rand(64, 3, 8, device=cuda) < 0.5
    TK.topk(one_row, 100)  # builds and loads the kernels first
    E.multi_hot_lookup_all(table, ids, mask, cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        TK.topk(one_row, 100)  # split: two launches and scratch
        TK.topk(rows, 100)     # one pass
        E.multi_hot_lookup_all(table, ids, mask, cfg)
        EB.embedding_bag_fixed(table, ids.reshape(-1, 8))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_fused_wrapper_does_not_synchronize(cuda):
    short = [t.to(cuda) for t in _fused_inputs(40, 1024, 0)]
    long = [t.to(cuda) for t in _fused_inputs(3, 8192, 1)]
    FM.fused_measures(*short)  # builds and loads the kernel first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        FM.fused_measures(*short)  # a warp per row
        FM.fused_measures(*long)   # the table's prologue, a block per row
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_embedding_bag_fixed_out_of_range_traps_on_the_device(cuda):
    code = (
        "import torch\n"
        "from repro_torch.kernels import embedding_bag as EB\n"
        "t = torch.zeros((10, 4), device='cuda')\n"
        "ids = torch.tensor([[1, 2], [3, 10]], dtype=torch.int32, "
        "device='cuda')\n"
        "EB.embedding_bag_fixed(t, ids)\n"
        "torch.cuda.synchronize()\n"
        "print('NO TRAP')\n")
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0, res.stdout
    assert "NO TRAP" not in res.stdout


def test_embedding_bag_fixed_rejects_what_the_kernel_does_not_take(cuda):
    table = torch.zeros((10, 4), device=cuda)
    ids = torch.tensor([[1, 2]], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        EB.embedding_bag_fixed(table, ids.long())
    with pytest.raises(ValueError):
        EB.embedding_bag_fixed(table.t(), ids)  # not contiguous
    with pytest.raises(ValueError):
        EB.embedding_bag_fixed(table, ids, torch.ones((1, 2), device=cuda,
                                                      dtype=torch.int32))
    with pytest.raises(ValueError):  # float weights: the general entry
        EB.embedding_bag_fixed(table, ids, torch.ones((1, 2), device=cuda))
    with pytest.raises(ValueError):
        EB.embedding_bag_fixed(table, ids.cpu())
    with pytest.raises(ValueError):
        EB.embedding_bag_fixed(table.double(), ids)


# -- sweep, significance, ranked engine, streaming, Q-learning ---------------


def _sweep_case(k=6, nq=30, nd=50, seed=7):
    rng = np.random.default_rng(seed)
    qrel, runs = {}, []
    docs = {f"q{i}": [f"d{j}" for j in range(int(rng.integers(5, nd)))]
            for i in range(nq)}
    for qid, names in docs.items():
        qrel[qid] = {d: int(rng.integers(-1, 4)) for d in names[::2]}
    for _ in range(k):
        runs.append({qid: {d: float(s) for d, s in zip(
            names, np.round(rng.random(len(names)), 2))}
            for qid, names in docs.items()})
    return qrel, runs


SWEEP_MEASURES = ("map", "ndcg", "P", "recall", "recip_rank", "bpref",
                  "success", "Rprec", "num_rel_ret", "gm_map")


def test_sweep_on_cuda_single_and_sharded(cuda):
    """``single`` bit-identical to K separate ``evaluate_buffer`` calls on
    the card; ``sharded`` (the fused kernel) matches it with count columns
    exact; both match the CPU sweep within TOL."""
    from repro_torch.core import evaluate_sweep

    qrel, runs = _sweep_case()
    ev = RelevanceEvaluator(qrel, SWEEP_MEASURES, device=cuda)
    ev.chunk_queries = 64  # two runs a group, so several dispatches
    single = evaluate_sweep(ev, runs)
    before = FM.LAUNCHES
    sharded = evaluate_sweep(ev, runs, backend="sharded")
    assert FM.LAUNCHES - before == 3
    cpu = evaluate_sweep(qrel, runs, measures=SWEEP_MEASURES, device="cpu")
    for ki, run in enumerate(runs):
        want = ev.evaluate_buffer(ev.tokenize_run(run))
        for qi, qid in enumerate(single.qids):
            for mi, key in enumerate(single.measure_keys):
                assert single.table[ki, qi, mi] == want[qid][key], \
                    (ki, qid, key)
    for m, key in enumerate(single.measure_keys):
        for other in (sharded, cpu):
            a, b = other.table[..., m], single.table[..., m]
            if key.startswith(EXACT) or key == "num_rel_ret":
                assert np.array_equal(a, b), key
            else:
                np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL,
                                           err_msg=key)


def test_significance_on_cuda_matches_cpu(cuda):
    from repro_torch import stats as S

    x = np.random.default_rng(3).random((12, 60)).astype(np.float32)
    got = S.significance_report(x, tests=("t", "permutation"),
                                n_permutations=500, device=cuda)
    want = S.significance_report(x, tests=("t", "permutation"),
                                 n_permutations=500, device="cpu")
    np.testing.assert_allclose(got["t"], want["t"], rtol=1e-4, atol=1e-6)
    for key in ("p", "p_holm", "p_bonferroni"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5)
    sub = x[:, :14]
    assert torch.equal(S.paired_permutation_exact(sub, device=cuda).cpu(),
                       S.paired_permutation_exact(sub, device="cpu"))


def test_tf32_leaves_permutation_p_values_unchanged(cuda):
    from repro_torch import stats as S

    x = torch.from_numpy(np.random.default_rng(4).random(
        (9, 16)).astype(np.float32)).to(cuda)
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        exact = S.paired_permutation_exact(x)
        mc = S.paired_permutation_matrix(x, seed=2)
        torch.backends.cuda.matmul.allow_tf32 = True
        assert torch.equal(S.paired_permutation_exact(x), exact)
        assert torch.equal(S.paired_permutation_matrix(x, seed=2), mc)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_permutation_generator_is_seeded_on_the_device(cuda):
    from repro_torch import stats as S

    x = torch.from_numpy(np.random.default_rng(5).random(
        (5, 30)).astype(np.float32)).to(cuda)
    a = S.paired_permutation_matrix(x, seed=9)
    assert a.device.type == "cuda"
    gen = torch.Generator(device=cuda).manual_seed(9)
    assert torch.equal(S.paired_permutation_matrix(x, generator=gen), a)
    assert torch.equal(S.paired_permutation_matrix(x, seed=9), a)
    assert not torch.equal(S.paired_permutation_matrix(x, seed=10), a)
    exact = S.paired_permutation_exact(x[:, :12])
    mc = S.paired_permutation_matrix(x[:, :12], n_permutations=4000, seed=9)
    off = ~torch.eye(5, dtype=torch.bool, device=cuda)
    assert float((mc - exact)[off].abs().max()) < 0.06


def test_ranked_engine_on_cuda_matches_sorted_engine(cuda):
    from repro_torch.core import measures as M
    from repro_torch.core import ranked as RK

    rng = np.random.default_rng(6)
    q, d = 300, 256
    scores = torch.from_numpy(rng.choice(
        np.array([0.0, -0.0, 0.5, 1.0], np.float32), (q, d))).to(cuda)
    rel = torch.from_numpy(rng.integers(-1, 4, (q, d)).astype(
        np.float32)).to(cuda)
    judged = torch.from_numpy(rng.random((q, d)) < 0.3).to(cuda)
    tiebreak = torch.from_numpy(np.argsort(rng.random((q, d)), 1).astype(
        np.int32)).to(cuda)
    batch = M.batch_from_dense(scores, rel, judged=judged, tiebreak=tiebreak)
    parsed = M.parse_measures(sorted(M.SUPPORTED_MEASURES - {"gm_map"}))
    want = M.compute_measures(batch, parsed)
    got = RK.compute_measures_ranked(RK.from_eval_batch(batch, d), parsed)
    for k, v in want.items():
        if k.startswith(EXACT) or k.startswith("num_"):
            assert torch.equal(got[k], v), k
        else:
            assert torch.allclose(got[k], v, atol=TOL, rtol=TOL), k


def test_streaming_and_rl_on_cuda_match_cpu(cuda):
    from repro_torch.core import streaming
    from repro_torch.data import synthetic_ir as SIR
    from repro_torch.rl.environment import EnvConfig, QueryExpansionEnv

    names = ("map", "ndcg", "P")
    qrel = trec.load_qrel(os.path.join(FIXTURES, "conformance.qrel"))
    run = trec.load_run(os.path.join(FIXTURES, "conformance.run"))
    sums = {}
    for dev in (cuda, torch.device("cpu")):
        ev = RelevanceEvaluator(qrel, names, device=dev)
        buf = ev.tokenize_run(run)
        state = streaming.metric_update_run(
            streaming.metric_init(names, device=dev), ev, buf, None, names)
        assert state["__count"].device.type == dev.type
        sums[dev.type] = {k: float(v) for k, v in state.items()}
    for k, v in sums["cpu"].items():
        assert sums["cuda"][k] == pytest.approx(v, abs=TOL), k
    coll = SIR.build_collection(SIR.CollectionConfig(
        vocab_size=60, n_docs=15, n_queries=4, avg_doc_len=40, seed=2))
    envs = [QueryExpansionEnv(coll, EnvConfig(max_actions=3), device=dev)
            for dev in (cuda, "cpu")]
    for qid in coll.qrels:
        for env in envs:
            env.reset(qid)
        for a in (5, 60, 11):
            (_, rg, dg, _), (_, rc, dc, _) = (env.step(a) for env in envs)
            assert dg == dc and rg == pytest.approx(rc, abs=2e-4)
            if dg:
                break


def test_compare_cli_on_cuda_byte_matches_golden(cuda):
    import io

    from repro_torch import compare

    runs = [os.path.join(FIXTURES, n)
            for n in ("conformance.run", "sweep_b.run", "sweep_c.run")]
    with open(os.path.join(FIXTURES, "compare.golden"), newline="") as fh:
        golden = fh.read()
    for extra in ([], ["--sharded"]):
        out = io.StringIO()
        assert compare.main([*extra, os.path.join(FIXTURES,
                                                  "conformance.qrel"),
                             *runs], out=out) == 0
        assert out.getvalue() == golden


# -- training: B3's backward kernel and train steps on the card ----------------


def bag_bwd_inputs(n, m, e, fields, field_rows, case, seed):
    """B3-bwd's inputs, numpy: ids ``[n, m]`` int32 (uniform, a few rows,
    Zipf, or the rows either side of a slab edge ``edgeR``), a bool mask
    (None: every lookup weighs 1) and ``grad [n, e]`` float32."""
    rng = np.random.default_rng(seed)
    if case == "zipf":  # recsys_data.ctr_batch's single-hot ids
        ids = (rng.pareto(1.2, (n, m)) * 17).astype(np.int64) % field_rows
    elif case == "repeated":
        ids = rng.integers(0, 3, (n, m))
    elif case.startswith("edge"):
        ids = int(case[4:]) - 1 + rng.integers(0, 2, (n, m))
    else:
        ids = rng.integers(0, field_rows, (n, m))
    mask = None if case in ("none", "zipf") else rng.random((n, m)) < 0.6
    if case == "empty":
        mask[:] = False
    grad = rng.standard_normal((n, e)).astype(np.float32)
    if case == "nonfinite":  # masked-out lookups of non-finite rows
        grad[::7, 0] = np.inf
        grad[3::11, -1] = np.nan
    return ids.astype(np.int32), mask, grad


#: (n, m, e, fields, field_rows, case); the host check runs the same cases
#: (tests/test_torch_host_check.py).  Slabs of EB.slab_rows(e) rows: 512
#: for e = 10, 320 for e = 16, 152 for e = 33, 5,120 for e = 1.
BAG_BWD_CASES = [
    (5000, 8, 10, 3, 97, "mask"),       # xDeepFM's layout
    (1, 8, 10, 1, 97, "mask"),          # one bag
    (300, 4, 10, 2, 97, "empty"),       # every lookup masked out
    (400, 8, 33, 1, 97, "repeated"),    # a few rows taken many times
    (257, 3, 10, 4, 97, "none"),        # no mask, fields > 1
    (0, 8, 10, 3, 97, "mask"), (10, 0, 10, 1, 97, "none"),
    # the rows either side of a slab edge; V = 2,100 off a multiple of 512
    (600, 8, 10, 1, 1100, "edge512"),
    (5000, 8, 10, 3, 700, "mask"),
    # heavy slabs (over 8,192 lookups), split by rows among the windows of
    # 8,192 sorted lookups: one slab of 16,000 lookups; three rows taken
    # 24,000 times, runs across windows; three fields' Zipf heads
    (2000, 8, 10, 1, 97, "mask"),
    (3000, 8, 10, 1, 97, "repeated"),
    (40000, 1, 10, 3, 700, "zipf"),
    # Zipf ids, one lookup a bag (the vocab-parallel fields)
    (6000, 1, 10, 39, 700, "zipf"),
    # E = 1 (the linear term, 39 lookups a bag: one heavy slab), E = 16
    # (the widest row held in registers a chunk ahead) and E = 33
    (3000, 39, 1, 1, 5000, "mask"),
    (500, 8, 16, 2, 300, "mask"),
    (700, 8, 33, 2, 500, "mask"),
    # NaN times 0 stays in the sum
    (500, 8, 10, 2, 60, "nonfinite"),
]


def assert_bits_equal(got, want):
    """Equal bit for bit where ``want`` is a number, NaN where it is NaN
    (the card's NaN and the CPU's may differ in sign and payload)."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan])


@pytest.mark.parametrize("n,m,e,fields,field_rows,case", BAG_BWD_CASES)
def test_embedding_bag_fixed_backward_matches_plain(cuda, n, m, e, fields,
                                                    field_rows, case):
    """B3-bwd: bit for bit the plain version on the CPU (which adds in
    lookup order, as the kernel does), the same bits on two launches and
    on a launch from prepared inputs; one launch a call, a
    call without lookups included (the kernel writes its zeros); and
    close to the plain version on the card, whose atomics add in any
    order: a row here sums up to 1,100 terms of ~1, so within 1e-5
    relative and 1e-5 of the largest sum."""
    ids, mask, grad = bag_bwd_inputs(n, m, e, fields, field_rows, case,
                                     n + m + e + fields)
    v = fields * field_rows
    cpu = [None if x is None else torch.from_numpy(x)
           for x in (grad, ids, mask)]
    dev = [None if x is None else x.to(cuda) for x in cpu]
    before = EB.BACKWARD_LAUNCHES
    got = EB.embedding_bag_fixed_backward(*dev, v, fields, field_rows)
    again = EB.embedding_bag_fixed_backward(*dev, v, fields, field_rows)
    assert EB.BACKWARD_LAUNCHES == before + 2
    prepared = EB.prepare_backward(dev[1], v, e, fields, field_rows)
    direct = EB.launch_backward(dev[0], dev[2], m, v, *prepared)
    plain = EB.embedding_bag_fixed_backward_plain(*dev, v, fields,
                                                  field_rows)
    want = EB.embedding_bag_fixed_backward_plain(*cpu, v, fields, field_rows)
    torch.cuda.synchronize()
    assert got.shape == (v, e)
    for out in (got, again, direct):
        assert_bits_equal(out.cpu(), want)
    if case != "nonfinite":
        scale = float(want.abs().max()) if want.numel() else 0.0
        assert torch.allclose(got, plain, atol=1e-5 * scale, rtol=1e-5)
    if case == "empty":
        assert not bool(got.any())


def test_embedding_bag_fixed_backward_launches_no_fill(cuda):
    """One B3-bwd call on the card is the grouping and one kernel that
    writes the whole gradient: under ``torch.profiler`` the kernel runs
    once a call, the call runs no zero or fill op and no fill kernel of
    its own (the sort fills its index vector), the launch on prepared
    inputs runs no fill or memset at all, and ``BACKWARD_LAUNCHES`` rises
    by 1 a call."""
    from torch.profiler import ProfilerActivity, profile

    ids, mask, grad = bag_bwd_inputs(5000, 8, 10, 3, 97, "mask", 1)
    dev = [torch.from_numpy(x).to(cuda) for x in (grad, ids, mask)]
    args = (*dev, 3 * 97, 3, 97)
    EB.embedding_bag_fixed_backward(*args)  # built, allocator warm
    prepared = EB.prepare_backward(dev[1], 3 * 97, 10, 3, 97)
    torch.cuda.synchronize()
    before = EB.BACKWARD_LAUNCHES
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as whole:
        EB.embedding_bag_fixed_backward(*args)
        torch.cuda.synchronize()
    with profile(activities=acts) as launch:
        EB.launch_backward(dev[0], dev[2], 8, 3 * 97, *prepared)
        torch.cuda.synchronize()
    assert EB.BACKWARD_LAUNCHES == before + 2
    calls = {"whole": [evt.name for evt in whole.events()],
             "launch": [evt.name for evt in launch.events()]}
    for names in calls.values():
        assert sum("embedding_bag_fixed_backward_kernel" in x
                   for x in names) == 1, names
        assert not [x for x in names if x in ("aten::fill_", "aten::zero_",
                                              "aten::zeros")
                    or "FillFunctor" in x], names
    assert not [x for x in calls["launch"]
                if "fill" in x.lower() or "memset" in x.lower()], calls


def test_embedding_bag_fixed_backward_out_of_range_traps(cuda):
    """A row outside [0, V) (an id past its field, a negative id, any id
    into a table of no rows) stops B3-bwd with a device-side trap; the
    wrapper refuses int64 ids and rows wider than the kernel takes."""
    cases = ["ids = torch.tensor([[1, 2], [3, 40]], dtype=torch.int32, "
             "device='cuda'); v = 60",
             "ids = torch.tensor([[1, -2]], dtype=torch.int32, "
             "device='cuda'); v = 60",
             "ids = torch.tensor([[0]], dtype=torch.int32, device='cuda'); "
             "v = 0"]
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    for case in cases:
        code = ("import torch\n"
                "from repro_torch.kernels import embedding_bag as EB\n"
                f"{case}\n"
                "g = torch.ones((ids.shape[0], 4), device='cuda')\n"
                "EB.embedding_bag_fixed_backward(g, ids, None, v, 2, 20)\n"
                "torch.cuda.synchronize()\n"
                "print('NO TRAP')\n")
        res = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode != 0 and "NO TRAP" not in res.stdout, case
    ids = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        EB.embedding_bag_fixed_backward(torch.ones((2, 4), device=cuda),
                                        ids.long(), None, 10)
    with pytest.raises(ValueError, match="at most"):
        EB.embedding_bag_fixed_backward(torch.ones((2, 257), device=cuda),
                                        ids, None, 10)


def test_embedding_bag_fixed_grad_on_cuda_matches_cpu_autograd(cuda):
    """The autograd Function: forward B3, backward B3-bwd; the table's
    gradient equals the CPU's (plain forward and backward), bit for bit;
    the call under inference mode records nothing."""
    rng = np.random.default_rng(9)
    table = torch.from_numpy(rng.standard_normal((300, 10)).astype(
        np.float32))
    ids = torch.from_numpy(rng.integers(0, 100, (96, 8)).astype(np.int32))
    mask = torch.from_numpy(rng.random((96, 8)) < 0.6)
    weight = torch.from_numpy(rng.standard_normal((96, 10)).astype(
        np.float32))
    grads = []
    for dev in ("cpu", cuda):
        t = table.to(dev).detach().requires_grad_()
        out = EB.embedding_bag_fixed_grad(t, ids.to(dev), mask.to(dev), 3,
                                          100)
        (out * weight.to(dev)).sum().backward()
        grads.append(t.grad.cpu())
    assert torch.equal(grads[0], grads[1])
    with torch.inference_mode():
        out = EB.embedding_bag_fixed_grad(table.to(cuda), ids.to(cuda))
    assert out.grad_fn is None


def _train_batch(name, cfg, b, step):
    if name == "sasrec":
        return RD.seq_batch(RD.SeqDataConfig(cfg.n_items, cfg.seq_len, b),
                            step)
    if name == "mind":
        return RD.mind_batch(RD.SeqDataConfig(cfg.table.vocab_per_field,
                                              cfg.hist_len, b), step)
    return RD.ctr_batch(RD.CTRDataConfig(
        cfg.table.n_fields, cfg.table.vocab_per_field, b, cfg.n_multi_hot,
        cfg.multi_hot_len), step)


@pytest.mark.parametrize("name", ["xdeepfm", "sasrec", "autoint", "mind"])
def test_recsys_train_step_on_cuda_matches_cpu(cuda, name):
    """A smoke train step on the card (no host sync in it) against the
    same step on the CPU from the same weights: loss, grad_norm and every
    gradient leaf, the table's included, within rtol 2e-4 plus atol
    2e-4 · max|g|; xDeepFM launches B3 and B3-bwd once a step."""
    arch = get_arch(name)
    cfg = arch.make_config(True)
    shape = smoke_shape(arch.shapes["train_batch"], batch=64)
    cpu_model = MODELS[name](cfg, device="cpu")
    gpu_model = MODELS[name](cfg, device=cuda)
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu = arch.make_step(cfg, shape, device=cuda)
    cpu = arch.make_step(cfg, shape, device="cpu")
    gpu_state, cpu_state = gpu.init_opt(gpu_model), cpu.init_opt(cpu_model)
    for step in range(2):
        batch = _train_batch(name, cfg, 64, step)
        dev_batch = to_device(batch, cuda)
        eb, bwd = EB.LAUNCHES, EB.BACKWARD_LAUNCHES
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            gpu_model, gpu_state, got = gpu.step_fn(gpu_model, gpu_state,
                                                    dev_batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        if name == "xdeepfm":
            assert (EB.LAUNCHES, EB.BACKWARD_LAUNCHES) == (eb + 1, bwd + 1)
        cpu_model, cpu_state, want = cpu.step_fn(cpu_model, cpu_state,
                                                 to_device(batch, "cpu"))
        for k in want:
            assert float(got[k]) == pytest.approx(float(want[k]), rel=TOL,
                                                  abs=TOL), k
        cpu_grads = dict(cpu_model.named_parameters())
        for n, p in gpu_model.named_parameters():
            g, w = p.grad.cpu(), cpu_grads[n].grad
            allow = TOL * w.abs() + TOL * float(w.abs().max())
            assert bool(((g - w).abs() <= allow).all()), (n, step)


@pytest.mark.parametrize("task", ["node", "graph"])
def test_gnn_train_step_on_cuda_matches_cpu(cuda, task):
    arch = get_arch("gatedgcn")
    cfg = arch.make_config(True)
    if task == "node":
        meta = (("n_nodes", 300), ("n_edges", 1200), ("d_feat", 8),
                ("n_classes", 5))
        batch = GD.random_graph(GD.GraphConfig(300, 1200, 8, 5, 4, seed=1))
    else:
        meta = (("n_nodes", 60), ("n_edges", 100), ("d_feat", 8),
                ("n_classes", 3), ("graph_task", True), ("n_graphs", 10))
        batch = GD.graph_batch(10, 6, 10, 8, 3, 4, seed=1)
    shape = ShapeSpec("t", "train", meta)
    cpu_model = GatedGCN(shape_config(cfg, shape), device="cpu")
    gpu_model = GatedGCN(shape_config(cfg, shape), device=cuda)
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu = arch.make_step(cfg, shape, device=cuda)
    cpu = arch.make_step(cfg, shape, device="cpu")
    dev_batch = to_device(batch, cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, got = gpu.step_fn(gpu_model, gpu.init_opt(gpu_model),
                                dev_batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _, _, want = cpu.step_fn(cpu_model, cpu.init_opt(cpu_model),
                             to_device(batch, "cpu"))
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=TOL,
                                              abs=TOL), k
    cpu_grads = dict(cpu_model.named_parameters())
    for n, p in gpu_model.named_parameters():
        g, w = p.grad.cpu(), cpu_grads[n].grad
        assert bool(((g - w).abs() <= TOL * w.abs()
                     + TOL * float(w.abs().max())).all()), n


@pytest.mark.parametrize("name", ["olmo-1b", "phi3-medium-14b",
                                  "nemotron-4-15b", "qwen3-moe-235b-a22b",
                                  "arctic-480b"])
def test_lm_steps_on_cuda_match_cpu(cuda, name):
    """A smoke LM's train step on the card (no host sync in it) against
    the CPU's from the same weights: the metrics and every gradient leaf
    within rtol 2e-4 plus atol 2e-4 · max|g|; then ``prefill`` (last
    logits and the cache) and four ``decode`` steps (logits, the cache
    written in place, the rank metrics) within 2e-4.  No kernel of the
    port is launched."""
    arch = get_arch(name)
    cfg = arch.make_config(True)
    b, s, n = 2, 16, 4
    cpu_model = Transformer(cfg, device="cpu")
    gpu_model = Transformer(cfg, device=cuda)
    gpu_model.load_state_dict(cpu_model.state_dict())
    tokens = LD.MarkovLM(LD.LMDataConfig(cfg.vocab_size, s + n, b,
                                         seed=3)).batch(0)
    batch = {k: v[:, :s] for k, v in tokens.items()}
    shape = smoke_shape(arch.shapes["train_4k"], seq_len=s, global_batch=b)
    gpu = arch.make_step(cfg, shape, device=cuda)
    cpu = arch.make_step(cfg, shape, device="cpu")
    launches = (EB.LAUNCHES, FM.LAUNCHES, TK.LAUNCHES)
    dev_batch = to_device(batch, cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gpu_model, _, got = gpu.step_fn(gpu_model, gpu.init_opt(gpu_model),
                                        dev_batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cpu_model, _, want = cpu.step_fn(cpu_model, cpu.init_opt(cpu_model),
                                     to_device(batch, "cpu"))
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=TOL,
                                              abs=TOL), k
    cpu_grads = dict(cpu_model.named_parameters())
    for n_, p in gpu_model.named_parameters():
        g, w = p.grad.cpu(), cpu_grads[n_].grad
        assert bool(((g - w).abs() <= TOL * w.abs()
                     + TOL * float(w.abs().max())).all()), n_

    pre = smoke_shape(arch.shapes["prefill_32k"], seq_len=s, global_batch=b)
    dec = smoke_shape(arch.shapes["decode_32k"], seq_len=s, global_batch=b)
    out = []
    for dev, model in ((cuda, gpu_model), ("cpu", cpu_model)):
        toks = torch.from_numpy(tokens["tokens"]).to(dev)
        # the cache padded to s slots, then n tokens decoded into it
        last, full = arch.make_step(cfg, pre, device=dev).step_fn(
            model, toks[:, :s - n], max_seq=s)
        step = arch.make_step(cfg, dec, device=dev).step_fn
        rows = [last]
        for pos in range(s - n, s):
            logits, cache2, metrics = step(model, full, toks[:, pos], pos,
                                           toks[:, pos + 1])
            assert cache2 is full
            rows += [logits, *metrics.values()]
        out.append([r.cpu() for r in rows] + [full["k"].cpu(),
                                              full["v"].cpu()])
    for g, w in zip(*out):
        torch.testing.assert_close(g.float(), w.float(), rtol=TOL, atol=TOL)
    assert (EB.LAUNCHES, FM.LAUNCHES, TK.LAUNCHES) == launches


def test_trainer_times_each_step_on_the_card(cuda):
    """The trainer reads its step times from CUDA events at logged steps
    only: a step whose work is slow on the device alone (the host returns
    at once) is flagged as a straggler between two logged steps."""
    def step(params, opt_state, batch):  # one step 10x the others' work
        torch.cuda._sleep(200_000_000 if batch == 7 else 20_000_000)
        return params, opt_state, {"loss": torch.full((), float(batch),
                                                      device=cuda)}

    trainer = Trainer(TrainConfig(total_steps=10, log_every=5), step, {},
                      {}, iter(range(100)))
    logs = []
    assert trainer.run(log_fn=logs.append) == {"loss": 9.0}
    assert len(trainer.monitor.times) == 10
    assert trainer.monitor.flags == 1
    assert [s for s in logs if s.startswith("[straggler]")] == [
        s for s in logs if s.startswith("[straggler] step 8 ")]


# -- the eleventh slice: B2 and B3 on a shard ----------------------------------


class _StubMesh:
    """Rank ``rank`` of a (1, m) mesh, as the sharding rules read one."""

    mesh_dim_names = ("data", "model")

    def __init__(self, m, rank):
        self.shape, self.rank = (1, m), rank

    def size(self, dim=None):
        return self.shape[dim] if dim is not None else self.shape[1]

    def get_local_rank(self, name):
        return self.rank if name == "model" else 0


@pytest.mark.parametrize("blocks", (2, 3))
def test_b2_merge_of_candidate_blocks_is_one_top_k(cuda, blocks):
    """Retrieval's candidate split: B2 on each block, then B2 over the
    gathered (value, index) pairs, bit for bit one B2 call over the row,
    ties (repeated scores) to the lower index and NaN last."""
    from repro_torch.launch.steps import merge_topk

    rng = np.random.default_rng(blocks)
    n, k = 6000, 300
    x = rng.standard_normal((2, n)).astype(np.float32)
    x[:, 4000:4100] = x[:, 10:110]  # ties across blocks
    x[0, rng.choice(n, 5900, replace=False)] = np.nan  # NaN in the top k
    scores = torch.from_numpy(x).to(cuda)
    want = TK.topk(scores, k)
    before = TK.LAUNCHES
    width = n // blocks
    vals, idx = [], []
    for b in range(blocks):
        v, i = TK.topk(scores[:, b * width:(b + 1) * width].contiguous(), k)
        vals.append(v)
        idx.append(i + b * width)
    got = merge_topk(torch.cat(vals, 1), torch.cat(idx, 1), k)
    assert TK.LAUNCHES == before + blocks + 1
    assert torch.equal(got[1], want[1])
    assert got[0].cpu().numpy().tobytes() == want[0].cpu().numpy().tobytes()


@pytest.mark.parametrize("m", (2, 3))
def test_b3_on_row_shards_sums_to_the_unsharded_lookup(cuda, m):
    """The vocab-parallel lookup: each shard's B3 launch on its own rows
    (zero weight elsewhere) and the partial sums added as the sum over
    ``model`` adds them, within 1e-5 of one B3 call on the whole table;
    a shard's NaN row reaches no other shard's sums."""
    rng = np.random.default_rng(m)
    table = torch.from_numpy(rng.standard_normal((1000, 10)).astype(
        np.float32)).to(cuda)
    table[0] = float("nan")  # shard 0's first row
    ids = torch.from_numpy(rng.integers(1, 1000, (4096, 8)).astype(
        np.int32)).to(cuda)
    mask = torch.from_numpy(rng.random((4096, 8)) < 0.8).to(cuda)
    want = EB.embedding_bag_fixed(table, ids, mask)
    before = EB.LAUNCHES
    parts = [E.VocabParallel(table, _StubMesh(m, r)).partial(ids, mask)
             for r in range(m)]
    assert EB.LAUNCHES == before + m
    got = parts[0]
    for p in parts[1:]:
        got = got + p
    assert torch.isfinite(got).all()
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
