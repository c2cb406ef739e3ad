"""The CUDA kernels against their plain versions, on a GPU.

Edge shapes the smoke test's main path does not reach: one-rank rows,
rows shorter than every cutoff, tiles cut by D, k above D, several tiles
merged into the running top-k, heavy ties and signed zeros; EmbeddingBag
at odd widths, with empty bags, one bag holding every lookup and no
lookups; and smoke-size recsys steps on the card against the CPU.  Run on
a machine with a GPU::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Elsewhere every test skips (unverified, not passed).  This file imports
neither JAX nor the JAX package, so it runs where only the port does.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.core import RelevanceEvaluator
from repro_torch.core import trec
from repro_torch.configs.common import smoke_shape
from repro_torch.data import recsys_data as RD
from repro_torch.distributed import ShardedEvaluator
from repro_torch.kernels import embedding_bag as EB
from repro_torch.kernels import fused_measures as FM
from repro_torch.kernels import topk as TK
from repro_torch.launch.api import get_arch, to_device
from repro_torch.launch.steps import MODELS

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


@pytest.mark.parametrize("q,d,level", [
    (1, 1, 1.0), (3, 8, 1.0), (5, 64, 2.0), (7, 1000, 1.0), (4, 1024, 1.0),
    (3, 1100, 1.0), (2, 5000, 1.0), (300, 2048, 1.0),
])
def test_fused_kernel_matches_plain(cuda, q, d, level):
    args = [t.to(cuda) for t in _fused_inputs(q, d, q + d)]
    before = FM.LAUNCHES
    got = FM.fused_measures(*args, level)
    assert FM.LAUNCHES == before + 1
    want = FM.fused_measures_plain(*args, level)
    torch.cuda.synchronize()
    for c, name in enumerate(FM.COLUMNS):
        if name.startswith(EXACT):
            assert torch.equal(got[:, c], want[:, c]), name
        else:
            assert torch.allclose(got[:, c], want[:, c], atol=TOL,
                                  rtol=TOL), name
    assert not got[:, len(FM.COLUMNS):].any()


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
        assert EB.LAUNCHES == eb + cfg.n_multi_hot
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
