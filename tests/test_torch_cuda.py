"""The CUDA kernels against their plain versions, on a GPU.

Edge shapes the smoke test's main path does not reach: one-rank rows,
rows shorter than every cutoff, tiles cut by D, k above D, several tiles
merged into the running top-k, heavy ties and signed zeros.  Run on a
machine with a GPU::

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
from repro_torch.distributed import ShardedEvaluator
from repro_torch.kernels import fused_measures as FM
from repro_torch.kernels import topk as TK

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
