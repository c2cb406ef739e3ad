"""The port's ranking and measure core against the JAX package's.

The same numpy batch (made from a seed) goes through ``repro.core.measures``
and ``repro_torch.core.measures`` on the CPU.  Count columns must be
bit-identical, every other column within atol = rtol = 2e-4 (the repo's
fused-vs-core tolerance), and the rank order exact.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RelevanceEvaluator as JaxEvaluator
from repro.core import measures as JM
from repro.core import sorting as JS
from repro.core import registry as JR

from repro_torch.core import RelevanceEvaluator
from repro_torch.core import measures as M
from repro_torch.core import sorting as S

TOL = 2e-4
EXACT_PREFIXES = ("num_", "P_", "recall_", "success_", "judged_")
EXACT_KEYS = ("Rprec", "recip_rank")


def is_exact(key):
    return key.startswith(EXACT_PREFIXES) or key in EXACT_KEYS


def assert_columns_match(got, want, tol=TOL):
    """Per-key ``[Q]`` arrays: count columns bitwise, the rest within tol."""
    assert set(got) == set(want)
    for key, w in want.items():
        g = np.asarray(got[key], dtype=np.float32)
        w = np.asarray(w, dtype=np.float32)
        if is_exact(key):
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=key)


def assert_results_match(got, want, tol=TOL):
    """``{qid: {key: value}}`` dicts, same rule per key."""
    assert list(got) == list(want)
    for qid in want:
        assert list(got[qid]) == list(want[qid]), qid
    keys = list(next(iter(want.values()))) if want else []
    assert_columns_match(
        {k: [got[q][k] for q in got] for k in keys},
        {k: [want[q][k] for q in want] for k in keys}, tol)


def random_fields(seed, q=12, d=40, j=16, signed_zeros=True):
    """An EvalBatch as numpy arrays: heavy ties, -0.0 against 0.0, scores
    that tie only in float32, graded and negative rel, short, empty and
    padded rows."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, d + 1, q)
    counts[0], counts[1] = d, 0  # a full row and an empty one
    mask = np.arange(d)[None, :] < counts[:, None]
    pool = np.array([0.0, -0.0, 1.0, 1.0 + 1e-9, 2.0, -3.5, 0.25])
    if not signed_zeros:
        pool = pool[pool != 0]
    scores = rng.choice(pool, size=(q, d))  # float64: ties appear in f32
    scores[2] = rng.standard_normal(d)
    tiebreak = np.argsort(rng.random((q, d)), axis=1).astype(np.int32)
    judged = (rng.random((q, d)) < 0.6) & mask
    rel = np.where(judged, rng.choice([-1, 0, 1, 2, 3], size=(q, d)), 0)
    ideal = -np.sort(-rng.integers(0, 4, (q, j)), axis=1)
    n_rel = (ideal >= 1).sum(1) + rng.integers(0, 3, q)
    query_mask = np.ones(q, bool)
    query_mask[-2:] = False
    return dict(scores=scores, tiebreak=tiebreak,
                rel=rel.astype(np.float32), judged=judged, mask=mask,
                ideal_rel=ideal.astype(np.float32),
                n_rel=n_rel.astype(np.float32),
                n_judged_nonrel=rng.integers(0, 10, q).astype(np.float32),
                query_mask=query_mask)


def jax_batch(fields):
    return JM.EvalBatch(**{k: jnp.asarray(v) for k, v in fields.items()})


ALL_MEASURES = sorted(JR.supported_families()) + [
    "RBP(p=0.5)", "P_3", "ndcg_cut_7", "map_cut_2", "err_3", "judged_4"]


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """One intra-op thread.  These tests are small, and the suite runs in
    parallel workers beside timing-sensitive tests (the serve layer's
    request-coalescing doctest) that an oversubscribed CPU would break."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def fields():
    return random_fields(0)


def test_batch_from_numpy_matches_jax_fields(fields):
    jb, tb = jax_batch(fields), M.batch_from_numpy(fields, "cpu")
    for name in M.EvalBatch._fields:
        a, b = np.asarray(getattr(jb, name)), getattr(tb, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_scores_tie_in_float32_at_the_batch_boundary():
    fields = random_fields(1)
    fields["scores"] = np.array([[1.0, 1.0 + 1e-9]] * 2)
    batch = M.batch_from_numpy(fields | dict(
        tiebreak=np.array([[1, 0]] * 2, np.int32),
        mask=np.ones((2, 2), bool)), "cpu")
    assert batch.scores.dtype == torch.float32
    assert batch.scores[0, 0] == batch.scores[0, 1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_sort_permutation_matches_lax_sort(seed):
    f = random_fields(seed)
    q, d = f["scores"].shape
    idx = np.broadcast_to(np.arange(d, dtype=np.int32), (q, d)).copy()
    jm, ji = JS.rank_sort(jnp.asarray(f["scores"]),
                          jnp.asarray(f["tiebreak"]), jnp.asarray(f["mask"]),
                          jnp.asarray(idx))
    tm, ti = S.rank_sort(torch.from_numpy(f["scores"]),
                         torch.from_numpy(f["tiebreak"]),
                         torch.from_numpy(f["mask"]), torch.from_numpy(idx))
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    # padding entries share one key, so only the real prefix has an order
    counts = f["mask"].sum(1)
    for r in range(q):
        np.testing.assert_array_equal(np.asarray(ji)[r, :counts[r]],
                                      ti.numpy()[r, :counts[r]], err_msg=r)


def test_signed_zeros_tie_and_tiebreak_decides():
    scores = torch.tensor([[0.0, -0.0, 0.0, -0.0, 1.0, float("nan")]])
    tiebreak = torch.tensor([[3, 0, 2, 1, 5, 4]], dtype=torch.int32)
    mask = torch.ones((1, 6), dtype=torch.bool)
    idx = torch.arange(6)[None]
    (_, order) = S.rank_sort(scores, tiebreak, mask, idx)
    (_, jorder) = JS.rank_sort(jnp.asarray(scores.numpy()),
                               jnp.asarray(tiebreak.numpy()),
                               jnp.asarray(mask.numpy()),
                               jnp.asarray(idx.numpy()))
    assert order.tolist() == [[4, 1, 3, 2, 0, 5]]
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))


@pytest.mark.parametrize("level,judged_only", [(1.0, False), (2.0, True)])
def test_sort_batch_matches_jax(fields, level, judged_only):
    js = JM.sort_batch(jax_batch(fields), level, judged_only)
    ts = M.sort_batch(M.batch_from_numpy(fields, "cpu"), level, judged_only)
    for name in ("rel", "binrel", "judged", "mask", "cum_rel", "n_ret"):
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      getattr(ts, name).numpy(),
                                      err_msg=name)


@pytest.mark.parametrize("level,judged_only", [(1.0, False), (2.0, True)])
def test_every_column_matches_jax(fields, level, judged_only):
    parsed = JR.canonicalize(ALL_MEASURES)[0]
    want = JM.compute_measures_jit(jax_batch(fields), parsed, level,
                                   judged_only)
    got = M.compute_measures(M.batch_from_numpy(fields, "cpu"), parsed,
                             level, judged_only)
    assert_columns_match({k: v.numpy() for k, v in got.items()},
                         {k: np.asarray(v) for k, v in want.items()})
    assert len(got) == len(JR.keys_for(parsed))


def test_aggregate_and_finalize_match_jax(fields):
    parsed = JR.canonicalize(["map", "gm_map", "P_5", "ndcg"])[0]
    jb, tb = jax_batch(fields), M.batch_from_numpy(fields, "cpu")
    jagg = JM.aggregate(JM.compute_measures_jit(jb, parsed), jb.query_mask)
    tagg = M.aggregate(M.compute_measures(tb, parsed), tb.query_mask)
    # a mean is a float sum whatever the column: compared within TOL
    assert set(tagg) == set(jagg)
    for k in jagg:
        np.testing.assert_allclose(float(tagg[k]), float(jagg[k]),
                                   atol=TOL, rtol=TOL, err_msg=k)
    assert M.finalize_aggregates({"gm_map": -1.0, "map": 0.5}) == \
        JM.finalize_aggregates({"gm_map": -1.0, "map": 0.5})


def test_batch_from_dense_matches_jax():
    rng = np.random.default_rng(5)
    scores = rng.standard_normal((6, 30)).astype(np.float32)
    rel = rng.integers(0, 4, (6, 30)).astype(np.float32)
    judged = rng.random((6, 30)) < 0.7
    jb = JM.batch_from_dense(jnp.asarray(scores), jnp.asarray(rel),
                             judged=jnp.asarray(judged), relevance_level=2)
    tb = M.batch_from_dense(torch.from_numpy(scores), torch.from_numpy(rel),
                            judged=torch.from_numpy(judged),
                            relevance_level=2)
    for name in M.EvalBatch._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jb, name)),
                                      getattr(tb, name).numpy(),
                                      err_msg=name)


# -- the top-k route ------------------------------------------------------

BOUNDED = ("P@5", "P_10", "recall_10", "nDCG@10", "map_cut_10",
           "success_10", "Judged@10", "ERR@20", "num_ret", "num_rel")


def _wide_case(nd=600, nq=3, seed=7):
    rng = random.Random(seed)
    run, qrel = {}, {}
    for qi in range(nq):
        qid = f"q{qi}"
        run[qid] = {f"d{j:04d}": rng.choice([0.25, 0.5, rng.random()])
                    for j in range(nd)}
        qrel[qid] = {f"d{j:04d}": rng.randint(0, 2)
                     for j in rng.sample(range(nd), 40)}
    return run, qrel


@pytest.mark.parametrize("judged_only", [False, True])
def test_topk_route_matches_full_sort_and_jax(monkeypatch, judged_only):
    run, qrel = _wide_case()
    ev = RelevanceEvaluator(qrel, BOUNDED, judged_docs_only=judged_only,
                            device="cpu")
    buf = ev.tokenize_run(run)
    assert ev._route_topk(buf)
    routed = ev.evaluate(run)

    batch = ev.batch_from_buffer(buf, topk_layout=True)
    topk_cols = M.compute_measures_topk(batch, ev.measures,
                                        ev.relevance_level, judged_only)
    full_cols = M.compute_measures(ev.batch_from_buffer(buf), ev.measures,
                                   ev.relevance_level, judged_only)
    assert_columns_match({k: v.numpy() for k, v in topk_cols.items()},
                         {k: v.numpy() for k, v in full_cols.items()})

    jev = JaxEvaluator(qrel, BOUNDED, judged_docs_only=judged_only)
    monkeypatch.setattr(type(jev), "_route_topk", lambda self, b: False)
    assert_results_match(routed, jev.evaluate(run))


def test_topk_route_keeps_trec_tie_rule(monkeypatch):
    ev = RelevanceEvaluator({"q": {"dB": 1}}, ("P_5", "success_1"),
                            device="cpu")
    monkeypatch.setattr(type(ev), "_route_topk", lambda self, buf: True)
    res = ev.evaluate({"q": {"dA": 1.0, "dB": 1.0}})
    assert res["q"]["success_1"] == 1.0
    assert res["q"]["P_5"] == np.float32(0.2)
