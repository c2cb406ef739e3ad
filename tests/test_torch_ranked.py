"""The port's rank-reduction engine and streaming remainder, on the CPU.

One tie-heavy seeded batch (``random_fields``: score ties, ``-0.0`` against
``+0.0``, scores that tie only in float32, graded and negative relevance,
short, empty and padded rows) goes through ``repro.core.ranked`` and
``repro_torch.core.ranked``: judged ranks and the judged-document
selection equal, measures within atol = rtol = 2e-4 of the JAX ranked
engine, and the port's ranked engine against the port's sorted engine with
count columns bit-identical (the rest within 2e-4), whatever the query
chunk size.  The streaming state (``metric_init``, ``metric_update``,
``metric_update_run``) matches ``repro.core.streaming`` within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RelevanceEvaluator as JaxEvaluator
from repro.core import measures as JM
from repro.core import ranked as JRK
from repro.core import streaming as JSTREAM

from repro_torch.core import RelevanceEvaluator
from repro_torch.core import measures as M
from repro_torch.core import ranked as RK
from repro_torch.core import streaming

from test_torch_measures import single_torch_thread  # noqa: F401
from test_torch_measures import (assert_columns_match, jax_batch,
                                 random_fields)

MEASURES = M.parse_measures(sorted(M.SUPPORTED_MEASURES - {"gm_map"}))
STREAM_NAMES = ("ndcg", "recip_rank", "P", "map")
CPU = "cpu"


@pytest.fixture(scope="module")
def fields():
    return random_fields(3, q=12, d=40, j=16)


@pytest.fixture(scope="module")
def batches(fields):
    return M.batch_from_numpy(fields, CPU), jax_batch(fields)


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def test_from_eval_batch_picks_what_jax_picks(batches, fields):
    tb, jb = batches
    d = fields["scores"].shape[1]
    got, want = RK.from_eval_batch(tb, d), JRK.from_eval_batch(jb, d)
    for name in RK.RankedBatch._fields:
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            err_msg=name)


def test_judged_ranks_equal_jax(batches, fields):
    tb, jb = batches
    d = fields["scores"].shape[1]
    got = RK.judged_ranks(RK.from_eval_batch(tb, d)).numpy()
    want = np.asarray(JRK.judged_ranks(JRK.from_eval_batch(jb, d)))
    np.testing.assert_array_equal(got, want)


def test_ranked_matches_jax_ranked_engine(batches, fields):
    tb, jb = batches
    d = fields["scores"].shape[1]
    got = RK.compute_measures_ranked(RK.from_eval_batch(tb, d), MEASURES)
    want = JRK.compute_measures_ranked(JRK.from_eval_batch(jb, d), MEASURES)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-4, rtol=2e-4, err_msg=k)


@pytest.mark.parametrize("chunk_elems", [None, 40 * 40 * 5])
def test_ranked_matches_the_sorted_engine(batches, fields, chunk_elems,
                                          monkeypatch):
    """Count columns bit-identical to ``compute_measures``, the rest within
    2e-4, with the whole batch as one chunk and in chunks of 5 queries."""
    if chunk_elems is not None:
        monkeypatch.setattr(RK, "_CHUNK_ELEMS", chunk_elems)
    tb, _ = batches
    d = fields["scores"].shape[1]
    got = RK.compute_measures_ranked(RK.from_eval_batch(tb, d), MEASURES)
    want = M.compute_measures(tb, MEASURES)
    assert_columns_match(_np(got), _np(want))


def test_ranked_at_a_relevance_level_of_two(batches, fields):
    tb, _ = batches
    d = fields["scores"].shape[1]
    got = RK.compute_measures_ranked(RK.from_eval_batch(tb, d), MEASURES,
                                     relevance_level=2.0)
    assert_columns_match(_np(got), _np(M.compute_measures(tb, MEASURES, 2.0)))


def test_signed_zeros_tie_and_the_tiebreak_decides():
    """``-0.0`` and ``+0.0`` compare equal (as ``rank_sort`` orders them):
    the smaller tiebreak wins, whichever zero it carries."""
    scores = torch.tensor([[0.0, -0.0, 1.0, -0.0, 0.0]])
    tiebreak = torch.tensor([[3, 0, 4, 2, 1]], dtype=torch.int32)
    rel = torch.ones_like(scores)
    batch = M.batch_from_dense(scores, rel, tiebreak=tiebreak)
    ranks = RK.judged_ranks(RK.from_eval_batch(batch, 5))[0]
    # score 1.0 first, then the zeros by tiebreak: 0, 1, 2, 3
    assert ranks.tolist() == [5.0, 2.0, 1.0, 4.0, 3.0]
    jranks = JRK.judged_ranks(JRK.from_eval_batch(JM.batch_from_dense(
        jnp.asarray(scores.numpy()), jnp.asarray(rel.numpy()),
        tiebreak=jnp.asarray(tiebreak.numpy())), 5))
    assert np.asarray(jranks)[0].tolist() == ranks.tolist()


def test_unretrieved_judged_document():
    batch = M.EvalBatch(
        scores=torch.tensor([[3.0, 2.0]]),
        tiebreak=torch.tensor([[0, 1]], dtype=torch.int32),
        rel=torch.tensor([[1.0, 0.0]]),
        judged=torch.tensor([[True, True]]),
        mask=torch.tensor([[True, True]]),
        ideal_rel=torch.tensor([[2.0, 1.0]]),  # an unretrieved rel=2 doc
        n_rel=torch.tensor([2.0]),
        n_judged_nonrel=torch.tensor([1.0]),
        query_mask=torch.tensor([True]))
    got = RK.compute_measures_ranked(RK.from_eval_batch(batch), MEASURES)
    assert_columns_match(_np(got), _np(M.compute_measures(batch, MEASURES)))
    assert float(got["recall_5"][0]) == 0.5


# -- streaming remainder ------------------------------------------------------


def _dense_pair(seed, q=4, d=30):
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((q, d)).astype(np.float32)
    rel = rng.integers(0, 3, (q, d)).astype(np.float32)
    return (M.batch_from_dense(torch.from_numpy(scores),
                               torch.from_numpy(rel)),
            JM.batch_from_dense(jnp.asarray(scores), jnp.asarray(rel)))


def test_metric_init_keys_match_jax():
    got = streaming.metric_init(STREAM_NAMES, device=CPU)
    want = JSTREAM.metric_init(STREAM_NAMES)
    assert list(got) == list(want)
    assert all(v.dtype == torch.float32 and float(v) == 0.0
               for v in got.values())


def test_metric_update_matches_jax_streaming():
    state = streaming.metric_init(STREAM_NAMES, device=CPU)
    jstate = JSTREAM.metric_init(STREAM_NAMES)
    for seed in range(3):
        tb, jb = _dense_pair(seed)
        if seed == 2:  # a padded batch: its last query must not count
            mask = np.array([True, True, True, False])
            tb = tb._replace(query_mask=torch.from_numpy(mask))
            jb = jb._replace(query_mask=jnp.asarray(mask))
        state = streaming.metric_update(state, tb, STREAM_NAMES)
        jstate = JSTREAM.metric_update(jstate, jb, STREAM_NAMES)
    assert float(state["__count"]) == float(jstate["__count"]) == 11.0
    got, want = streaming.metric_finalize(state), JSTREAM.metric_finalize(
        jstate)
    assert list(got) == list(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), abs=1e-6), k


def test_metric_update_run_matches_jax():
    qrel = {"q1": {"a": 1, "b": 0, "c": 2}, "q2": {"a": 0, "d": 1}}
    run = {"q1": {"a": 0.5, "b": 0.9, "c": 0.1, "x": 0.3},
           "q2": {"a": 0.2, "d": 0.1, "y": 0.9}}
    fresh = np.array([0.1, 0.2, 0.9, 0.4, 0.3, 0.8, 0.5], np.float32)
    ev = RelevanceEvaluator(qrel, STREAM_NAMES, device=CPU)
    jev = JaxEvaluator(qrel, STREAM_NAMES)
    state = streaming.metric_update_run(
        streaming.metric_init(STREAM_NAMES, device=CPU), ev,
        ev.tokenize_run(run), fresh, STREAM_NAMES)
    jstate = JSTREAM.metric_update_run(
        JSTREAM.metric_init(STREAM_NAMES), jev, jev.tokenize_run(run), fresh,
        STREAM_NAMES)
    for k in jstate:
        assert float(state[k]) == pytest.approx(float(jstate[k]), abs=1e-6), k
