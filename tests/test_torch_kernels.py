"""The kernels' plain PyTorch versions against the JAX package's kernels.

On the CPU each wrapper runs its kernel's plain version; these tests hold
those versions (and the wrappers' CPU dispatch) against the Pallas kernels
run as ``tests/test_kernels.py`` runs them here: the fused-measure kernel
in interpret mode (or its ``ref`` oracle), top-k against ``jax.lax.top_k``
and, for signed zeros, against the Pallas kernel's own sorting network
(``repro.kernels.bitonic``).  The CUDA kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import measures as JM
from repro.kernels import bitonic as JBITONIC
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF

from repro_torch.core import measures as M
from repro_torch.kernels import fused_measures as FM
from repro_torch.kernels import ops, ref
from repro_torch.kernels import topk as TK

from test_torch_measures import single_torch_thread  # noqa: F401
from test_torch_measures import assert_columns_match

RNG_SEED = 11
#: the two shapes the Pallas interpreter compiles for (D below every
#: cutoff, D above the deepest); each compile costs seconds here
SHAPES = [(3, 8), (4, 1100)]


@functools.lru_cache(maxsize=None)
def _sorted_inputs(q, d, seed=RNG_SEED):
    """Rank-sorted rel/judged and the scalar block, from the JAX package."""
    rng = np.random.default_rng(seed)
    scores = jnp.asarray(rng.standard_normal((q, d)).astype(np.float32))
    rel = jnp.asarray(rng.integers(-1, 4, (q, d)).astype(np.float32))
    judged = jnp.asarray(rng.random((q, d)) < 0.6)
    batch = JM.batch_from_dense(scores, rel, judged=judged)
    s = JM.sort_batch(batch)
    scal = JOPS.make_scalars(batch.n_rel, batch.n_judged_nonrel,
                             batch.ideal_rel)
    return batch, s, scal


def _torch(*arrays):
    return [torch.from_numpy(np.array(x)) for x in arrays]


def _cols(out):
    return {name: np.asarray(out)[:, i] for i, name in enumerate(FM.COLUMNS)}


@pytest.mark.parametrize("q,d", SHAPES)
def test_fused_plain_matches_pallas_kernel(q, d):
    _, s, scal = _sorted_inputs(q, d)
    want = JOPS.fused_measures_cols(s.rel, s.judged, scal, interpret=True)
    rel, judged, scal_t = _torch(s.rel, s.judged, scal)
    got = FM.fused_measures_plain(rel, judged, scal_t)
    assert got.shape == (q, FM.OUT_WIDTH) and got.dtype == torch.float32
    assert_columns_match(_cols(got.numpy()), _cols(want))
    assert not got[:, len(FM.COLUMNS):].any()
    # the oracle built from the measure core agrees as well
    assert_columns_match(_cols(ref.fused_measures_ref(rel, judged, scal_t)),
                         _cols(got))


def test_fused_plain_at_relevance_level_two():
    # jitted, as the JAX engines run: XLA then rounds x / k (static k) as
    # x * f32(1 / k), which eager dispatch would not
    _, s, scal = _sorted_inputs(*SHAPES[1])
    oracle = jax.jit(JREF.fused_measures_ref,
                     static_argnames="relevance_level")
    want = oracle(s.rel, s.judged, scal, relevance_level=2.0)
    got = FM.fused_measures_plain(*_torch(s.rel, s.judged, scal), 2.0)
    assert_columns_match(_cols(got.numpy()), _cols(want))


def test_make_scalars_matches_jax():
    batch, _, want = _sorted_inputs(*SHAPES[1])
    got = ops.make_scalars(*_torch(batch.n_rel, batch.n_judged_nonrel,
                                   batch.ideal_rel))
    np.testing.assert_array_equal(got[:, :2].numpy(), np.asarray(want)[:, :2])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)


@pytest.mark.parametrize("judged_only", [False, True])
def test_evaluate_fused_matches_jax(judged_only):
    batch, _, _ = _sorted_inputs(*SHAPES[1])
    want = JOPS.evaluate_fused(batch, judged_only=judged_only,
                               interpret=True)
    tb = M.batch_from_numpy({f: np.array(getattr(batch, f))
                             for f in JM.EvalBatch._fields}, "cpu")
    got = ops.evaluate_fused(tb, judged_only=judged_only)
    assert_columns_match({k: v.numpy() for k, v in got.items()},
                         {k: np.asarray(v) for k, v in want.items()})


def test_fused_wrapper_on_cpu_is_the_plain_version_and_not_counted():
    rng = np.random.default_rng(RNG_SEED)
    args = _torch(rng.integers(0, 3, (4, 40)).astype(np.float32),
                  (rng.random((4, 40)) < 0.5).astype(np.float32),
                  rng.random((4, 16)).astype(np.float32) * 5)
    before = FM.LAUNCHES
    np.testing.assert_array_equal(
        ops.fused_measures_cols(*args).numpy(),
        FM.fused_measures_plain(*args).numpy())
    assert FM.LAUNCHES == before
    with pytest.raises(ValueError):
        FM.fused_measures(args[0], args[1], args[2][:, :12])
    with pytest.raises(ValueError):
        FM.fused_measures(*args, relevance_level=0.0)


@pytest.mark.parametrize("q,d,k", [
    (1, 257, 10), (3, 1000, 100), (2, 4096, 1000), (5, 64, 64), (2, 5, 8),
])
def test_topk_plain_matches_lax_top_k(q, d, k):
    scores = np.random.default_rng(q * d + k).standard_normal(
        (q, d)).astype(np.float32)
    v, i = TK.topk_plain(torch.from_numpy(scores), k)
    kk = min(k, d)
    rv, ri = jax.lax.top_k(jnp.asarray(scores), kk)
    np.testing.assert_array_equal(v[:, :kk].numpy(), np.asarray(rv))
    np.testing.assert_array_equal(i[:, :kk].numpy(), np.asarray(ri))
    assert v.shape == (q, k) and i.dtype == torch.int32
    assert (v[:, kk:] == -np.inf).all() and (i[:, kk:] == 0).all()
    rv2, ri2 = ref.topk_ref(torch.from_numpy(scores), k)
    assert torch.equal(v, rv2) and torch.equal(i, ri2)


def test_topk_plain_ties_break_by_index_like_lax():
    scores = np.random.default_rng(3).choice(
        np.array([0.0, 1.0, 2.0, -np.inf], np.float32), size=(4, 2000))
    v, i = TK.topk_plain(torch.from_numpy(scores), 50)
    rv, ri = jax.lax.top_k(jnp.asarray(scores), 50)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))


def test_topk_signed_zeros_tie_as_in_the_pallas_kernel():
    # lax.top_k orders +0.0 before -0.0; the Pallas kernel's sorting
    # network (and the port's kernel) compare with == and let the index
    # decide, which is also the full sort's rule (core.sorting)
    scores = np.random.default_rng(4).choice(
        np.array([0.0, -0.0, 1.0], np.float32), size=64)
    _, want = jax.jit(JBITONIC.sort_desc)(jnp.asarray(scores),
                                          jnp.arange(64, dtype=jnp.int32))
    _, got = TK.topk_plain(torch.from_numpy(scores)[None], 64)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    _, got_ref = ref.topk_ref(torch.from_numpy(scores)[None], 64)
    np.testing.assert_array_equal(got_ref[0].numpy(), np.asarray(want))


def test_topk_wrapper_on_cpu_is_the_plain_version_and_not_counted():
    scores = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (3, 700)).astype(np.float32))
    before = TK.LAUNCHES
    v, i = ops.topk(scores, 20)
    pv, pi = TK.topk_plain(scores, 20)
    assert torch.equal(v, pv) and torch.equal(i, pi)
    assert TK.LAUNCHES == before
    with pytest.raises(ValueError):
        TK.topk(scores[0], 5)
    assert TK.geometry(1000) == (1024, 2048)
    assert TK.geometry(20) == (128, 512)


def nan_rows(q, d, seed):
    """Rows with heavy ties, signed zeros, +-inf and NaN of both signs and
    several payloads; row 1 all NaN; row 0 one NaN among numbers."""
    rng = np.random.default_rng(seed)
    s = rng.choice(np.array([0.0, -0.0, 1.0, 2.0], np.float32), size=(q, d))
    s[rng.random((q, d)) < 0.1] = np.inf
    s[rng.random((q, d)) < 0.1] = -np.inf
    nans = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFC00123],
                    np.uint32).view(np.float32)
    hit = rng.random((q, d)) < 0.15
    s[hit] = rng.choice(nans, size=int(hit.sum()))
    s[0] = rng.standard_normal(d)
    s[0, d // 2] = np.nan
    s[1] = nans[rng.integers(0, 4, d)]
    return s


@pytest.mark.parametrize("q,d,k", [(4, 300, 50), (3, 40, 40), (4, 6, 9)])
def test_topk_plain_orders_nan_after_every_number(q, d, k):
    """Every NaN (either sign, any payload) after every number, -inf
    included, NaNs by column: the order of the JAX package's full sort
    (``repro.core.sorting.rank_sort`` with the column as tiebreak), which
    is what the depth-bounded route must reproduce.  Rows shorter than k
    (the last case) pad after their NaNs."""
    from repro.core import sorting as JSORT

    scores = nan_rows(q, d, q + d + k)
    v, i = TK.topk_plain(torch.from_numpy(scores), k)
    cols = np.broadcast_to(np.arange(d, dtype=np.int32), (q, d))
    _, want = JSORT.rank_sort(jnp.asarray(scores), jnp.asarray(cols),
                              jnp.ones((q, d), bool), jnp.asarray(cols))
    kk = min(k, d)
    np.testing.assert_array_equal(i[:, :kk].numpy(), np.asarray(want)[:, :kk])
    # values are the scores at those columns, bit for bit (NaN payloads too)
    np.testing.assert_array_equal(
        v[:, :kk].numpy().view(np.uint32),
        np.take_along_axis(scores, i[:, :kk].numpy().astype(np.int64),
                           -1).view(np.uint32))
    assert (v[:, kk:] == -np.inf).all() and (i[:, kk:] == 0).all()
    # numpy's lexsort oracle agrees
    rv, ri = ref.topk_ref(torch.from_numpy(scores), k)
    assert torch.equal(i, ri)
    assert np.isnan(v[1, :kk].numpy()).all()  # the all-NaN row
