"""The port's significance stack against the JAX package's, on the CPU.

The same seeded ``[K, Q]`` score matrices go through ``repro.stats`` and
``repro_torch.stats``:

* ``betainc`` (float64 Lentz continued fraction) against
  ``scipy.special.betainc`` (float64, within 1e-10) and
  ``jax.scipy.special.betainc`` (float32, whose own error grows with df:
  within 1e-6 + 4e-7·df) over the ``(df/2, 1/2, df/(df+t²))`` points a
  t-test reaches;
* t within 1e-5 relative of JAX and 1e-4 of ``scipy.stats.ttest_rel``,
  p within the betainc bound of JAX and 1e-6 of scipy;
* Holm and Bonferroni bit-identical to JAX on the same p matrix;
* exact enumeration equal to JAX's exactly; Monte Carlo within the
  binomial bound of ``tests/test_stats.py`` of the exact p-values.
"""

import doctest
import importlib
import math

import jax.scipy.special as jsp
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as ss
import scipy.stats as sps
import torch

from repro import stats as JS

from repro_torch import stats as S
from repro_torch.stats import significance as SIG

from test_stats import P_DF1, P_DF3, T_DF3, X_DF1, X_DF3, _rand
from test_torch_measures import single_torch_thread  # noqa: F401

CPU = "cpu"


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _t_tail_points(df):
    t = np.concatenate([[0.0, 1e-4], np.logspace(-3, 2, 40), [np.inf]])
    t = t.astype(np.float32)
    return (np.float32(df) / (np.float32(df) + t * t)).astype(np.float32)


@pytest.mark.parametrize("df", [1, 2, 3, 9, 39, 248])
def test_betainc_matches_scipy_and_jax(df):
    x = _t_tail_points(df)
    ours = SIG.betainc(df / 2.0, 0.5, torch.from_numpy(x)).numpy()
    assert ours.dtype == np.float64
    ref = ss.betainc(df / 2.0, 0.5, x.astype(np.float64))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-10)
    jx = np.asarray(jsp.betainc(jnp.float32(df / 2.0), jnp.float32(0.5),
                                jnp.asarray(x)))
    np.testing.assert_allclose(ours, jx, rtol=0, atol=1e-6 + 4e-7 * df)
    assert ours[0] == 1.0 and ours[-1] == 0.0  # t = 0 and t = inf


def test_betainc_symmetric_branch_and_edges():
    a = torch.tensor([0.5, 2.0, 30.0, 0.7], dtype=torch.float64)
    b = torch.tensor([0.5, 3.0, 0.5, 9.0], dtype=torch.float64)
    for x in (0.0, 1e-9, 0.3, 0.5, 0.97, 1.0):
        got = SIG.betainc(a, b, torch.full((4,), x, dtype=torch.float64))
        ref = ss.betainc(a.numpy(), b.numpy(), x)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)


def test_closed_forms():
    t, p = S.paired_t_matrix(X_DF1, device=CPU)
    assert abs(float(t[0, 1]) - 2.0) < 1e-6
    assert abs(float(p[0, 1]) - P_DF1) < 1e-7
    assert float(t[1, 0]) == -float(t[0, 1])
    t, p = S.paired_t_matrix(X_DF3, device=CPU)
    assert abs(float(t[0, 1]) - T_DF3) < 1e-5
    assert abs(float(p[0, 1]) - P_DF3) < 1e-6
    d = S.paired_diff_means(X_DF1, device=CPU)
    assert float(d[0, 0]) == float(d[1, 1]) == 0.0
    assert float(d[0, 1]) == pytest.approx(0.2, abs=1e-7)
    p = S.paired_permutation_exact(X_DF1, device=CPU)
    assert float(p[0, 1]) == 0.5


@pytest.mark.parametrize("k,q,seed", [(3, 5, 0), (8, 40, 9), (6, 249, 2)])
def test_t_matrix_matches_jax_and_scipy(k, q, seed):
    x = _rand(k, q, seed)
    t, p = (_np(a) for a in S.paired_t_matrix(x, device=CPU))
    jt, jp = (np.asarray(a) for a in JS.paired_t_matrix(x))
    assert t.dtype == p.dtype == np.float32
    np.testing.assert_allclose(t, jt, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p, jp, rtol=0, atol=1e-6 + 4e-7 * (q - 1))
    assert np.array_equal(t, -t.T) and np.array_equal(np.diag(t),
                                                      np.zeros(k))
    assert np.array_equal(p, p.T) and np.array_equal(np.diag(p), np.ones(k))
    for i in range(k):
        for j in range(i + 1, k):
            ref = sps.ttest_rel(x[i], x[j])
            assert abs(float(t[i, j]) - ref.statistic) < 1e-4
            assert abs(float(p[i, j]) - ref.pvalue) < 1e-6


def test_degenerate_pairs_match_jax():
    base = np.array([0.25, 0.5, 0.75, 0.0, 0.25, 0.5], dtype=np.float32)
    x = np.stack([base, base + 0.5, base]).astype(np.float32)
    t, p = (_np(a) for a in S.paired_t_matrix(x, device=CPU))
    jt, jp = (np.asarray(a) for a in JS.paired_t_matrix(x))
    assert np.array_equal(t, jt) and np.array_equal(p, jp)
    assert t[0, 1] == -np.inf and t[1, 0] == np.inf and p[0, 1] == 0.0
    assert t[0, 2] == 0.0 and p[0, 2] == 1.0


def test_nan_row_gives_the_jax_nan_pattern():
    """A NaN score makes its system's t and p NaN (no exception from the
    continued fraction), with the JAX package's NaN positions throughout
    the report."""
    x = _rand(4, 9, seed=8)
    x[2, 5] = np.nan
    got = SIG.betainc(4.0, 0.5, torch.tensor([np.nan, 0.3]))
    assert got[0].isnan() and not got[1].isnan()
    rep = S.significance_report(x, tests=("t", "permutation"),
                                n_permutations=200, seed=1, device=CPU)
    want = JS.significance_report(x, tests=("t", "permutation"),
                                  n_permutations=200, seed=1)
    assert sorted(rep) == sorted(want)
    for key, value in want.items():
        assert np.array_equal(np.isnan(rep[key]), np.isnan(value)), key
    assert np.isnan(rep["t"][2, 0]) and np.isnan(rep["p"][0, 2])
    finite = ~np.isnan(want["t"])
    np.testing.assert_allclose(rep["t"][finite], want["t"][finite],
                               rtol=1e-5)
    for key in ("p", "p_holm", "p_bonferroni"):
        np.testing.assert_allclose(rep[key], want[key], atol=5e-6)


@pytest.mark.parametrize("k,seed", [(4, 3), (7, 4)])
def test_corrections_bit_identical_to_jax(k, seed):
    jp = np.triu(_rand(k, k, seed) ** 3, 1)  # many small p-values
    jp = jp + jp.T + np.eye(k, dtype=np.float32)
    jp[0, 1] = jp[1, 0] = jp[0, 2] = jp[2, 0] = 0.01  # a tie in the family
    holm = _np(S.holm_matrix(jp, device=CPU))
    bonf = _np(S.bonferroni_matrix(jp, device=CPU))
    assert np.array_equal(holm, np.asarray(JS.holm_matrix(jp)))
    assert np.array_equal(bonf, np.asarray(JS.bonferroni_matrix(jp)))
    assert (holm <= bonf).all()


@pytest.mark.parametrize("k,q,seed", [(4, 10, 11), (5, 14, 12)])
def test_exact_enumeration_equals_jax(k, q, seed):
    x = _rand(k, q, seed)
    got = _np(S.paired_permutation_exact(x, device=CPU))
    want = np.asarray(JS.paired_permutation_exact(x))
    assert np.array_equal(got, want)


def test_exact_enumeration_of_duplicate_systems_is_one():
    """Two identical rows: every sign pattern ties the observed 0, p = 1.
    The JAX package's float32 row means and projections of the two rows
    can differ in the last bit (their reductions start at different
    alignments), which gives it a p below 1 here; the port's float64
    counts do not, and every other pair equals JAX's exactly."""
    x = _rand(5, 14, 12)
    x[1] = x[0]
    got = _np(S.paired_permutation_exact(x, device=CPU))
    want = np.asarray(JS.paired_permutation_exact(x))
    assert got[0, 1] == got[1, 0] == 1.0
    other = np.ones_like(got, dtype=bool)
    other[0, 1] = other[1, 0] = False
    assert np.array_equal(got[other], want[other])


def test_exact_enumeration_does_not_depend_on_the_block_size(monkeypatch):
    x = _rand(4, 12, 5)
    whole = _np(S.paired_permutation_exact(x, device=CPU))
    monkeypatch.setattr(SIG, "_BLOCK_ELEMS", 16 * 7)  # 7-pattern blocks
    assert np.array_equal(_np(S.paired_permutation_exact(x, device=CPU)),
                          whole)


def test_monte_carlo_within_bound_of_exact():
    """(count+1)/(P+1) within a binomial CI of the exact p (the JAX test's
    bound, ``tests/test_stats.py``)."""
    x = _rand(4, 10, seed=11)
    n_perm = 4000
    exact = np.asarray(JS.paired_permutation_exact(x))
    mc = _np(S.paired_permutation_matrix(x, n_permutations=n_perm, seed=5,
                                         device=CPU))
    for i in range(4):
        for j in range(i + 1, 4):
            pe = float(exact[i, j])
            bound = 3.5 * math.sqrt(pe * (1 - pe) / n_perm) + 2 / (n_perm + 1)
            assert abs(float(mc[i, j]) - pe) <= bound, (i, j, pe, mc[i, j])


def test_monte_carlo_seeding_and_structure():
    x = _rand(4, 9, 8)
    a = _np(S.paired_permutation_matrix(x, seed=3, device=CPU))
    b = _np(S.paired_permutation_matrix(x, seed=3, device=CPU))
    c = _np(S.paired_permutation_matrix(x, seed=4, device=CPU))
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    gen = torch.Generator().manual_seed(3)
    assert np.array_equal(_np(S.paired_permutation_matrix(
        x, generator=gen, device=CPU)), a)
    assert np.array_equal(a, a.T) and np.array_equal(np.diag(a), np.ones(4))
    assert ((a > 0) & (a <= 1)).all()


def test_significance_report_matches_jax():
    x = _rand(3, 7, seed=6)
    rep = S.significance_report(x, tests=("t", "permutation"),
                                n_permutations=300, seed=1, device=CPU)
    want = JS.significance_report(x, tests=("t", "permutation"),
                                  n_permutations=300, seed=1)
    assert sorted(rep) == sorted(want)
    for key, value in rep.items():
        assert isinstance(value, np.ndarray) and value.dtype == np.float32
        assert value.shape == want[key].shape, key
    np.testing.assert_allclose(rep["means"], want["means"], atol=1e-7)
    np.testing.assert_allclose(rep["diff"], want["diff"], atol=1e-7)
    np.testing.assert_allclose(rep["t"], want["t"], rtol=1e-5)
    for key in ("p", "p_holm", "p_bonferroni"):
        np.testing.assert_allclose(rep[key], want[key], atol=5e-6)
    assert "p_permutation" not in S.significance_report(x, device=CPU)


def test_input_validation():
    with pytest.raises(ValueError):
        S.paired_t_matrix(np.zeros(4, np.float32), device=CPU)
    with pytest.raises(ValueError):
        S.paired_t_matrix(np.zeros((3, 1), np.float32), device=CPU)
    with pytest.raises(ValueError):
        S.paired_permutation_exact(
            np.zeros((2, S.EXACT_ENUMERATION_MAX_Q + 1), np.float32),
            device=CPU)
    with pytest.raises(ValueError):
        S.significance_report(X_DF1, tests=("wilcoxon",), device=CPU)
    with pytest.raises(ValueError):
        S.paired_permutation_matrix(X_DF1, n_permutations=0, device=CPU)
    with pytest.raises(ValueError):
        S.holm_matrix(np.ones((2, 3)), device=CPU)


def test_tensor_inputs_stay_on_their_device():
    x = torch.from_numpy(_rand(3, 6, 1))
    t, p = S.paired_t_matrix(x)  # no device: the tensor's own
    assert t.device.type == p.device.type == "cpu"
    assert S.holm_matrix(p).device.type == "cpu"


@pytest.mark.parametrize("module_name", [
    "repro_torch.stats", "repro_torch.stats.corrections",
    "repro_torch.stats.significance", "repro_torch.core.sweep",
    "repro_torch.core.streaming",
    "repro_torch.distributed.sharded_evaluator",
])
def test_docstring_examples(module_name):
    results = doctest.testmod(importlib.import_module(module_name))
    assert results.attempted > 0 and results.failed == 0, results
