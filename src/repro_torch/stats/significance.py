"""Paired significance tests over all K×K system pairs, in PyTorch.

The port of ``repro.stats.significance``.  Input convention for every
function: ``x`` is a ``[K, Q]`` matrix of per-query scores — row ``i`` is
system ``i``'s value of ONE measure on the same ``Q`` queries (the pairing
axis).  A tensor stays on its device; anything else is copied to
``device`` (CUDA by default, ``"cpu"`` on request).  Matrices come back as
tensors on that device; :func:`significance_report` returns numpy arrays.

All pairwise statistics come from the antisymmetric difference tensor
``d[i, j, q] = x[i, q] - x[j, q]`` with batched reductions, as in the JAX
package.  Numerics, where the port has to choose:

* **t-test.** ``t`` is computed in float32, as the JAX package computes it.
  Its two-sided tail ``I_{df/(df+t²)}(df/2, 1/2)`` comes from
  :func:`betainc`, a Lentz continued fraction evaluated in float64 (torch
  has no incomplete beta), returned as float32.
* **Permutation tests.** The projections ``x @ signs.T / Q`` and the
  observed ``|mean_i - mean_j|`` they are counted against are float64, so
  the ``>=`` count with its ``_TIE_RTOL`` slack does not depend on TF32 or on
  a device's summation order: a resample that ties the observed statistic
  lands 1e-6 inside the threshold, any other at least a float32 value's
  spacing away.  Monte Carlo sign flips come from a ``torch.Generator`` on
  ``x``'s device seeded with ``seed``; the JAX package's ``jax.random``
  stream cannot be reproduced, so the two agree statistically, while exact
  enumeration (``Q <= 20``) gives the same counts.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.stats.corrections import bonferroni_matrix, holm_matrix

#: queries beyond which exact sign-flip enumeration (2^Q patterns) is refused
EXACT_ENUMERATION_MAX_Q = 20

#: relative slack when counting permuted |means| against the observed |mean|
#: — resamples that tie the observed statistic must count as >=
_TIE_RTOL = 1e-6

#: float64 elements of one block's [K, K, B] permuted-difference tensor
_BLOCK_ELEMS = 1 << 25

_F64 = torch.float64

# Lentz continued fraction for the incomplete beta (Numerical Recipes'
# betacf): relative stopping tolerance, the zero guard, the iteration cap
# and how often the loop reads its convergence flag back from the device.
_CF_EPS = 1e-15
_CF_TINY = 1e-300
_CF_MAX_ITER = 10_000
_CF_CHECK_EVERY = 16


def _as_kq(x, device=None) -> torch.Tensor:
    if not isinstance(x, torch.Tensor) or device is not None:
        x = torch.as_tensor(x, device=resolve_device(device))
    x = x.to(torch.float32)
    if x.ndim != 2:
        raise ValueError(
            f"expected a [K, Q] score matrix, got shape {tuple(x.shape)}")
    if x.shape[1] < 2:
        raise ValueError(
            f"need at least 2 paired queries, got Q={x.shape[1]}")
    return x


def _nonzero(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v.abs() < _CF_TINY, _CF_TINY, v)


def _betacf(a, b, x):
    """Continued fraction of I_x(a, b) (modified Lentz), float64.

    A non-finite ``x`` counts as converged from the start and gives NaN.
    """
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = torch.ones_like(x)
    d = 1.0 / _nonzero(1.0 - qab * x / qap)
    done = ~torch.isfinite(x)
    h = torch.where(done, math.nan, d)
    for m in range(1, _CF_MAX_ITER + 1):
        m2 = 2.0 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 / _nonzero(1.0 + aa * d)
        c = _nonzero(1.0 + aa / c)
        step = d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 / _nonzero(1.0 + aa * d)
        c = _nonzero(1.0 + aa / c)
        delta = d * c
        h = torch.where(done, h, h * step * delta)
        done = done | ((delta - 1.0).abs() < _CF_EPS)
        if m % _CF_CHECK_EVERY == 0 and bool(done.all()):
            return h
    raise RuntimeError("betainc: continued fraction did not converge in "
                       f"{_CF_MAX_ITER} iterations")


def betainc(a, b, x) -> torch.Tensor:
    """Regularized incomplete beta ``I_x(a, b)`` in float64.

    ``a``, ``b`` > 0 and ``x`` broadcast together; scalars are placed on
    ``x``'s device.  The continued fraction converges fast for
    ``x < (a+1)/(a+b+2)``; above it the symmetry
    ``I_x(a, b) = 1 - I_{1-x}(b, a)`` is used.  ``I_0 = 0`` and ``I_1 = 1``;
    a NaN ``x`` gives NaN, as ``jax.scipy.special.betainc`` does.

    >>> round(float(betainc(0.5, 0.5, torch.tensor(0.5))), 12)
    0.5
    """
    x = torch.as_tensor(x, dtype=_F64)
    a = torch.as_tensor(a, dtype=_F64, device=x.device)
    b = torch.as_tensor(b, dtype=_F64, device=x.device)
    a, b, x = torch.broadcast_tensors(a, b, x)
    swap = x > (a + 1.0) / (a + b + 2.0)
    aa = torch.where(swap, b, a)
    bb = torch.where(swap, a, b)
    xx = torch.clamp(torch.where(swap, 1.0 - x, x), 0.0, 1.0)
    log_front = (torch.lgamma(a + b) - torch.lgamma(aa) - torch.lgamma(bb)
                 + aa * torch.log(xx) + bb * torch.log1p(-xx))
    val = torch.exp(log_front) * _betacf(aa, bb, xx) / aa
    val = torch.where(swap, 1.0 - val, val)
    return torch.where(x <= 0.0, 0.0, torch.where(x >= 1.0, 1.0, val))


def paired_diff_means(x, device=None) -> torch.Tensor:
    """``[K, K]`` matrix of mean per-query differences ``mean_q(x_i - x_j)``.

    Antisymmetric with a zero diagonal; entry ``[i, j] > 0`` means system
    ``i`` beats system ``j`` on average.

    >>> paired_diff_means([[1.0, 1.0], [0.0, 0.5]], device="cpu").tolist()
    [[0.0, 0.75], [-0.75, 0.0]]
    """
    x = _as_kq(x, device)
    row = x.mean(dim=1)
    return row[:, None] - row[None, :]


def _structure(mat, diag, *, anti: bool = False):
    """Enforce exact (anti)symmetry + a fixed diagonal on a [K, K] matrix.

    The two broadcast operands of ``a - a.T``-style expressions may reduce
    in different orders, leaving ~1e-8 noise where the math says exactly 0,
    so the structural invariants (which the corrections rely on) are
    imposed from the upper triangle.
    """
    upper = torch.triu(mat, 1)
    eye = torch.eye(mat.shape[0], dtype=mat.dtype, device=mat.device)
    return upper + (-upper.T if anti else upper.T) + diag * eye


def paired_t_matrix(x, device=None):
    """All-pairs two-sided paired t-test: ``(t, p)``, each ``[K, K]``.

    ``t`` is antisymmetric with a zero diagonal; ``p`` is symmetric with a
    unit diagonal.  Equivalent to ``scipy.stats.ttest_rel(x[i], x[j])`` for
    every pair.  Degenerate pairs: all-zero differences give t = 0 / p = 1;
    a constant non-zero difference gives t = ±inf / p = 0 (scipy's limits).

    >>> t, p = paired_t_matrix([[0.9, 0.8, 0.7, 0.6], [0.1, 0.2, 0.3, 0.4]],
    ...                        device="cpu")
    >>> float(t[0, 0]), float(p[0, 0]), bool(abs(t[0, 1]) > 2)
    (0.0, 1.0, True)
    """
    x = _as_kq(x, device)
    q = x.shape[1]
    d = x[:, None, :] - x[None, :, :]  # [K, K, Q] paired differences
    mean = d.mean(dim=-1)
    var = ((d - mean[..., None]) ** 2).sum(dim=-1) / (q - 1)
    se = torch.sqrt(var / q)
    t = torch.where(se > 0, mean / torch.where(se > 0, se, 1.0),
                    torch.where(mean == 0, 0.0, torch.sign(mean) * math.inf))
    df = float(q - 1)
    t64 = t.to(_F64)
    tail_x = df / (df + t64 * t64)  # t=0 → 1 → p=1; t=±inf → 0 → p=0
    p = betainc(df / 2.0, 0.5, tail_x).to(torch.float32)
    return _structure(t, 0.0, anti=True), _structure(p, 1.0)


def _exceed_counts(x: torch.Tensor, blocks: Iterator[torch.Tensor]
                   ) -> torch.Tensor:
    """``[K, K]`` int64: sign patterns whose |permuted mean difference|
    reaches the observed one, summed over ``blocks`` of ``[B, Q]`` float64
    ±1 patterns."""
    k, q = x.shape
    x64 = x.to(_F64)
    row = x64.sum(dim=1) / q
    obs = (row[:, None] - row[None, :]).abs()
    thresh = (obs * (1.0 - _TIE_RTOL) - 1e-12)[..., None]
    count = torch.zeros((k, k), dtype=torch.int64, device=x.device)
    for signs in blocks:
        # Per-pair permuted mean difference = (s·x_i - s·x_j) / Q: the
        # [K, B] projections first turn O(K²·B·Q) into O(K·B·Q + K²·B).
        proj = x64 @ signs.T / q
        perm = (proj[:, None, :] - proj[None, :, :]).abs()
        count += (perm >= thresh).sum(dim=-1)
    return count


def _block(k: int) -> int:
    return max(1, _BLOCK_ELEMS // (k * k))


def paired_permutation_matrix(x, n_permutations: int = 2000,
                              generator: Optional[torch.Generator] = None,
                              seed: int = 0, device=None) -> torch.Tensor:
    """All-pairs paired (sign-flip) permutation test p-values, ``[K, K]``.

    The null hypothesis for pair ``(i, j)`` is that the per-query
    differences are symmetric around 0; the statistic is the absolute mean
    difference under ``n_permutations`` random sign flips (one shared sign
    matrix drives every pair).  The signs come from ``generator``, or from
    a new one on ``x``'s device seeded with ``seed``.  Add-one smoothing:
    the smallest p-value is ``1 / (n_permutations + 1)``; the diagonal is
    exactly 1.

    >>> x = [[0.9, 0.8, 0.7, 0.9, 0.8], [0.1, 0.2, 0.3, 0.1, 0.2]]
    >>> p = paired_permutation_matrix(x, n_permutations=500, device="cpu")
    >>> float(p[0, 0]), bool(p[0, 1] < 0.2), bool(p[0, 1] == p[1, 0])
    (1.0, True, True)
    """
    x = _as_kq(x, device)
    if n_permutations < 1:
        raise ValueError(f"need n_permutations >= 1, got {n_permutations}")
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(seed)
    k, q = x.shape
    bits = torch.randint(0, 2, (n_permutations, q), generator=generator,
                         device=x.device, dtype=torch.int8)
    step = _block(k)
    count = _exceed_counts(x, (bits[lo:lo + step].to(_F64) * 2.0 - 1.0
                               for lo in range(0, n_permutations, step)))
    denom = torch.tensor(n_permutations + 1.0, device=x.device)
    return _structure((count.to(torch.float32) + 1.0) / denom, 1.0)


def paired_permutation_exact(x, device=None) -> torch.Tensor:
    """Exact sign-flip permutation p-values by full 2^Q enumeration.

    Only feasible for tiny query sets (``Q <= 20``); the ground truth the
    Monte Carlo :func:`paired_permutation_matrix` is tested against.
    Pattern ``b`` flips query ``i`` iff bit ``i`` of ``b`` is 0.

    >>> paired_permutation_exact([[1.0, 2.0], [0.0, 0.0]],
    ...                          device="cpu").tolist()
    [[1.0, 0.5], [0.5, 1.0]]
    """
    x = _as_kq(x, device)
    k, q = x.shape
    if q > EXACT_ENUMERATION_MAX_Q:
        raise ValueError(
            f"exact enumeration is 2^Q patterns; Q={q} exceeds "
            f"the cap of {EXACT_ENUMERATION_MAX_Q}")
    n = 1 << q
    step = _block(k)
    shifts = torch.arange(q, device=x.device)

    def blocks():
        for lo in range(0, n, step):
            b = torch.arange(lo, min(lo + step, n), device=x.device)
            yield ((b[:, None] >> shifts[None, :]) & 1).to(_F64) * 2.0 - 1.0

    # no smoothing: this IS the full null distribution (the identity
    # pattern is one of the 2^Q, so the count is always >= 1)
    count = _exceed_counts(x, blocks())
    return _structure(count.to(torch.float32) / float(n), 1.0)


def significance_report(x, *, tests: Sequence[str] = ("t",),
                        n_permutations: int = 2000,
                        seed: int = 0, device=None) -> Dict[str, np.ndarray]:
    """The full comparison bundle for one ``[K, Q]`` score matrix.

    Returns numpy host arrays: ``means`` ``[K]``; ``diff``, ``t``, ``p``,
    ``p_holm``, ``p_bonferroni`` ``[K, K]`` (always present);
    ``p_permutation``, ``p_permutation_holm``, ``p_permutation_bonferroni``
    only when ``"permutation"`` is in ``tests``.

    >>> rep = significance_report([[1.0, 0.9, 0.8], [0.1, 0.2, 0.3]],
    ...                           device="cpu")
    >>> sorted(rep)
    ['diff', 'means', 'p', 'p_bonferroni', 'p_holm', 't']
    """
    unknown = set(tests) - {"t", "permutation"}
    if unknown:
        raise ValueError(f"unknown significance tests: {sorted(unknown)} "
                         "(expected 't' and/or 'permutation')")
    x = _as_kq(x, device)
    t, p = paired_t_matrix(x)

    def host(a):
        return a.cpu().numpy()

    out = {
        "means": host(x.mean(dim=1)),
        "diff": host(paired_diff_means(x)),
        "t": host(t),
        "p": host(p),
        "p_holm": host(holm_matrix(p)),
        "p_bonferroni": host(bonferroni_matrix(p)),
    }
    if "permutation" in tests:
        pp = paired_permutation_matrix(x, n_permutations=n_permutations,
                                       seed=seed)
        out["p_permutation"] = host(pp)
        out["p_permutation_holm"] = host(holm_matrix(pp))
        out["p_permutation_bonferroni"] = host(bonferroni_matrix(pp))
    return out
