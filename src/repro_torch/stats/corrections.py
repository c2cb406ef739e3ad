"""Multiple-comparison corrections over symmetric K×K p-value matrices.

The port of ``repro.stats.corrections``.  A K-system sweep tests
``m = K·(K-1)/2`` hypotheses at once (one per unordered pair).  Both
corrections treat the strict upper triangle of the ``[K, K]`` matrix as the
family of hypotheses, mirror the result back to a symmetric matrix, and pass
the diagonal (self-comparisons, p = 1) through untouched.  Inputs are
tensors (kept on their device) or array-likes (moved to ``device``, CUDA by
default); the result is a float32 tensor.

* :func:`bonferroni_matrix` — ``min(p · m, 1)``.
* :func:`holm_matrix` — the step-down refinement: the s-th smallest
  p-value is scaled by ``(m - s)`` and a running max enforces
  monotonicity (``holm <= bonferroni`` elementwise).
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device


def _as_square(p, device=None) -> torch.Tensor:
    if not isinstance(p, torch.Tensor) or device is not None:
        p = torch.as_tensor(p, device=resolve_device(device))
    p = p.to(torch.float32)
    if p.ndim != 2 or p.shape[0] != p.shape[1]:
        raise ValueError(f"expected a square [K, K] p-value matrix, "
                         f"got shape {tuple(p.shape)}")
    return p


def bonferroni_matrix(p, device=None) -> torch.Tensor:
    """Bonferroni-correct a symmetric ``[K, K]`` p-value matrix.

    Each off-diagonal entry becomes ``min(p * m, 1)`` with
    ``m = K·(K-1)/2`` tested pairs; the diagonal is returned unchanged.

    >>> p = [[1.0, 0.01, 0.4], [0.01, 1.0, 0.5], [0.4, 0.5, 1.0]]
    >>> bonferroni_matrix(p, device="cpu").double().round(decimals=2).tolist()
    [[1.0, 0.03, 1.0], [0.03, 1.0, 1.0], [1.0, 1.0, 1.0]]
    """
    p = _as_square(p, device)
    k = p.shape[0]
    m = k * (k - 1) // 2
    if m == 0:
        return p
    eye = torch.eye(k, dtype=torch.bool, device=p.device)
    return torch.where(eye, p, torch.clamp(p * m, max=1.0))


def holm_matrix(p, device=None) -> torch.Tensor:
    """Holm step-down correction of a symmetric ``[K, K]`` p-value matrix.

    The strict upper triangle is sorted ascending (stably); the s-th
    smallest raw p-value (0-based) is multiplied by ``(m - s)``, a
    cumulative max makes the adjusted sequence non-decreasing, everything
    is clipped at 1 and mirrored back symmetrically.  The diagonal is
    returned unchanged.

    >>> p = [[1.0, 0.01, 0.04], [0.01, 1.0, 0.03], [0.04, 0.03, 1.0]]
    >>> holm_matrix(p, device="cpu").double().round(decimals=2).tolist()
    [[1.0, 0.03, 0.06], [0.03, 1.0, 0.06], [0.06, 0.06, 1.0]]
    """
    p = _as_square(p, device)
    k = p.shape[0]
    if k < 2:
        return p
    iu, ju = torch.triu_indices(k, k, 1, device=p.device)
    flat = p[iu, ju]
    m = flat.shape[0]
    order = torch.argsort(flat, stable=True)
    scaled = flat[order] * (m - torch.arange(m, dtype=torch.float32,
                                             device=p.device))
    adjusted = torch.clamp(torch.cummax(scaled, dim=0).values, max=1.0)
    restored = torch.empty_like(flat)
    restored[order] = adjusted  # undo the sort
    out = p.clone()
    out[iu, ju] = restored
    out[ju, iu] = restored
    return out
