"""Statistical comparison of evaluation sweeps, in PyTorch.

The port of ``repro.stats``: paired t-tests and paired (sign-flip)
permutation tests over per-query scores for **all K×K system pairs at
once**, as batched tensor reductions on the device, with Bonferroni and
Holm corrections applied to the p-value matrix the same way.  One
``[K, Q]`` score matrix in, dense ``[K, K]`` statistic / p-value matrices
out.

This package imports nothing from :mod:`repro_torch.core`: the sweep that
produces the ``[K, Q]`` matrices is
:func:`repro_torch.core.sweep.evaluate_sweep`, and the CLI is
``python -m repro_torch.compare``.

>>> x = [[0.6, 0.7, 0.5, 0.8], [0.5, 0.5, 0.4, 0.6], [0.1, 0.2, 0.1, 0.2]]
>>> t, p = paired_t_matrix(x, device="cpu")
>>> tuple(t.shape), float(t[0, 0]), bool(p[0, 2] < p[0, 1])
((3, 3), 0.0, True)
"""

from repro_torch.stats.corrections import bonferroni_matrix, holm_matrix
from repro_torch.stats.significance import (EXACT_ENUMERATION_MAX_Q,
                                            paired_diff_means,
                                            paired_t_matrix,
                                            paired_permutation_exact,
                                            paired_permutation_matrix,
                                            significance_report)

__all__ = [
    "EXACT_ENUMERATION_MAX_Q",
    "paired_diff_means",
    "paired_t_matrix",
    "paired_permutation_matrix",
    "paired_permutation_exact",
    "significance_report",
    "bonferroni_matrix",
    "holm_matrix",
]
