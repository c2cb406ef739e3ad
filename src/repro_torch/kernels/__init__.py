"""Hand-written CUDA kernels (Hopper, sm_90a) and their plain versions.

* ``topk``            — per-row top-k over the document axis.
* ``fused_measures``  — every standard trec_eval column in one pass.
* ``embedding_bag``   — weighted sum of table rows per bag.
* ``bucketing``       — power-of-two shape classes.

Each kernel module holds its wrapper (kernel for CUDA tensors, plain
PyTorch version for CPU tensors) and a launch counter; ``ops`` is the
public surface, ``ref`` the oracles, ``_build`` the nvcc/ctypes loader.
"""

from repro_torch.kernels import bucketing  # noqa: F401  (imported first)
from repro_torch.kernels import ops, ref  # noqa: F401
