"""Per-row top-k: the hand-written CUDA kernel and its plain PyTorch version.

The counterpart of ``repro.kernels.topk`` + ``repro.kernels.bitonic``.  The
kernel (``csrc/topk.cu``) bitonic-sorts each ``block_d`` tile of a row's
(score, column) pairs in shared memory and merges it into a running
``k2 = next_pow2(k, 128)`` buffer; ``block_d = max(2·k2, 512)`` as in the
Pallas kernel.  Order: value descending, ties to the lower column
(``jax.lax.top_k``'s rule).  Rows shorter than k come back padded with
-inf and out-of-range indices (>= D), as from the Pallas kernel.

:func:`topk` launches the kernel for a CUDA tensor and uses
:func:`topk_plain` only for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bucketing import next_pow2

#: kernel launches since the count was last set to 0 (plain calls excluded)
LAUNCHES = 0


def geometry(k: int):
    """(k2, block_d): the running-buffer and tile widths for depth k."""
    k2 = next_pow2(k, 128)
    return k2, max(2 * k2, 512)


def topk_plain(scores: torch.Tensor, k: int):
    """Top-k (values, indices) of each row by a stable descending sort.

    ``-0.0`` is ordered as ``+0.0`` (the kernel's ``==`` tie), and rows
    shorter than k are padded with -inf values and zero indices.
    """
    q, d = scores.shape
    key = torch.where(scores == 0, 0.0, scores)
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices
    idx = order[:, :k].to(torch.int32)
    vals = torch.gather(scores, -1, order[:, :k])
    if k > d:
        vals = torch.cat([vals, torch.full((q, k - d), -torch.inf,
                                           dtype=scores.dtype,
                                           device=scores.device)], -1)
        idx = torch.cat([idx, torch.zeros((q, k - d), dtype=torch.int32,
                                          device=scores.device)], -1)
    return vals, idx


def _lib():
    lib = _build.load("topk")
    fn = lib.topk_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def topk(scores: torch.Tensor, k: int):
    """Top-k (values ``[Q, k]`` f32, indices ``[Q, k]`` i32) of each row.

    A CUDA tensor goes through the kernel; a CPU tensor through
    :func:`topk_plain`.
    """
    if scores.dim() != 2:
        raise ValueError(f"scores must be [Q, D], got {tuple(scores.shape)}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if scores.device.type == "cpu":
        return topk_plain(scores, k)
    if scores.device.type != "cuda":
        raise ValueError(f"unsupported device {scores.device}")
    if scores.dtype != torch.float32 or not scores.is_contiguous():
        raise ValueError("scores must be a contiguous float32 tensor")
    q, d = scores.shape
    k2, block_d = geometry(k)
    if k2 > 4096 or d < 1:
        raise ValueError(f"kernel takes k <= 4096 and D >= 1, got k={k}, "
                         f"D={d}")
    out_v = torch.empty((q, k), dtype=torch.float32, device=scores.device)
    out_i = torch.empty((q, k), dtype=torch.int32, device=scores.device)
    if q == 0:
        return out_v, out_i
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        rc = _lib()(scores.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
                    q, d, k, k2, block_d, stream)
    if rc != 0:
        raise RuntimeError(f"topk kernel launch failed: CUDA error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out_v, out_i
