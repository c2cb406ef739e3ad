"""Per-row top-k: the hand-written CUDA kernel and its plain PyTorch version.

The counterpart of ``repro.kernels.topk`` + ``repro.kernels.bitonic``.  The
kernel (``csrc/topk.cu``) packs each (score, column) into a 64-bit key,
stages only the keys above the block's running k-th, keeps the k largest
with radix selects, and bitonic-sorts the final k (padded to
``k2 = next_pow2(k, 128)``) in shared memory.  When Q rows cannot fill
the card, each row is cut into S chunks: pass 1 writes every chunk's
top-k keys to scratch ``[Q, S, k]``, pass 2 merges them (:func:`splits`).
Order: value descending, ties to the lower column (``jax.lax.top_k``'s
rule), and every NaN, whatever its sign or payload, after every number
(-inf included), NaNs among themselves by column.  That is the full sort's
order (``core.sorting.sort_key``: NaN after the -inf padding of the top-k
layout), so the depth-bounded route ranks NaN scores as the full-sort
route does; the JAX Pallas kernel has no order for NaN.  Rows shorter
than k come back padded with -inf and out-of-range indices (>= D), as from
the Pallas kernel.

:func:`topk` calls the ``torch.library`` op ``repro_torch::topk``, which
PyTorch's dispatcher sends by the tensor's device: the kernel for a CUDA
tensor, :func:`topk_plain` for a CPU tensor, and for a ``meta`` tensor
empty outputs of the right shapes (a dispatch mode sees the call as one
op: the dry run counts its bytes).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bucketing import next_pow2

#: calls that launched the kernel since the count was last set to 0 (one
#: per call, whether it ran one pass or two; plain calls excluded)
LAUNCHES = 0
#: kernels those calls launched, as the C entry reports them (two a call
#: when rows are split)
KERNEL_LAUNCHES = 0


def geometry(k: int):
    """(k2, block_d) for depth k: the running-buffer width, and the Pallas
    kernel's tile width ``max(2·k2, 512)``; a split chunk holds at least
    two such tiles."""
    k2 = next_pow2(k, 128)
    return k2, max(2 * k2, 512)


def splits(q: int, d: int, k: int, n_sm: int) -> int:
    """Chunks per row: 1 (one pass) when ``q`` fills ``2·n_sm`` blocks;
    else enough blocks to fill the card, at most ``sqrt(D / k2)`` (pass 1
    reads D / S scores a block, pass 2 S·k candidates: the two balance
    there) and at least ``2·block_d`` columns a chunk."""
    if q >= 2 * n_sm:
        return 1
    k2, block_d = geometry(k)
    s = min(-(-2 * n_sm // q), d // (2 * block_d), math.isqrt(d // k2))
    return max(1, s)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def topk_plain(scores: torch.Tensor, k: int):
    """Top-k (values, indices) of each row by a stable descending sort.

    ``-0.0`` is ordered as ``+0.0`` (the kernel's ``==`` tie), every NaN
    after every number (a second stable sort on the NaN flag; ``torch.sort``
    alone puts NaN first), and rows shorter than k are padded with -inf
    values and zero indices.
    """
    q, d = scores.shape
    nan = torch.isnan(scores)
    key = torch.where(scores == 0, 0.0, scores).masked_fill(nan, -torch.inf)
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices
    last = torch.sort(torch.gather(nan, -1, order).to(torch.uint8), dim=-1,
                      stable=True).indices
    order = torch.gather(order, -1, last)
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
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_longlong, p,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    return fn


def topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (values ``[Q, k]`` f32, indices ``[Q, k]`` i32) of each row.

    A CUDA tensor goes through the kernel (one call: one launch, or two
    when rows are split); a CPU tensor through :func:`topk_plain`.
    """
    if scores.dim() != 2:
        raise ValueError(f"scores must be [Q, D], got {tuple(scores.shape)}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    return torch.ops.repro_torch.topk(scores, int(k))


def _topk_cuda(scores: torch.Tensor, k: int):
    if scores.dtype != torch.float32 or not scores.is_contiguous():
        raise ValueError("scores must be a contiguous float32 tensor")
    q, d = scores.shape
    k2, _ = geometry(k)
    if k2 > 4096 or d < 1 or d + k2 >= 2**31 - 1:
        raise ValueError(f"kernel takes k <= 4096 and 1 <= D < 2**31 - k2, "
                         f"got k={k}, D={d}")
    dev = scores.device
    out_v = torch.empty((q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    if q == 0:
        return out_v, out_i
    with torch.cuda.device(dev):
        s = splits(q, d, k, _sm_count(dev.index))
        chunk = -(-d // s)
        s = -(-d // chunk)  # no empty chunk
        # pass 1's per-chunk top-k keys (64-bit: score and column)
        cand = (torch.empty((q, s, k), dtype=torch.int64, device=dev)
                if s > 1 else None)
        stream = torch.cuda.current_stream(dev).cuda_stream
        launched = ctypes.c_int(0)
        rc = _lib()(scores.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
                    0 if cand is None else cand.data_ptr(), q, d, k, k2, s,
                    chunk, stream, ctypes.byref(launched))
    if rc != 0:
        raise RuntimeError(f"topk kernel launch failed: CUDA error {rc}")
    global LAUNCHES, KERNEL_LAUNCHES
    LAUNCHES += 1
    KERNEL_LAUNCHES += launched.value
    return out_v, out_i


def _topk_meta(scores: torch.Tensor, k: int):
    q = scores.shape[0]
    return (scores.new_empty((q, k), dtype=torch.float32),
            scores.new_empty((q, k), dtype=torch.int32))


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("topk(Tensor scores, int k) -> (Tensor, Tensor)")
_LIB.impl("topk", topk_plain, "CPU")
_LIB.impl("topk", _topk_cuda, "CUDA")
_LIB.impl("topk", _topk_meta, "Meta")
