"""EmbeddingBag: the hand-written CUDA kernel and its plain PyTorch version.

The counterpart of ``repro.kernels.embedding_bag``: the weighted sum of
table rows per bag, ``out[b] = Σ_{i: seg[i]=b} w[i] · table[idx[i]]``,
each bag summed in lookup order, an empty bag 0.  The kernel
(``csrc/embedding_bag.cu``) gives one thread to each (bag, column) pair;
the wrapper stable-sorts the lookups by bag id and builds CSR offsets
around it with plain torch ops, as the JAX wrapper sorts around its Pallas
kernel.

:func:`embedding_bag` launches the kernel for a CUDA tensor and uses
:func:`embedding_bag_plain` only for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: kernel launches since the count was last set to 0 (plain calls excluded)
LAUNCHES = 0

_MAX_BLOCKS = 2**31 - 1
_THREADS = 256


def embedding_bag_plain(table, indices, segment_ids, n_bags, weights=None):
    """``table[idx] * w``, then ``index_add_`` into zeros, in lookup order."""
    rows = table[indices.long()]
    if weights is not None:
        rows = rows * weights[:, None]
    out = torch.zeros((n_bags, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    return out.index_add_(0, segment_ids.long(), rows)


def _check(table, indices, segment_ids, n_bags, weights):
    if table.dim() != 2:
        raise ValueError(f"table must be [V, E], got {tuple(table.shape)}")
    if indices.dim() != 1 or segment_ids.shape != indices.shape:
        raise ValueError("indices and segment_ids must be [L] of one length")
    if weights is not None and weights.shape != indices.shape:
        raise ValueError("weights must be [L] like indices")
    if indices.is_floating_point() or segment_ids.is_floating_point():
        raise ValueError("indices and segment_ids must be integer tensors")
    if n_bags < 0:
        raise ValueError(f"n_bags must be >= 0, got {n_bags}")
    tensors = [table, indices, segment_ids]
    if weights is not None:
        tensors.append(weights)
    if any(t.device != table.device for t in tensors):
        raise ValueError("table, indices, segment_ids and weights must lie "
                         "on one device")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {table.device}")
    if indices.numel() == 0:
        return
    bad = ((indices < 0) | (indices >= table.shape[0])
           | (segment_ids < 0) | (segment_ids >= n_bags)).any()
    if bool(bad):
        raise ValueError(f"an index is outside [0, {table.shape[0]}) or a "
                         f"segment id outside [0, {n_bags})")


def _lib():
    lib = _build.load("embedding_bag")
    fn = lib.embedding_bag_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, ctypes.c_longlong, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def prepare(indices, segment_ids, n_bags, weights=None):
    """The kernel's inputs: lookups stable-sorted by bag id (int32 indices,
    f32 weights) and the CSR offsets ``[n_bags + 1]`` int64."""
    seg_s, order = torch.sort(segment_ids, stable=True)
    idx_s = indices[order].to(torch.int32)
    if weights is None:
        w_s = torch.ones(idx_s.shape, dtype=torch.float32,
                         device=idx_s.device)
    else:
        w_s = weights[order].contiguous()
    bounds = torch.arange(n_bags + 1, dtype=seg_s.dtype, device=seg_s.device)
    offsets = torch.searchsorted(seg_s, bounds)
    return idx_s, w_s, offsets


def launch(table, idx_s, w_s, offsets, n_bags):
    """One kernel launch on prepared inputs (see :func:`prepare`)."""
    global LAUNCHES
    e = table.shape[1]
    out = torch.empty((n_bags, e), dtype=torch.float32, device=table.device)
    if -(-n_bags * e // _THREADS) > _MAX_BLOCKS:
        raise ValueError(f"{n_bags} bags x {e} columns exceed one grid")
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = _lib()(table.data_ptr(), idx_s.data_ptr(), w_s.data_ptr(),
                    offsets.data_ptr(), out.data_ptr(), n_bags, e, stream)
    if rc != 0:
        raise RuntimeError(
            f"embedding_bag kernel launch failed: CUDA error {rc}")
    if n_bags * e:  # the C entry point launches nothing for an empty grid
        LAUNCHES += 1
    return out


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  segment_ids: torch.Tensor, n_bags: int,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted sum of table rows per bag → ``[n_bags, E]`` f32.

    ``table`` ``[V, E]`` f32; ``indices`` and ``segment_ids`` ``[L]``
    integer, in any order (each bag sums its lookups in the order given);
    ``weights`` ``[L]`` f32, default 1.  A CUDA tensor goes through the
    kernel, a CPU tensor through :func:`embedding_bag_plain`.
    """
    _check(table, indices, segment_ids, n_bags, weights)
    if table.device.type == "cpu":
        return embedding_bag_plain(table, indices, segment_ids, n_bags,
                                   weights)
    if table.dtype != torch.float32 or not table.is_contiguous():
        raise ValueError("table must be a contiguous float32 tensor")
    if weights is not None and weights.dtype != torch.float32:
        raise ValueError("weights must be float32")
    if table.shape[0] > 2**31:
        raise ValueError("the kernel takes int32 row indices: V <= 2**31")
    return launch(table, *prepare(indices, segment_ids, n_bags, weights),
                  n_bags)
