"""EmbeddingBag: the hand-written CUDA kernel and its plain PyTorch version.

The counterpart of ``repro.kernels.embedding_bag``: the weighted sum of
table rows per bag, ``out[b] = Σ_{i: seg[i]=b} w[i] · table[idx[i]]``,
each bag summed in lookup order, an empty bag 0.  The kernel
(``csrc/embedding_bag.cu``) gives one thread to each (bag, column) pair
and has two entry points:

* :func:`embedding_bag_fixed` — bags of a fixed length m, ids ``[N, m]``
  with a bool mask (the recsys multi-hot fields): no sort, no offsets, no
  host sync; an id out of range stops the kernel on the device.  Bag n may belong to field
  ``n % fields`` with ids offset by ``field · field_rows``, so one launch
  covers every multi-hot field of a batch.
* :func:`embedding_bag` — lookups in any order: the wrapper stable-sorts
  them by bag id and builds CSR offsets with plain torch ops, as the JAX
  wrapper sorts around its Pallas kernel, and checks ids on the host.

Each launches the kernel for a CUDA tensor and uses its plain version
(:func:`embedding_bag_fixed_plain`, :func:`embedding_bag_plain`) only for
a CPU tensor.  ``LAUNCHES`` counts the kernel launches of both, as their
C entry points report them.  :func:`embedding_bag_fixed` calls the
``torch.library`` op ``repro_torch::embedding_bag_fixed``, which
PyTorch's dispatcher sends by the tensors' device: the kernel, the plain
version, or for ``meta`` tensors an empty output of the right shape (a
dispatch mode sees the call as one op: the dry run counts its bytes).

Training differentiates the fixed-length entry through
:func:`embedding_bag_fixed_grad`, a ``torch.autograd.Function`` whose
forward is :func:`embedding_bag_fixed` and whose backward is
:func:`embedding_bag_fixed_backward`: the table's gradient, each bag's
gradient row times its mask entry added into the rows of its lookups, in
lookup order.  On the card that is a second kernel of
``csrc/embedding_bag.cu`` (``embedding_bag_fixed_backward_launch``; it
replaces no Pallas kernel, since the JAX package trains without its
kernel and lets XLA form the scatter): the wrapper groups the lookups by
row (one stable ``torch.sort`` of 32-bit row keys, the ids plus their
field offsets in one pass, and ``torch.searchsorted`` for each slab's
first lookup) and one launch writes every byte of the dense ``[V, E]``
gradient once, slab by slab from shared memory, with no zero fill
before it (``csrc/embedding_bag_bwd.cuh``), deterministic and bit for
bit the CPU plain version.  Its bound is that dense gradient written
once, plus the ids, mask and output gradient read once.
``BACKWARD_LAUNCHES`` counts its launches.  On the CPU it is
:func:`embedding_bag_fixed_backward_plain`.  It too is a ``torch.library``
op, ``repro_torch::embedding_bag_fixed_backward``, with CPU, CUDA and
Meta implementations, so the dry run's train cells count it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: kernel launches since the count was last set to 0 (plain calls excluded)
LAUNCHES = 0
#: launches of the backward kernel, counted the same way
BACKWARD_LAUNCHES = 0

_MAX_BLOCKS = 2**31 - 1
_THREADS = 256
#: widest row the backward kernel takes (``csrc/embedding_bag_bwd.cuh``:
#: 32 lookups of a chunk fill its 8,192 staged floats)
MAX_BACKWARD_WIDTH = 256
#: the floats of the backward kernel's slab in shared memory at most
#: (``kSlabFloats``, 20 KB)
SLAB_FLOATS = 5120
#: the backward kernel's 32-bit row keys, with room for one slab past V
_MAX_KEY_ROWS = 2**31 - 2**14


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


def _lib(entry="embedding_bag_launch"):
    fn = getattr(_build.load("embedding_bag"), entry)
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = {
            "embedding_bag_launch": [p, p, p, p, p, ll, i, p],
            "embedding_bag_fixed_launch": [p, ll, i, p, p, ll, i, i, ll, i,
                                           p, p],
            "embedding_bag_fixed_backward_launch": [p, p, p, p, p, ll, i,
                                                    i, ll, i, p, p],
        }[entry] + [ctypes.POINTER(ctypes.c_int)]
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
    launched = ctypes.c_int(0)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = _lib()(table.data_ptr(), idx_s.data_ptr(), w_s.data_ptr(),
                    offsets.data_ptr(), out.data_ptr(), n_bags, e, stream,
                    ctypes.byref(launched))
    if rc != 0:
        raise RuntimeError(
            f"embedding_bag kernel launch failed: CUDA error {rc}")
    LAUNCHES += launched.value  # none for an empty grid
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


def _field_rows(n, fields, field_rows, device):
    """``[n, 1]`` row offsets of bags 0..n-1: ``(bag % fields) ·
    field_rows``."""
    return (torch.arange(n, device=device) % fields * field_rows)[:, None]


def embedding_bag_fixed_plain(table, ids, mask=None, fields: int = 1,
                              field_rows: int = 0):
    """Gather, multiply by the mask (1 / 0), and add the m lookups of each
    bag in order from 0: the kernel's sum, one rounded operation at a
    time."""
    n, m = ids.shape
    rows = ids.long()
    if field_rows:
        rows = rows + _field_rows(n, fields, field_rows, ids.device)
    x = table[rows]  # [n, m, E]
    if mask is not None:
        x = x * mask.to(table.dtype)[..., None]
    out = torch.zeros((n, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    for j in range(m):
        out = out + x[:, j]
    return out


def embedding_bag_fixed(table: torch.Tensor, ids: torch.Tensor,
                        mask: torch.Tensor | None = None,
                        fields: int = 1, field_rows: int = 0) -> torch.Tensor:
    """Masked sum of the m rows of each fixed-length bag → ``[N, E]`` f32.

    ``table`` ``[V, E]`` f32; ``ids`` ``[N, m]`` int32, bag n's lookups in
    order; ``mask`` ``[N, m]`` bool (each lookup weighs 1 / 0), default
    all 1.  Bag n's ids are offset by ``(n % fields) · field_rows``.  A
    CUDA tensor goes through the kernel: the checks below need no sync,
    and a row outside ``[0, V)`` stops the kernel with a device-side trap
    (the error shows at the next synchronisation).  A CPU tensor goes
    through :func:`embedding_bag_fixed_plain`, after a range check that
    raises.
    """
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"table must be [V, E] and ids [N, m], got "
                         f"{tuple(table.shape)} and {tuple(ids.shape)}")
    if mask is not None and (mask.shape != ids.shape
                             or mask.dtype != torch.bool):
        raise ValueError("mask must be a bool [N, m] like ids")
    if fields < 1 or field_rows < 0:
        raise ValueError(f"need fields >= 1 and field_rows >= 0, got "
                         f"{fields}, {field_rows}")
    tensors = [table, ids] + ([] if mask is None else [mask])
    if any(t.device != table.device for t in tensors):
        raise ValueError("table, ids and mask must lie on one device")
    return torch.ops.repro_torch.embedding_bag_fixed(
        table, ids, mask, int(fields), int(field_rows))


def _fixed_cpu(table, ids, mask, fields, field_rows):
    if ids.is_floating_point():
        raise ValueError("ids must be an integer tensor")
    rows = ids.long()
    if field_rows and ids.numel():
        rows = rows + _field_rows(ids.shape[0], fields, field_rows,
                                  ids.device)
    if ids.numel() and bool(((rows < 0) | (rows >= table.shape[0])).any()):
        raise ValueError(f"a row is outside [0, {table.shape[0]})")
    return embedding_bag_fixed_plain(table, ids, mask, fields, field_rows)


def _fixed_cuda(table, ids, mask, fields, field_rows):
    if table.dtype != torch.float32 or not table.is_contiguous():
        raise ValueError("table must be a contiguous float32 tensor")
    if ids.dtype != torch.int32 or not ids.is_contiguous():
        raise ValueError("ids must be a contiguous int32 tensor")
    if mask is not None and not mask.is_contiguous():
        raise ValueError("mask must be contiguous")
    n, m = ids.shape
    v, e = table.shape
    out = torch.empty((n, e), dtype=torch.float32, device=table.device)
    if n == 0 or e == 0:
        return out
    vec2 = e % 2 == 0 and table.data_ptr() % 8 == 0
    if -(-n * (e // 2 if vec2 else e) // _THREADS) > _MAX_BLOCKS:
        raise ValueError(f"{n} bags x {e} columns exceed one grid")
    launched = ctypes.c_int(0)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = _lib("embedding_bag_fixed_launch")(
            table.data_ptr(), v, e, ids.data_ptr(),
            0 if mask is None else mask.data_ptr(), n, m,
            fields, field_rows, int(vec2), out.data_ptr(), stream,
            ctypes.byref(launched))
    if rc != 0:
        raise RuntimeError(
            f"embedding_bag kernel launch failed: CUDA error {rc}")
    global LAUNCHES
    LAUNCHES += launched.value
    return out


def _fixed_meta(table, ids, mask, fields, field_rows):
    return table.new_empty((ids.shape[0], table.shape[1]),
                           dtype=torch.float32)


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("embedding_bag_fixed(Tensor table, Tensor ids, Tensor? mask, "
            "int fields, int field_rows) -> Tensor")
_LIB.impl("embedding_bag_fixed", _fixed_cpu, "CPU")
_LIB.impl("embedding_bag_fixed", _fixed_cuda, "CUDA")
_LIB.impl("embedding_bag_fixed", _fixed_meta, "Meta")


def _fixed_rows(ids, fields: int, field_rows: int) -> torch.Tensor:
    """``[N, m]`` int64 table rows of fixed-length bags: ids plus
    ``(n % fields) · field_rows``."""
    rows = ids.long()
    if field_rows and ids.numel():
        rows = rows + _field_rows(ids.shape[0], fields, field_rows,
                                  ids.device)
    return rows


def embedding_bag_fixed_backward_plain(grad, ids, mask, num_rows: int,
                                       fields: int = 1, field_rows: int = 0):
    """The table's gradient ``[num_rows, E]``: ``grad[n] · mask[n, j]``
    added into row ``row(n, j)`` with ``index_add_``, which on the CPU
    adds in lookup order from zero, one rounded operation at a time, as
    the kernel does (on CUDA it adds with atomics, in no fixed order)."""
    n, m = ids.shape
    e = grad.shape[1]
    x = grad[:, None, :].expand(n, m, e)
    if mask is not None:
        x = x * mask.to(grad.dtype)[..., None]
    out = torch.zeros((num_rows, e), dtype=grad.dtype, device=grad.device)
    return out.index_add_(0, _fixed_rows(ids, fields, field_rows).reshape(-1),
                          x.reshape(n * m, e))


def embedding_bag_fixed_backward(grad: torch.Tensor, ids: torch.Tensor,
                                 mask: torch.Tensor | None, num_rows: int,
                                 fields: int = 1,
                                 field_rows: int = 0) -> torch.Tensor:
    """Gradient of :func:`embedding_bag_fixed` with respect to its table
    ``[num_rows, E]``, given ``grad`` ``[N, E]`` of its output.

    A CUDA tensor (int32 ids) goes through the backward kernel: the
    wrapper stable-sorts the lookups' 32-bit rows (no host sync) and one
    launch writes the whole gradient, each row summed in lookup order
    (the same bits on every launch), an untouched row 0.  A row outside
    ``[0, num_rows)`` stops the kernel with a device-side trap.  A CPU
    tensor goes through :func:`embedding_bag_fixed_backward_plain`."""
    if grad.dim() != 2 or ids.dim() != 2 or grad.shape[0] != ids.shape[0]:
        raise ValueError(f"grad must be [N, E] and ids [N, m], got "
                         f"{tuple(grad.shape)} and {tuple(ids.shape)}")
    if mask is not None and (mask.shape != ids.shape
                             or mask.dtype != torch.bool):
        raise ValueError("mask must be a bool [N, m] like ids")
    tensors = [grad, ids] + ([] if mask is None else [mask])
    if any(t.device != grad.device for t in tensors):
        raise ValueError("grad, ids and mask must lie on one device")
    if ids.is_floating_point():
        raise ValueError("ids must be an integer tensor")
    return torch.ops.repro_torch.embedding_bag_fixed_backward(
        grad, ids, mask, int(num_rows), int(fields), int(field_rows))


def _backward_cuda(grad, ids, mask, num_rows, fields, field_rows):
    if grad.dtype != torch.float32 or not grad.is_contiguous():
        raise ValueError("grad must be a contiguous float32 tensor")
    if ids.dtype != torch.int32 or not ids.is_contiguous():
        raise ValueError("ids must be a contiguous int32 tensor")
    if mask is not None and not mask.is_contiguous():
        raise ValueError("mask must be contiguous")
    e = grad.shape[1]
    if e > MAX_BACKWARD_WIDTH:
        raise ValueError(f"the backward kernel takes rows of at most "
                         f"{MAX_BACKWARD_WIDTH} floats, got {e}")
    if num_rows > _MAX_KEY_ROWS or (fields - 1) * field_rows > _MAX_KEY_ROWS:
        raise ValueError(f"the backward kernel sorts 32-bit rows: "
                         f"{num_rows} rows or field offsets up to "
                         f"{(fields - 1) * field_rows} exceed {_MAX_KEY_ROWS}")
    return launch_backward(grad, mask, ids.shape[1], num_rows,
                           *prepare_backward(ids, num_rows, e, fields,
                                             field_rows))


def _backward_meta(grad, ids, mask, num_rows, fields, field_rows):
    return grad.new_empty((num_rows, grad.shape[1]), dtype=torch.float32)


_LIB.define("embedding_bag_fixed_backward(Tensor grad, Tensor ids, "
            "Tensor? mask, int num_rows, int fields, int field_rows) "
            "-> Tensor")
_LIB.impl("embedding_bag_fixed_backward", embedding_bag_fixed_backward_plain,
          "CPU")
_LIB.impl("embedding_bag_fixed_backward", _backward_cuda, "CUDA")
_LIB.impl("embedding_bag_fixed_backward", _backward_meta, "Meta")


def _rows32(ids, fields: int, field_rows: int) -> torch.Tensor:
    """``[N, m]`` int32 table rows of fixed-length bags, ids plus ``(n %
    fields) · field_rows``, in one pass over the ids (the ids themselves
    when every offset is 0)."""
    n, m = ids.shape
    if fields == 1 or not field_rows or n == 0:
        return ids
    offsets = torch.arange(0, fields * field_rows, field_rows,
                           dtype=torch.int32, device=ids.device)
    if n % fields == 0:
        return (ids.view(n // fields, fields, m) + offsets[:, None]).view(n, m)
    return ids + offsets.repeat(-(-n // fields))[:n, None]


def slab_rows(width: int) -> int:
    """Rows of the backward kernel's slab for rows of ``width`` floats: as
    many as :data:`SLAB_FLOATS` holds, a multiple of 4."""
    return (SLAB_FLOATS // width) & ~3


def prepare_backward(ids, num_rows: int, width: int, fields: int = 1,
                     field_rows: int = 0):
    """The backward kernel's grouping: the lookups' table rows as int32
    keys, stable-sorted (those of one row in lookup order), each one's
    position ``n·m + j`` (int64), and the first sorted lookup of each slab
    of :func:`slab_rows` of ``width`` rows, the last entry the number of
    lookups (int64 ``[ceil(num_rows / R) + 1]``)."""
    r = slab_rows(width)
    keys, order = torch.sort(_rows32(ids, fields, field_rows).reshape(-1),
                             stable=True)
    edges = torch.arange(0, (-(-num_rows // r) + 1) * r, r,
                         dtype=torch.int32, device=ids.device)
    return keys, order, torch.searchsorted(keys, edges)


def launch_backward(grad, mask, m: int, num_rows: int, keys, order, starts):
    """One backward kernel launch on prepared inputs (see
    :func:`prepare_backward`) into a new ``[num_rows, E]``, every float of
    which the kernel writes."""
    global BACKWARD_LAUNCHES
    e = grad.shape[1]
    out = torch.empty((num_rows, e), dtype=torch.float32, device=grad.device)
    if out.data_ptr() % 16:
        raise ValueError("the gradient must start on 16 bytes")
    launched = ctypes.c_int(0)
    with torch.cuda.device(grad.device):
        stream = torch.cuda.current_stream(grad.device).cuda_stream
        rc = _lib("embedding_bag_fixed_backward_launch")(
            keys.data_ptr(), order.data_ptr(), starts.data_ptr(),
            grad.data_ptr(), 0 if mask is None else mask.data_ptr(),
            keys.numel(), m, e, num_rows, slab_rows(e), out.data_ptr(),
            stream, ctypes.byref(launched))
    if rc != 0:
        raise RuntimeError(
            f"embedding_bag backward kernel launch failed: CUDA error {rc}")
    BACKWARD_LAUNCHES += launched.value  # none for an empty gradient
    return out


class _EmbeddingBagFixed(torch.autograd.Function):
    """:func:`embedding_bag_fixed` with a gradient for its table."""

    @staticmethod
    def forward(ctx, table, ids, mask, fields, field_rows):
        ctx.save_for_backward(ids, mask)
        ctx.shape = (table.shape[0], fields, field_rows)
        return embedding_bag_fixed(table, ids, mask, fields, field_rows)

    @staticmethod
    def backward(ctx, grad):
        ids, mask = ctx.saved_tensors
        num_rows, fields, field_rows = ctx.shape
        d_table = embedding_bag_fixed_backward(grad.contiguous(), ids, mask,
                                               num_rows, fields, field_rows)
        return d_table, None, None, None, None


def embedding_bag_fixed_grad(table: torch.Tensor, ids: torch.Tensor,
                             mask: torch.Tensor | None = None,
                             fields: int = 1,
                             field_rows: int = 0) -> torch.Tensor:
    """:func:`embedding_bag_fixed` recorded for autograd: its backward
    gives the table the gradient of :func:`embedding_bag_fixed_backward`
    (ids and mask get none)."""
    return _EmbeddingBagFixed.apply(table, ids, mask, fields, field_rows)
