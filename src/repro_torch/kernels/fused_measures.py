"""Fused one-pass measure computation: the CUDA kernel and its plain version.

The counterpart of ``repro.kernels.fused_measures``: every standard
trec_eval column from the rank-sorted relevance rows in one pass.  The
kernel (``csrc/fused_measures.cu``) walks each row in 256-rank chunks with
warp scans: a warp per row up to D = 2,048, else a block per row (after a
prologue launch that builds the rank-term table; the C entry chooses from
D); :func:`fused_measures_plain` is the same arithmetic as the Pallas
``_kernel`` with ``torch.cumsum``.

Inputs (already rank-sorted by score desc / tiebreak asc):
  rel      [Q, D] f32 — judgment of doc at each rank (0 unjudged/padding)
  judged   [Q, D] f32 — 1.0 where the doc is judged
  scalars  [Q, 16] f32 — col 0: R (n_rel), 1: judged-nonrel count,
           2: full-ranking ideal DCG, 3..11: ideal DCG at the 9 cutoffs.

Output: [Q, 64] f32, columns per :data:`COLUMNS` (zeros after 55).
:func:`fused_measures` launches the kernel for CUDA tensors and uses the
plain version only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.measures import _at_rank as _at
from repro_torch.core.measures import _per_k
from repro_torch.core.measures import _safe_div as _sdiv
from repro_torch.core.registry import DEFAULT_RBP_P
from repro_torch.kernels import _build

CUTOFFS = (5, 10, 15, 20, 30, 100, 200, 500, 1000)
SUCCESS_CUTOFFS = (1, 5, 10)

COLUMNS = (
    ["map", "recip_rank", "ndcg", "bpref", "num_rel_ret", "Rprec"]
    + [f"P_{k}" for k in CUTOFFS]
    + [f"recall_{k}" for k in CUTOFFS]
    + [f"ndcg_cut_{k}" for k in CUTOFFS]
    + [f"map_cut_{k}" for k in CUTOFFS]
    + [f"success_{k}" for k in SUCCESS_CUTOFFS]
    + [f"judged_{k}" for k in CUTOFFS]
    + [f"rbp_{DEFAULT_RBP_P:.2f}"]
)
OUT_WIDTH = 64  # len(COLUMNS) == 55
SCALAR_WIDTH = 16

#: calls that launched the kernel since the count was last set to 0 (one
#: per call; plain calls excluded)
LAUNCHES = 0
#: kernels those calls launched, as the C entry reports them (the rank-term
#: table's prologue and the pass over the rows when rows are long)
KERNEL_LAUNCHES = 0


def fused_measures_plain(rel, judged, scalars, relevance_level: float = 1.0):
    """All 55 columns with ``torch.cumsum``: the Pallas ``_kernel``'s
    arithmetic, expression for expression.  Returns ``[Q, 64]`` f32."""
    q, d = rel.shape
    n_rel = scalars[:, 0]
    n_nonrel = scalars[:, 1]
    ranks = torch.arange(1, d + 1, dtype=torch.float32, device=rel.device)
    binrel = (rel >= relevance_level).to(torch.float32)
    cum = torch.cumsum(binrel, dim=-1)
    prec = cum / ranks
    ap_cum = torch.cumsum(binrel * prec, dim=-1)
    gains = torch.clamp(rel, min=0.0) / torch.log2(ranks + 1.0)
    dcg_cum = torch.cumsum(gains, dim=-1)
    jn = judged * (1.0 - binrel)
    nr_above = torch.cumsum(jn, dim=-1) - jn
    bpref_den = torch.minimum(n_rel, n_nonrel)[:, None]
    bterm = torch.where(
        nr_above > 0,
        1.0 - _sdiv(torch.minimum(nr_above, n_rel[:, None]), bpref_den), 1.0)
    bpref = _sdiv(torch.sum(bterm * binrel, dim=-1), n_rel)
    num_rel_ret = cum[:, -1]
    first_rank = 1.0 + torch.sum((cum == 0).to(torch.float32), dim=-1)
    rr = torch.where(num_rel_ret > 0, 1.0 / first_rank, 0.0)
    within_r = (ranks <= n_rel[:, None]).to(torch.float32)
    rprec = _sdiv(torch.sum(binrel * within_r, dim=-1), n_rel)

    cols = [_sdiv(ap_cum[:, -1], n_rel), rr,
            _sdiv(dcg_cum[:, -1], scalars[:, 2]), bpref, num_rel_ret, rprec]
    cols += [_per_k(_at(cum, k), k) for k in CUTOFFS]
    cols += [_sdiv(_at(cum, k), n_rel) for k in CUTOFFS]
    cols += [_sdiv(_at(dcg_cum, k), scalars[:, 3 + j])
             for j, k in enumerate(CUTOFFS)]
    cols += [_sdiv(_at(ap_cum, k), n_rel) for k in CUTOFFS]
    cols += [(_at(cum, k) > 0).to(torch.float32) for k in SUCCESS_CUTOFFS]
    cum_judged = torch.cumsum(judged, dim=-1)
    cols += [_per_k(_at(cum_judged, k), k) for k in CUTOFFS]
    rbp_w = (1.0 - DEFAULT_RBP_P) * torch.pow(DEFAULT_RBP_P, ranks - 1.0)
    cols.append(torch.sum(binrel * rbp_w, dim=-1))
    out = torch.stack(cols, dim=-1)
    return torch.nn.functional.pad(out, (0, OUT_WIDTH - out.shape[-1]))


def _lib():
    lib = _build.load("fused_measures")
    fn = lib.fused_measures_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, p, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    return fn


def fused_measures(rel_sorted, judged_sorted, scalars,
                   relevance_level: float = 1.0):
    """All 55 standard measure columns in one pass.  Returns [Q, 64] f32.

    CUDA tensors go through the kernel; CPU tensors through
    :func:`fused_measures_plain`.
    """
    if rel_sorted.dim() != 2 or rel_sorted.shape[1] < 1 \
            or judged_sorted.shape != rel_sorted.shape \
            or scalars.shape != (rel_sorted.shape[0], SCALAR_WIDTH):
        raise ValueError(
            f"expected rel, judged [Q, D >= 1] and scalars "
            f"[Q, {SCALAR_WIDTH}], "
            f"got {tuple(rel_sorted.shape)}, {tuple(judged_sorted.shape)}, "
            f"{tuple(scalars.shape)}")
    if not relevance_level > 0:
        raise ValueError("relevance_level must be > 0 (padding has rel 0)")
    dev = rel_sorted.device
    if judged_sorted.device != dev or scalars.device != dev:
        raise ValueError("rel, judged and scalars must share one device")
    if dev.type == "cpu":
        return fused_measures_plain(rel_sorted, judged_sorted, scalars,
                                    relevance_level)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t in (rel_sorted, judged_sorted, scalars):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("inputs must be contiguous float32 tensors")
    q, d = rel_sorted.shape
    out = torch.empty((q, OUT_WIDTH), dtype=torch.float32, device=dev)
    if q == 0:
        return out
    # the rank-term table of long rows (the C entry chooses; 8·D bytes)
    table = torch.empty(2 * d, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        launched = ctypes.c_int(0)
        rc = _lib()(rel_sorted.data_ptr(), judged_sorted.data_ptr(),
                    scalars.data_ptr(), out.data_ptr(), table.data_ptr(), q,
                    d, float(relevance_level), stream,
                    ctypes.byref(launched))
    if rc != 0:
        raise RuntimeError(
            f"fused_measures kernel launch failed: CUDA error {rc}")
    global LAUNCHES, KERNEL_LAUNCHES
    LAUNCHES += 1
    KERNEL_LAUNCHES += launched.value
    return out
