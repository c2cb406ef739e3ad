"""trec_eval ranking semantics in PyTorch.

trec_eval ranks documents by decreasing retrieval score and breaks ties by
docno (descending lexicographic order — the *larger* docno wins).  The
evaluator precomputes, per query, a ``tiebreak`` integer for every retrieved
document: the rank of its docno in descending lexicographic order (0 wins
ties).  Dense in-loop callers use the candidate index as the tiebreak.

torch has no multi-key sort, so :func:`rank_sort` packs ``(-score,
tiebreak)`` into ONE int64 key whose signed order is the lexicographic
order of the pair, and sorts that.  The float half follows ``lax.sort``'s
comparator: ``-0.0`` and ``+0.0`` compare equal (the tiebreak decides) and
every NaN sorts after every number.
"""

from __future__ import annotations

import torch

# Large sentinel that pushes padded entries to the end of the sort.
_PAD_TIEBREAK = 2**31 - 1


def sort_key(scores, tiebreak, mask) -> torch.Tensor:
    """int64 key ordering entries by (-score asc, tiebreak asc), padding last.

    High 32 bits: ``-score`` as an order-preserving int32 (IEEE bits with
    the magnitude bits flipped for negatives), after mapping ``-0.0`` to
    ``+0.0`` and every NaN to one positive quiet NaN.  Low 32 bits: the
    tiebreak shifted from int32 to ``[0, 2**32)``.  No sum can carry into
    the high half, so int64 order is the pair's lexicographic order.
    """
    neg = torch.where(mask, -scores.to(torch.float32), torch.inf)
    neg = torch.where(neg == 0, 0.0, neg)  # -0.0 == 0.0: tiebreak decides
    neg = torch.where(torch.isnan(neg), torch.nan, neg)
    bits = neg.view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    tb = torch.where(mask, tiebreak.to(torch.int32), _PAD_TIEBREAK)
    return ordered * (2**32) + (tb.to(torch.int64) + 2**31)


def rank_sort(scores, tiebreak, mask, *payload):
    """Sort along the last axis by (-score, tiebreak asc); padding goes last.

    Args:
      scores:   [..., D] float tensor of retrieval scores.
      tiebreak: [..., D] int tensor; smaller value wins ties.
      mask:     [..., D] bool; False entries are padding and sort to the end.
      *payload: tensors of the same shape to carry through the sort.

    Returns:
      Tuple of (sorted_mask, *sorted_payload).
    """
    order = torch.sort(sort_key(scores, tiebreak, mask), dim=-1,
                       stable=True).indices
    return tuple(torch.gather(x, -1, order) for x in (mask,) + payload)
