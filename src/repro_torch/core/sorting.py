"""trec_eval ranking semantics in PyTorch.

trec_eval ranks documents by decreasing retrieval score and breaks ties by
docno (descending lexicographic order — the *larger* docno wins).  The
evaluator precomputes, per query, a ``tiebreak`` integer for every retrieved
document: the rank of its docno in descending lexicographic order (0 wins
ties).  Dense in-loop callers use the candidate index as the tiebreak.
:func:`ranks_of` gives every entry's rank, :func:`gold_rank` one entry's
rank without a sort (the GNN and LM steps' in-loop metrics).

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


def ranks_of(scores, tiebreak, mask) -> torch.Tensor:
    """1-based rank of every entry under trec_eval ordering (int32; the
    ranks of padding follow the real entries', up to D)."""
    d = scores.shape[-1]
    idx = torch.arange(d, dtype=torch.int64,
                       device=scores.device).expand(scores.shape)
    (_, sorted_idx) = rank_sort(scores, tiebreak, mask, idx)
    pos = torch.arange(1, d + 1, dtype=torch.int32,
                       device=scores.device).expand(scores.shape)
    return torch.zeros(scores.shape, dtype=torch.int32,
                       device=scores.device).scatter(-1, sorted_idx, pos)


def gold_rank(scores, gold_index, tiebreak=None) -> torch.Tensor:
    """Rank (1-based, int32) of ``gold_index`` in a score vector under
    trec_eval's tie rule, by compare-and-count (no sort).

    A document ranks above gold if its score is strictly greater, or equal
    with a smaller tiebreak value.  The default tiebreak is the index.

    >>> gold_rank(torch.tensor([[0.5, 0.9, 0.5]]), torch.tensor([2]))
    tensor([3], dtype=torch.int32)
    """
    d = scores.shape[-1]
    if tiebreak is None:
        tiebreak = torch.arange(d, dtype=torch.int32, device=scores.device)
    tiebreak = tiebreak.expand(scores.shape)
    gold = gold_index.long()[..., None]
    gold_score = torch.gather(scores, -1, gold)
    gold_tb = torch.gather(tiebreak, -1, gold)
    above = (scores > gold_score) | ((scores == gold_score)
                                     & (tiebreak < gold_tb))
    return torch.sum(above, dim=-1, dtype=torch.int32) + 1
