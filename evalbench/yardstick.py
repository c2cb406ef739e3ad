"""Peaks of the card and the bytes the measure core needs.

The benchmark's own copy: the program's ``analysis/roofline.py`` holds the
same published peaks, but a figure that decides a metric has to live
where a later change to the program cannot move it.
"""

from __future__ import annotations

#: NVIDIA H100 SXM (80 GB HBM3), data sheet: memory bandwidth at the full
#: power limit of 700 W
HBM_BYTES_PER_S = 3.35e12

#: bytes a real (query, document) pair holds in the measure core's input:
#: score f32, tie rank i32, relevance f32, judged bool, mask bool
PAIR_BYTES = 4 + 4 + 4 + 1 + 1
#: bytes a judgment holds in the ideal rows (f32)
IDEAL_BYTES = 4
#: bytes a query holds besides its rows: R f32, judged non-relevant f32,
#: query mask bool
QUERY_BYTES = 4 + 4 + 1
#: bytes a value of the output holds (f32)
VALUE_BYTES = 4


def core_bytes(pairs: int, judgments: int, queries: int,
               outputs: int) -> int:
    """The least bytes one measure-core pass moves: every unpadded input
    byte read once, every output value written once. The same count
    whatever kernel implements the core (sort, fused pass or top-k)."""
    return (pairs * PAIR_BYTES + judgments * IDEAL_BYTES
            + queries * QUERY_BYTES + outputs * VALUE_BYTES)


def least_seconds(nbytes: int) -> float:
    """The least time ``nbytes`` take at the card's memory bandwidth."""
    return nbytes / HBM_BYTES_PER_S
