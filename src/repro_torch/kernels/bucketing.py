"""Power-of-two shape bucketing.

Batch extents are padded UP to the next power of two (``bucket_queries`` /
``bucket_docs``), so every extent in ``[1, max]`` maps onto one of
``log2(max) + O(1)`` classes.  Padded rows/columns carry ``mask == False``
and are inert for every measure, so bucketing never changes a value.  The
port keeps the same classes as the JAX package so both engines see
identically shaped batches (and the kernels see the same ``[Q, D]`` tiles).

Dependency-free (no torch, no numpy).
"""

from __future__ import annotations

__all__ = ["MIN_DOC_BUCKET", "next_pow2", "bucket_queries", "bucket_docs"]

#: default minimum document-axis bucket
MIN_DOC_BUCKET = 8


def next_pow2(n: int, minimum: int = 1) -> int:
    """Smallest power of two (times ``minimum``) that is >= ``n``.

    >>> [next_pow2(n) for n in (1, 2, 3, 9, 1000)]
    [1, 2, 4, 16, 1024]
    """
    b = minimum
    while b < n:
        b *= 2
    return b


def bucket_queries(nq: int, minimum: int = 1, multiple: int = 1) -> int:
    """Padding class for a query-axis extent, rounded up to ``multiple``.

    >>> bucket_queries(37)
    64
    >>> bucket_queries(5, multiple=3)
    9
    """
    b = next_pow2(max(nq, 1), minimum)
    if multiple > 1:
        b = ((b + multiple - 1) // multiple) * multiple
    return b


def bucket_docs(nd: int, minimum: int = MIN_DOC_BUCKET) -> int:
    """Padding class for a document- (or judged-) axis extent.

    >>> bucket_docs(100), bucket_docs(3), bucket_docs(1000)
    (128, 8, 1024)
    """
    return next_pow2(max(nd, 1), minimum)
