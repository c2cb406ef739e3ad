"""Docnos of TREC disks 4 and 5 less the Congressional Record, in each
source's style, a fixed count a source: ``{"style": "trec45", "sources":
[{"style": "FBIS", "docs": 130471}, ...]}``. The same list for every
seed."""

import numpy as np


def _fbis(i, n):  # FBIS3-10082, FBIS4-...
    half = n // 2
    return np.char.add(np.where(i < half, "FBIS3-", "FBIS4-"),
                       (np.where(i < half, i, i - half) + 1).astype(str))


def _fr94(i, n):  # FR940104-0-00001
    day, rest = i // 225, i % 225
    month, dom = day // 25 + 1, day % 25 + 1
    return np.char.add(
        np.char.add("FR94", np.char.zfill(month.astype(str), 2)),
        np.char.add(np.char.zfill(dom.astype(str), 2),
                    np.char.add(np.char.add("-", (rest // 75).astype(str)),
                                np.char.add("-", np.char.zfill(
                                    (rest % 75 + 1).astype(str), 5)))))


def _ft(i, n):  # FT911-1 ... FT944-n
    per = -(-n // 34)
    return np.char.add(np.char.add("FT", (911 + i // per).astype(str)),
                       np.char.add("-", (i % per + 1).astype(str)))


def _la(i, n):  # LA010189-0001
    day, rest = i // 181, i % 181
    month, dom, year = day % 12 + 1, (day // 12) % 28 + 1, 89 + day // 336
    return np.char.add(
        np.char.add("LA", np.char.zfill(month.astype(str), 2)),
        np.char.add(np.char.add(np.char.zfill(dom.astype(str), 2),
                                year.astype(str)),
                    np.char.add("-", np.char.zfill((rest + 1).astype(str),
                                                   4))))


SOURCES = {"FBIS": _fbis, "FR94": _fr94, "FT": _ft, "LA": _la}


def names(spec) -> np.ndarray:
    """Every docno of the collection, source by source."""
    parts = []
    for src in spec["sources"]:
        if src["style"] not in SOURCES:
            raise ValueError(f"unknown trec45 source {src['style']!r}")
        n = int(src["docs"])
        parts.append(SOURCES[src["style"]](np.arange(n, dtype=np.int64), n))
    out = np.concatenate(parts)
    if len(np.unique(out)) != len(out):
        raise ValueError("trec45 docnos are not unique")
    return out


def make(spec):
    """(the number of distinct docnos, a function of ids → docnos)."""
    all_names = names(spec)
    return len(all_names), all_names.__getitem__
