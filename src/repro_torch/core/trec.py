"""TREC run / qrel file formats (the port's own copy).

These exist for interoperability *and* as the serialization layer of the
serialize-invoke-parse baseline (the workflow the paper measures against).

Formats (whitespace separated):
  qrel:  ``qid  iter  docno  rel``
  run:   ``qid  Q0    docno  rank  score  tag``

numpy is imported only by the two array parsers, so the dict parsers and
writers load in a process that imports no numerical library (the
trec_eval baseline's child).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Mapping, TextIO, Tuple

if TYPE_CHECKING:
    import numpy as np


def parse_qrel(fh: TextIO) -> Dict[str, Dict[str, int]]:
    qrel: Dict[str, Dict[str, int]] = {}
    for line in fh:
        parts = line.split()
        if not parts:
            continue
        if len(parts) != 4:
            raise ValueError(f"malformed qrel line: {line!r}")
        qid, _, docno, rel = parts
        qrel.setdefault(qid, {})[docno] = int(rel)
    return qrel


def parse_run(fh: TextIO) -> Dict[str, Dict[str, float]]:
    run: Dict[str, Dict[str, float]] = {}
    for line in fh:
        parts = line.split()
        if not parts:
            continue
        if len(parts) != 6:
            raise ValueError(f"malformed run line: {line!r}")
        qid, _, docno, _rank, score, _tag = parts
        run.setdefault(qid, {})[docno] = float(score)
    return run


def parse_run_arrays(fh: TextIO) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse a TREC run straight into flat ``(qids, docnos, scores)`` arrays.

    The tokenized-ingest fast path: the arrays feed
    ``RelevanceEvaluator.buffer_from_arrays`` directly, so a run file becomes
    a pre-tokenized :class:`~repro_torch.core.evaluator.RunBuffer` without ever
    materializing a dict-of-dicts.  Rows are returned as-is; duplicate
    ``(qid, docno)`` pairs are the caller's responsibility (trec_eval rejects
    them, dict parsing keeps the last).

    Returns three flat, equal-length 1-D arrays: ``qids`` and ``docnos`` as
    numpy unicode arrays (file row order preserved), ``scores`` as float32.

    >>> import io
    >>> fh = io.StringIO("q1 Q0 d2 0 0.9 tag\\nq1 Q0 d1 1 0.2 tag\\n")
    >>> qids, docnos, scores = parse_run_arrays(fh)
    >>> qids.tolist(), docnos.tolist(), scores.astype('f8').round(2).tolist()
    (['q1', 'q1'], ['d2', 'd1'], [0.9, 0.2])
    """
    qids, docnos, scores = [], [], []
    for line in fh:
        parts = line.split()
        if not parts:
            continue
        if len(parts) != 6:
            raise ValueError(f"malformed run line: {line!r}")
        qids.append(parts[0])
        docnos.append(parts[2])
        scores.append(parts[4])
    import numpy as np

    return (np.array(qids), np.array(docnos),
            np.array(scores, dtype=np.float32))


def parse_qrel_arrays(fh: TextIO) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse a TREC qrel into flat ``(qids, docnos, rels)`` arrays."""
    qids, docnos, rels = [], [], []
    for line in fh:
        parts = line.split()
        if not parts:
            continue
        if len(parts) != 4:
            raise ValueError(f"malformed qrel line: {line!r}")
        qids.append(parts[0])
        docnos.append(parts[2])
        rels.append(int(parts[3]))
    import numpy as np

    return (np.array(qids), np.array(docnos),
            np.array(rels, dtype=np.int32))


def write_qrel(fh: TextIO, qrel: Mapping[str, Mapping[str, int]]) -> None:
    for qid, docs in qrel.items():
        for docno, rel in docs.items():
            fh.write(f"{qid} 0 {docno} {int(rel)}\n")


def write_run(fh: TextIO, run: Mapping[str, Mapping[str, float]],
              tag: str = "repro") -> None:
    # Like the paper's benchmark setup: written WITHOUT sorting — the
    # evaluator sorts internally, so rank fields are positional placeholders.
    for qid, docs in run.items():
        for rank, (docno, score) in enumerate(docs.items()):
            fh.write(f"{qid} Q0 {docno} {rank} {score:.6f} {tag}\n")


def load_qrel(path: str) -> Dict[str, Dict[str, int]]:
    with open(path) as fh:
        return parse_qrel(fh)


def load_run(path: str) -> Dict[str, Dict[str, float]]:
    with open(path) as fh:
        return parse_run(fh)


def load_run_arrays(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """File-path convenience wrapper around :func:`parse_run_arrays`."""
    with open(path) as fh:
        return parse_run_arrays(fh)


def run_id(path: str) -> str:
    """The run tag (6th column) of the first data line — trec_eval's runid."""
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if len(parts) != 6:
                raise ValueError(f"malformed run line: {line!r}")
            return parts[5]
    return ""


def save_qrel(path: str, qrel) -> None:
    with open(path, "w") as fh:
        write_qrel(fh, qrel)


def save_run(path: str, run, tag: str = "repro") -> None:
    with open(path, "w") as fh:
        write_run(fh, run, tag)
