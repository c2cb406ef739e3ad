"""The registration journal: what the router promised to remember.

Every acknowledged ``register_qrel`` / ``register_run`` lives here twice:

* **in memory** (:attr:`RegistrationJournal.entries`) — the source for
  replaying registrations onto restarted workers and onto new owners at
  rebalance (the router's restart-transparency contract);
* **on disk** (``--state-dir``) — an append-only JSONL log, one wire-style
  frame per record (the same framing contract as the protocol itself:
  :func:`repro_torch.serve.wire.split_frames` reads it back, enforcing the same
  frame limit and dropping a torn trailing line from a crash mid-append).
  A router restarted against the same ``--state-dir`` recovers every
  acknowledged collection before accepting traffic, so a *whole-cluster*
  restart loses nothing.

Record kinds (one JSON object per line)::

    {"kind": "qrel", "qrel_id": ..., "payload": {...}}   # register_qrel
    {"kind": "run",  "qrel_id": ..., "run_id": ..., "payload": {...}}
    {"kind": "drop", "qrel_id": ...}                      # drop_qrel

``drop`` records and superseded registrations make the log grow without
bound if left alone; once ``compact_min_dead`` dead records accumulate the
log is rewritten as a snapshot of the live entries (atomic
write-new-then-rename, fsync'd), dropping everything superseded or
dropped.  Appends fsync by default: an acknowledged registration must
survive the router dying the very next instant.

``state_dir=None`` degrades to the in-memory journal alone: same API, no
files.  The file format is ``repro.serve.cluster.journal``'s byte for
byte: either package loads the other's log.

>>> import tempfile
>>> d = tempfile.mkdtemp()
>>> j = RegistrationJournal(d)
>>> j.record_qrel("web", {"qrel_id": "web", "qrel": {"q1": {"d1": 1}}})
>>> j.record_run("web", "bm25", {"qrel_id": "web", "run_id": "bm25"})
>>> j2 = RegistrationJournal(d)                   # a restarted router
>>> sorted(j2.entries) == ["web"] and list(j2.entries["web"]["runs"])
['bm25']
>>> j2.record_drop("web")                         # dropped = pruned
True
>>> RegistrationJournal(d).entries                # ...durably
{}
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

from repro_torch.serve.wire import (DEFAULT_FRAME_LIMIT, OversizedFrame,
                              split_frames)

#: journal file name inside ``--state-dir``
JOURNAL_FILE = "registrations.jsonl"


class RegistrationJournal:
    """In-memory registration map with an optional durable JSONL log.

    ``entries`` maps ``qrel_id -> {"qrel": <register_qrel payload>,
    "runs": {run_id: <register_run payload>}}`` — exactly the shape the
    router replays onto workers.  All mutations go through
    :meth:`record_qrel` / :meth:`record_run` / :meth:`record_drop` so the
    disk log can never disagree with memory.
    """

    def __init__(self, state_dir: Optional[str] = None, *,
                 frame_limit: int = DEFAULT_FRAME_LIMIT,
                 compact_min_dead: int = 32, fsync: bool = True):
        self._frame_limit = int(frame_limit)
        self._compact_min_dead = int(compact_min_dead)
        self._fsync = bool(fsync)
        self._path: Optional[str] = None
        self._dead = 0          # drop/superseded records since last compact
        self._skipped = 0       # unreadable records dropped at load
        self.counters = {"appended": 0, "compactions": 0,
                         "recovered_collections": 0}
        self.entries: Dict[str, dict] = {}
        if state_dir is not None:
            os.makedirs(state_dir, exist_ok=True)
            self._path = os.path.join(state_dir, JOURNAL_FILE)
            self._load()

    # -- recovery ------------------------------------------------------------

    def _load(self) -> None:
        try:
            with open(self._path, "rb") as fh:
                data = fh.read()
        except FileNotFoundError:
            return
        for frame in split_frames(data, self._frame_limit):
            if isinstance(frame, OversizedFrame):
                self._skipped += 1
                continue
            try:
                rec = json.loads(frame)
                kind, qrel_id = rec["kind"], rec["qrel_id"]
                # a record missing its payload or run id is corrupt too
                # (repro.serve.cluster.journal raises KeyError on one)
                payload = rec["payload"] if kind in ("qrel", "run") else None
                run_id = rec["run_id"] if kind == "run" else None
            except (ValueError, KeyError, TypeError):
                self._skipped += 1  # a corrupt line: skip, keep replaying
                continue
            if kind == "qrel":
                if qrel_id in self.entries:
                    self._dead += 1 + len(self.entries[qrel_id]["runs"])
                self.entries[qrel_id] = {"qrel": payload, "runs": {}}
            elif kind == "run" and qrel_id in self.entries:
                runs = self.entries[qrel_id]["runs"]
                if run_id in runs:
                    self._dead += 1
                runs[str(run_id)] = payload
            elif kind == "drop":
                entry = self.entries.pop(qrel_id, None)
                self._dead += 2 + (len(entry["runs"]) if entry else 0)
            else:
                self._skipped += 1
        self.counters["recovered_collections"] = len(self.entries)
        if self._dead >= self._compact_min_dead:
            self._compact()

    # -- mutation ------------------------------------------------------------

    def record_qrel(self, qrel_id: str, payload: dict) -> None:
        old = self.entries.get(qrel_id)
        if old is not None:  # superseded registration (and its runs)
            self._dead += 1 + len(old["runs"])
        self.entries[qrel_id] = {"qrel": payload, "runs": {}}
        self._append({"kind": "qrel", "qrel_id": qrel_id,
                      "payload": payload})

    def record_run(self, qrel_id: str, run_id: str, payload: dict) -> None:
        entry = self.entries.get(qrel_id)
        if entry is None:
            return  # register_run raced a drop: nothing durable to extend
        if run_id in entry["runs"]:
            self._dead += 1
        entry["runs"][str(run_id)] = payload
        self._append({"kind": "run", "qrel_id": qrel_id,
                      "run_id": str(run_id), "payload": payload})

    def record_drop(self, qrel_id: str) -> bool:
        """Prune a collection everywhere; True if it was journaled.

        This is the fix for the compaction bug-in-waiting: dropped
        collections must leave BOTH the in-memory journal (or replay onto
        a restarted worker resurrects them) and the durable log (or a
        whole-cluster restart does), and the drop record itself is what
        compaction later folds away.
        """
        entry = self.entries.pop(qrel_id, None)
        if entry is None:
            return False
        self._dead += 2 + len(entry["runs"])  # their records + this one
        self._append({"kind": "drop", "qrel_id": qrel_id})
        return True

    # -- the durable log -----------------------------------------------------

    def _append(self, record: dict) -> None:
        if self._path is None:
            if self._dead >= self._compact_min_dead:
                self._dead = 0  # memory-only: nothing on disk to rewrite
            return
        frame = json.dumps(record).encode() + b"\n"
        with open(self._path, "ab") as fh:
            fh.write(frame)
            fh.flush()
            if self._fsync:
                os.fsync(fh.fileno())
        self.counters["appended"] += 1
        if self._dead >= self._compact_min_dead:
            self._compact()

    def _compact(self) -> None:
        """Rewrite the log as a snapshot of the live entries, atomically."""
        if self._path is None:
            return
        tmp = self._path + ".compact"
        with open(tmp, "wb") as fh:
            for qrel_id, entry in self.entries.items():
                fh.write(json.dumps({"kind": "qrel", "qrel_id": qrel_id,
                                     "payload": entry["qrel"]}).encode()
                         + b"\n")
                for run_id, payload in entry["runs"].items():
                    fh.write(json.dumps(
                        {"kind": "run", "qrel_id": qrel_id,
                         "run_id": run_id, "payload": payload}).encode()
                        + b"\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self._path)
        self._dead = 0
        self.counters["compactions"] += 1

    # -- mapping facade (what the router iterates) ---------------------------

    def get(self, qrel_id: str) -> Optional[dict]:
        return self.entries.get(qrel_id)

    def __contains__(self, qrel_id: str) -> bool:
        return qrel_id in self.entries

    def __len__(self) -> int:
        return len(self.entries)

    def __iter__(self):
        return iter(self.entries)

    def stats(self) -> dict:
        out = {**self.counters, "collections": len(self.entries),
               "dead_records": self._dead, "skipped_records": self._skipped,
               "durable": self._path is not None}
        if self._path is not None:
            out["path"] = self._path
            try:
                out["bytes"] = os.path.getsize(self._path)
            except OSError:
                out["bytes"] = 0
        return out
