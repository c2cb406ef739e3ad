"""Consistent-hash ring: which worker owns which collection id.

The cluster shards *collections* (qrel ids), not requests: every request
naming a ``qrel_id`` goes to the one worker whose LRU interned that qrel,
so a hot collection's evaluator lives exactly once per worker process and
the worker's micro-batcher still coalesces everything aimed at it.

Plain modulo hashing would reshuffle almost every collection when the pool
grows or shrinks; the classic consistent-hash construction keeps the
disruption to ~1/N of the keyspace.  Each node is hashed onto the ring at
``replicas`` pseudo-random points (virtual nodes — 64 by default, enough
to keep the per-node share within a few percent of uniform for small
pools) and a key belongs to the first node point at or after its own hash,
wrapping at the top.

Hashing is SHA-1 (stable across processes and Python versions — never
``hash()``, which is salted per process), truncated to 64 bits.

>>> ring = HashRing(["w0", "w1", "w2"])
>>> ring.owner("robust04") == ring.owner("robust04")   # deterministic
True
>>> before = {k: ring.owner(k) for k in map(str, range(200))}
>>> ring.add("w3")                                     # grow the pool
>>> moved = [k for k, o in before.items() if ring.owner(k) != o]
>>> 0 < len(moved) < 110                 # ~1/4 of keys move, not all
True
>>> all(ring.owner(k) == "w3" for k in moved)  # ...and only TO the newcomer
True
>>> ring.remove("w3")                    # shrink: movers return home
>>> all(ring.owner(k) == before[k] for k in before)
True

Replication reads the same ring: a key's **replica set** is the first R
*distinct* nodes met walking clockwise from its hash
(:meth:`HashRing.owners`), so ``owners(k, 1)[0] == owner(k)`` always, the
sets are deterministic across processes, and a membership change disturbs
each replica set by at most the one node that joined or left it.

>>> sets = {k: ring.owners(k, 2) for k in map(str, range(100))}
>>> all(len(set(s)) == 2 for s in sets.values())       # R distinct workers
True
>>> ring.add("w3")
>>> changed = [k for k, s in sets.items() if ring.owners(k, 2) != s]
>>> all(set(ring.owners(k, 2)) - set(sets[k]) <= {"w3"} for k in changed)
True
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Iterable, List, Tuple


def _hash(key: str) -> int:
    """Stable 64-bit point on the ring for ``key``."""
    return int.from_bytes(hashlib.sha1(key.encode("utf-8")).digest()[:8],
                          "big")


class HashRing:
    """Consistent-hash ring over named nodes with virtual replicas."""

    def __init__(self, nodes: Iterable[str] = (), *, replicas: int = 64):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.replicas = int(replicas)
        self._nodes: set = set()
        self._ring: List[Tuple[int, str]] = []   # sorted (point, node)
        self._points: List[int] = []             # parallel sorted points
        for node in nodes:
            self.add(node)

    @property
    def nodes(self) -> Tuple[str, ...]:
        return tuple(sorted(self._nodes))

    def __len__(self) -> int:
        return len(self._nodes)

    def __contains__(self, node: str) -> bool:
        return node in self._nodes

    def add(self, node: str) -> None:
        """Place ``node`` on the ring at ``replicas`` virtual points."""
        if node in self._nodes:
            raise ValueError(f"node {node!r} is already on the ring")
        self._nodes.add(node)
        self._ring.extend((_hash(f"{node}#{i}"), node)
                          for i in range(self.replicas))
        self._ring.sort()
        self._points = [p for p, _ in self._ring]

    def remove(self, node: str) -> None:
        if node not in self._nodes:
            raise KeyError(f"node {node!r} is not on the ring")
        self._nodes.discard(node)
        self._ring = [(p, n) for p, n in self._ring if n != node]
        self._points = [p for p, _ in self._ring]

    def owner(self, key: str) -> str:
        """The node owning ``key``: first node point at/after its hash."""
        if not self._ring:
            raise KeyError("ring is empty: no workers")
        i = bisect.bisect_left(self._points, _hash(key))
        if i == len(self._points):
            i = 0  # wrap past the top of the ring
        return self._ring[i][1]

    def owners(self, key: str, n: int = 1) -> List[str]:
        """The replica set for ``key``: the first ``n`` DISTINCT nodes met
        walking clockwise from its hash (capped at the pool size).

        ``owners(key, 1) == [owner(key)]`` by construction, and appending a
        node to the walk order is how replication degrades gracefully: with
        fewer nodes than ``n`` every node is a replica.
        """
        if n < 1:
            raise ValueError(f"need n >= 1 replicas, got {n}")
        if not self._ring:
            raise KeyError("ring is empty: no workers")
        n = min(n, len(self._nodes))
        start = bisect.bisect_left(self._points, _hash(key))
        out: List[str] = []
        for step in range(len(self._ring)):
            node = self._ring[(start + step) % len(self._ring)][1]
            if node not in out:
                out.append(node)
                if len(out) == n:
                    break
        return out

    def copy(self) -> "HashRing":
        """An independent ring with the same membership (for what-if
        ownership computations during rebalancing)."""
        clone = HashRing(replicas=self.replicas)
        clone._nodes = set(self._nodes)
        clone._ring = list(self._ring)
        clone._points = list(self._points)
        return clone
