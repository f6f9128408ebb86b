"""Consistent-hash ring shared by the storage router and the balancer.

The port's copy of ``predictionio_tpu/fleet/ring.py``: the same points,
so a key lands on the same node index in both packages.

Hashing is ``md5`` over UTF-8 key bytes — STABLE across processes and
runs (Python's builtin ``hash`` is per-process salted, which would
re-shard the world on every restart). Each node owns ``virtual_nodes``
points on the ring so load stays even at small N and adding a shard
moves only ~1/N of the keyspace — the property that makes fold-in
routing (a user's events fold on the replica that serves them) and
entity-disjoint aggregation merges possible at all.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import List, Sequence


def stable_hash(key: str) -> int:
    """64-bit stable hash of a string key (process-independent)."""
    return int.from_bytes(
        hashlib.md5(key.encode("utf-8")).digest()[:8], "big")


class HashRing:
    """Maps string keys to node indices ``0..n_nodes-1``.

    Nodes are identified by index; callers keep the index-aligned list
    of whatever the node IS (a shard URL, a replica). ``node_for``
    walks clockwise from the key's point; ``preference`` returns the
    full failover order (each subsequent DISTINCT node clockwise), so
    a router can hand a dead node's keys to the next-preferred one
    deterministically.
    """

    def __init__(self, n_nodes: int, virtual_nodes: int = 128):
        if n_nodes < 1:
            raise ValueError("HashRing needs at least one node")
        self.n_nodes = int(n_nodes)
        self.virtual_nodes = max(1, int(virtual_nodes))
        points: List[int] = []
        owners: List[int] = []
        pairs = sorted(
            (stable_hash(f"node{node}#{v}"), node)
            for node in range(self.n_nodes)
            for v in range(self.virtual_nodes))
        for h, node in pairs:
            points.append(h)
            owners.append(node)
        self._points = points
        self._owners = owners

    def node_for(self, key: str) -> int:
        """The node index owning ``key``."""
        i = bisect.bisect_right(self._points, stable_hash(key))
        if i == len(self._points):
            i = 0  # wrap: past the last point lands on the first
        return self._owners[i]

    def preference(self, key: str) -> Sequence[int]:
        """All node indices in failover order for ``key`` (owner
        first, then each next distinct node clockwise)."""
        start = bisect.bisect_right(self._points, stable_hash(key))
        order: List[int] = []
        seen = set()
        n = len(self._points)
        for step in range(n):
            node = self._owners[(start + step) % n]
            if node not in seen:
                seen.add(node)
                order.append(node)
                if len(order) == self.n_nodes:
                    break
        return order
