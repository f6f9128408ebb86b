"""The trainer the templates call, and the item layout of a sharded
store.

The port's copy of ``train_als_auto``, ``ItemShardLayout``,
``contiguous_item_layout`` and ``density_aware_item_layout`` from
``predictionio_tpu/parallel/als_sharding.py``. The layouts are numpy,
byte-equal to the JAX package's for the same counts. Training runs on
one device: the sharded trainers wait for ROADMAP A6.3.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np

from predictionio_tpu_torch.device import DeviceLike
from predictionio_tpu_torch.ops.als import (
    ALSParams,
    BucketedRatings,
    train_als,
    train_als_bucketed,
)


# ---------------------------------------------------------------------------
# Density-aware item sharding (the layout a sharded serving store uses)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ItemShardLayout:
    """How the item axis of a sharded factor store is laid out.

    ``perm[pos] -> item id`` (or -1 for an empty pad slot) over
    ``n_shards * cap`` contiguous positions: shard ``s`` owns positions
    ``[s*cap, (s+1)*cap)``; ``inv[item] -> pos`` is its inverse. Serving
    permutes the item factor rows into it, fold-in reads the item store
    back through it, and top-k results translate back to item ids on the
    host."""

    perm: np.ndarray            # int64 [n_shards * cap], -1 = pad slot
    inv: np.ndarray             # int64 [n_items], item id -> position
    n_shards: int
    n_items: int
    counts_per_shard: np.ndarray  # int64 [n_shards] interaction mass

    @property
    def n_positions(self) -> int:
        return int(self.perm.shape[0])

    @property
    def cap(self) -> int:
        return self.n_positions // self.n_shards

    @property
    def items_per_shard(self) -> np.ndarray:
        """Real items each shard holds (pad slots excluded)."""
        return (self.perm.reshape(self.n_shards, self.cap)
                >= 0).sum(axis=1)

    def valid_mask(self) -> np.ndarray:
        """float32 [n_positions]: 1.0 where the position holds a real
        item, the validity row each shard's top-k masks by."""
        return (self.perm >= 0).astype(np.float32)

    def balance_report(self) -> Dict[str, Any]:
        """Interaction-mass balance across the shards."""
        c = self.counts_per_shard.astype(np.float64)
        mean = float(c.mean()) if len(c) else 0.0
        return {
            "nShards": int(self.n_shards),
            "itemsPerShard": [int(v) for v in self.items_per_shard],
            "interactionsPerShard": [int(v) for v in
                                     self.counts_per_shard],
            "maxOverMeanInteractions": round(
                float(c.max()) / mean, 4) if mean > 0 else None,
        }

    def to_json(self) -> Dict[str, Any]:
        return {"perm": self.perm.tolist(), "nShards": int(self.n_shards),
                "nItems": int(self.n_items),
                "countsPerShard": self.counts_per_shard.tolist()}

    @classmethod
    def from_json(cls, blob: Dict[str, Any]) -> "ItemShardLayout":
        perm = np.asarray(blob["perm"], dtype=np.int64)
        n_items = int(blob["nItems"])
        inv = np.full(n_items, -1, dtype=np.int64)
        real = perm >= 0
        inv[perm[real]] = np.flatnonzero(real)
        return cls(perm, inv, int(blob["nShards"]), n_items,
                   np.asarray(blob["countsPerShard"], dtype=np.int64))


def _layout_from_assignment(shards, counts: np.ndarray, n_shards: int,
                            cap: int) -> ItemShardLayout:
    n_items = int(len(counts))
    perm = np.full(n_shards * cap, -1, dtype=np.int64)
    mass = np.zeros(n_shards, dtype=np.int64)
    for s, items in enumerate(shards):
        items = np.sort(np.asarray(items, dtype=np.int64))
        perm[s * cap:s * cap + len(items)] = items
        mass[s] = int(counts[items].sum()) if len(items) else 0
    inv = np.full(n_items, -1, dtype=np.int64)
    real = perm >= 0
    inv[perm[real]] = np.flatnonzero(real)
    return ItemShardLayout(perm, inv, n_shards, n_items, mass)


def contiguous_item_layout(n_items: int, n_shards: int,
                           counts: Optional[np.ndarray] = None,
                           cap_multiple: int = 8) -> ItemShardLayout:
    """The span layout (items ``[s*cap, (s+1)*cap)`` on shard ``s``): the
    balance baseline, and the layout of a store without counts."""
    n_shards = max(1, int(n_shards))
    cap = -(-max(int(n_items), 1) // n_shards)
    cap = -(-cap // cap_multiple) * cap_multiple
    if counts is None:
        counts = np.zeros(n_items, dtype=np.int64)
    ids = np.arange(n_items, dtype=np.int64)
    shards = [ids[s * cap:(s + 1) * cap] for s in range(n_shards)]
    return _layout_from_assignment(shards, np.asarray(counts), n_shards,
                                   cap)


def density_aware_item_layout(counts, n_shards: int,
                              cap_multiple: int = 8) -> ItemShardLayout:
    """Assign items to shards by interaction count: a greedy bin-pack
    (the heaviest item first, onto the lightest shard with room), so the
    power-law head spreads over the shards. Every shard holds at most
    ``cap`` items; within a shard items sit in ascending id order."""
    counts = np.asarray(counts, dtype=np.int64)
    n_items = int(counts.shape[0])
    n_shards = max(1, int(n_shards))
    cap = -(-max(n_items, 1) // n_shards)
    cap = -(-cap // cap_multiple) * cap_multiple
    # heaviest first; ties broken by item id
    order = np.lexsort((np.arange(n_items), -counts))
    heap = [(0, s) for s in range(n_shards)]  # (mass, shard)
    heapq.heapify(heap)
    shards = [[] for _ in range(n_shards)]
    for item in order:
        while True:
            mass, s = heapq.heappop(heap)
            if len(shards[s]) < cap:
                break
            # a full shard leaves the heap for good (the capacity covers
            # every item, so the heap never empties early)
        shards[s].append(int(item))
        heapq.heappush(heap, (mass + int(counts[item]), s))
    return _layout_from_assignment(shards, counts, n_shards, cap)


def train_als_auto(user_side, item_side, params: ALSParams,
                   device: Union[DeviceLike, Sequence[DeviceLike]] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Train on uniform :class:`~predictionio_tpu_torch.ops.als.
    PaddedRatings` or length-bucketed :class:`~predictionio_tpu_torch.
    ops.als.BucketedRatings` sides (the preparator's choice) on one
    device (None = cuda), under the trainers' precision policy and
    checkpoint lane (``params.precision`` / ``PIO_ALS_PRECISION``,
    ``PIO_CHECKPOINT_*``, resolved by the trainer per call). A sequence
    of several devices raises: the sharded trainers are not ported yet."""
    if isinstance(device, (list, tuple)):
        if len(device) > 1:
            raise NotImplementedError(
                f"training across {len(device)} devices is not ported yet "
                "(ROADMAP A6.3: the sharded trainers); pass one "
                "device")
        device = device[0] if device else None
    if isinstance(user_side, BucketedRatings):
        return train_als_bucketed(user_side, item_side, params, device)
    return train_als(user_side, item_side, params, device)
