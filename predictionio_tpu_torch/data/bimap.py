"""Bidirectional ID mapping for dense matrix indexing.

The port's own copy of ``predictionio_tpu.data.bimap`` (the reference's
``BiMap.stringInt``): the forward map is a dict, the inverse an object
array so decoding a top-k list of indices is one vectorised lookup.
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterable, Iterator, List, Optional, Sequence

import numpy as np


class BiMap:
    """Immutable bidirectional map K <-> V (unique values required)."""

    def __init__(self, forward: Dict[Hashable, Hashable]):
        self._fwd = dict(forward)
        self._inv: Optional[Dict[Hashable, Hashable]] = None
        if len(set(self._fwd.values())) != len(self._fwd):
            raise ValueError("BiMap values must be unique")

    @classmethod
    def string_int(cls, keys: Iterable[str]) -> "StringIndexBiMap":
        """Map distinct keys to dense ints 0..n-1, insertion-ordered."""
        return StringIndexBiMap(keys)

    def __getitem__(self, k: Hashable) -> Hashable:
        return self._fwd[k]

    def get(self, k: Hashable, default=None):
        return self._fwd.get(k, default)

    def __contains__(self, k: Hashable) -> bool:
        return k in self._fwd

    def __len__(self) -> int:
        return len(self._fwd)

    def __iter__(self) -> Iterator[Hashable]:
        return iter(self._fwd)

    def keys(self):
        return self._fwd.keys()

    def values(self):
        return self._fwd.values()

    def items(self):
        return self._fwd.items()

    def inv_get(self, v: Hashable, default=None):
        if self._inv is None:
            self._inv = {val: k for k, val in self._fwd.items()}
        return self._inv.get(v, default)

    def to_dict(self) -> Dict[Hashable, Hashable]:
        return dict(self._fwd)


class StringIndexBiMap(BiMap):
    """String -> dense int index with vectorised inverse decoding."""

    def __init__(self, keys: Iterable[str]):
        ordered: List[str] = []
        seen = set()
        for k in keys:
            if k not in seen:
                seen.add(k)
                ordered.append(k)
        super().__init__({k: i for i, k in enumerate(ordered)})
        self._labels = np.asarray(ordered, dtype=object)

    @classmethod
    def from_distinct(cls, labels: Sequence[str]) -> "StringIndexBiMap":
        """Build from labels already known to be distinct, without
        de-duplicating them again."""
        self = cls.__new__(cls)
        BiMap.__init__(self, {str(k): i for i, k in enumerate(labels)})
        self._labels = np.asarray([str(k) for k in labels], dtype=object)
        return self

    @property
    def labels(self) -> np.ndarray:
        """Object ndarray such that labels[i] == key with index i."""
        return self._labels

    def append(self, labels: Sequence[str]) -> List[int]:
        """Extend the map with NEW labels in place, assigning the next
        dense indices; returns their indices. A label already mapped, or
        one given twice, is an error: the caller (online fold-in growing
        the user universe under a live server) resolves known ids first.
        The factor store must hold a label's row before the label lands
        here, so a lock-free ``get`` on the predict path never resolves
        an index the store does not hold yet."""
        new = [str(k) for k in labels]
        if len(set(new)) != len(new):
            raise ValueError("append: duplicate labels within the batch")
        for k in new:
            if k in self._fwd:
                raise ValueError(f"label {k!r} already mapped")
        base = len(self._fwd)
        out = []
        for i, k in enumerate(new):
            self._fwd[k] = base + i
            out.append(base + i)
        if new:
            self._labels = np.concatenate(
                [self._labels, np.asarray(new, dtype=object)])
            self._inv = None  # the inverse is rebuilt on the next inv_get
        return out

    def decode(self, indices) -> np.ndarray:
        """Vectorised index -> key decoding (for top-k model outputs)."""
        return self._labels[np.asarray(indices)]

    def encode(self, keys: Sequence[str]) -> np.ndarray:
        """Vectorised key -> index encoding; raises KeyError on unknowns."""
        try:
            return np.fromiter((self._fwd[k] for k in keys), dtype=np.int32,
                               count=len(keys))
        except KeyError as e:
            raise KeyError(f"unknown key {e.args[0]!r} in BiMap.encode") from e
