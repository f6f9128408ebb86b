"""Host-side task parallelism for evaluation sweeps.

The port's copy of ``predictionio_tpu/utils/concurrency.py``: param sets
are evaluated on a small thread pool (device launches and numpy sections
release the GIL, so threads overlap the host work and keep the card's
queue fed without any process fan-out).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, List, Sequence, TypeVar

T = TypeVar("T")
R = TypeVar("R")


def eval_workers(requested: int, n_items: int) -> int:
    """Worker count for a param-set sweep: the requested value, else a
    modest CPU-based default, never more than the items."""
    if requested and requested > 0:
        w = int(requested)
    else:
        w = min(4, os.cpu_count() or 2)
    return max(1, min(w, n_items))


def parallel_map(fn: Callable[[T], R], items: Iterable[T],
                 workers: int) -> List[R]:
    """Ordered map over items; serial (no pool) when workers <= 1. A
    worker exception propagates to the caller as it would serially."""
    items = list(items)
    if workers <= 1 or len(items) <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(max_workers=min(workers, len(items))) as pool:
        return list(pool.map(fn, items))
