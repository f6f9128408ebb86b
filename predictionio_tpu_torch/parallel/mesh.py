"""Work-partition index math.

The port's copy of ``shard_spans`` from
``predictionio_tpu/parallel/mesh.py``: balanced contiguous spans, no
mesh. The mesh helpers come with the sharded paths (ROADMAP A6).
"""

from __future__ import annotations

from typing import List, Tuple


def shard_spans(n: int, parts: int) -> List[Tuple[int, int]]:
    """Split ``range(n)`` into at most ``parts`` balanced contiguous
    ``(start, stop)`` spans, never an empty one. ``pio batchpredict``'s
    ``--query-partitions`` chunker uses it."""
    if n <= 0:
        return []
    parts = max(1, min(int(parts), n))
    base, rem = divmod(n, parts)
    spans: List[Tuple[int, int]] = []
    start = 0
    for i in range(parts):
        stop = start + base + (1 if i < rem else 0)
        spans.append((start, stop))
        start = stop
    return spans
