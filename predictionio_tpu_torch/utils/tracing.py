"""Stage timelines for the pipelined ingest.

The port's copy of ``StageTimeline`` from
``predictionio_tpu/utils/tracing.py``, and of that module only this
class: the port has no spans or trace context yet, so the ``parent``
arguments are kept for the JAX signature and take ``None``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Optional

# epoch seconds from the monotonic clock: a wall-clock step in the
# middle of an ingest must not corrupt durations
_EPOCH_ANCHOR = time.time() - time.perf_counter()


def _now() -> float:
    return _EPOCH_ANCHOR + time.perf_counter()


class StageTimeline:
    """Thread-safe wall-span collector for pipeline overlap accounting.

    Each :meth:`scope` (or :meth:`wrap_iter` step) appends one
    ``(stage, start, end, thread)`` record in epoch seconds, from
    whichever thread ran it: producer decode spans interleave with
    consumer index and bucket spans. :meth:`summary` reduces them to
    per-stage busy totals, the union wall span and the overlap ratio
    (busy / wall; 1.0 = fully serial, higher = real overlap);
    :meth:`to_json` is the per-stage timeline artifact."""

    def __init__(self):
        self._spans: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    def add(self, stage: str, start: float, end: float) -> None:
        with self._lock:
            self._spans.append({
                "stage": stage, "start": start, "end": end,
                "durationSec": round(end - start, 6),
                "thread": threading.get_ident(),
            })

    @contextlib.contextmanager
    def scope(self, stage: str, trace_parent: Optional[object] = None):
        t0 = _now()
        try:
            yield
        finally:
            self.add(stage, t0, _now())

    def wrap_iter(self, it, stage: str,
                  trace_parent: Optional[object] = None):
        """Yield from ``it`` timing each ``next()`` as one stage span: run
        inside a producer thread this measures exactly the decode wall
        time, on the decode thread."""
        it = iter(it)
        while True:
            with self.scope(stage, trace_parent):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item

    def spans(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._spans)

    def summary(self, spans: Optional[List[Dict[str, Any]]] = None
                ) -> Dict[str, Any]:
        if spans is None:
            spans = self.spans()
        if not spans:
            return {"stages": {}, "wall_sec": 0.0, "busy_sec": 0.0,
                    "overlap_ratio": None}
        stages: Dict[str, Dict[str, Any]] = {}
        for s in spans:
            st = stages.setdefault(s["stage"],
                                   {"busy_sec": 0.0, "spans": 0,
                                    "first_start": s["start"],
                                    "last_end": s["end"]})
            st["busy_sec"] += s["end"] - s["start"]
            st["spans"] += 1
            st["first_start"] = min(st["first_start"], s["start"])
            st["last_end"] = max(st["last_end"], s["end"])
        wall = (max(s["end"] for s in spans)
                - min(s["start"] for s in spans))
        busy = sum(s["end"] - s["start"] for s in spans)
        for st in stages.values():
            st["busy_sec"] = round(st["busy_sec"], 4)
            st["wall_span_sec"] = round(st.pop("last_end")
                                        - st.pop("first_start"), 4)
        return {
            "stages": stages,
            "wall_sec": round(wall, 4),
            "busy_sec": round(busy, 4),
            "overlap_ratio": round(busy / wall, 3) if wall > 0 else None,
        }

    def to_json(self) -> Dict[str, Any]:
        # one snapshot for origin, span list and summary: a stage still
        # recording on another thread must not land between them
        spans = self.spans()
        base = min((s["start"] for s in spans), default=0.0)
        return {
            "origin_epoch_sec": base,
            "spans": [{**s, "start": round(s["start"] - base, 6),
                       "end": round(s["end"] - base, 6)}
                      for s in spans],
            "summary": self.summary(spans),
        }
