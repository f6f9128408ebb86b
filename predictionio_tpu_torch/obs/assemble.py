"""Cross-process trace assembly.

The port's copy of ``predictionio_tpu/obs/assemble.py``.

A distributed query touches several processes — balancer, query
replica, the storage wire client, an event-store shard — and each
process retains (or exports) only its own fragment of the trace: a
record with the same ``traceId`` but a different span subset. The
offline ``--trace-dir`` reader and the balancer's live ``GET
/traces/<id>`` fan-out fold fragments with the same rules:

- the fragment holding the TOPMOST span (``parentId is None``) names
  the merged trace ("pio.train", "query POST /queries.json"), not a
  downstream server's wire-request root;
- ``durationSec`` is the max across fragments, ``error``/``slow`` are
  OR'd;
- span order is fragment-major (topmost fragment's spans first), which
  keeps the renderers' parent-before-child expectations intact.

The live path additionally dedupes spans by ``spanId``: an in-process
fleet member shares the balancer's trace buffer, so its fetched
fragment duplicates spans the balancer already holds. Per-process
exports never duplicate span ids, so the offline dir reader inherits
the dedup for free (it is a no-op there).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

__all__ = ["topmost", "fold_fragment", "dedupe_spans", "assemble"]


def topmost(record: Dict[str, Any]) -> bool:
    """Does this fragment hold the trace's root span (no parent)?"""
    return any(s.get("parentId") is None for s in record.get("spans", ()))


def fold_fragment(prior: Dict[str, Any],
                  rec: Dict[str, Any]) -> Dict[str, Any]:
    """Fold one more fragment of the same trace into ``prior`` and
    return the merged record (which may be ``rec`` when it is the one
    holding the topmost span). Mutates its arguments; callers pass
    fresh/owned dicts (parsed JSON lines, rendered buffer copies)."""
    if topmost(rec) and not topmost(prior):
        rec["spans"] = list(rec.get("spans", ())) \
            + list(prior.get("spans", ()))
        rec["durationSec"] = max(prior.get("durationSec", 0.0),
                                 rec.get("durationSec", 0.0))
        rec["error"] = prior.get("error", False) or rec.get("error", False)
        rec["slow"] = prior.get("slow", False) or rec.get("slow", False)
        return rec
    prior["spans"] = list(prior.get("spans", ()))
    prior["spans"].extend(rec.get("spans", ()))
    prior["durationSec"] = max(prior.get("durationSec", 0.0),
                               rec.get("durationSec", 0.0))
    prior["error"] = prior.get("error") or rec.get("error", False)
    prior["slow"] = prior.get("slow") or rec.get("slow", False)
    return prior


def dedupe_spans(record: Dict[str, Any]) -> Dict[str, Any]:
    """Drop spans whose ``spanId`` was already seen (first one wins —
    fragment order puts the authoritative topmost fragment first).
    Spans without an id are kept as-is."""
    seen = set()
    out: List[Dict[str, Any]] = []
    for s in record.get("spans", ()):
        sid = s.get("spanId")
        if sid is not None:
            if sid in seen:
                continue
            seen.add(sid)
        out.append(s)
    record["spans"] = out
    return record


def assemble(fragments: Iterable[Optional[Dict[str, Any]]]
             ) -> Optional[Dict[str, Any]]:
    """Merge per-process fragments of ONE trace into a single record.

    ``None`` entries (members that did not retain the trace) are
    skipped. Returns ``None`` when no fragment survives. The merged
    record gains a ``processes`` list (the distinct pids that
    contributed spans) so a reader can see at a glance how many
    processes the trace crossed."""
    merged: Optional[Dict[str, Any]] = None
    for rec in fragments:
        if not rec or not isinstance(rec, dict):
            continue
        if not rec.get("spans"):
            continue
        merged = dict(rec) if merged is None else fold_fragment(merged, rec)
    if merged is None:
        return None
    dedupe_spans(merged)
    pids = []
    for s in merged["spans"]:
        pid = s.get("pid")
        if pid is not None and pid not in pids:
            pids.append(pid)
    merged["processes"] = pids
    return merged
