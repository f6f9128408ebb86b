"""Fleet observability plane.

The port's copy of ``predictionio_tpu/obs/``: one view over a sharded
deployment (balancer + N query replicas + N event-store shards).

- :mod:`predictionio_tpu_torch.obs.federation` — scrape every fleet
  member's ``/metrics`` (+ ``/healthz`` / ``/stats.json``) in parallel
  and merge the series into ONE fleet-wide exposition (counters summed,
  gauges per member, histograms folded bucket-exactly through
  ``LatencyHistogram.merge``).
- :mod:`predictionio_tpu_torch.obs.assemble` — merge per-process trace
  fragments into one cross-process span tree (shared between the
  offline ``--trace-dir`` reader and the balancer's live ``GET
  /traces/<id>`` fan-out).
- :mod:`predictionio_tpu_torch.obs.slo` — declarative service-level
  objectives evaluated as multi-window burn rates over the federated
  metrics; firing alerts flip the balancer's readiness detail.

Submodules are imported directly (``from predictionio_tpu_torch.obs
import federation``); this package imports nothing at module scope so
:mod:`predictionio_tpu_torch.utils.tracing` can lazily reach
:mod:`.assemble` without an import cycle.
"""

__all__ = ["assemble", "federation", "slo"]
