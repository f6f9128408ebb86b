"""Sharded host plane: the consistent-hash event-store fleet.

The port's copy of ``predictionio_tpu/fleet/``, the storage half:

- :mod:`predictionio_tpu_torch.fleet.ring` — the stable consistent-hash
  ring (entity keys for storage; the query fleet's user keys later).
- :mod:`predictionio_tpu_torch.fleet.router` — ``FleetLEvents`` /
  ``FleetPEvents``, a storage source type (``fleet``) that fans event
  writes across N event-server shards by entity key and
  scatter-gathers reads (merged finds, union-merged materialized
  aggregation, a composed fleet tail cursor fold-in consumes
  transparently).

Resilience is inherited, not reinvented: every shard leg runs under
the resthttp wire's retry policy + per-URL breaker, and inside a
serving scope a dead shard degrades the answer (``degradedReasons:
["shard_down"]``) instead of failing it. The query fleet
(``balancer.py``, ``pio deploy --fleet N``) is not ported yet
(ROADMAP A2.6).
"""

from predictionio_tpu_torch.fleet.ring import HashRing

__all__ = ["HashRing"]
