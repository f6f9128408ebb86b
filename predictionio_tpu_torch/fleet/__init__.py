"""Sharded host plane: consistent-hash event-store fleet + query fleet.

The port's copy of ``predictionio_tpu/fleet/``:

- :mod:`predictionio_tpu_torch.fleet.ring` — the stable consistent-hash
  ring both routers share (entity keys for storage, user keys for
  serving).
- :mod:`predictionio_tpu_torch.fleet.router` — ``FleetLEvents`` /
  ``FleetPEvents``, a storage source type (``fleet``) that fans event
  writes across N event-server shards by entity key and
  scatter-gathers reads (merged finds, union-merged materialized
  aggregation, a composed fleet tail cursor fold-in consumes
  transparently).
- :mod:`predictionio_tpu_torch.fleet.balancer` — ``QueryFleet``, the
  ``pio deploy --fleet N`` mode: N query-server replicas behind one
  thin HTTP/1.1 keep-alive balancer with hash-ring user routing and
  rolling warm ``/reload`` hand-off.

Resilience is inherited, not reinvented: every shard leg runs under
the resthttp wire's retry policy + per-URL breaker, and inside a
serving scope a dead shard degrades the answer (``degradedReasons:
["shard_down"]``) instead of failing it, a dead replica's queries
go to the next replica in the ring (``replica_down``), and traceparent
propagation spans balancer → replica → router → shard.
"""

from predictionio_tpu_torch.fleet.ring import HashRing

__all__ = ["HashRing"]
