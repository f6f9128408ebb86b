"""Query-server fleet mode: N replicas behind one thin balancer.

The port's copy of ``predictionio_tpu/fleet/balancer.py``.

``pio deploy --fleet N`` builds N in-process :class:`QueryServer`
replicas (each on an ephemeral loopback port) and binds ONE public
HTTP/1.1 keep-alive balancer in front of them:

- **Replicas** — each replica loads the engine instance on its own
  (``build_deployment`` once per replica), so each has its own device
  store (``DeviceTopK`` on the card ``ctx`` names), its own batch
  dispatcher thread and, with fold-in on, its own fold-in consumer; a
  replica's ``/reload`` swaps only its own deployment. The replicas'
  dispatchers launch on the device's default stream, in the order
  their threads reach it.
- **Routing** — ``POST /queries.json`` is routed by the query's user
  key over the SAME consistent-hash ring the storage router uses, so a
  user's queries always land on one replica. With online fold-in on,
  every replica tails the full fleet event stream, and sticky routing
  makes the freshness a user observes monotonic: their events fold on
  the replica that serves them. Queries without a user key round-robin.
- **Warm hand-off** — ``POST /reload`` rolls replica by replica: drain
  one from routing, swap it (the replica's own warm ``/reload``),
  rejoin, move on. The fleet is never cold and never serves two
  instances to one user mid-roll (their replica is either pre- or
  post-swap, not both).
- **Resilience** — a dead replica is skipped for the next replica in
  the key's ring preference order; the hop is marked on the answer
  (``degradedReasons: ["replica_down"]``). Forwarded requests carry
  ``outbound_context_headers()`` so one trace spans balancer → replica
  → (storage router) → shard.

The balancer and its replicas run in one process and share the metrics
registry; the event-store shards do NOT. ``GET /metrics`` on the
balancer is therefore the *federated* fleet exposition: the local
registry plus every remote member's scrape, merged by
:mod:`predictionio_tpu_torch.obs.federation`, with SLO burn rates
(:mod:`predictionio_tpu_torch.obs.slo`) evaluated over the merged view.
``GET /traces/<id>`` assembles the cross-process trace live from every
member's fragment, and ``GET /traces.json`` unions the fleet's slow
logs.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import logging
import os
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, List, Optional, Tuple

from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.fleet.ring import HashRing
from predictionio_tpu_torch.obs import assemble as trace_assemble
from predictionio_tpu_torch.obs.federation import FleetFederation
from predictionio_tpu_torch.obs.slo import SLOEngine, load_slo_config
from predictionio_tpu_torch.utils import tracing
from predictionio_tpu_torch.utils.http_instrumentation import (
    InstrumentedHandlerMixin,
)
from predictionio_tpu_torch.utils.tracing import outbound_context_headers
from predictionio_tpu_torch.workflow.create_server import (
    QueryServer,
    _HTTPServer,
    ReloadDowngradeError,
    ServerConfig,
    build_deployment,
    resolve_engine_instance,
    undeploy,
)

logger = logging.getLogger("pio.torch.fleet.balancer")

# query JSON fields tried (in order) for the sticky routing key
USER_KEY_FIELDS = ("user", "userId", "uid", "entityId")

FORWARD_TIMEOUT_SEC = 75.0


def _iso_utc(epoch: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(epoch))


def _fetch_member_json(url: str, path: str,
                       timeout: float = 2.0) -> Optional[Any]:
    """One short-lived GET against a fleet member; None on any miss
    (dead member, 404, garbage) — trace assembly and slow-log union
    degrade member by member, they never fail outright."""
    parts = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(
        parts.hostname or "127.0.0.1", parts.port or 80, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        if resp.status != 200:
            return None
        return json.loads(resp.read().decode("utf-8"))
    except (OSError, ValueError, http.client.HTTPException):
        return None
    finally:
        try:
            conn.close()
        except OSError:
            pass


def _storage_topology() -> Optional[Dict[str, Any]]:
    """The event-store fleet topology when EVENTDATA is the ``fleet``
    source type (None otherwise) — surfaces per-shard breaker states on
    ``/stats.json``."""
    try:
        dao = storage.get_levents()
    except Exception:
        return None
    topo = getattr(dao, "topology", None)
    if not callable(topo):
        return None
    try:
        return topo()
    except Exception:
        logger.exception("storage topology probe failed")
        return None


class _Replica:
    """One QueryServer plus its routing state."""

    def __init__(self, index: int, server: QueryServer):
        self.index = index
        self.server = server
        self.draining = False
        self.forward_errors = 0

    @property
    def address(self) -> Tuple[str, int]:
        return self.server.address

    def describe(self) -> Dict[str, Any]:
        host, port = (None, None)
        if self.server._httpd is not None:
            host, port = self.address
        checks = {}
        try:
            checks = self.server.health_checks()
        except Exception:
            pass
        dep = self.server._deployment
        return {"index": self.index,
                "address": f"{host}:{port}" if host else None,
                "draining": self.draining,
                "ready": bool(checks) and all(checks.values()),
                "checks": checks,
                "engineInstanceId": dep.instance.id
                if dep is not None and dep.instance is not None else None,
                "forwardErrors": self.forward_errors}


class QueryFleet:
    """N query-server replicas behind one keep-alive balancer.

    ``instance`` is the engine instance every replica deploys (None:
    the latest completed one of ``config``'s engine coordinates), and
    ``ctx`` the device they serve on (``ctx.device`` None = cuda)."""

    def __init__(self, config: ServerConfig, replicas: int,
                 instance=None, ctx=None):
        if replicas < 1:
            raise ValueError("--fleet needs at least 1 replica")
        self.config = config
        if instance is None:
            instance = resolve_engine_instance(
                None, config.engine_id, config.engine_version,
                config.engine_variant)
        self.replicas: List[_Replica] = []
        for i in range(replicas):
            rcfg = dataclasses.replace(config, ip="127.0.0.1", port=0)
            self.replicas.append(_Replica(i, QueryServer(
                rcfg, build_deployment(instance, ctx))))
        self.ring = HashRing(replicas, virtual_nodes=64)
        self._rr = 0  # round-robin cursor for keyless queries
        self._rr_lock = threading.Lock()
        self._reload_lock = threading.Lock()
        self._httpd: Optional[_HTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.scheme = "http"
        # the fleet observability plane: SLO engine + federation
        self.slo = SLOEngine(load_slo_config(config.slo_config))
        self.federation = FleetFederation(
            targets=self._federation_targets, slo=self.slo)
        self._obs_stop = threading.Event()
        self._obs_thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()

    # -- lifecycle --------------------------------------------------------
    def start(self, undeploy_stale: bool = True) -> "QueryFleet":
        self._stopped.clear()
        started: List[_Replica] = []
        try:
            for rep in self.replicas:
                # replicas bind ephemeral loopback ports: nothing stale
                # can hold port 0, so they skip the probe
                rep.server.start()
                started.append(rep)
            if undeploy_stale and self.config.port:
                undeploy(self.config.ip, self.config.port)
            fleet = self

            class Handler(_BalancerHandler):
                query_fleet = fleet

            # the query server's listener: daemon threads and a listen
            # queue that holds a burst of clients' connects
            self._httpd = _HTTPServer((self.config.ip, self.config.port),
                                      Handler)
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="pio-torch-fleet-balancer", daemon=True)
            self._thread.start()
            self._start_observer()
        except Exception:
            # a failure ANYWHERE past the first replica start (another
            # replica, the stale-port probe, the balancer bind — e.g.
            # EADDRINUSE) must not leak running replicas
            if self._httpd is not None:
                try:
                    self._httpd.server_close()
                except Exception:
                    pass
                self._httpd = None
            self._thread = None
            for rep in reversed(started):
                try:
                    rep.server.stop()
                except Exception:
                    pass
            raise
        logger.info("Query fleet: %d replicas behind %s://%s:%d",
                    len(self.replicas), self.scheme, *self.address)
        return self

    @property
    def address(self) -> Tuple[str, int]:
        assert self._httpd is not None, "fleet not started"
        host, port = self._httpd.server_address[:2]
        return str(host), int(port)

    def _start_observer(self) -> None:
        """Background federation poll: keeps the SLO sample ring fed
        even when nobody is scraping the balancer. ``PIO_SLO_POLL_SEC``
        (default 10; <= 0 disables)."""
        try:
            interval = float(os.environ.get("PIO_SLO_POLL_SEC", "10")
                             or 0.0)
        except ValueError:
            interval = 10.0
        if interval <= 0:
            return
        self._obs_stop.clear()

        def _loop() -> None:
            while not self._obs_stop.wait(interval):
                try:
                    self.federation.observe()
                except Exception:
                    logger.exception("fleet observation failed")

        self._obs_thread = threading.Thread(
            target=_loop, name="pio-torch-fleet-observer", daemon=True)
        self._obs_thread.start()

    def stop(self) -> None:
        self._obs_stop.set()
        if self._obs_thread is not None:
            self._obs_thread.join(timeout=5)
            self._obs_thread = None
        if self._httpd is not None:
            httpd, self._httpd = self._httpd, None
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.federation.close()
        # the last replica started stops first: each restores the
        # PIO_FOLDIN it found at its start, so the first one restores
        # the value from before the fleet
        for rep in reversed(self.replicas):
            try:
                rep.server.stop()
            except Exception:
                logger.exception("replica %d stop failed", rep.index)
        self._stopped.set()

    def serve_forever(self) -> None:
        """Block until the fleet stops (``POST /stop`` or :meth:`stop`):
        the balancer's thread ends first, then every replica."""
        if self._httpd is None:
            self.start()
        assert self._thread is not None
        self._thread.join()
        self._stopped.wait(timeout=30)

    # -- routing ----------------------------------------------------------
    def route(self, body: bytes) -> List[_Replica]:
        """Replicas to try, in order: the user key's ring preference
        with draining replicas pushed to the back (drained replicas
        still serve as a LAST resort — a query is never refused because
        a roll is in flight)."""
        key = None
        try:
            query = json.loads(body.decode("utf-8"))
            if isinstance(query, dict):
                for field in USER_KEY_FIELDS:
                    if query.get(field) is not None:
                        key = str(query[field])
                        break
        except (ValueError, UnicodeDecodeError):
            pass
        if key is not None:
            order = list(self.ring.preference(key))
        else:
            with self._rr_lock:
                self._rr = (self._rr + 1) % len(self.replicas)
                start = self._rr
            order = [(start + i) % len(self.replicas)
                     for i in range(len(self.replicas))]
        reps = [self.replicas[i] for i in order]
        return [r for r in reps if not r.draining] + \
               [r for r in reps if r.draining]

    # -- rolling reload ---------------------------------------------------
    def reload(self) -> Dict[str, Any]:
        """Drain → swap → rejoin, one replica at a time. A downgrade
        refusal aborts the roll with the already-swapped replicas
        attached to the error (rendered in the 409 body) — the operator
        sees exactly how far it got; nothing is ever stopped, so the
        fleet stays warm."""
        with self._reload_lock:
            swapped: List[Dict[str, Any]] = []
            for rep in self.replicas:
                rep.draining = True
                try:
                    info = rep.server.reload()
                    swapped.append({"replica": rep.index, **info})
                except ReloadDowngradeError as e:
                    e.swapped = list(swapped)
                    raise
                finally:
                    rep.draining = False
            return {"replicas": swapped}

    # -- observability ----------------------------------------------------
    def topology(self) -> Dict[str, Any]:
        reps = [rep.describe() for rep in self.replicas]
        return {"type": "queryFleet",
                "replicas": reps,
                "readyReplicas": sum(1 for r in reps if r["ready"]),
                "virtualNodes": self.ring.virtual_nodes,
                "storage": _storage_topology()}

    def status(self) -> Dict[str, Any]:
        return {"status": "alive", "fleet": self.topology()}

    def _federation_targets(self) -> List[Tuple[str, str]]:
        """Remote scrape targets: the event-store shards (separate
        processes). Replicas are in-process and already covered by the
        local registry snapshot."""
        topo = _storage_topology()
        if not topo or topo.get("type") != "fleet":
            return []
        out: List[Tuple[str, str]] = []
        for shard in topo.get("shards") or ():
            url = shard.get("url")
            if url:
                out.append((f"shard{shard.get('index', len(out))}", url))
        return out

    def federated_metrics(self) -> str:
        """The fleet-wide Prometheus exposition (merged + per-member
        drill-down), served at the balancer's ``GET /metrics``."""
        return self.federation.observe().prometheus()

    def stats_json(self) -> Dict[str, Any]:
        sc = self.federation.observe()
        fleet_block = {
            **self.topology(),
            "members": sc.members,
            "scrape": {
                "at": _iso_utc(sc.at),
                "durationSec": sc.duration_sec,
                "problems": sc.problems,
            },
        }
        out = {"status": "alive", "fleet": fleet_block,
               "metrics": sc.merged}
        out["alerts"] = sc.alerts if sc.alerts is not None \
            else self.slo.alerts_block()
        return out

    def assemble_trace(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """Live cross-process assembly: this process's fragment (which
        covers balancer + replicas) plus every remote member's
        ``GET /traces/<id>``, folded into one tree."""
        fragments: List[Optional[Dict[str, Any]]] = [
            tracing.trace_buffer().get(trace_id)]
        for _name, url in self._federation_targets():
            fragments.append(
                _fetch_member_json(url, "/traces/" + trace_id))
        return trace_assemble.assemble(fragments)

    def fleet_traces_json(self, limit: int = 50) -> Dict[str, Any]:
        """``GET /traces.json`` at the balancer: the local trace index
        plus the union of every member's slow log, so the worst query
        anywhere in the fleet is one GET away."""
        buf = tracing.trace_buffer()
        slow = [dict(e, member="balancer") for e in buf.slow_log(limit)]
        seen = {(e.get("traceId"), e.get("time")) for e in slow}
        for name, url in self._federation_targets():
            doc = _fetch_member_json(url, f"/traces.json?limit={limit}")
            for e in (doc or {}).get("slowLog") or ():
                key = (e.get("traceId"), e.get("time"))
                if key in seen:
                    continue  # in-process member: same buffer as ours
                seen.add(key)
                slow.append(dict(e, member=name))
        slow.sort(key=lambda e: e.get("time") or "", reverse=True)
        return {"enabled": buf.enabled,
                "sampleRate": buf.sample_rate,
                "slowThresholdSec": buf.slow_threshold_sec,
                "traces": buf.index(limit),
                "slowLog": slow[:limit]}

    def health_checks(self) -> Dict[str, bool]:
        """The fleet is ready while ANY replica is — readiness is the
        balancer's ability to answer, not every replica's. A firing
        SLO alert flips the ``slo_alerts`` readiness detail (liveness
        untouched — the process answers 503, it does not die)."""
        reps = [rep.describe() for rep in self.replicas]
        return {"balancer": self._httpd is not None,
                "replicas": any(r["ready"] for r in reps),
                "slo_alerts": not self.slo.firing()}


class _BalancerHandler(InstrumentedHandlerMixin, BaseHTTPRequestHandler):
    query_fleet: QueryFleet
    protocol_version = "HTTP/1.1"
    metrics_server_label = "balancer"

    def log_message(self, fmt, *args):
        logger.debug("%s - %s", self.address_string(), fmt % args)

    def _drain(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length) if length else b""

    _ROUTES = ("/", "/healthz", "/metrics", "/stats.json",
               "/queries.json", "/reload", "/stop", "/traces.json")

    def _route_label(self, path: str) -> str:
        if path.startswith("/traces/"):
            return "/traces/<id>"
        return path if path in self._ROUTES else "<other>"

    def _dispatch(self, method: str) -> None:
        path = urllib.parse.urlsplit(self.path).path.rstrip("/") or "/"
        handle = (lambda: self._do_get(path)) if method == "GET" \
            else (lambda: self._do_post(path))
        self._dispatch_instrumented(method, path, handle)

    def _query_params(self) -> Dict[str, List[str]]:
        return urllib.parse.parse_qs(
            urllib.parse.urlsplit(self.path).query)

    def _do_get(self, path: str) -> None:
        fleet = self.query_fleet
        self._drain()
        if path == "/":
            self._respond(200, fleet.status())
        elif path == "/healthz":
            self._respond_healthz(fleet.health_checks())
        elif path == "/metrics":
            # the FEDERATED exposition: merged fleet series + member=
            # drill-down, not just this process's registry
            self._respond_bytes(
                200, fleet.federated_metrics().encode("utf-8"),
                "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/stats.json":
            self._respond(200, fleet.stats_json())
        elif path == "/traces.json":
            query = self._query_params()
            try:
                limit = min(int(self._q_first(query, "limit") or 50),
                            500)
            except ValueError:
                limit = 50
            self._respond(200, fleet.fleet_traces_json(limit))
        elif path.startswith("/traces/"):
            query = self._query_params()
            trace_id = path[len("/traces/"):]
            rec = fleet.assemble_trace(trace_id)
            if rec is None:
                self._respond(
                    404,
                    {"message": f"trace {trace_id} not found "
                                "on any fleet member"})
            else:
                self._respond_trace_record(rec, query)
        else:
            self._respond(404, {"message": "Not Found"})

    def _do_post(self, path: str) -> None:
        fleet = self.query_fleet
        body = self._drain()
        try:
            if path == "/queries.json":
                self._forward_query(body)
            elif path == "/reload":
                try:
                    info = fleet.reload()
                except ReloadDowngradeError as e:
                    self._respond(
                        409,
                        {"message": str(e),
                         "replicas": getattr(e, "swapped", [])})
                    return
                self._respond(200, {"message": "Reloading...", **info})
            elif path == "/stop":
                self.close_connection = True
                self._respond_bytes(
                    200,
                    json.dumps({"message": "Shutting down."})
                    .encode("utf-8"),
                    "application/json; charset=UTF-8",
                    extra_headers={"Connection": "close"})
                threading.Thread(target=fleet.stop, daemon=True).start()
            else:
                self._respond(404, {"message": "Not Found"})
        except Exception as e:
            logger.exception("unhandled error on POST %s", path)
            try:
                self._respond(500, {"message": str(e)})
            except Exception:
                pass

    # one keep-alive upstream per (handler thread, replica): the
    # ThreadingHTTPServer gives each client connection its own thread,
    # so a persistent client gets persistent upstreams end to end
    _local = threading.local()

    def _upstream(self, rep: _Replica) -> http.client.HTTPConnection:
        conns = getattr(self._local, "conns", None)
        if conns is None:
            conns = self._local.conns = {}
        if rep.server._httpd is None:  # stopped replica: next in ring
            raise ConnectionRefusedError(
                f"replica {rep.index} is stopped")
        host, port = rep.address
        conn = conns.get(rep.index)
        if conn is None or (conn.host, conn.port) != (host, port):
            if conn is not None:
                conn.close()
            conn = http.client.HTTPConnection(
                host, port, timeout=FORWARD_TIMEOUT_SEC)
            conns[rep.index] = conn
        return conn

    def _discard_upstream(self, rep: _Replica) -> None:
        conns = getattr(self._local, "conns", None)
        if conns is not None:
            conn = conns.pop(rep.index, None)
            if conn is not None:
                conn.close()

    def _forward_once(self, rep: _Replica, body: bytes
                      ) -> Tuple[int, bytes, Dict[str, str]]:
        headers = {"Content-Type":
                   self.headers.get("Content-Type")
                   or "application/json; charset=UTF-8",
                   "Content-Length": str(len(body)),
                   **outbound_context_headers()}
        for attempt in (0, 1):  # one redial on a stale keep-alive conn
            conn = self._upstream(rep)
            try:
                conn.request("POST", "/queries.json", body=body,
                             headers=headers)
                resp = conn.getresponse()
                payload = resp.read()
                keep = {}
                retry_after = resp.getheader("Retry-After")
                if retry_after:
                    keep["Retry-After"] = retry_after
                ctype = resp.getheader("Content-Type") \
                    or "application/json; charset=UTF-8"
                if resp.will_close:
                    self._discard_upstream(rep)
                return resp.status, payload, {"ctype": ctype, **keep}
            except (OSError, http.client.HTTPException):
                self._discard_upstream(rep)
                if attempt:
                    raise
        raise AssertionError("unreachable")

    def _forward_query(self, body: bytes) -> None:
        fleet = self.query_fleet
        last_err: Optional[Exception] = None
        hopped = False
        for rep in fleet.route(body):
            try:
                status, payload, extra = self._forward_once(rep, body)
            except (OSError, http.client.HTTPException) as e:
                rep.forward_errors += 1
                last_err = e
                hopped = True
                logger.warning("fleet: replica %d unreachable (%r), "
                               "trying next", rep.index, e)
                continue
            if hopped:
                # the answer came off a non-preferred replica: say so,
                # the same contract storage uses for a dead shard
                payload = self._mark_degraded_payload(payload)
            ctype = extra.pop("ctype")
            self._respond_bytes(status, payload, ctype,
                                extra_headers=extra or None)
            return
        self._respond(503, {"message": "no query replica reachable",
                            "error": repr(last_err)})

    @staticmethod
    def _mark_degraded_payload(payload: bytes) -> bytes:
        try:
            doc = json.loads(payload.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return payload
        if not isinstance(doc, dict):
            return payload
        doc["degraded"] = True
        reasons = list(doc.get("degradedReasons") or [])
        if "replica_down" not in reasons:
            reasons.append("replica_down")
        doc["degradedReasons"] = reasons
        return json.dumps(doc).encode("utf-8")

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")
