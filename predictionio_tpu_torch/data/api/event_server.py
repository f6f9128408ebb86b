"""Event-collection REST server (:7070).

Parity target: ``data/.../api/EventServer.scala:90-632`` — same routes,
same status codes, same JSON shapes:

- ``GET /``                        → ``{"status": "alive"}``
- ``POST /events.json``            → 201 ``{"eventId": ...}``
- ``GET /events.json``             → filtered query, default limit 20
- ``GET|DELETE /events/<id>.json`` → single-event fetch/delete
- ``POST /batch/events.json``      → ≤50 events, per-item statuses
- ``GET /stats.json``              → counters (only with ``stats=True``)
- ``GET /plugins.json`` + ``GET /plugins/<type>/<name>/...``
- ``POST|GET /webhooks/<name>.json|.form``

Auth: ``accessKey`` query param or Basic ``Authorization`` header
(EventServer.scala:90-128); optional ``channel`` query param resolves a
channel name to its ID. The spray/akka stack is replaced by a
thread-per-request stdlib HTTP server: the storage DAOs are blocking and
thread-safe, so threads are the idiomatic host-side concurrency here
(the card is never on this path).

The port's copy of ``predictionio_tpu/data/api/event_server.py``, every
route included; ``/healthz`` reports the event store ready while its
circuit breaker is not refusing calls.
"""

from __future__ import annotations

import base64
import collections
import dataclasses
import hashlib
import json
import logging
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.api.plugins import EventInfo, EventServerPluginContext
from predictionio_tpu_torch.data.api.stats import StatsKeeper
from predictionio_tpu_torch.data.event import (
    Event,
    EventValidationError,
    validate_event,
)
from predictionio_tpu_torch.data.storage.base import UNSET
from predictionio_tpu_torch.utils import metrics, resilience
from predictionio_tpu_torch.utils.http_instrumentation import (
    InstrumentedHandlerMixin,
    SeveringThreadingHTTPServer,
)

logger = logging.getLogger("pio.eventserver")

MAX_EVENTS_PER_BATCH = 50  # EventServer.scala:68
DEFAULT_QUERY_LIMIT = 20   # EventServer.scala:352


@dataclasses.dataclass
class EventServerConfig:
    """EventServerConfig (EventServer.scala:572-576).

    ``service_key`` additionally enables the ``/storage/*`` wire: the
    remote-DAO lane the ``resthttp`` storage backend speaks, so training
    on one machine can read events served from another — the
    architecture ``Storage.scala:360-391`` gets from remote HBase/JDBC
    services. It is a storage credential (the analog of the DB password
    in the reference's storage config), distinct from per-app access
    keys; unset = the wire is disabled.

    ``server_config_path`` names a server.json whose ``ssl`` section
    (certfile/keyfile) serves the whole API over TLS — net-new vs the
    reference's plain-HTTP event server, and what keeps access keys and
    the service key off the wire in cleartext."""
    ip: str = "0.0.0.0"
    port: int = 7070
    stats: bool = False
    service_key: Optional[str] = None
    server_config_path: Optional[str] = None


@dataclasses.dataclass
class AuthData:
    """Resolved access-key auth (EventServer.scala:87)."""
    app_id: int
    channel_id: Optional[int]
    events: Sequence[str]


class _HttpError(Exception):
    def __init__(self, status: int, payload: Dict[str, Any]):
        super().__init__(payload.get("message", ""))
        self.status = status
        self.payload = payload


class EventServer:
    """The daemon. ``start()`` binds and serves on a background thread."""

    def __init__(self, config: Optional[EventServerConfig] = None,
                 plugin_context: Optional[EventServerPluginContext] = None,
                 reg: Optional[storage.StorageRegistry] = None):
        self.config = config or EventServerConfig()
        self.registry = reg or storage.registry()
        self.event_client = self.registry.get_levents()
        self.access_keys_client = self.registry.get_metadata_access_keys()
        self.channels_client = self.registry.get_metadata_channels()
        self.stats_keeper = StatsKeeper() if self.config.stats else None
        # client-chosen event names are a label value: cap the distinct
        # series one SERVER will ever mint (registry series never evict);
        # per-instance so one exhausted server cannot poison another
        self._event_label = metrics.BoundedLabel(cap=100)
        self.plugin_context = plugin_context or EventServerPluginContext()
        # (app, channel, body-digest) -> acked count of recently
        # fully-committed /storage appends. The wire retries a
        # byte-identical body, so a retried POST that hits here is a
        # pure replay of a committed append — answered in O(hash),
        # never rescanning the store. A miss (server restart, partial
        # commit) falls back to the exact existence scan.
        self._append_seen: "collections.OrderedDict[tuple, int]" = \
            collections.OrderedDict()
        self._append_seen_lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "EventServer":
        from predictionio_tpu_torch.common import SSLConfiguration
        from predictionio_tpu_torch.common.auth import (
            ServerConfig as AuthServerConfig,
        )

        server = self

        class Handler(_EventHandler):
            event_server = server

        # TLS only when a server.json is NAMED: the cwd/server.json
        # fallback ServerConfig.load applies elsewhere must not flip a
        # plain `pio eventserver` to HTTPS because a deploy config
        # happens to sit in the working directory
        if self.config.server_config_path:
            sslc = SSLConfiguration(
                AuthServerConfig.load(self.config.server_config_path))
        else:
            sslc = SSLConfiguration(AuthServerConfig())
        self.scheme = "https" if sslc.enabled else "http"
        self._httpd = SeveringThreadingHTTPServer(
            (self.config.ip, self.config.port), Handler)
        if sslc.enabled:
            sslc.wrap_server(self._httpd)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="pio-eventserver",
            daemon=True)
        self._thread.start()
        logger.info("Event server started on %s://%s:%d", self.scheme,
                    *self.address)
        return self

    @property
    def address(self) -> Tuple[str, int]:
        assert self._httpd is not None, "server not started"
        host, port = self._httpd.server_address[:2]
        return str(host), int(port)

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def serve_forever(self) -> None:
        if self._httpd is None:
            self.start()
        assert self._thread is not None
        self._thread.join()

    # -- auth (EventServer.scala:90-128) -----------------------------------
    def authenticate(self, query: Dict[str, List[str]],
                     headers) -> AuthData:
        key_param = _first(query, "accessKey")
        channel_param = _first(query, "channel")
        if key_param is not None:
            k = self.access_keys_client.get(key_param)
            if k is None:
                raise _HttpError(401, {"message": "Invalid accessKey."})
            if channel_param is not None:
                channel_map = {
                    c.name: c.id
                    for c in self.channels_client.get_by_appid(k.appid)
                }
                if channel_param not in channel_map:
                    raise _HttpError(
                        401, {"message": f"Invalid channel '{channel_param}'."})
                return AuthData(k.appid, channel_map[channel_param], k.events)
            return AuthData(k.appid, None, k.events)
        auth_header = headers.get("Authorization")
        if auth_header and auth_header.startswith("Basic "):
            try:
                decoded = base64.b64decode(
                    auth_header[len("Basic "):]).decode("utf-8")
            except Exception:
                raise _HttpError(401, {"message": "Invalid accessKey."})
            app_access_key = decoded.strip().split(":")[0]
            k = self.access_keys_client.get(app_access_key)
            if k is None:
                raise _HttpError(401, {"message": "Invalid accessKey."})
            return AuthData(k.appid, None, k.events)
        raise _HttpError(401, {"message": "Missing accessKey."})

    # -- route logic -------------------------------------------------------
    def _bookkeep(self, app_id: int, status: int, event: Event) -> None:
        # per-event-type ingest counters are always on (registry-gated),
        # unlike the reference's opt-in --stats windows
        metrics.INGEST_EVENTS.inc(app_id=str(app_id),
                                  event=self._event_label(event.event),
                                  status=str(status))
        if self.stats_keeper is not None:
            self.stats_keeper.bookkeeping(app_id, status, event)

    def _insert_one(self, event: Event, auth: AuthData) -> Tuple[int, Dict]:
        """Single-event insert path (EventServer.scala:259-299)."""
        if auth.events and event.event not in auth.events:
            self._bookkeep(auth.app_id, 403, event)
            return 403, {"message": f"{event.event} events are not allowed"}
        info = EventInfo(auth.app_id, auth.channel_id, event)
        for blocker in self.plugin_context.input_blockers.values():
            try:
                blocker.process(info, self.plugin_context)
            except ValueError as e:
                self._bookkeep(auth.app_id, 403, event)
                return 403, {"message": str(e)}
        event_id = self.event_client.insert(event, auth.app_id,
                                            auth.channel_id)
        for sniffer in self.plugin_context.input_sniffers.values():
            try:
                sniffer.process(info, self.plugin_context)
            except Exception:
                logger.exception("input sniffer failed")
        self._bookkeep(auth.app_id, 201, event)
        return 201, {"eventId": str(event_id)}

    def post_events(self, auth: AuthData, body: bytes) -> Tuple[int, Any]:
        event = _parse_event(body)
        return self._insert_one(event, auth)

    def post_batch(self, auth: AuthData, body: bytes) -> Tuple[int, Any]:
        """Batch insert, per-item status (EventServer.scala:374-440)."""
        try:
            items = json.loads(body.decode("utf-8"))
            if not isinstance(items, list):
                raise ValueError("batch body must be a JSON array")
        except (json.JSONDecodeError, UnicodeDecodeError, ValueError) as e:
            return 400, {"message": f"{e}"}
        if len(items) > MAX_EVENTS_PER_BATCH:
            return 400, {"message":
                         "Batch request must have less than or equal to "
                         f"{MAX_EVENTS_PER_BATCH} events"}
        results = []
        for item in items:
            try:
                event = _parse_event_dict(item)
            except EventValidationError as e:
                results.append({"status": 400, "message": str(e)})
                continue
            try:
                status, payload = self._insert_one(event, auth)
            except Exception as e:  # per-item isolation (scala :404-408)
                results.append({"status": 500, "message": str(e)})
                continue
            entry: Dict[str, Any] = {"status": status}
            entry.update(payload)
            results.append(entry)
        return 200, results

    def get_events(self, auth: AuthData,
                   query: Dict[str, List[str]]) -> Tuple[int, Any]:
        """Filtered query (EventServer.scala:300-372)."""
        reversed_ = _first(query, "reversed") in ("true", "True", "1")
        entity_type = _first(query, "entityType")
        entity_id = _first(query, "entityId")
        if reversed_ and (entity_type is None or entity_id is None):
            return 400, {"message":
                         "the parameter reversed can only be used with both "
                         "entityType and entityId specified."}
        try:
            from predictionio_tpu_torch.data.event import _parse_time
            start_time = _parse_time(_first(query, "startTime"))
            until_time = _parse_time(_first(query, "untilTime"))
            limit_s = _first(query, "limit")
            limit = int(limit_s) if limit_s is not None else DEFAULT_QUERY_LIMIT
        except (EventValidationError, ValueError) as e:
            return 400, {"message": f"{e}"}
        event_name = _first(query, "event")
        tet = _first(query, "targetEntityType")
        tei = _first(query, "targetEntityId")
        events = list(self.event_client.find(
            app_id=auth.app_id,
            channel_id=auth.channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            entity_id=entity_id,
            event_names=[event_name] if event_name else None,
            target_entity_type=tet if tet is not None else UNSET,
            target_entity_id=tei if tei is not None else UNSET,
            limit=limit,
            reversed=reversed_,
        ))
        if not events:
            return 404, {"message": "Not Found"}
        return 200, [e.to_dict() for e in events]

    def get_event(self, auth: AuthData, event_id: str) -> Tuple[int, Any]:
        event = self.event_client.get(event_id, auth.app_id, auth.channel_id)
        if event is None:
            return 404, {"message": "Not Found"}
        return 200, event.to_dict()

    def delete_event(self, auth: AuthData, event_id: str) -> Tuple[int, Any]:
        found = self.event_client.delete(event_id, auth.app_id,
                                         auth.channel_id)
        if found:
            return 200, {"message": "Found"}
        return 404, {"message": "Not Found"}

    def get_stats(self, auth: AuthData) -> Tuple[int, Any]:
        if self.stats_keeper is None:
            return 404, {"message": "To see stats, launch Event Server with "
                                    "--stats argument."}
        payload = self.stats_keeper.get(auth.app_id)
        # per-(app, channel) stream-end watermark (last appended event id
        # + time + the tail cursor): the observability hook the online
        # fold-in freshness story reads — "how far does the stream go"
        # next to the query server's "how far have I folded"
        try:
            payload["tailWatermark"] = self.event_client.tail_watermark(
                auth.app_id, auth.channel_id)
        except Exception:
            payload["tailWatermark"] = None  # backend keeps no cheap tail
        # richer than the reference shape: the process-wide registry
        # snapshot rides along. The caller authed for ONE app, so
        # app-labeled series are filtered to it — the reference's
        # /stats.json was app-scoped and this view must not widen it
        snap = metrics.registry().snapshot()
        for fam in snap.values():
            fam["series"] = [
                s for s in fam["series"]
                if s["labels"].get("app_id") in (None, str(auth.app_id))]
        payload["metrics"] = {k: v for k, v in snap.items() if v["series"]}
        return 200, payload

    def post_webhooks(self, auth: AuthData, name: str, form: bool,
                      body: bytes,
                      content_type: str) -> Tuple[int, Any]:
        """Webhook ingestion (api/Webhooks.scala:44-151)."""
        from predictionio_tpu_torch.data import webhooks

        if form:
            connector = webhooks.FORM_CONNECTORS.get(name)
        else:
            connector = webhooks.JSON_CONNECTORS.get(name)
        if connector is None:
            return 404, {"message":
                         f"webhooks connection for {name} is not supported."}
        try:
            if form:
                fields = dict(urllib.parse.parse_qsl(body.decode("utf-8")))
                event_json = connector.to_event_json(fields)
            else:
                data = json.loads(body.decode("utf-8"))
                if not isinstance(data, dict):
                    raise webhooks.ConnectorException(
                        "webhook body must be a JSON object")
                event_json = connector.to_event_json(data)
            event = _parse_event_dict(event_json)
        except (webhooks.ConnectorException, EventValidationError,
                json.JSONDecodeError, UnicodeDecodeError) as e:
            return 400, {"message": f"{e}"}
        event_id = self.event_client.insert(event, auth.app_id,
                                            auth.channel_id)
        self._bookkeep(auth.app_id, 201, event)
        return 201, {"eventId": str(event_id)}

    def get_webhooks(self, auth: AuthData, name: str,
                     form: bool) -> Tuple[int, Any]:
        from predictionio_tpu_torch.data import webhooks

        reg = webhooks.FORM_CONNECTORS if form else webhooks.JSON_CONNECTORS
        if name in reg:
            return 200, {"message": "Ok"}
        return 404, {"message":
                     f"webhooks connection for {name} is not supported."}

    # -- storage wire (/storage/*, service-key authed) ---------------------
    # The remote-DAO lane: the `resthttp` backend's LEvents/PEvents client
    # speaks these routes, so engines train against THIS server's event
    # store from another machine/process (Storage.scala:360-391 remote-DAO
    # architecture; bulk reads are the HBPEvents.scala:83-89 analog —
    # partition bytes shipped raw, decoded client-side by the native
    # codec). The service key is a storage credential like the
    # reference's DB password: callers are trusted peers, and the append
    # lane takes pre-validated JSONL (the client DAO validates before
    # serializing, as the jsonlfs fast lane does).

    def storage_auth(self, query: Dict[str, List[str]]) -> None:
        import hmac

        sk = self.config.service_key
        if not sk:
            raise _HttpError(403, {
                "message": "storage wire disabled — start the event "
                           "server with a service key"})
        given = _first(query, "serviceKey") or ""
        if not hmac.compare_digest(given, sk):
            raise _HttpError(401, {"message": "Invalid serviceKey."})

    @staticmethod
    def _storage_scope(query) -> Tuple[int, Optional[int]]:
        app_id = _first(query, "appId")
        if app_id is None:
            raise _HttpError(400, {"message": "appId is required"})
        ch = _first(query, "channelId")
        # malformed numbers are client errors, not 500s
        return (_int_param(app_id, "appId"),
                _int_param(ch, "channelId") if ch is not None else None)

    def storage_init(self, query) -> Tuple[int, Any]:
        app_id, ch = self._storage_scope(query)
        return 200, {"ok": bool(self.event_client.init(app_id, ch))}

    def storage_remove(self, query) -> Tuple[int, Any]:
        app_id, ch = self._storage_scope(query)
        return 200, {"ok": bool(self.event_client.remove(app_id, ch))}

    _APPEND_SEEN_CAP = 512

    def storage_append(self, query, body: bytes,
                       retried: bool = False) -> Tuple[int, Any]:
        app_id, ch = self._storage_scope(query)
        digest = (app_id, ch, hashlib.sha256(body).digest())
        if retried:
            acked = self._recent_append_count(digest)
            if acked is not None:
                logger.info("storage append retry: byte-identical replay"
                            " of a committed append; skipped")
                return 200, {"count": acked}
        lines = [ln for ln in body.decode("utf-8").split("\n")
                 if ln.strip()]
        # the ack (and the replay-cache entry) count the LOGICAL lines
        # of this request: after the dedup scan drops already-committed
        # lines, the whole body is durable — acking the post-dedup
        # remainder would make the same retried request answer 10 on a
        # cache hit but 0 after a server restart
        n_acked = len(lines)
        le = self.event_client
        if retried and lines:
            lines = self._dedup_retried_lines(lines, app_id, ch)
        if hasattr(le, "append_raw_lines"):
            le.append_raw_lines(lines, app_id, ch)
        else:
            le.insert_batch([Event.from_json(ln) for ln in lines],
                            app_id, ch)
        self._remember_append(digest, n_acked)
        return 200, {"count": n_acked}

    def _recent_append_count(self, digest: tuple) -> Optional[int]:
        with self._append_seen_lock:
            acked = self._append_seen.get(digest)
            if acked is not None:
                self._append_seen.move_to_end(digest)
            return acked

    def _remember_append(self, digest: tuple, count: int) -> None:
        with self._append_seen_lock:
            self._append_seen[digest] = count
            self._append_seen.move_to_end(digest)
            while len(self._append_seen) > self._APPEND_SEEN_CAP:
                self._append_seen.popitem(last=False)

    def _dedup_retried_lines(self, lines, app_id: int,
                             ch: Optional[int]):
        """Exactly-once for RETRIED appends (``X-Idempotency-Retry``):
        the client's first attempt may have committed before its
        response was lost — a blind re-append would duplicate every
        acknowledged-but-unacked event. Backends whose insert is an
        id-keyed upsert (sqlite, memory) dedup natively; append-only
        backends (jsonlfs) get one existence scan here. The scan runs
        ONLY on retried requests that missed the byte-identical replay
        cache (server restarted, or the first attempt only partially
        committed), so the bulk-ingest hot path pays nothing and the
        common retry pays a hash, not a store scan."""
        from predictionio_tpu_torch.data.storage.observed import unwrap

        le = self.event_client
        if getattr(unwrap(le), "idempotent_event_writes", False):
            return lines
        existing = {e.event_id
                    for e in le.find(app_id=app_id, channel_id=ch)}
        kept = []
        for ln in lines:
            try:
                eid = json.loads(ln).get("eventId")
            except (json.JSONDecodeError, AttributeError):
                eid = None
            if eid and eid in existing:
                continue
            kept.append(ln)
        if len(kept) != len(lines):
            logger.info("storage append retry: deduplicated %d of %d "
                        "already-committed events",
                        len(lines) - len(kept), len(lines))
        return kept

    def health_checks(self) -> Dict[str, bool]:
        """Readiness checks for ``GET /healthz``: the event store's
        circuit breaker must not be refusing calls (liveness is the
        response itself)."""
        return {"storage": resilience.storage_ready(self.event_client)}

    def storage_get_event(self, query, event_id: str) -> Tuple[int, Any]:
        app_id, ch = self._storage_scope(query)
        e = self.event_client.get(event_id, app_id, ch)
        if e is None:
            return 404, {"message": "Not Found"}
        return 200, e.to_dict()

    def storage_delete_event(self, query, event_id: str) -> Tuple[int, Any]:
        app_id, ch = self._storage_scope(query)
        return 200, {"found": bool(
            self.event_client.delete(event_id, app_id, ch))}

    def storage_delete_until(self, query) -> Tuple[int, Any]:
        app_id, ch = self._storage_scope(query)
        until = _time_param(query, "untilTime")
        if until is None:
            return 400, {"message": "untilTime is required"}
        return 200, {"removed":
                     self.event_client.delete_until(app_id, until, ch)}

    def storage_tail(self, query,
                     body: Optional[bytes] = None) -> Tuple[int, Any]:
        """Tail-read wire (``GET``/``POST /storage/tail.json``): the
        remote-DAO lane for ``find_since`` / ``tail_cursor`` /
        ``tail_watermark`` — what a deployed query server's online
        fold-in consumer polls when its event store lives in this
        process. The cursor is the backend's opaque JSON, passed
        through verbatim both ways; POST carries it in the request body
        (a jsonlfs watermark grows one entry per partition, and a large
        store's cursor would overflow the request-line cap as a query
        parameter)."""
        app_id, ch = self._storage_scope(query)
        le = self.event_client
        if _first(query, "watermark") == "true":
            return 200, {"watermark": le.tail_watermark(app_id, ch)}
        if _first(query, "position") == "end":
            return 200, {"cursor": le.tail_cursor(app_id, ch)}
        cursor = None
        limit = None
        if body:
            try:
                parsed = json.loads(body.decode("utf-8"))
                if not isinstance(parsed, dict):
                    raise ValueError("body must be a JSON object")
            except (json.JSONDecodeError, UnicodeDecodeError,
                    ValueError) as e:
                raise _HttpError(400, {"message": f"invalid body: {e}"})
            cursor = parsed.get("cursor")
            if cursor is not None and not isinstance(cursor, dict):
                raise _HttpError(
                    400, {"message": "invalid cursor: must be a JSON "
                                     "object"})
            if parsed.get("limit") is not None:
                limit = _int_param(str(parsed["limit"]), "limit")
        raw = _first(query, "cursor")
        if cursor is None and raw:
            try:
                cursor = json.loads(raw)
                if not isinstance(cursor, dict):
                    raise ValueError("cursor must be a JSON object")
            except (json.JSONDecodeError, ValueError) as e:
                raise _HttpError(400, {"message": f"invalid cursor: {e}"})
        limit_s = _first(query, "limit")
        if limit is None and limit_s is not None:
            limit = _int_param(limit_s, "limit")
        if limit is None:
            # server-side cap: a limit-less tail read would materialize
            # the ENTIRE store as one list + one unchunked response (the
            # bulk-read lane is the streaming /storage/events.jsonl);
            # callers page through the returned cursor
            limit = 10_000
        events, cur = le.find_since(app_id, ch, cursor=cursor, limit=limit)
        return 200, {"events": [e.to_dict() for e in events],
                     "cursor": cur}

    def storage_aggregate(self, query) -> Tuple[int, Any]:
        """Server-side ``aggregate_properties`` for the remote-DAO lane:
        unbounded calls answer from the backend's MATERIALIZED state, so
        a remote training host downloads current entities, not event
        history (the hot `PEventStore.aggregate_properties` shape)."""
        app_id, ch = self._storage_scope(query)
        entity_type = _first(query, "entityType")
        if not entity_type:
            return 400, {"message": "entityType is required"}
        props = self.event_client.aggregate_properties(
            app_id, entity_type, channel_id=ch,
            start_time=_time_param(query, "startTime"),
            until_time=_time_param(query, "untilTime"))
        out = {}
        for eid, pm in props.items():
            rec: Dict[str, Any] = {"properties": pm.fields}
            if pm.first_updated is not None:
                rec["firstUpdatedT"] = pm.first_updated.isoformat()
            if pm.last_updated is not None:
                rec["lastUpdatedT"] = pm.last_updated.isoformat()
            out[eid] = rec
        return 200, out

    _STORAGE_FILTER_KEYS = ("startTime", "untilTime", "entityType",
                            "entityId", "event", "targetEntityType",
                            "targetEntityTypeNull", "targetEntityId",
                            "targetEntityIdNull", "limit", "reversed")

    def storage_stream(self, query):
        """Yield event-JSONL byte chunks for a bulk read.

        Fast lane: when the underlying store is jsonlfs and no content
        filter is requested, the partition files ARE the wire format —
        raw bytes go out with zero parsing. Otherwise events stream
        through the underlying ``find``."""
        app_id, ch = self._storage_scope(query)
        unfiltered = not any(k in query for k in self._STORAGE_FILTER_KEYS)
        le = self.event_client
        from predictionio_tpu_torch.data.storage.jsonlfs import JsonlFsLEvents
        from predictionio_tpu_torch.data.storage.observed import unwrap

        # the fast lane needs the concrete backend behind the metrics
        # wrapper (partition files ARE the wire format)
        raw = unwrap(le)
        if unfiltered and isinstance(raw, JsonlFsLEvents):
            d = raw._dir(app_id, ch)
            def raw_parts():
                for part in raw._parts(d):
                    with open(part, "rb") as f:
                        while True:
                            chunk = f.read(1 << 22)
                            if not chunk:
                                break
                            yield chunk
            return raw_parts()

        tet = _first(query, "targetEntityType")
        if _first(query, "targetEntityTypeNull") == "true":
            tet = None
        elif tet is None:
            tet = UNSET
        tei = _first(query, "targetEntityId")
        if _first(query, "targetEntityIdNull") == "true":
            tei = None
        elif tei is None:
            tei = UNSET
        limit_s = _first(query, "limit")
        events = le.find(
            app_id=app_id, channel_id=ch,
            start_time=_time_param(query, "startTime"),
            until_time=_time_param(query, "untilTime"),
            entity_type=_first(query, "entityType"),
            entity_id=_first(query, "entityId"),
            event_names=query.get("event") or None,
            target_entity_type=tet, target_entity_id=tei,
            limit=_int_param(limit_s, "limit") if limit_s is not None
            else None,
            reversed=_first(query, "reversed") == "true",
        )

        def serialized():
            buf: List[str] = []
            for e in events:
                buf.append(e.to_json())
                if len(buf) >= 2000:
                    yield ("\n".join(buf) + "\n").encode("utf-8")
                    buf.clear()
            if buf:
                yield ("\n".join(buf) + "\n").encode("utf-8")
        return serialized()


def _first(query: Dict[str, List[str]], key: str) -> Optional[str]:
    vals = query.get(key)
    return vals[0] if vals else None


def _int_param(raw: str, name: str) -> int:
    try:
        return int(raw)
    except (TypeError, ValueError):
        raise _HttpError(400, {"message": f"invalid {name}: {raw!r}"})


def _time_param(query: Dict[str, List[str]], name: str):
    from predictionio_tpu_torch.data.event import EventValidationError, _parse_time

    raw = _first(query, name)
    try:
        return _parse_time(raw)
    except (EventValidationError, ValueError):
        raise _HttpError(400, {"message": f"invalid {name}: {raw!r}"})


def _parse_event_dict(d: Any) -> Event:
    if not isinstance(d, dict):
        raise EventValidationError("event JSON must be an object")
    try:
        event = Event.from_dict(d)
    except EventValidationError:
        raise
    except (TypeError, ValueError, AttributeError) as e:
        # malformed field types (tags: 5, properties: "x", ...) are client
        # errors, same contract as validation failures
        raise EventValidationError(str(e)) from e
    validate_event(event)
    return event


def _parse_event(body: bytes) -> Event:
    try:
        d = json.loads(body.decode("utf-8"))
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise _HttpError(400, {"message": f"invalid JSON: {e}"})
    try:
        return _parse_event_dict(d)
    except EventValidationError as e:
        raise _HttpError(400, {"message": str(e)})


class _EventHandler(InstrumentedHandlerMixin, BaseHTTPRequestHandler):
    """Request → route dispatch. One instance per request (threaded)."""

    event_server: EventServer  # injected by EventServer.start
    protocol_version = "HTTP/1.1"
    metrics_server_label = "event"

    # -- plumbing ----------------------------------------------------------
    def log_message(self, fmt, *args):  # route through logging, not stderr
        logger.debug("%s - %s", self.address_string(), fmt % args)

    def _body(self) -> bytes:
        return self._request_body

    def _respond_chunked(self, status: int, chunks) -> None:
        """Stream an unbounded byte-chunk iterator (Transfer-Encoding:
        chunked). A failure after the headers go out aborts the
        connection (``_stream_started`` tells ``_dispatch`` a second
        response is impossible) — the client sees a truncated chunked
        stream and raises, never silently-short data."""
        self._status_sent = status
        self.send_response(status)
        self.send_header("Content-Type", "application/x-jsonlines")
        self.send_header("Transfer-Encoding", "chunked")
        rid = getattr(self, "_request_id", None)
        if rid:
            self.send_header("X-Request-ID", rid)
        tp = getattr(self, "_traceparent", None)
        if tp:
            self.send_header("traceparent", tp)
        self.end_headers()
        self._stream_started = True
        for c in chunks:
            if not c:
                continue
            self.wfile.write(f"{len(c):x}\r\n".encode("ascii"))
            self.wfile.write(c)
            self.wfile.write(b"\r\n")
        self.wfile.write(b"0\r\n\r\n")

    # route patterns for metric labels: bounded cardinality, never raw
    # paths (an id or webhook name must not mint a new series)
    def _route_label(self, path: str) -> str:
        if path in ("/", "/healthz", "/metrics", "/stats.json",
                    "/events.json",
                    "/batch/events.json", "/plugins.json", "/traces.json",
                    "/storage/events.jsonl", "/storage/init.json",
                    "/storage/remove.json", "/storage/delete_until.json",
                    "/storage/aggregate.json", "/storage/tail.json"):
            return path
        if path.startswith("/traces/"):
            return "/traces/<id>"
        if path.startswith("/storage/events/"):
            return "/storage/events/<id>.json"
        if path.startswith("/events/"):
            return "/events/<id>.json"
        if path.startswith("/webhooks/"):
            return "/webhooks/<name>"
        if path.startswith("/plugins/"):
            return "/plugins/<type>/<name>"
        return "<other>"

    def _dispatch(self, method: str) -> None:
        parsed = urllib.parse.urlsplit(self.path)
        path = parsed.path.rstrip("/") or "/"
        self._dispatch_instrumented(
            method, path, lambda: self._handle(method, path, parsed))

    def _handle(self, method: str, path: str, parsed) -> None:
        srv = self.event_server
        query = urllib.parse.parse_qs(parsed.query)
        # Drain the request body up-front: every exit path (401, 404, ...)
        # must leave rfile at a message boundary or HTTP/1.1 keep-alive
        # clients would read garbage on the next pipelined request.
        length = int(self.headers.get("Content-Length") or 0)
        self._request_body = self.rfile.read(length) if length else b""
        # per-REQUEST flag on a per-CONNECTION handler instance: a prior
        # successful stream on this keep-alive connection must not make
        # later errors close the socket instead of responding
        self._stream_started = False
        try:
            if path == "/" and method == "GET":
                self._respond(200, {"status": "alive"})
                return
            if path == "/healthz" and method == "GET":
                # liveness + readiness probe: unauthenticated like
                # GET / (a load balancer has no access key)
                self._respond_healthz(srv.health_checks())
                return
            if path == "/metrics" and method == "GET":
                # Prometheus scrape endpoint: unauthenticated like GET /.
                # It is an OPERATOR surface — it carries cross-app
                # operational counters (event-type names, volumes), so
                # bind it to scrape-network interfaces, not the public
                # internet (README "Observability")
                self._respond_prometheus()
                return
            if path == "/traces.json" and method == "GET":
                # trace index/detail are operator surfaces like /metrics
                # (unauthenticated; bind to scrape-network interfaces)
                self._respond_traces_index(query)
                return
            if path.startswith("/traces/") and method == "GET":
                self._respond_trace(path[len("/traces/"):], query)
                return
            if path == "/plugins.json" and method == "GET":
                self._respond(200, srv.plugin_context.describe())
                return
            if path.startswith("/storage/"):
                srv.storage_auth(query)
                self._storage_route(srv, method, path, query)
                return
            auth = srv.authenticate(query, self.headers)
            status, payload = self._route(srv, method, path, query, auth)
            self._respond(status, payload)
        except _HttpError as e:
            if getattr(self, "_stream_started", False):
                self.close_connection = True
                return
            self._respond(e.status, e.payload)
        except Exception as e:
            logger.exception("unhandled error on %s %s", method, path)
            if getattr(self, "_stream_started", False):
                # mid-stream failure: a second status line would corrupt
                # the chunked framing — abort so the client sees a
                # truncated stream and raises
                self.close_connection = True
                return
            self._respond(500, {"message": str(e)})

    def _route(self, srv: EventServer, method: str, path: str,
               query: Dict[str, List[str]], auth: AuthData) -> Tuple[int, Any]:
        if path == "/events.json":
            if method == "POST":
                return srv.post_events(auth, self._body())
            if method == "GET":
                return srv.get_events(auth, query)
        elif path == "/batch/events.json":
            if method == "POST":
                return srv.post_batch(auth, self._body())
        elif path == "/stats.json" and method == "GET":
            return srv.get_stats(auth)
        elif path.startswith("/events/") and path.endswith(".json"):
            event_id = urllib.parse.unquote(
                path[len("/events/"):-len(".json")])
            if method == "GET":
                return srv.get_event(auth, event_id)
            if method == "DELETE":
                return srv.delete_event(auth, event_id)
        elif path.startswith("/webhooks/"):
            rest = path[len("/webhooks/"):]
            form = rest.endswith(".form")
            if rest.endswith(".json") or form:
                name = rest.rsplit(".", 1)[0]
                if method == "POST":
                    return srv.post_webhooks(
                        auth, name, form, self._body(),
                        self.headers.get("Content-Type", ""))
                if method == "GET":
                    return srv.get_webhooks(auth, name, form)
        elif path.startswith("/plugins/") and method == "GET":
            segments = [s for s in path.split("/") if s][1:]
            if len(segments) >= 2:
                ptype, pname, *args = segments
                ctx = srv.plugin_context
                reg = (ctx.input_blockers if ptype == "inputblocker"
                       else ctx.input_sniffers)
                plugin = reg.get(pname)
                if plugin is None:
                    return 404, {"message": f"plugin {pname} not found"}
                return 200, json.loads(
                    plugin.handle_rest(auth.app_id, auth.channel_id, args))
        return 404, {"message": "Not Found"}

    def _storage_route(self, srv: EventServer, method: str, path: str,
                       query: Dict[str, List[str]]) -> None:
        if path == "/storage/events.jsonl":
            if method == "GET":
                self._respond_chunked(200, srv.storage_stream(query))
                return
            if method == "POST":
                retried = bool(self.headers.get("X-Idempotency-Retry"))
                self._respond(*srv.storage_append(query, self._body(),
                                                  retried=retried))
                return
        elif path == "/storage/init.json" and method == "POST":
            self._respond(*srv.storage_init(query))
            return
        elif path == "/storage/remove.json" and method == "POST":
            self._respond(*srv.storage_remove(query))
            return
        elif path == "/storage/delete_until.json" and method == "POST":
            self._respond(*srv.storage_delete_until(query))
            return
        elif path == "/storage/aggregate.json" and method == "GET":
            self._respond(*srv.storage_aggregate(query))
            return
        elif path == "/storage/tail.json" and method in ("GET", "POST"):
            self._respond(*srv.storage_tail(
                query, self._request_body if method == "POST" else None))
            return
        elif path.startswith("/storage/events/") and path.endswith(".json"):
            # clients percent-encode ids with reserved characters
            event_id = urllib.parse.unquote(
                path[len("/storage/events/"):-len(".json")])
            if method == "GET":
                self._respond(*srv.storage_get_event(query, event_id))
                return
            if method == "DELETE":
                self._respond(*srv.storage_delete_event(query, event_id))
                return
        self._respond(404, {"message": "Not Found"})

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def do_DELETE(self):
        self._dispatch("DELETE")


def create_event_server(config: Optional[EventServerConfig] = None,
                        **kwargs) -> EventServer:
    """createEventServer parity (EventServer.scala:610-632)."""
    return EventServer(config, **kwargs)
