"""REST-client event storage backend (``resthttp``).

The networked storage lane: LEvents/PEvents DAOs that speak HTTP to a
running event server's ``/storage/*`` wire, so an engine trains against
an event store living on ANOTHER machine/process — the defining
property of the reference's storage layer, where ``Storage.scala:360-391``
hands out DAOs for remote HBase/ES/JDBC services and training scans
regions over the network (``HBPEvents.scala:83-89``,
``JDBCPEvents.scala:31-100``). No DB services exist in this environment;
the event server IS the service, and the wire format is the same
event-JSONL every other component speaks.

The port's copy of ``predictionio_tpu/data/storage/resthttp.py``. The wire
is one format in both directions: the port's client speaks to the JAX
package's event server and the JAX client to the port's.

- Typed CRUD/find ride ``/storage/events.json[l]`` (server-side
  filtering for ``find``).
- Bulk training reads (``find_columnar_blocks``) fetch the UNFILTERED
  raw stream — for a jsonlfs-backed server that is partition bytes with
  zero server-side parsing — and decode client-side with the native C++
  codec (``jsonlfs.decode_jsonl_events``), filters applied over
  dictionary codes. The network ships bytes; the training host pays the
  decode, exactly like a remote HBase scan.

Config (``PIO_STORAGE_SOURCES_<NAME>_{URL,SERVICE_KEY,TIMEOUT,
CA_FILE,INSECURE_SKIP_VERIFY}``): ``url`` e.g.
``http(s)://eventhost:7070``; ``service_key`` must match the server's
``--service-key``; for ``https`` URLs ``ca_file`` pins the server's
(typically self-signed) certificate; ``verify_hostname=false`` for
IP-only deployments with CN-only certs. Only the event DAOs exist — configure this
source for EVENTDATA and keep METADATA/MODELDATA local (the registry
raises per-kind capability errors otherwise).
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import urllib.parse
import urllib.request
from typing import Iterable, List, Optional, Sequence

from predictionio_tpu_torch.data.datamap import PropertyMap
from predictionio_tpu_torch.data.event import (
    Event,
    new_event_id,
    validate_event,
)
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import UNSET, StorageError
from predictionio_tpu_torch.utils import faults, metrics, resilience
from predictionio_tpu_torch.utils.tracing import (
    outbound_context_headers,
    span,
)

logger = logging.getLogger("pio.torch.storage.resthttp")


class StorageUnavailable(StorageError):
    """The event server could not be reached. When the failure happened
    at CONNECT time the request provably never executed (retry class
    SAFE — any op, idempotent or not, may retry); after the request was
    sent the class is AMBIGUOUS."""

    def __init__(self, msg: str, retry_class: str = resilience.SAFE):
        super().__init__(msg)
        self.pio_retry_class = retry_class


class StorageTimeout(StorageError, TimeoutError):
    """A wire read exceeded the read timeout (the op may have run)."""

    pio_retry_class = resilience.AMBIGUOUS


class StorageServerError(StorageError):
    """HTTP 5xx (or 429) from the event server; carries the parsed
    ``Retry-After`` so backoff honors the server's own pacing."""

    pio_retry_class = resilience.AMBIGUOUS

    def __init__(self, msg: str, status: int,
                 retry_after: Optional[float] = None):
        super().__init__(msg)
        self.status = int(status)
        if retry_after is not None:
            self.pio_retry_after = retry_after


def _parse_retry_after(value: Optional[str]) -> Optional[float]:
    if not value:
        return None
    try:
        return max(0.0, float(value))
    except ValueError:
        return None  # HTTP-date form: not worth a date parse here


class _PooledConn:
    """A checked-out keep-alive connection. ``close()`` returns the
    socket to the wire's idle pool when the response was fully drained
    and the server did not ask to close — so every existing
    ``conn.close()`` call site (call/stream/redirect hops) participates
    in reuse without changing; anything else really closes."""

    __slots__ = ("_conn", "_resp", "_wire")

    def __init__(self, conn, resp, wire: "_Wire"):
        self._conn, self._resp, self._wire = conn, resp, wire

    def close(self) -> None:
        conn, self._conn = self._conn, None
        if conn is None:
            return
        resp = self._resp
        try:
            reusable = resp is not None and resp.isclosed() \
                and not resp.will_close
        except Exception:
            reusable = False
        if reusable:
            self._wire._checkin(conn)
        else:
            conn.close()


class _Wire:
    """Shared HTTP plumbing for the storage wire, resilience included.

    Connections are reused: after a fully-drained HTTP/1.1 response the
    socket goes back to a per-wire idle pool (bounded by config
    ``pool_max`` / ``$PIO_STORAGE_POOL_MAX``, default 8) and the next
    call skips the TCP/TLS dial — the fleet router multiplies wire
    calls by the shard count, so fan-out must not pay a fresh connect
    per shard per op. A stale keep-alive (server closed the idle
    socket) fails the reused send fast and falls through to ONE fresh
    dial; it never consumes a retry-policy attempt.

    Timeouts are SPLIT: ``connect_timeout`` (config ``connect_timeout``
    / ``$PIO_STORAGE_CONNECT_TIMEOUT``, default 3s — a dead host must
    fail in seconds, not a minute) bounds the TCP/TLS dial;
    ``read_timeout`` (config ``read_timeout`` / legacy ``timeout`` /
    ``$PIO_STORAGE_READ_TIMEOUT``, default 60s) bounds each blocking
    read of the open socket. Every call runs under the shared
    :class:`~predictionio_tpu_torch.utils.resilience.RetryPolicy` behind this
    URL's circuit breaker: connect-phase failures retry anything, 5xx /
    timeouts retry idempotent calls (event inserts ARE idempotent —
    the client assigns event ids before the first attempt and flags
    retries with ``X-Idempotency-Retry`` so the server dedups), and
    ``Retry-After`` floors the backoff.

    For an ``https://`` URL, ``ca_file`` pins the server certificate
    (the usual self-signed deployment); ``insecure_skip_verify`` (bool)
    disables verification entirely — test rigs only."""

    def __init__(self, config: Optional[dict] = None):
        cfg = config or {}
        self.url = (cfg.get("url") or "http://127.0.0.1:7070").rstrip("/")
        parts = urllib.parse.urlsplit(self.url)
        self._scheme = parts.scheme or "http"
        self._host = parts.hostname or "127.0.0.1"
        self._port = parts.port or (443 if self._scheme == "https" else 80)
        # an event server behind a reverse-proxy path prefix
        # (http://gw/pio-events) keeps its prefix on every wire path
        self._base_path = parts.path.rstrip("/")
        self.service_key = cfg.get("service_key") or ""
        legacy = cfg.get("timeout")
        self.connect_timeout = float(
            cfg.get("connect_timeout")
            or os.environ.get("PIO_STORAGE_CONNECT_TIMEOUT") or 3.0)
        self.read_timeout = float(
            cfg.get("read_timeout") or legacy
            or os.environ.get("PIO_STORAGE_READ_TIMEOUT") or 60.0)
        # the default op budget must survive one full read stall plus a
        # retry, or timeout-class failures can never actually retry
        # (PIO_STORAGE_OP_DEADLINE, when set, overrides this)
        self.policy = resilience.RetryPolicy.from_env(
            default_deadline=max(30.0, 2.0 * self.read_timeout
                                 + 2.0 * self.connect_timeout))
        self.breaker = resilience.breaker_for(self.url)
        self._pool: list = []
        self._pool_lock = threading.Lock()
        self._pool_max = int(
            cfg.get("pool_max")
            or os.environ.get("PIO_STORAGE_POOL_MAX") or 8)
        self.pool_reuses = 0  # kept-alive sends (observability/tests)
        self._ssl_ctx = None
        if self._scheme == "https":
            import ssl

            ca = cfg.get("ca_file")
            skip = str(cfg.get("insecure_skip_verify", "")
                       ).strip().lower() in ("1", "true", "yes")
            ctx = ssl.create_default_context(cafile=ca or None)
            # hostname verification stays ON by default even with a
            # pinned ca_file (a CA bundle signs many hosts); IP-only
            # deployments with CN-only self-signed certs opt out via
            # verify_hostname=false
            if str(cfg.get("verify_hostname", "")
                   ).strip().lower() in ("0", "false", "no"):
                ctx.check_hostname = False
            if skip:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            self._ssl_ctx = ctx
        # the wire dials the event server DIRECTLY: it is an internal
        # service hop, and routing storage traffic through an ambient
        # egress proxy (which the pre-split-timeout urllib lane did by
        # accident) is the classic way internal traffic breaks. Say so
        # loudly instead of failing with an opaque connect error.
        proxies = urllib.request.getproxies()
        if proxies.get(self._scheme) and \
                not urllib.request.proxy_bypass(self._host):
            logger.warning(
                "%s_proxy is set but the storage wire connects to %s "
                "directly (proxies are not supported on this hop); "
                "add the host to no_proxy to silence this",
                self._scheme, self.url)

    def _full(self, path: str, params: dict) -> str:
        """Path + query (http.client takes the host separately)."""
        q = {"serviceKey": self.service_key}
        for k, v in params.items():
            if v is not None:
                q[k] = v
        return f"{self._base_path}{path}?" + \
            urllib.parse.urlencode(q, doseq=True)

    def _headers(self, body: Optional[bytes], attempt: int,
                 replay_possible: bool = False) -> dict:
        """Observability context on EVERY wire call (request id +
        traceparent, so the server's spans join the caller's trace).
        ``X-Idempotency-Retry`` goes out only when a PRIOR attempt of
        this op failed AMBIGUOUSLY — i.e. the server may have committed
        it. A SAFE failure (connect refused: the request provably never
        left) must NOT flag the retry: the server's byte-digest replay
        cache would otherwise swallow a legitimate id-less append whose
        bytes happen to match an earlier committed one."""
        headers = dict(outbound_context_headers())
        if body is not None:
            headers["Content-Type"] = "application/x-jsonlines"
        if attempt > 0 and replay_possible:
            headers["X-Idempotency-Retry"] = str(attempt)
        return headers

    def _checkout(self):
        with self._pool_lock:
            return self._pool.pop() if self._pool else None

    def _checkin(self, conn) -> None:
        with self._pool_lock:
            if len(self._pool) < self._pool_max:
                self._pool.append(conn)
                return
        conn.close()

    def close(self) -> None:
        """Drain the idle keep-alive pool (checked-out connections
        close themselves through ``_PooledConn``)."""
        with self._pool_lock:
            idle, self._pool = self._pool, []
        for conn in idle:
            conn.close()

    def _dial(self):
        """TCP/TLS connect under the connect deadline. Dial failures
        are SAFE — the request provably never left."""
        import http.client

        try:
            if self._scheme == "https":
                conn = http.client.HTTPSConnection(
                    self._host, self._port, timeout=self.connect_timeout,
                    context=self._ssl_ctx)
            else:
                conn = http.client.HTTPConnection(
                    self._host, self._port, timeout=self.connect_timeout)
            conn.connect()
        except (TimeoutError, socket.timeout) as e:
            raise StorageUnavailable(
                f"event server unreachable at {self.url}: connect timed "
                f"out after {self.connect_timeout}s",
                retry_class=resilience.SAFE) from e
        except OSError as e:
            # refused / DNS / TLS dial failure: the request never left
            raise StorageUnavailable(
                f"event server unreachable at {self.url}: {e}",
                retry_class=resilience.SAFE) from e
        # the dial is done: from here each blocking socket op runs
        # under the (longer) read deadline
        conn.sock.settimeout(self.read_timeout)
        # small request/response segments must not wait out a delayed
        # ACK (Nagle costs a flat ~40ms per exchange on keep-alive)
        try:
            conn.sock.setsockopt(socket.IPPROTO_TCP,
                                 socket.TCP_NODELAY, 1)
        except OSError:
            pass  # non-TCP transports (unix sockets in tests)
        return conn

    def _request_once(self, method: str, pathq: str,
                      body: Optional[bytes], headers: dict):
        """One HTTP exchange under the split timeouts. Returns
        ``(conn, resp)`` — the caller reads and closes (the conn is a
        :class:`_PooledConn`, so a clean close rejoins the keep-alive
        pool). Dial failures are SAFE (nothing was sent); post-send
        failures are AMBIGUOUS — except a failure in the SEND phase on
        a REUSED idle connection, the classic stale keep-alive (the
        server is allowed to close an idle socket at any time): that
        conn is discarded and the exchange falls through to one fresh
        dial. Once the send completed on a reused socket, a dropped
        response is AMBIGUOUS exactly like the fresh-dial path — the
        server may have executed, and a silent redial would re-send
        behind the back of the ``idempotent=False`` retry protection
        (an unkeyed event batch appended twice, a committed delete
        replayed)."""
        import http.client

        pooled = self._checkout()
        if pooled is not None:
            sent = False
            try:
                pooled.request(method, pathq, body=body, headers=headers)
                sent = True
                resp = pooled.getresponse()
                self.pool_reuses += 1
                return _PooledConn(pooled, resp, self), resp
            except (TimeoutError, socket.timeout) as e:
                # time passed and the server may have executed: this is
                # a real timeout, not a stale socket — no silent redial
                pooled.close()
                raise StorageTimeout(
                    f"{method} {self.url}: no response within "
                    f"{self.read_timeout}s") from e
            except (OSError, http.client.HTTPException) as e:
                pooled.close()
                if sent:
                    raise StorageUnavailable(
                        f"event server dropped the connection at "
                        f"{self.url}: {e}",
                        retry_class=resilience.AMBIGUOUS) from e
                # stale keep-alive at send: fall through, redial
        conn = self._dial()
        try:
            conn.request(method, pathq, body=body, headers=headers)
            resp = conn.getresponse()
            return _PooledConn(conn, resp, self), resp
        except (TimeoutError, socket.timeout) as e:
            conn.close()
            raise StorageTimeout(
                f"{method} {self.url}: no response within "
                f"{self.read_timeout}s") from e
        except (OSError, http.client.HTTPException) as e:
            # BadStatusLine & co are HTTPException, NOT OSError — a
            # server killed mid-response must still classify AMBIGUOUS
            # (it may have committed) and must not leak the connection
            conn.close()
            raise StorageUnavailable(
                f"event server dropped the connection at {self.url}: {e}",
                retry_class=resilience.AMBIGUOUS) from e

    _MAX_REDIRECTS = 3

    def _request_redirects(self, method: str, pathq: str,
                           body: Optional[bytes], headers: dict):
        """``_request_once`` plus bounded SAME-ORIGIN redirect following
        for GETs — the old urllib lane followed read redirects (e.g. a
        gateway's trailing-slash canonicalization) and the http.client
        rewrite must not regress that. A cross-origin ``Location``
        (scheme/host/port change, e.g. an http->https upgrade) is a
        config error surfaced loudly: silently re-dialing a different
        origin would hide the misconfigured storage URL. Writes are
        never redirected (urllib's POST handling re-issued as GET —
        never correct on this wire)."""
        for _ in range(self._MAX_REDIRECTS):
            conn, resp = self._request_once(method, pathq, body, headers)
            if method != "GET" or resp.status not in (301, 302, 303,
                                                      307, 308):
                return conn, resp
            loc = resp.headers.get("Location")
            try:
                resp.read()
            finally:
                conn.close()
            if not loc:
                raise StorageError(
                    f"{method} {pathq}: {resp.status} redirect with no "
                    "Location header")
            parts = urllib.parse.urlsplit(loc)
            if parts.scheme or parts.netloc:
                port = parts.port or (
                    443 if (parts.scheme or self._scheme) == "https"
                    else 80)
                if (parts.scheme or self._scheme) != self._scheme or \
                        parts.hostname != self._host or \
                        port != self._port:
                    raise StorageError(
                        f"{method} {pathq}: redirected off-origin to "
                        f"{loc}; update the storage URL ({self.url}) to "
                        "the canonical endpoint")
                pathq = parts.path + (f"?{parts.query}"
                                      if parts.query else "")
            else:
                pathq = loc
        raise StorageError(
            f"{method}: more than {self._MAX_REDIRECTS} redirects from "
            f"{self.url}")

    def _check_status(self, status: int, raw: bytes, context: str,
                      retry_after_hdr: Optional[str], ok) -> None:
        """ONE definition of which wire statuses are retryable: 5xx and
        429 raise StorageServerError (Retry-After parsed), other
        not-ok statuses are permanent StorageErrors."""
        if status in ok:
            return
        try:
            payload = json.loads(raw.decode("utf-8"))
            msg = payload.get("message", payload)
        except Exception:
            msg = raw.decode("utf-8", "replace")
        if status >= 500 or status == 429:
            raise StorageServerError(
                f"{context} -> {status}: {msg}", status,
                _parse_retry_after(retry_after_hdr))
        raise StorageError(f"{context} -> {status}: {msg}")

    def _run_resilient(self, attempt_fn, op: str,
                       idempotent=True, retry_state: Optional[dict] = None):
        """Breaker + retry shell shared by ``call`` and ``stream``.
        ``retry_state`` (when given) gets ``ambiguous=True`` once any
        failed attempt may have executed server-side — the attempt fn
        reads it to decide whether the next request flags itself as a
        possible replay."""
        if not resilience.enabled():
            return attempt_fn(0)

        def on_retry(attempt: int, exc: BaseException,
                     delay: float) -> None:
            metrics.STORAGE_RETRIES.inc(backend="resthttp", op=op)
            if retry_state is not None and \
                    resilience.classify(exc) == resilience.AMBIGUOUS:
                retry_state["ambiguous"] = True

        return base.run_guarded(self.breaker, self.policy, attempt_fn,
                                idempotent=idempotent, on_retry=on_retry)

    def call(self, method: str, path: str, params: dict,
             body: Optional[bytes] = None, ok=(200,),
             op: Optional[str] = None, idempotent=True):
        """One JSON wire call with retries. ``op`` names the logical
        DAO op for fault-injection matching and retry metrics. Wire
        calls default idempotent (reads, idempotent admin verbs, and
        id-carrying event appends the server dedups); a caller sending
        id-LESS event lines must pass ``idempotent=False`` — the
        server cannot dedup what carries no key."""
        opname = op or f"{method} {path}"
        pathq = self._full(path, params)
        retry_state = {"ambiguous": False}
        with span(f"resthttp {method} {path}",
                  attributes={"url": self.url}):
            def attempt(n: int):
                # injected faults sit INSIDE the retry loop, like real
                # ones; a torn directive means "the server committed
                # but the response was lost" — execute fully, discard
                # the response, fail ambiguously (the retry + the
                # server-side dedup then prove exactly-once)
                import http.client

                torn = faults.maybe_fault("resthttp", opname)
                conn, resp = self._request_redirects(
                    method, pathq, body,
                    self._headers(body, n,
                                  replay_possible=retry_state["ambiguous"]))
                try:
                    raw = resp.read()
                    status = resp.status
                    retry_after = resp.headers.get("Retry-After")
                except (TimeoutError, socket.timeout) as e:
                    raise StorageTimeout(
                        f"{method} {path}: response stalled past "
                        f"{self.read_timeout}s") from e
                except (OSError, http.client.HTTPException) as e:
                    # IncompleteRead = killed mid-response: AMBIGUOUS
                    raise StorageUnavailable(
                        f"{method} {path}: response truncated by "
                        f"{self.url}: {e}",
                        retry_class=resilience.AMBIGUOUS) from e
                finally:
                    conn.close()
                if torn is not None:
                    raise torn.error()
                self._check_status(status, raw, f"{method} {path}",
                                   retry_after, ok)
                try:
                    payload = json.loads(raw.decode("utf-8"))
                except Exception:
                    payload = {"message": raw.decode("utf-8", "replace")}
                return status, payload

            return self._run_resilient(attempt, opname,
                                       idempotent=idempotent,
                                       retry_state=retry_state)

    def stream(self, params: dict, op: str = "find"):
        """GET /storage/events.jsonl as a raw byte-chunk iterator. The
        wire span (and the retry loop) covers the connect + response
        headers; once bytes flow, a failure is NOT replayable here —
        the consumer has already seen a prefix — and surfaces as a
        StorageError."""
        pathq = self._full("/storage/events.jsonl", params)
        with span("resthttp GET /storage/events.jsonl",
                  attributes={"url": self.url, "streaming": True}):
            def attempt(n: int):
                torn = faults.maybe_fault("resthttp", op)
                conn, resp = self._request_redirects(
                    "GET", pathq, None, self._headers(None, n))
                if torn is not None:
                    # response lost after the server answered: the
                    # directive must MANIFEST (a silently-dropped torn
                    # rule would burn its budget testing nothing)
                    conn.close()
                    raise torn.error()
                if resp.status != 200:
                    try:
                        raw = resp.read()
                    finally:
                        conn.close()
                    self._check_status(
                        resp.status, raw, "GET /storage/events.jsonl",
                        resp.headers.get("Retry-After"), ok=(200,))
                return conn, resp

            conn, resp = self._run_resilient(attempt, op)

        def chunks():
            import http.client

            try:
                while True:
                    c = resp.read(1 << 22)
                    if not c:
                        break
                    yield c
            except (TimeoutError, socket.timeout) as e:
                raise StorageTimeout(
                    f"storage stream from {self.url} stalled past "
                    f"{self.read_timeout}s") from e
            except (OSError, http.client.HTTPException) as e:
                # truncated chunked framing (server died mid-stream)
                raise StorageError(
                    f"storage stream from {self.url} interrupted: "
                    f"{e}") from e
            finally:
                conn.close()
        return chunks()


def _scope(app_id: int, channel_id: Optional[int]) -> dict:
    p = {"appId": int(app_id)}
    if channel_id is not None:
        p["channelId"] = int(channel_id)
    return p


class RestLEvents(base.LEvents):
    """LEvents client over the event server's storage wire.

    Resilience lives IN the wire (retries + this URL's breaker around
    every call), so the registry's DAO wrapper must not stack a second
    retry loop on top — ``self_resilient`` tells it so. Event writes
    are idempotent: ids are client-generated before the first attempt
    and the server dedups retried appends (``X-Idempotency-Retry``)."""

    metrics_backend = "resthttp"
    self_resilient = True
    idempotent_event_writes = True

    def __init__(self, config: Optional[dict] = None):
        self._w = _Wire(config)
        # per-endpoint availability domain: the wire URL
        self.resilience_endpoint = self._w.url

    # -- lifecycle --------------------------------------------------------
    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        _, p = self._w.call("POST", "/storage/init.json",
                            _scope(app_id, channel_id), op="init")
        return bool(p.get("ok"))

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        _, p = self._w.call("POST", "/storage/remove.json",
                            _scope(app_id, channel_id), op="remove")
        return bool(p.get("ok"))

    def close(self) -> None:
        self._w.close()  # drain the keep-alive pool

    def shutdown(self) -> None:
        self._w.close()

    # -- writes -----------------------------------------------------------
    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def insert_batch(self, events: Iterable[Event], app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        evs = list(events)
        for e in evs:
            validate_event(e)
        # ids assigned ONCE, before the wire's retry loop: a retried
        # POST replays the same ids, which the server dedups
        ids = [e.event_id or new_event_id() for e in evs]
        body = "\n".join(e.with_id(i).to_json()
                         for e, i in zip(evs, ids)).encode("utf-8")
        self._w.call("POST", "/storage/events.jsonl",
                     _scope(app_id, channel_id), body=body,
                     op="insert_batch")
        return ids

    def append_raw_lines(self, lines: Sequence[str], app_id: int,
                         channel_id: Optional[int] = None) -> None:
        """Pre-validated fast lane (same contract as the jsonlfs one):
        the bytes go to the server verbatim. Ambiguous failures retry
        only when every line carries a TOP-LEVEL ``eventId`` (the
        idempotency key the server-side dedup needs — a nested
        properties key must not fool the check); id-less lines still
        retry provably-unsent failures (connection refused). The exact
        per-line parse is LAZY: only a retry decision pays it, never
        the bulk-ingest success path."""
        lines = list(lines)

        def keyed() -> bool:
            for ln in lines:
                try:
                    d = json.loads(ln)
                except ValueError:
                    return False
                if not isinstance(d, dict) or not d.get("eventId"):
                    return False
            return True

        self._w.call("POST", "/storage/events.jsonl",
                     _scope(app_id, channel_id),
                     body="\n".join(lines).encode("utf-8"),
                     op="append_raw_lines", idempotent=keyed)

    # -- reads ------------------------------------------------------------
    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        quoted = urllib.parse.quote(event_id, safe="")
        status, payload = self._w.call(
            "GET", f"/storage/events/{quoted}.json",
            _scope(app_id, channel_id), ok=(200, 404), op="get")
        if status == 404:
            return None
        return Event.from_dict(payload)

    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        # idempotent=False: the STATE change replays fine, but the
        # RESPONSE doesn't — a retry after a committed first attempt
        # returns found=false for an event that was just deleted.
        # Ambiguous failures surface to the caller; provably-unsent
        # ones (connect refused) still retry.
        quoted = urllib.parse.quote(event_id, safe="")
        _, payload = self._w.call(
            "DELETE", f"/storage/events/{quoted}.json",
            _scope(app_id, channel_id), op="delete", idempotent=False)
        return bool(payload.get("found"))

    def delete_until(self, app_id, until_time,
                     channel_id: Optional[int] = None) -> int:
        # idempotent=False for the same reason as delete(): a replayed
        # attempt reports removed=0 after the first removed N.
        p = _scope(app_id, channel_id)
        p["untilTime"] = until_time.isoformat()
        _, payload = self._w.call("POST", "/storage/delete_until.json", p,
                                  op="delete_until", idempotent=False)
        return int(payload.get("removed", 0))

    # -- tail reads (find_since contract, base.py) -------------------------
    # The remote server's backend mints the cursor; it crosses the wire
    # as opaque JSON both ways, so a resthttp consumer tails whatever
    # store the event server actually runs (memory/sqlite/jsonlfs, or
    # another resthttp hop).

    def find_since(self, app_id, channel_id=None, cursor=None, limit=None):
        p = _scope(app_id, channel_id)
        if cursor is not None:
            # the cursor rides in the request BODY: a jsonlfs watermark
            # carries one entry per partition, and a big store's cursor
            # in the query string would overflow the server's
            # request-line cap (64 KB) — permanently wedging the tail
            body = {"cursor": cursor}
            if limit is not None:
                body["limit"] = int(limit)
            _, payload = self._w.call(
                "POST", "/storage/tail.json", p,
                body=json.dumps(body).encode("utf-8"), op="find_since")
        else:
            if limit is not None:
                p["limit"] = int(limit)
            _, payload = self._w.call("GET", "/storage/tail.json", p,
                                      op="find_since")
        events = [Event.from_dict(d) for d in payload.get("events", [])]
        return events, payload.get("cursor") or {}

    def tail_cursor(self, app_id, channel_id=None):
        p = _scope(app_id, channel_id)
        p["position"] = "end"
        _, payload = self._w.call("GET", "/storage/tail.json", p,
                                  op="tail_cursor")
        return payload.get("cursor") or {}

    def tail_watermark(self, app_id, channel_id=None):
        p = _scope(app_id, channel_id)
        p["watermark"] = "true"
        _, payload = self._w.call("GET", "/storage/tail.json", p,
                                  op="tail_watermark")
        return payload.get("watermark")

    def aggregate_properties(self, app_id, entity_type, channel_id=None,
                             start_time=None, until_time=None,
                             required=None):
        """Server-side aggregation over the storage wire: the server
        answers from ITS backend's materialized state (one small JSON
        of current entities crosses the network, not the event
        history). A pre-aggregate-route server 404s — fall back to the
        client-side replay fold over ``find``."""
        from predictionio_tpu_torch.data.event import _parse_time

        p = _scope(app_id, channel_id)
        p["entityType"] = entity_type
        if start_time is not None:
            p["startTime"] = start_time.isoformat()
        if until_time is not None:
            p["untilTime"] = until_time.isoformat()
        status, payload = self._w.call(
            "GET", "/storage/aggregate.json", p, ok=(200, 404),
            op="aggregate")
        if status == 404:
            # super() does the hit/replay accounting for this path
            return super().aggregate_properties(
                app_id, entity_type, channel_id=channel_id,
                start_time=start_time, until_time=until_time,
                required=required)
        from predictionio_tpu_torch.utils import metrics

        if start_time is not None or until_time is not None:
            # bounded reads ALWAYS replay server-side (base contract)
            metrics.AGGREGATE_REPLAYS.inc(backend=self.metrics_backend,
                                          reason="bounded")
        # unbounded 200s are NOT counted as hits here: the server may
        # have served them via its own replay fallback, and it is the
        # server's base.aggregate_properties that counts hit vs replay
        # truthfully under ITS backend label
        out = {}
        for eid, rec in payload.items():
            out[eid] = PropertyMap(
                rec.get("properties") or {},
                first_updated=_parse_time(rec.get("firstUpdatedT")),
                last_updated=_parse_time(rec.get("lastUpdatedT")))
        return base._apply_required(out, required)

    def find(self, app_id, channel_id=None, start_time=None,
             until_time=None, entity_type=None, entity_id=None,
             event_names=None, target_entity_type=UNSET,
             target_entity_id=UNSET, limit=None,
             reversed=False) -> Iterable[Event]:
        p = _scope(app_id, channel_id)
        if start_time is not None:
            p["startTime"] = start_time.isoformat()
        if until_time is not None:
            p["untilTime"] = until_time.isoformat()
        if entity_type is not None:
            p["entityType"] = entity_type
        if entity_id is not None:
            p["entityId"] = entity_id
        if event_names is not None:
            p["event"] = list(event_names)
        if target_entity_type is not UNSET:
            if target_entity_type is None:
                p["targetEntityTypeNull"] = "true"
            else:
                p["targetEntityType"] = target_entity_type
        if target_entity_id is not UNSET:
            if target_entity_id is None:
                p["targetEntityIdNull"] = "true"
            else:
                p["targetEntityId"] = target_entity_id
        if limit is not None and limit >= 0:
            p["limit"] = int(limit)
        if reversed:
            p["reversed"] = "true"
        # tag the request as filtered even when every filter is a
        # default: `find` promises time ordering, which the raw
        # partition lane does not (storage order)
        p["limit"] = p.get("limit", -1)
        # split on BYTES, decode complete lines: a multibyte character
        # straddling a network-chunk boundary must not be corrupted
        tail = b""
        for chunk in self._w.stream(p, op="find"):
            buf = tail + chunk
            lines = buf.split(b"\n")
            tail = lines.pop()
            for ln in lines:
                if ln.strip():
                    yield Event.from_json(ln.decode("utf-8"))
        if tail.strip():
            yield Event.from_json(tail.decode("utf-8"))


class RestPEvents(base.LEventsBackedPEvents):
    """Bulk reads: raw byte stream decoded client-side (native codec)."""

    def __init__(self, config: Optional[dict] = None):
        super().__init__(RestLEvents(config))
        self._w: _Wire = self._l._w

    def find_columnar_blocks(self, app_id, channel_id=None, start_time=None,
                             until_time=None, entity_type=None,
                             event_names=None, target_entity_type=UNSET,
                             value_property=None, default_value=1.0,
                             strict=True, block_size=1_000_000,
                             prefetch=0):
        """Fetch the UNFILTERED raw stream (for a jsonlfs-backed server:
        partition bytes, no server-side parsing) in ~8MB bites split at
        line boundaries, decode each with the native codec, and apply
        the filters over dictionary codes — the remote analog of the
        jsonlfs partition scan. ``prefetch`` is accepted but ignored:
        the wire stream is already pipelined by TCP readahead and
        decode happens per bite on this side."""
        del prefetch
        from predictionio_tpu_torch.data.storage.jsonlfs import (
            decode_jsonl_events,
        )

        BITE = 8 << 20
        buf = bytearray()

        def decode(data: bytes):
            for block in decode_jsonl_events(
                    data, start_time=start_time, until_time=until_time,
                    entity_type=entity_type, event_names=event_names,
                    target_entity_type=target_entity_type,
                    value_property=value_property,
                    default_value=default_value, strict=strict,
                    source=f"{self._w.url}/storage/events.jsonl"):
                for i in range(0, len(block), block_size):
                    yield block.take(slice(i, i + block_size))

        for chunk in self._w.stream(_scope(app_id, channel_id),
                                    op="find_columnar_blocks"):
            buf.extend(chunk)
            if len(buf) >= BITE:
                cut = buf.rfind(b"\n")
                if cut < 0:
                    continue
                data, buf = bytes(buf[:cut + 1]), bytearray(buf[cut + 1:])
                yield from decode(data)
        if buf:
            if not buf.endswith(b"\n"):
                buf.extend(b"\n")
            yield from decode(bytes(buf))

    def find_columnar(self, app_id, channel_id=None, start_time=None,
                      until_time=None, entity_type=None, event_names=None,
                      target_entity_type=UNSET, value_property=None,
                      default_value=1.0, strict=True):
        """Full scan = concatenated blocks, stably sorted by event time
        (the non-streaming contract other backends honor)."""
        import numpy as np

        from predictionio_tpu_torch.data.columnar import ColumnarEvents

        blocks = list(self.find_columnar_blocks(
            app_id, channel_id=channel_id, start_time=start_time,
            until_time=until_time, entity_type=entity_type,
            event_names=event_names, target_entity_type=target_entity_type,
            value_property=value_property, default_value=default_value,
            strict=strict))
        batch = ColumnarEvents.concat(blocks)
        order = np.argsort(batch.event_times, kind="stable")
        return batch.take(order)
