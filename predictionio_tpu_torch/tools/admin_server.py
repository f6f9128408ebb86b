"""Admin REST server (:7071): remote app management.

The port's copy of ``predictionio_tpu/tools/admin_server.py``. Parity
target: ``tools/.../admin/AdminAPI.scala:65-105`` routes backed by
``admin/CommandClient.scala:64-156`` semantics (status 0 = failure,
1 = success, matching GeneralResponse/AppNewResponse/AppListResponse):

- ``GET  /``                    → ``{"status": "alive"}``
- ``GET  /cmd/app``             → list apps with their access keys
- ``POST /cmd/app``             → create app + initial access key
- ``DELETE /cmd/app/<name>``      → delete app (and its event data)
- ``DELETE /cmd/app/<name>/data`` → wipe + re-init the app's event data

Every request runs under the port's
:class:`~predictionio_tpu_torch.utils.http_instrumentation.
InstrumentedHandlerMixin`: ``GET /metrics``, ``/traces.json`` and the
``X-Request-ID`` / ``traceparent`` echo. ``GET /healthz`` reports
whether the event storage resolves and its circuit breaker is not
refusing calls.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.storage.base import (
    AccessKey,
    App,
    generate_access_key,
)
from predictionio_tpu_torch.utils import resilience
from predictionio_tpu_torch.utils.http_instrumentation import (
    InstrumentedHandlerMixin,
    SeveringThreadingHTTPServer,
)

logger = logging.getLogger("pio.torch.adminserver")


@dataclasses.dataclass
class AdminServerConfig:
    """AdminServerConfig (AdminAPI.scala:131-133)."""
    ip: str = "localhost"
    port: int = 7071


class CommandClient:
    """CommandClient.scala:64-156 — the app CRUD command semantics."""

    def __init__(self, reg: Optional[storage.StorageRegistry] = None):
        self.registry = reg or storage.registry()

    def app_new(self, name: str, app_id: Optional[int] = None,
                description: Optional[str] = None) -> Dict[str, Any]:
        apps = self.registry.get_metadata_apps()
        if apps.get_by_name(name) is not None:
            return {"status": 0,
                    "message": f"App {name} already exists. Aborting."}
        if app_id is not None and apps.get(app_id) is not None:
            other = apps.get(app_id)
            return {"status": 0,
                    "message": f"App ID {other.id} already exists and maps "
                               f"to the app '{other.name}'. Aborting."}
        new_id = apps.insert(App(id=app_id or 0, name=name,
                                 description=description))
        if new_id is None:
            return {"status": 0, "message": "Unable to create new app."}
        if not self.registry.get_levents().init(new_id):
            return {"status": 0, "message": "Unable to initialize Event "
                                            f"Store for this app ID: {new_id}."}
        key = generate_access_key()
        inserted = self.registry.get_metadata_access_keys().insert(
            AccessKey(key=key, appid=new_id, events=()))
        if inserted is None:
            return {"status": 0, "message": "Unable to create new access key."}
        return {"status": 1, "message": "App created successfully.",
                "id": new_id, "name": name, "key": inserted}

    def app_list(self) -> Dict[str, Any]:
        apps = sorted(self.registry.get_metadata_apps().get_all(),
                      key=lambda a: a.name)
        keys = self.registry.get_metadata_access_keys()
        return {"status": 1, "message": "Successful retrieved app list.",
                "apps": [{"id": a.id, "name": a.name,
                          "keys": [{"key": k.key, "events": list(k.events)}
                                   for k in keys.get_by_appid(a.id)]}
                         for a in apps]}

    def app_data_delete(self, name: str) -> Dict[str, Any]:
        app = self.registry.get_metadata_apps().get_by_name(name)
        if app is None:
            return {"status": 0, "message": f"App {name} does not exist."}
        lev = self.registry.get_levents()
        ok1 = lev.remove(app.id)
        msg1 = (f"Removed Event Store for this app ID: {app.id}" if ok1
                else "Error removing Event Store for this app.")
        ok2 = lev.init(app.id)
        msg2 = (f"Initialized Event Store for this app ID: {app.id}." if ok2
                else f"Unable to initialize Event Store for this appId: "
                     f"{app.id}.")
        return {"status": 1 if ok1 and ok2 else 0, "message": msg1 + msg2}

    def app_delete(self, name: str) -> Dict[str, Any]:
        from predictionio_tpu_torch.tools.app_commands import (
            delete_app_cascade,
        )

        app = self.registry.get_metadata_apps().get_by_name(name)
        if app is None:
            return {"status": 0, "message": f"App {name} does not exist."}
        try:
            delete_app_cascade(app.id, self.registry)
        except Exception as e:
            return {"status": 0,
                    "message": f"Error removing Event Store for app "
                               f"{app.name}: {e}."}
        return {"status": 1, "message": "App successfully deleted"}


class AdminServer:
    def __init__(self, config: Optional[AdminServerConfig] = None,
                 reg: Optional[storage.StorageRegistry] = None):
        self.config = config or AdminServerConfig()
        self.client = CommandClient(reg)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "AdminServer":
        server = self

        class Handler(_AdminHandler):
            admin_server = server

        self._httpd = SeveringThreadingHTTPServer(
            (self.config.ip, self.config.port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="pio-adminserver", daemon=True)
        self._thread.start()
        logger.info("Admin server is listening on %s:%s",
                    self.config.ip, self.config.port)
        return self

    @property
    def port(self) -> int:
        assert self._httpd is not None
        return self._httpd.server_address[1]

    def serve_forever(self) -> None:
        """Block until stopped, starting the server first when needed."""
        if self._httpd is None:
            self.start()
        assert self._thread is not None
        try:
            self._thread.join()
        except KeyboardInterrupt:
            self.stop()

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    def health_checks(self) -> Dict[str, bool]:
        """Readiness for ``GET /healthz``: the metadata/event storage
        this server administers resolves and its breaker is closed."""
        return {"storage": resilience.storage_ready(
            self.client.registry.get_levents)}

    # -- request handling --------------------------------------------------
    def handle(self, method: str, path: str,
               body: bytes) -> Tuple[int, Dict[str, Any]]:
        parts = [p for p in path.split("/") if p]
        if not parts:
            if method == "GET":
                return 200, {"status": "alive"}
            return 405, {"message": "method not allowed"}
        if parts[0] != "cmd" or len(parts) < 2 or parts[1] != "app":
            return 404, {"message": f"unknown path {path}"}
        if len(parts) == 2:
            if method == "GET":
                return 200, self.client.app_list()
            if method == "POST":
                try:
                    req = json.loads(body.decode("utf-8")) if body else {}
                    name = req["name"]
                except (json.JSONDecodeError, UnicodeDecodeError, KeyError,
                        TypeError) as e:
                    return 400, {"message": f"bad request: {e}"}
                return 200, self.client.app_new(
                    name, app_id=req.get("id"),
                    description=req.get("description"))
            return 405, {"message": "method not allowed"}
        if len(parts) == 3 and method == "DELETE":
            return 200, self.client.app_delete(parts[2])
        if len(parts) == 4 and parts[3] == "data" and method == "DELETE":
            return 200, self.client.app_data_delete(parts[2])
        return 404, {"message": f"unknown path {path}"}


class _AdminHandler(InstrumentedHandlerMixin, BaseHTTPRequestHandler):
    """Mounted on the shared instrumentation mixin (same as the event
    and query servers): request-id/traceparent accept+echo, per-route
    counters + latency histograms under ``server="admin"``, and the
    operator surfaces ``GET /metrics`` / ``GET /traces.json``."""

    admin_server: AdminServer
    # keep-alive (same as the event/query servers): scrapers and CLI
    # polls reuse one TCP connection instead of a handshake per request
    protocol_version = "HTTP/1.1"
    metrics_server_label = "admin"

    def log_message(self, fmt, *args):  # route through logging, not stderr
        logger.debug(fmt, *args)

    def _route_label(self, path: str) -> str:
        if path in ("/", "/healthz", "/metrics", "/traces.json",
                    "/cmd/app"):
            return path
        if path.startswith("/traces/"):
            return "/traces/<id>"
        if path.startswith("/cmd/app/"):
            return ("/cmd/app/<name>/data" if path.endswith("/data")
                    else "/cmd/app/<name>")
        return "<other>"

    def _dispatch(self, method: str) -> None:
        parsed = urllib.parse.urlparse(self.path)
        query = urllib.parse.parse_qs(parsed.query)
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        # strip BEFORE routing/accounting: "/metrics/" must hit the
        # same route label (and untraced-route guard) as "/metrics"
        path = parsed.path.rstrip("/") or "/"

        def handle() -> None:
            if method == "GET" and path == "/healthz":
                self._respond_healthz(self.admin_server.health_checks())
                return
            if method == "GET" and path == "/metrics":
                self._respond_prometheus()
                return
            if method == "GET" and path == "/traces.json":
                self._respond_traces_index(query)
                return
            if method == "GET" and path.startswith("/traces/"):
                self._respond_trace(path[len("/traces/"):], query)
                return
            try:
                status, payload = self.admin_server.handle(
                    method, path, body)
            except Exception as e:  # pragma: no cover - defensive
                logger.exception("admin request failed")
                status, payload = 500, {"message": str(e)}
            self._respond(status, payload)

        self._dispatch_instrumented(method, path, handle)

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def do_DELETE(self):
        self._dispatch("DELETE")


def create_admin_server(config: Optional[AdminServerConfig] = None,
                        reg=None) -> AdminServer:
    """createAdminServer (AdminAPI.scala:136-156)."""
    return AdminServer(config, reg)
