"""Evaluation dashboard (:9000).

The port's copy of ``predictionio_tpu/tools/dashboard.py``. Parity
target: ``tools/.../dashboard/Dashboard.scala:88-156`` — a
key-authenticated HTML index of completed evaluation instances plus
per-instance evaluator results in txt/html/json, and a CORS-enabled
``local_evaluator_results.json`` used by external tooling:

- ``GET /``  (auth)              → HTML: server info, PIO_* env, completed
  evaluations table with links (Twirl ``index.scala.html`` analog)
- ``GET /engine_instances/<id>/evaluator_results.txt|html|json``
- ``GET /engine_instances/<id>/local_evaluator_results.json``  (CORS)

Key authentication and TLS come from the port's ``common/``; ``GET
/metrics`` and the request-id / ``traceparent`` echo from its
``utils/http_instrumentation.py``. ``GET /healthz`` reports whether the
storage resolves and its circuit breaker is not refusing calls.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import html as _html
import json
import logging
import os
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from predictionio_tpu_torch.common import (
    KeyAuthentication,
    ServerConfig,
    SSLConfiguration,
)
from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.utils import resilience, tracing
from predictionio_tpu_torch.utils.http_instrumentation import (
    InstrumentedHandlerMixin,
    SeveringThreadingHTTPServer,
)

logger = logging.getLogger("pio.torch.dashboard")


@dataclasses.dataclass
class DashboardConfig:
    """DashboardConfig (Dashboard.scala:37-40).

    ``trace_dir``: where ``GET /traces/<id>`` looks for stored traces
    (the ``--trace-dir`` JSONL export of the serving daemons) after the
    dashboard's own in-process buffer; defaults to ``$PIO_TRACE_DIR``."""
    ip: str = "localhost"
    port: int = 9000
    server_config: Optional[ServerConfig] = None
    trace_dir: Optional[str] = None


class Dashboard:
    def __init__(self, config: Optional[DashboardConfig] = None,
                 reg: Optional[storage.StorageRegistry] = None):
        self.config = config or DashboardConfig()
        self.registry = reg or storage.registry()
        self.auth = KeyAuthentication(self.config.server_config)
        self.ssl = SSLConfiguration(self.config.server_config) \
            if self.config.server_config else None
        self.start_time = _dt.datetime.now(tz=_dt.timezone.utc)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def health_checks(self):
        """Readiness for ``GET /healthz``: the metadata storage the
        instance list reads resolves and its breaker is closed."""
        return {"storage": resilience.storage_ready(
            self.registry.get_levents)}

    def start(self) -> "Dashboard":
        server = self

        class Handler(_DashboardHandler):
            dashboard = server

        self._httpd = SeveringThreadingHTTPServer(
            (self.config.ip, self.config.port), Handler)
        self._httpd.daemon_threads = True
        if self.ssl is not None and self.ssl.enabled:
            self.ssl.wrap_server(self._httpd)  # HTTPS as in the reference
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="pio-dashboard", daemon=True)
        self._thread.start()
        logger.info("Dashboard is listening on %s:%s",
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

    # -- routes ------------------------------------------------------------
    def handle(self, path: str, params) -> Tuple[int, str, str, dict]:
        """Returns (status, content_type, body, extra_headers).

        Auth gates EVERY route, not only the index — the reference
        authenticates only ``/`` (Dashboard.scala:89) but then the key
        would protect nothing of value; evaluation results are the
        sensitive payload.
        """
        if not self.auth.authenticate(params):
            return 401, "application/json", \
                json.dumps({"message": "Invalid accessKey."}), {}
        parts = [p for p in path.split("/") if p]
        if not parts:
            return 200, "text/html; charset=utf-8", self._index_html(), {}
        if parts[0] == "traces" and len(parts) == 2:
            return self._trace_view(parts[1])
        if parts[0] == "engine_instances" and len(parts) == 3:
            instance = self.registry.get_metadata_evaluation_instances() \
                .get(parts[1])
            if instance is None:
                return 404, "text/plain", "not found", {}
            kind = parts[2]
            if kind == "evaluator_results.txt":
                return 200, "text/plain; charset=utf-8", \
                    instance.evaluator_results, {}
            if kind == "evaluator_results.html":
                return 200, "text/html; charset=utf-8", \
                    instance.evaluator_results_html, {}
            if kind == "evaluator_results.json":
                return 200, "application/json", \
                    instance.evaluator_results_json, {}
            if kind == "local_evaluator_results.json":
                return 200, "application/json", \
                    instance.evaluator_results_json, \
                    {"Access-Control-Allow-Origin": "*"}  # CORSSupport
        return 404, "text/plain", "not found", {}

    def _trace_view(self, trace_id: str) -> Tuple[int, str, str, dict]:
        """HTML timeline of one stored trace: the dashboard's own
        buffer first (requests it served itself), then the shared
        ``--trace-dir`` JSONL export — where fragments the query AND
        event servers wrote merge into one cross-process timeline."""
        record = tracing.trace_buffer().get(trace_id)
        if record is None:
            trace_dir = self.config.trace_dir \
                or os.environ.get("PIO_TRACE_DIR") or None
            if trace_dir:
                found = tracing.load_traces_from_dir(trace_dir,
                                                     trace_id=trace_id)
                record = found[0] if found else None
        if record is None:
            return 404, "text/plain", f"trace {trace_id} not found", {}
        return (200, "text/html; charset=utf-8",
                tracing.render_trace_html(record), {})

    def _index_html(self) -> str:
        """The Twirl index template analog (dashboard/index.scala.html)."""
        completed = self.registry.get_metadata_evaluation_instances() \
            .get_completed()
        env_rows = "".join(
            f"<tr><td>{_html.escape(k)}</td><td>{_html.escape(v)}</td></tr>"
            for k, v in sorted(os.environ.items())
            if k.startswith("PIO_"))
        # result links carry the key so they remain reachable under auth
        key_q = ""
        if self.auth.enabled:
            key_q = "?accessKey=" + urllib.parse.quote(
                self.auth.config.access_key)
        rows = []
        for i in completed:
            iid = _html.escape(i.id)
            rows.append(
                f"<tr><td>{iid}</td>"
                f"<td>{_html.escape(i.start_time.isoformat())}</td>"
                f"<td>{_html.escape(i.end_time.isoformat())}</td>"
                f"<td>{_html.escape(i.evaluation_class)}</td>"
                f"<td>{_html.escape(i.batch)}</td>"
                f"<td>"
                f"<a href='/engine_instances/{iid}/evaluator_results.html"
                f"{key_q}'>HTML</a> "
                f"<a href='/engine_instances/{iid}/evaluator_results.json"
                f"{key_q}'>JSON</a> "
                f"<a href='/engine_instances/{iid}/evaluator_results.txt"
                f"{key_q}'>TXT</a></td></tr>")
        return f"""<!DOCTYPE html>
<html><head><title>PredictionIO Dashboard</title></head><body>
<h1>PredictionIO Dashboard</h1>
<p>Server started at {self.start_time.isoformat()}</p>
<h2>Completed evaluations</h2>
<table border="1">
<tr><th>ID</th><th>Started</th><th>Finished</th><th>Evaluation</th>
<th>Batch</th><th>Results</th></tr>
{''.join(rows) or '<tr><td colspan="6">none</td></tr>'}
</table>
<h2>Environment</h2>
<table border="1">{env_rows}</table>
</body></html>"""


class _DashboardHandler(InstrumentedHandlerMixin, BaseHTTPRequestHandler):
    """Mounted on the shared instrumentation mixin (same as the event
    and query servers): request-id/traceparent accept+echo, per-route
    counters + latency histograms under ``server="dashboard"``, and the
    unauthenticated operator scrape surface ``GET /metrics`` (the
    key-authed routes stay authed)."""

    dashboard: Dashboard
    # keep-alive (same as the event/query servers): a Prometheus
    # scraper or pio-trace poller reuses one TCP connection instead of
    # paying a handshake per request
    protocol_version = "HTTP/1.1"
    metrics_server_label = "dashboard"

    def log_message(self, fmt, *args):
        logger.debug(fmt, *args)

    def _route_label(self, path: str) -> str:
        if path in ("/", "/healthz", "/metrics"):
            return path
        parts = [p for p in path.split("/") if p]
        if parts and parts[0] == "engine_instances" and len(parts) == 3:
            return f"/engine_instances/<id>/{parts[2]}"
        if parts and parts[0] == "traces" and len(parts) == 2:
            return "/traces/<id>"
        return "<other>"

    def do_GET(self):
        parsed = urllib.parse.urlparse(self.path)
        params = urllib.parse.parse_qs(parsed.query)
        # strip BEFORE routing/accounting: "/metrics/" must hit the
        # same route label (and untraced-route guard) as "/metrics"
        path = parsed.path.rstrip("/") or "/"

        def handle() -> None:
            if path == "/healthz":
                self._respond_healthz(self.dashboard.health_checks())
                return
            if path == "/metrics":
                self._respond_prometheus()
                return
            try:
                status, ctype, body, extra = self.dashboard.handle(
                    path, params)
            except Exception as e:  # pragma: no cover - defensive
                logger.exception("dashboard request failed")
                status, ctype, body, extra = 500, "text/plain", str(e), {}
            self._respond_bytes(status, body.encode("utf-8"), ctype,
                                extra_headers=extra)

        self._dispatch_instrumented("GET", path, handle)


def create_dashboard(config: Optional[DashboardConfig] = None,
                     reg=None) -> Dashboard:
    """createDashboard (Dashboard.scala:164-174)."""
    return Dashboard(config, reg)
