"""The port's admin server and dashboard against the JAX package's.

Each package gets a memory store of its own holding the same records.
One request sequence goes to the JAX server and to the port's (each on
port 0); status codes and bodies must be equal once the minted ids are
normalised (access keys, the dashboard's start time). Then the cases of
``tests/test_admin_dashboard.py`` run against the port's servers: app
delete drops its channels, ``GET /metrics`` counts the routes under
their patterns, ``X-Request-ID`` / ``traceparent`` are echoed, the key
gates every dashboard route, and ``GET /traces/<id>`` renders a trace
from a ``--trace-dir`` export.
"""

import datetime as dt
import json
import re
import urllib.error
import urllib.request

import pytest

from predictionio_tpu.common import ServerConfig as JServerConfig
from predictionio_tpu.data import storage as jstorage
from predictionio_tpu.data.storage.base import (
    EvaluationInstance as JEvaluationInstance,
)
from predictionio_tpu.tools import admin_server as jadmin
from predictionio_tpu.tools import dashboard as jdash
from predictionio_tpu_torch.common import ServerConfig as TServerConfig
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.data.storage.base import (
    Channel,
    EvaluationInstance as TEvaluationInstance,
)
from predictionio_tpu_torch.tools import admin_server as tadmin
from predictionio_tpu_torch.tools import dashboard as tdash
from predictionio_tpu_torch.utils import metrics as tmetrics
from predictionio_tpu_torch.utils import tracing as ttracing

from test_torch_lifecycle import configure

UTC = dt.timezone.utc
# a key may start or end with "-" (URL-safe base64), where \b finds no
# word boundary
KEY_RE = re.compile(r"(?<![A-Za-z0-9_-])[A-Za-z0-9_-]{64}(?![A-Za-z0-9_-])")


def req(url, method="GET", body=None, headers=None):
    """(status, payload, headers): JSON bodies parsed, others as text."""
    r = urllib.request.Request(url, method=method, headers=headers or {},
                               data=body.encode() if body else None)
    try:
        with urllib.request.urlopen(r, timeout=5) as resp:
            status, raw, hdrs = resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as e:
        status, raw, hdrs = e.code, e.read(), e.headers
    text = raw.decode()
    if "json" in (hdrs.get("Content-Type") or ""):
        return status, json.loads(text or "null"), hdrs
    return status, text, hdrs


def normalised(payload):
    """Access keys and the dashboard's start time replaced by
    placeholders."""
    text = json.dumps(payload) if not isinstance(payload, str) else payload
    text = KEY_RE.sub("<key>", text)
    text = re.sub(r"Server started at [^<]+", "Server started at <t>", text)
    return json.loads(text) if not isinstance(payload, str) else text


@pytest.fixture
def stores(tmp_path):
    configure(jstorage, "memory", tmp_path / "jax.db")
    configure(tstorage, "memory", tmp_path / "port.db")
    yield
    jstorage.reset()
    tstorage.reset()


@pytest.fixture
def admins(stores):
    servers = [mod.AdminServer(mod.AdminServerConfig(ip="127.0.0.1",
                                                     port=0)).start()
               for mod in (jadmin, tadmin)]
    yield [f"http://127.0.0.1:{s.port}" for s in servers]
    for s in servers:
        s.stop()


ADMIN_SEQUENCE = [
    ("GET", "/", None),
    ("GET", "/healthz", None),
    ("POST", "/cmd/app", json.dumps({"name": "adminapp"})),
    ("POST", "/cmd/app", json.dumps({"name": "adminapp"})),
    ("POST", "/cmd/app", json.dumps({"name": "other", "id": 7,
                                     "description": "d"})),
    ("POST", "/cmd/app", json.dumps({"name": "clash", "id": 7})),
    ("GET", "/cmd/app", None),
    ("DELETE", "/cmd/app/adminapp/data", None),
    ("DELETE", "/cmd/app/adminapp", None),
    ("GET", "/cmd/app", None),
    ("DELETE", "/cmd/app/adminapp", None),
    ("DELETE", "/cmd/app/adminapp/data", None),
    ("POST", "/cmd/app", "{nope"),
    ("POST", "/cmd/app", json.dumps({"nameless": 1})),
    ("GET", "/cmd/nosuch", None),
    ("PUT", "/", None),
]


@pytest.mark.parametrize("step", range(len(ADMIN_SEQUENCE)),
                         ids=lambda i: " ".join(
                             str(p) for p in ADMIN_SEQUENCE[i][:2]))
def test_admin_answers_as_the_jax_admin(admins, step):
    """Each request of the sequence (the ones before it replayed first)
    answers with the JAX server's status and body."""
    for i in range(step + 1):
        method, path, body = ADMIN_SEQUENCE[i]
        got = [req(base + path, method, body)[:2] for base in admins]
    want, mine = got
    assert mine[0] == want[0]
    assert normalised(mine[1]) == normalised(want[1])


def test_admin_created_key_lists_in_both(admins):
    _, j_created, _ = req(admins[0] + "/cmd/app", "POST",
                          json.dumps({"name": "keyed"}))
    _, t_created, _ = req(admins[1] + "/cmd/app", "POST",
                          json.dumps({"name": "keyed"}))
    assert len(t_created["key"]) == len(j_created["key"]) == 64
    _, listing, _ = req(admins[1] + "/cmd/app")
    assert listing["apps"][0]["keys"] == [{"key": t_created["key"],
                                           "events": []}]
    assert tstorage.get_metadata_access_keys().get(t_created["key"]) \
        is not None


def test_app_delete_cleans_channels(admins):
    base = admins[1]
    _, created, _ = req(base + "/cmd/app", "POST",
                        json.dumps({"name": "chanapp"}))
    appid = created["id"]
    assert tstorage.get_metadata_channels().insert(
        Channel(0, "ch1", appid)) is not None
    _, deleted, _ = req(base + "/cmd/app/chanapp", "DELETE")
    assert deleted["status"] == 1
    assert tstorage.get_metadata_channels().get_by_appid(appid) == []


def _series(families, name, **labels):
    for s in families[name]["series"]:
        if s["labels"] == labels:
            return s
    raise AssertionError(f"no {name} series {labels}")


def scrape(base):
    status, text, hdrs = req(base + "/metrics")
    assert status == 200 and hdrs["Content-Type"].startswith("text/plain")
    return tmetrics.parse_prometheus(text)


def test_admin_metrics_count_route_patterns(admins):
    base = admins[1]
    req(base + "/")
    req(base + "/cmd/app")
    req(base + "/cmd/app/nosuchapp", "DELETE")
    fams = scrape(base)
    assert _series(fams, "pio_http_requests_total", method="GET",
                   route="/cmd/app", server="admin",
                   status="200")["value"] >= 1
    routes = {s["labels"].get("route")
              for s in fams["pio_http_requests_total"]["series"]
              if s["labels"].get("server") == "admin"}
    assert "/cmd/app/<name>" in routes
    assert not any(r and "nosuchapp" in r for r in routes)


@pytest.mark.parametrize("which", [0, 1], ids=["admin", "dashboard"])
def test_request_id_and_traceparent_echo(stores, which):
    server = (tadmin.AdminServer(tadmin.AdminServerConfig(
        ip="127.0.0.1", port=0)) if which == 0 else tdash.Dashboard(
        tdash.DashboardConfig(ip="127.0.0.1", port=0))).start()
    try:
        _, _, hdrs = req(f"http://127.0.0.1:{server.port}/", headers={
            "X-Request-ID": "admin-rid-7",
            "traceparent": "00-" + "fe" * 16 + "-" + "dc" * 8 + "-01"})
        assert hdrs["X-Request-ID"] == "admin-rid-7"
        assert hdrs["traceparent"].split("-")[1] == "fe" * 16
    finally:
        server.stop()


def evaluation_instance(cls):
    return cls(id="ev1", status="EVALCOMPLETED",
               start_time=dt.datetime(2021, 1, 1, tzinfo=UTC),
               end_time=dt.datetime(2021, 1, 2, tzinfo=UTC),
               evaluation_class="my.Eval", batch="b1",
               evaluator_results="one-liner",
               evaluator_results_html="<b>html</b>",
               evaluator_results_json='{"metric": 1.5}')


@pytest.fixture(params=[None, "sekret"], ids=["open", "keyed"])
def dashboards(stores, request):
    jstorage.get_metadata_evaluation_instances().insert(
        evaluation_instance(JEvaluationInstance))
    tstorage.get_metadata_evaluation_instances().insert(
        evaluation_instance(TEvaluationInstance))
    key = request.param
    servers = [mod.Dashboard(mod.DashboardConfig(
        ip="127.0.0.1", port=0, server_config=cfg(access_key=key)
        if key else None)).start()
        for mod, cfg in ((jdash, JServerConfig), (tdash, TServerConfig))]
    yield [f"http://127.0.0.1:{s.port}" for s in servers], key, servers
    for s in servers:
        s.stop()


DASH_PATHS = [
    "/",
    "/engine_instances/ev1/evaluator_results.txt",
    "/engine_instances/ev1/evaluator_results.html",
    "/engine_instances/ev1/evaluator_results.json",
    "/engine_instances/ev1/local_evaluator_results.json",
    "/engine_instances/nope/evaluator_results.json",
    "/engine_instances/ev1/other.bin",
    "/nosuch",
    "/healthz",
]


@pytest.mark.parametrize("key_q", ["", "?accessKey=sekret",
                                   "?accessKey=wrong"],
                         ids=["no key", "right key", "wrong key"])
@pytest.mark.parametrize("path", DASH_PATHS)
def test_dashboard_answers_as_the_jax_dashboard(dashboards, path, key_q):
    bases, _, _ = dashboards
    (js, jbody, jh), (ts, tbody, th) = [req(b + path + key_q)
                                        for b in bases]
    assert ts == js
    assert normalised(tbody) == normalised(jbody)
    assert th.get("Access-Control-Allow-Origin") == \
        jh.get("Access-Control-Allow-Origin")
    assert th.get("Content-Type") == jh.get("Content-Type")


def test_dashboard_lists_the_completed_instance(dashboards):
    bases, key, _ = dashboards
    status, body, _ = req(bases[1] + "/" + (f"?accessKey={key}"
                                            if key else ""))
    assert status == 200 and "ev1" in body and "my.Eval" in body
    if key:
        # the result links carry the key, so they stay reachable
        assert f"evaluator_results.json?accessKey={key}" in body
        assert req(bases[1] + "/")[0] == 401


def test_dashboard_metrics_unauthenticated(dashboards):
    bases, _, _ = dashboards
    req(bases[1] + "/")
    fams = scrape(bases[1])
    assert _series(fams, "pio_http_request_seconds", route="/",
                   server="dashboard")["count"] >= 1


def test_dashboard_trace_timeline_view(stores, tmp_path):
    """``GET /traces/<id>`` renders a trace from the ``--trace-dir``
    export when the dashboard's own buffer does not hold it."""
    buf = ttracing.trace_buffer()
    prior = (buf.enabled, buf.sample_rate, buf.slow_threshold_sec)
    buf.reset()
    buf.enabled, buf.sample_rate = True, 1.0
    buf.slow_threshold_sec = 3600.0
    buf.set_export_dir(str(tmp_path))
    server = tdash.Dashboard(tdash.DashboardConfig(
        ip="127.0.0.1", port=0, trace_dir=str(tmp_path))).start()
    try:
        with ttracing.trace_scope("deep.query") as root:
            with ttracing.span("serve.predict"):
                pass
        tid = root.trace_id
        buf.reset()  # not in the buffer: it loads from the directory
        base = f"http://127.0.0.1:{server.port}"
        status, body, _ = req(base + f"/traces/{tid}")
        assert status == 200 and tid in body and "serve.predict" in body
        assert req(base + "/traces/deadbeef")[0] == 404
    finally:
        server.stop()
        buf.set_export_dir(None)
        buf.reset()
        buf.enabled, buf.sample_rate, buf.slow_threshold_sec = prior
