"""The ``resthttp`` event store: the port's wire client against the JAX
package's, on the CPU.

- One wire, both directions: the port's ``RestLEvents`` / ``RestPEvents``
  against a JAX event server, and the JAX client against a port event
  server (each over a ``memory`` or a ``jsonlfs`` store), give the same
  answers to one sequence of CRUD, filtered ``find``, aggregation, tail
  reads and columnar reads as the JAX client against the JAX server.
- Retried appends are deduplicated: id-less raw lines never replay an
  ambiguous failure, keyed ones do; ``X-Idempotency-Retry`` answers a
  byte-identical replay from the digest cache and a cache miss from one
  existence scan, acking the full count; a seeded fault schedule (>= 10%
  of wire calls) leaves a store byte-identical to the fault-free one.
- A ``pio-torch eventserver`` child killed with SIGKILL mid-ingest and
  restarted on its directory loses no acknowledged event.
- Wire config (split timeouts, the deadline, redirects, the path prefix,
  the retry header after ambiguous failures only, stale keep-alives) and
  TLS with an ``openssl`` self-signed pair.
- The recommendation template trained on the CPU from a ``resthttp``
  source has the factors of its training from the server's own store.

Every server binds port 0; breakers and injectors of both packages are
reset around each test.
"""

import datetime as dt
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from predictionio_tpu.data import storage as jstorage
from predictionio_tpu.data.api import EventServer as JEventServer
from predictionio_tpu.data.api import EventServerConfig as JConfig
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage import resthttp as jrest
from predictionio_tpu.utils import faults as jfaults
from predictionio_tpu.utils import resilience as jres
from predictionio_tpu_torch.core.context import ComputeContext
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.data.api import EventServer, EventServerConfig
from predictionio_tpu_torch.data.event import Event as TEvent
from predictionio_tpu_torch.data.event import new_event_id
from predictionio_tpu_torch.data.storage import resthttp as trest
from predictionio_tpu_torch.data.storage.base import App, StorageError
from predictionio_tpu_torch.utils import faults as tfaults
from predictionio_tpu_torch.utils import metrics as tmetrics
from predictionio_tpu_torch.utils import resilience as tres

UTC = dt.timezone.utc
KEY = "torch-wire-key"
T0 = dt.datetime(2021, 3, 1, tzinfo=UTC)
FAST_RETRY_ENV = {
    "PIO_STORAGE_RETRIES": "3",
    "PIO_STORAGE_RETRY_BASE": "0.005",
    "PIO_STORAGE_RETRY_MAX": "0.02",
    "PIO_STORAGE_OP_DEADLINE": "20",
    "PIO_STORAGE_CONNECT_TIMEOUT": "1.0",
}


def t(i):
    return T0 + dt.timedelta(seconds=int(i))


@pytest.fixture(autouse=True)
def _clean_resilience():
    for faults, res in ((jfaults, jres), (tfaults, tres)):
        faults.clear()
        res.reset_breakers()
    yield
    for faults, res in ((jfaults, jres), (tfaults, tres)):
        faults.clear()
        res.reset_breakers()


@pytest.fixture
def fast_retries(monkeypatch):
    for k, v in FAST_RETRY_ENV.items():
        monkeypatch.setenv(k, v)


def _source(backend, path):
    if backend == "memory":
        return {"type": "memory"}
    return {"type": "jsonlfs", "path": str(path), "part_max_events": 16}


def _serve(pkg_storage, Server, Config, backend, path, **kw):
    reg = pkg_storage.StorageRegistry(pkg_storage.StorageConfig(
        sources={"EV": _source(backend, path), "META": {"type": "memory"}},
        repositories={"EVENTDATA": "EV", "METADATA": "META",
                      "MODELDATA": "META"}))
    srv = Server(Config(ip="127.0.0.1", port=0, service_key=KEY, **kw),
                 reg=reg).start()
    return srv, f"{srv.scheme}://{srv.address[0]}:{srv.address[1]}"


@pytest.fixture
def servers(tmp_path, request):
    backend = request.param
    js, jurl = _serve(jstorage, JEventServer, JConfig, backend,
                      tmp_path / "jax")
    ts, turl = _serve(tstorage, EventServer, EventServerConfig, backend,
                      tmp_path / "port")
    yield {"jax": jurl, "port": turl}
    js.stop()
    ts.stop()


def _events(Event, n=40):
    rng = np.random.default_rng(5)
    evs = []
    for i in range(n):
        if i % 9 == 4:
            evs.append(Event(event="$set", entity_type="user",
                             entity_id=f"u{i % 6}",
                             properties={"tier": int(i), "tag": f"t{i}"},
                             event_time=t(i), event_id=f"ev-{i:03d}",
                             creation_time=T0))
        else:
            evs.append(Event(
                event="rate" if i % 4 else "view", entity_type="user",
                entity_id=f"u{rng.integers(0, 6)}",
                target_entity_type="item",
                target_entity_id=f"i{rng.integers(0, 9)}",
                properties={"rating": float(rng.integers(1, 6))},
                event_time=t(i), event_id=f"ev-{i:03d}", creation_time=T0))
    return evs


def _js(evs):
    return [e.to_json() for e in evs]


def _wire_sequence(rest, Event, url, aid):
    """One op sequence through a client package to a server; answers in
    a package-free form."""
    cfg = {"url": url, "service_key": KEY}
    le, pe = rest.RestLEvents(cfg), rest.RestPEvents(cfg)
    out = {"init": le.init(aid)}
    evs = _events(Event)
    out["ids"] = le.insert_batch(evs[:30], aid)
    le.append_raw_lines([e.to_json() for e in evs[30:]], aid)
    out["get"] = le.get("ev-007", aid).to_json()
    out["get-missing"] = le.get("nope", aid)
    out["find"] = _js(le.find(aid))
    out["find-entity"] = _js(le.find(aid, entity_type="user",
                                     entity_id="u2"))
    out["find-rev-limit"] = _js(le.find(aid, reversed=True, limit=7))
    out["find-names-window"] = _js(le.find(
        aid, event_names=["view"], start_time=t(5), until_time=t(30)))
    out["find-no-target"] = _js(le.find(aid, target_entity_type=None))
    out["agg"] = {k: (sorted(v.fields.items()), str(v.first_updated),
                      str(v.last_updated))
                  for k, v in le.aggregate_properties(aid, "user").items()}
    evs1, cur = le.find_since(aid, limit=11)
    evs2, cur2 = le.find_since(aid, cursor=cur)
    out["tail"] = (_js(evs1), _js(evs2), cur2)
    out["tail_cursor"] = le.tail_cursor(aid)
    out["watermark"] = le.tail_watermark(aid)
    batch = pe.find_columnar(aid, event_names=["rate"],
                             value_property="rating")
    out["columnar"] = (batch.entity_ids.tolist(), batch.target_ids.tolist(),
                       batch.values.tolist())
    out["blocks"] = [len(b) for b in pe.find_columnar_blocks(
        aid, value_property="rating", block_size=9)]
    out["delete"] = (le.delete("ev-001", aid), le.delete("ev-001", aid))
    out["delete_until"] = le.delete_until(aid, t(10))
    out["after"] = sorted(e.event_id for e in le.find(aid))
    out["remove"] = le.remove(aid)
    le.close()
    return out


@pytest.mark.parametrize("servers", ["memory", "jsonlfs"], indirect=True)
def test_one_wire_both_directions(servers):
    want = _wire_sequence(jrest, JEvent, servers["jax"], 5)
    assert _wire_sequence(trest, TEvent, servers["jax"], 6) == want
    assert _wire_sequence(jrest, JEvent, servers["port"], 5) == want
    assert _wire_sequence(trest, TEvent, servers["port"], 6) == want
    assert len(want["find"]) == 40 and want["delete"] == (True, False)


@pytest.mark.parametrize("servers", ["jsonlfs"], indirect=True)
def test_wire_errors_equal(servers, monkeypatch):
    for url in (servers["jax"], servers["port"]):
        got = []
        for rest in (jrest, trest):
            le = rest.RestLEvents({"url": url, "service_key": "nope"})
            with pytest.raises(Exception) as ei:
                le.init(1)
            got.append(str(ei.value))
        assert got[0] == got[1] and "serviceKey" in got[1]


def test_wire_disabled_without_service_key():
    tstorage.reset(tstorage.StorageConfig(
        sources={"M": {"type": "memory"}},
        repositories={r: "M" for r in tstorage.REPOSITORIES}))
    srv = EventServer(EventServerConfig(ip="127.0.0.1", port=0)).start()
    try:
        le = trest.RestLEvents({"url": f"http://127.0.0.1:{srv.address[1]}",
                                "service_key": "anything"})
        with pytest.raises(StorageError, match="disabled"):
            le.init(1)
    finally:
        srv.stop()
        tstorage.reset()


# ---------------------------------------------------------------------------
# Retried appends
# ---------------------------------------------------------------------------


@pytest.fixture
def port_server(tmp_path):
    srv, url = _serve(tstorage, EventServer, EventServerConfig, "jsonlfs",
                      tmp_path / "ev")
    yield srv, url
    srv.stop()


def _ev(i):
    return TEvent(event="rate", entity_type="user", entity_id=f"u{i % 7}",
                  target_entity_type="item", target_entity_id=f"i{i % 11}",
                  properties={"rating": float(i % 5 + 1)}, event_time=t(i),
                  event_id=new_event_id(), creation_time=T0)


def test_idless_lines_fail_fast_keyed_lines_retry(fast_retries,
                                                  port_server):
    _, url = port_server
    client = trest.RestLEvents({"url": url, "service_key": KEY})
    client.init(1)
    noid = [json.dumps({"event": "rate", "entityType": "user",
                        "entityId": "u1", "targetEntityType": "item",
                        "targetEntityId": "i1",
                        "eventTime": "2022-05-01T00:00:00+00:00"})]
    tfaults.install("backend=resthttp,op=append_raw_lines,kind=timeout,"
                    "times=1")
    with pytest.raises(TimeoutError):
        client.append_raw_lines(noid, 1)
    tfaults.clear()
    assert list(client.find(1)) == []
    keyed = [_ev(i).to_json() for i in range(3)]
    tfaults.install("backend=resthttp,op=append_raw_lines,kind=timeout,"
                    "times=1")
    client.append_raw_lines(keyed, 1)  # the fault is masked
    tfaults.clear()
    assert len(list(client.find(1))) == 3


def _retried_post(srv, wire, body):
    import http.client as hc

    conn = hc.HTTPConnection(*srv.address, timeout=10)
    try:
        conn.request("POST", wire._full("/storage/events.jsonl",
                                        {"appId": 1}), body=body,
                     headers={"X-Idempotency-Retry": "1",
                              "Content-Type": "application/x-jsonlines"})
        resp = conn.getresponse()
        assert resp.status == 200
        return json.loads(resp.read())["count"]
    finally:
        conn.close()


def test_retry_header_dedups_committed_lines(port_server):
    srv, url = port_server
    wire = trest._Wire({"url": url, "service_key": KEY})
    client = trest.RestLEvents({"url": url, "service_key": KEY})
    body = "\n".join(_ev(i).to_json() for i in range(5)).encode("utf-8")
    wire.call("POST", "/storage/events.jsonl", {"appId": 1}, body=body,
              op="append_raw_lines")
    scans = []
    orig = srv._dedup_retried_lines
    srv._dedup_retried_lines = \
        lambda *a, **k: (scans.append(1), orig(*a, **k))[1]
    # a byte-identical replay: answered from the digest cache, no scan
    assert _retried_post(srv, wire, body) == 5 and scans == []
    got = [e.event_id for e in client.find(1)]
    assert len(got) == 5 == len(set(got))
    # a cache miss (restarted server): one scan, the full count acked
    with srv._append_seen_lock:
        srv._append_seen.clear()
    assert _retried_post(srv, wire, body) == 5 and scans == [1]
    fresh = _ev(99).to_json().encode("utf-8")
    assert _retried_post(srv, wire, fresh) == 1 and scans == [1, 1]
    assert len(list(client.find(1))) == 6
    # a blind re-POST without the header does append
    wire.call("POST", "/storage/events.jsonl", {"appId": 1}, body=body,
              op="append_raw_lines")
    assert len(list(client.find(1))) == 11


def test_ingest_and_reads_byte_identical_under_faults(fast_retries,
                                                      port_server):
    _, url = port_server
    client = trest.RestLEvents({"url": url, "service_key": KEY})
    batches = [[_ev(b * 6 + j) for j in range(6)] for b in range(10)]
    client.init(1)
    client.init(2)
    for evs in batches:
        client.insert_batch(evs, 1)
    tfaults.install("backend=resthttp,kind=refuse,every=3,seed=1;"
                    "backend=resthttp,op=insert_batch,kind=timeout,every=4;"
                    "backend=resthttp,op=insert_batch,kind=torn,every=5")
    for evs in batches:
        client.insert_batch(evs, 2)
    tfaults.clear()
    clean = sorted(e.to_json() for e in client.find(1))
    assert sorted(e.to_json() for e in client.find(2)) == clean
    assert tmetrics.STORAGE_RETRIES.value(backend="resthttp",
                                          op="insert_batch") > 0
    before = tmetrics.FAULTS_INJECTED.value(backend="resthttp", op="find",
                                            kind="torn")
    tfaults.install("backend=resthttp,kind=refuse,every=2;"
                    "backend=resthttp,op=find,kind=torn,times=1")
    assert sorted(e.to_json() for e in client.find(1)) == clean
    tfaults.clear()
    assert tmetrics.FAULTS_INJECTED.value(
        backend="resthttp", op="find", kind="torn") == before + 1


def _spawn_console_server(store, port=0):
    env = dict(os.environ)
    env.update({
        "PIO_STORAGE_SOURCES_EV_TYPE": "jsonlfs",
        "PIO_STORAGE_SOURCES_EV_PATH": str(store),
        "PIO_STORAGE_SOURCES_EV_PART_MAX_EVENTS": "32",
        "PIO_STORAGE_SOURCES_META_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "EV",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "META",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "META"})
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.console",
         "eventserver", "--ip", "127.0.0.1", "--port", str(port),
         "--service-key", KEY], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    for line in proc.stdout:
        m = re.search(r"ready at (\S+)\.$", line.strip())
        if m:
            return proc, m.group(1)
    raise RuntimeError(f"eventserver exited {proc.wait()}")


def test_killed_server_loses_no_acked_event(tmp_path, monkeypatch):
    # the retry budget spans the restart window
    monkeypatch.setenv("PIO_STORAGE_RETRIES", "200")
    monkeypatch.setenv("PIO_STORAGE_RETRY_BASE", "0.05")
    monkeypatch.setenv("PIO_STORAGE_RETRY_MAX", "0.1")
    monkeypatch.setenv("PIO_STORAGE_OP_DEADLINE", "45")
    monkeypatch.setenv("PIO_STORAGE_CONNECT_TIMEOUT", "1.0")
    store = tmp_path / "killstore"
    proc, url = _spawn_console_server(store)
    port = int(url.rsplit(":", 1)[1])
    procs = [proc]
    try:
        client = trest.RestLEvents({"url": url, "service_key": KEY})
        client.init(1)
        acked = []
        restart = threading.Thread(
            target=lambda: procs.append(
                _spawn_console_server(store, port)[0]), daemon=True)
        for b in range(16):
            if b == 8:
                proc.send_signal(signal.SIGKILL)
                proc.wait()
                restart.start()
            acked.extend(client.insert_batch([_ev(b * 10 + j)
                                              for j in range(10)], 1))
        restart.join(60)
        got = [e.event_id for e in client.find(1)]
        assert len(acked) == 160 and sorted(got) == sorted(acked)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)


# ---------------------------------------------------------------------------
# Wire config
# ---------------------------------------------------------------------------


def test_split_timeouts_and_deadline_like_jax(monkeypatch):
    for k in ("PIO_STORAGE_CONNECT_TIMEOUT", "PIO_STORAGE_READ_TIMEOUT",
              "PIO_STORAGE_OP_DEADLINE"):
        monkeypatch.delenv(k, raising=False)
    cfgs = [{"url": "http://h:1"}, {"url": "http://h:1", "timeout": "7"},
            {"url": "http://h:1", "connect_timeout": "0.25",
             "read_timeout": "4"},
            {"url": "http://gw.example.com/pio-events/"}]

    def shape(w):
        return (w.url, w.connect_timeout, w.read_timeout, w.policy.deadline,
                w._full("/storage/events.jsonl", {"appId": 1}), w._pool_max)

    for cfg in cfgs:
        assert shape(trest._Wire(cfg)) == shape(jrest._Wire(cfg))
    w = trest._Wire({"url": "http://h:1"})
    assert (w.connect_timeout, w.read_timeout) == (3.0, 60.0)
    assert w.policy.deadline > w.read_timeout + w.policy.max_delay
    monkeypatch.setenv("PIO_STORAGE_CONNECT_TIMEOUT", "0.5")
    monkeypatch.setenv("PIO_STORAGE_READ_TIMEOUT", "9")
    monkeypatch.setenv("PIO_STORAGE_OP_DEADLINE", "12")
    for cfg in cfgs:
        assert shape(trest._Wire(cfg)) == shape(jrest._Wire(cfg))
    assert trest._Wire(cfgs[0]).policy.deadline == 12.0


class _Resp:
    def __init__(self, status=200, headers=None, body=b'{"count": 1}'):
        self.status = status
        self.headers = headers or {}
        self._body = body

    def read(self, *a):
        return self._body


class _Conn:
    @staticmethod
    def close():
        pass


def test_retry_header_only_after_ambiguous_failure():
    def run_with(first_error):
        w = trest._Wire({"url": "http://h:1"})
        w.policy = tres.RetryPolicy(max_retries=2, base_delay=0.0,
                                    max_delay=0.0)
        seen = []

        def fake(method, pathq, body, headers):
            seen.append(headers)
            if len(seen) == 1:
                raise first_error
            return _Conn, _Resp()

        w._request_once = fake
        w.call("POST", "/storage/events.jsonl", {}, body=b"x")
        return seen

    safe = run_with(trest.StorageUnavailable("refused",
                                             retry_class=tres.SAFE))
    assert len(safe) == 2 and "X-Idempotency-Retry" not in safe[1]
    ambiguous = run_with(trest.StorageTimeout("stalled"))
    assert ambiguous[1].get("X-Idempotency-Retry") == "1"


def test_redirects_same_origin_only():
    def make_wire(responses):
        w = trest._Wire({"url": "http://h:1"})
        w.policy = tres.RetryPolicy(max_retries=0)
        paths = []

        def fake(method, pathq, body, headers):
            paths.append(pathq)
            return _Conn, responses.pop(0)

        w._request_once = fake
        return w, paths

    w, paths = make_wire([
        _Resp(302, {"Location": "http://h:1/storage/init.json/?x=1"}),
        _Resp(200, body=b'{"n": 1}')])
    assert w.call("GET", "/storage/init.json", {}) == (200, {"n": 1})
    assert paths[1] == "/storage/init.json/?x=1"
    w, _ = make_wire([_Resp(301, {"Location": "https://other:9/x"})])
    with pytest.raises(StorageError, match="off-origin"):
        w.call("GET", "/storage/init.json", {})
    w, paths = make_wire([_Resp(301, {"Location": "http://h:1/x"})])
    with pytest.raises(StorageError, match="301"):
        w.call("POST", "/storage/events.jsonl", {}, body=b"x")
    assert len(paths) == 1


def test_stale_keepalive_redials_dropped_response_is_ambiguous():
    class Pooled:
        def __init__(self, fail_at):
            self.fail_at, self.closed = fail_at, False

        def request(self, *a, **k):
            if self.fail_at == "send":
                raise BrokenPipeError("idle socket closed")

        def getresponse(self):
            raise ConnectionResetError("reset before response")

        def close(self):
            self.closed = True

    for fail_at, want_class, redial in (("response", tres.AMBIGUOUS, False),
                                        ("send", tres.SAFE, True)):
        w = trest._Wire({"url": "http://h:1"})
        pooled = Pooled(fail_at)
        w._checkout = lambda: pooled
        dials = []

        def fake_dial():
            dials.append(1)
            raise trest.StorageUnavailable("refused", retry_class=tres.SAFE)

        w._dial = fake_dial
        with pytest.raises(trest.StorageUnavailable) as ei:
            w._request_once("POST", "/x", b"b", {})
        assert tres.classify(ei.value) == want_class
        assert pooled.closed and bool(dials) == redial


def test_unreachable_fails_fast_and_opens_breaker(fast_retries):
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    le = trest.RestLEvents({"url": url})
    t0 = time.perf_counter()
    for _ in range(5):
        with pytest.raises(StorageError, match="unreachable"):
            le.init(1)
    assert time.perf_counter() - t0 < 5.0
    assert tres.breaker_for(url).state == tres.OPEN
    with pytest.raises(tres.CircuitOpenError):
        le.init(1)


# ---------------------------------------------------------------------------
# TLS
# ---------------------------------------------------------------------------


@pytest.fixture
def tls_server(tmp_path):
    cert, key = tmp_path / "cert.pem", tmp_path / "key.pem"
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048",
                    "-nodes", "-keyout", str(key), "-out", str(cert),
                    "-days", "1", "-subj", "/CN=localhost"],
                   check=True, capture_output=True, timeout=60)
    server_json = tmp_path / "server.json"
    server_json.write_text(json.dumps(
        {"ssl": {"certfile": str(cert), "keyfile": str(key)}}))
    srv, url = _serve(tstorage, EventServer, EventServerConfig, "jsonlfs",
                      tmp_path / "events",
                      server_config_path=str(server_json))
    assert url.startswith("https://")
    yield url, str(cert)
    srv.stop()


def test_crud_and_stream_over_tls(tls_server, fast_retries):
    url, cert = tls_server
    cfg = {"url": url, "service_key": KEY, "ca_file": cert,
           "verify_hostname": "false"}
    le = trest.RestLEvents(cfg)
    le.init(90)
    le.insert_batch([_ev(i) for i in range(30)], 90)
    assert len(list(le.find(90, limit=-1))) == 30
    assert len(trest.RestPEvents(cfg).find_columnar(
        90, value_property="rating")) == 30
    # the JAX client pins the same certificate the same way
    assert len(list(jrest.RestLEvents(cfg).find(90))) == 30
    with pytest.raises(StorageError, match="unreachable|certificate"):
        trest.RestLEvents({"url": url, "service_key": KEY}).init(91)
    with pytest.raises(StorageError):
        trest.RestLEvents({"url": url.replace("https://", "http://"),
                           "service_key": KEY}).init(92)
    insecure = trest.RestLEvents({"url": url, "service_key": KEY,
                                  "insecure_skip_verify": "true"})
    assert len(list(insecure.find(90))) == 30


# ---------------------------------------------------------------------------
# Training from a resthttp source
# ---------------------------------------------------------------------------


def _train(st, aid_name):
    from predictionio_tpu_torch.workflow import create_server as tserver
    from predictionio_tpu_torch.workflow import create_workflow as tcw

    cpu = ComputeContext(device="cpu")
    assert tcw.create_workflow(tcw.WorkflowConfig(
        engine_factory="predictionio_tpu_torch.templates.recommendation."
                       "engine:engine_factory"),
        {"datasource": {"params": {"appName": aid_name}},
         "preparator": {"params": {"bucketed": True}},
         "algorithms": [{"name": "als", "params": {
             "rank": 4, "numIterations": 3, "seed": 2}}]}, ctx=cpu)
    dep = tserver.build_deployment(tserver.resolve_engine_instance(None),
                                   cpu)
    return dep.models[0]


def test_remote_training_equals_local(tmp_path):
    """The template trains from a ``resthttp`` source (the events live
    in a ``jsonlfs`` store behind a port event server) to the factors
    it trains from that store read directly."""
    store = tmp_path / "events"
    srv, url = _serve(tstorage, EventServer, EventServerConfig, "jsonlfs",
                      store)
    try:
        rng = np.random.default_rng(1)
        evs = [TEvent(event="rate", entity_type="user",
                      entity_id=f"u{rng.integers(0, 20)}",
                      target_entity_type="item",
                      target_entity_id=f"i{rng.integers(0, 12)}",
                      properties={"rating": float(rng.integers(1, 6))},
                      event_time=t(i), event_id=f"e{i}", creation_time=T0)
               for i in range(400)]
        models = []
        for src in ({"type": "resthttp", "url": url, "service_key": KEY},
                    {"type": "jsonlfs", "path": str(store),
                     "part_max_events": 16}):
            tstorage.reset(tstorage.StorageConfig(
                sources={"EV": src, "LOCAL": {"type": "memory"}},
                repositories={"EVENTDATA": "EV", "METADATA": "LOCAL",
                              "MODELDATA": "LOCAL"}))
            aid = tstorage.get_metadata_apps().insert(App(0, "remoteapp"))
            assert aid == 1
            if not models:
                le = tstorage.get_levents()
                le.init(aid)
                le.insert_batch(evs, aid)
            models.append(_train(tstorage, "remoteapp"))
        remote, local = models
        assert list(remote.user_map.labels) == list(local.user_map.labels)
        assert list(remote.item_map.labels) == list(local.item_map.labels)
        np.testing.assert_array_equal(remote.user_factors,
                                      local.user_factors)
        np.testing.assert_array_equal(remote.item_factors,
                                      local.item_factors)
    finally:
        tstorage.reset()
        srv.stop()
