"""The port's query server: its operator surface, on the CPU.

- ``POST /profile/start`` and ``/profile/stop`` are gated by the
  ``server.json`` access key when one is set (403 without it), answer
  409 on a second start and on an idle stop, and write the capture's
  ``trace.json``; the status codes are the JAX query server's for the
  same sequence.
- A ``server.json`` with an ``ssl`` section (a self-signed pair made
  with ``openssl``) serves HTTPS; plain HTTP to it fails.
- ``undeploy`` stops a server in either scheme; ``start`` first stops a
  stale server still answering on its port.
"""

import http.client
import json
import os
import socket
import ssl
import subprocess
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu_torch.templates.recommendation.engine import (
    engine_factory,
)
from predictionio_tpu_torch.weights import als_model_from_numpy
from predictionio_tpu_torch.workflow import create_server as tserver


def deployment():
    rng = np.random.default_rng(3)
    X = rng.integers(-3, 4, (6, 4)).astype(np.float32)
    Y = rng.integers(-3, 4, (30, 4)).astype(np.float32)
    model = als_model_from_numpy(X, Y, [f"u{i}" for i in range(6)],
                                 [f"i{i}" for i in range(30)], {0: [1, 2]},
                                 device="cpu")
    engine = engine_factory()
    return tserver.deployment_from_models(
        engine, engine.engine_params_from_variant({}), [model])


def write_config(tmp_path, **raw):
    path = tmp_path / "server.json"
    path.write_text(json.dumps(raw))
    return str(path)


def serve(config_path=None, port=0, ip="127.0.0.1"):
    cfg = tserver.ServerConfig(ip=ip, port=port,
                               server_config_path=config_path)
    return tserver.QueryServer(cfg, deployment()).start()


def status_of(method, url, context=None):
    req = urllib.request.Request(url, data=b"" if method == "POST" else None,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=30, context=context) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


PROFILE_SEQUENCE = [
    ("/profile/stop", ""),
    ("/profile/start", ""),
    ("/profile/start", "?accessKey=wrong"),
    ("/profile/start", "?accessKey=op-key"),
    ("/profile/start", "?accessKey=op-key"),
    ("/profile/stop", "?accessKey=wrong"),
    ("/profile/stop", "?accessKey=op-key"),
    ("/profile/stop", "?accessKey=op-key"),
]
WANT_STATUSES = [403, 403, 403, 200, 409, 403, 200, 409]


def test_profile_routes_are_gated_and_single_flight(tmp_path,
                                                    monkeypatch):
    monkeypatch.setenv("PIO_PROFILE_DIR", str(tmp_path / "profiles"))
    srv = serve(write_config(tmp_path, accessKey="op-key"))
    try:
        base = "http://{}:{}".format(*srv.address)
        got = [status_of("POST", base + path + q)
               for path, q in PROFILE_SEQUENCE]
        assert [s for s, _ in got] == WANT_STATUSES
        assert got[0][1] == {"message": "invalid accessKey"}
        started, written = got[3][1], got[6][1]
        assert written["profileDir"] == started["profileDir"]
        assert os.path.isfile(os.path.join(written["profileDir"],
                                           "trace.json"))
        assert "already running" in got[4][1]["message"]
        assert got[7][1] == {"message": "no profiler capture is running"}
        # the query path is untouched by the captures
        assert status_of("GET", base + "/")[0] == 200
    finally:
        srv.stop()


def test_profile_routes_match_the_jax_server(tmp_path, monkeypatch):
    """The JAX query server answers the same sequence with the same
    codes (its deployment: one tiny trained instance)."""
    import importlib

    from predictionio_tpu.data import storage as jstorage
    from test_torch_lifecycle import FACTORIES, configure, fill, jcw, \
        variant

    jserver = importlib.import_module(
        "predictionio_tpu.workflow.create_server")
    monkeypatch.setenv("PIO_PROFILE_DIR", str(tmp_path / "profiles"))
    configure(jstorage, "memory", None)
    try:
        fill(jstorage, "predictionio_tpu")
        jcw.create_workflow(jcw.WorkflowConfig(engine_factory=FACTORIES[0]),
                            variant(3, True))
        cfg = jserver.ServerConfig(
            ip="127.0.0.1", port=0,
            server_config_path=write_config(tmp_path, accessKey="op-key"))
        srv = jserver.QueryServer(cfg).start(undeploy_stale=False)
        try:
            base = "http://{}:{}".format(*srv.address)
            got = [status_of("POST", base + path + q)[0]
                   for path, q in PROFILE_SEQUENCE]
        finally:
            srv.stop()
    finally:
        jstorage.reset()
    assert got == WANT_STATUSES


def test_profile_routes_are_open_without_a_key(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_PROFILE_DIR", str(tmp_path / "profiles"))
    srv = serve(write_config(tmp_path))
    try:
        base = "http://{}:{}".format(*srv.address)
        assert status_of("POST", base + "/profile/start")[0] == 200
        assert status_of("POST", base + "/profile/stop")[0] == 200
    finally:
        srv.stop()


@pytest.fixture
def tls_pair(tmp_path):
    cert, key = tmp_path / "cert.pem", tmp_path / "key.pem"
    try:
        subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
             "-keyout", str(key), "-out", str(cert), "-days", "1",
             "-subj", "/CN=127.0.0.1"],
            check=True, capture_output=True, timeout=60)
    except (OSError, subprocess.CalledProcessError) as e:
        pytest.fail(f"openssl could not make a self-signed pair: {e}")
    return str(cert), str(key)


def test_tls_from_server_json(tmp_path, tls_pair):
    cert, key = tls_pair
    srv = serve(write_config(tmp_path, ssl={"certfile": cert,
                                            "keyfile": key}))
    try:
        assert srv.scheme == "https"
        host, port = srv.address
        ctx = ssl.create_default_context(cafile=cert)
        ctx.check_hostname = False
        status, body = status_of("GET", f"https://{host}:{port}/",
                                 context=ctx)
        assert status == 200 and body["status"] == "alive"
        conn = http.client.HTTPSConnection(host, port, timeout=30,
                                           context=ctx)
        conn.request("POST", "/queries.json",
                     body=json.dumps({"user": "u1", "num": 3}))
        resp = conn.getresponse()
        assert resp.status == 200
        assert len(json.loads(resp.read())["itemScores"]) == 3
        conn.close()
        with pytest.raises((urllib.error.URLError, ConnectionError,
                            http.client.HTTPException)):
            urllib.request.urlopen(f"http://{host}:{port}/", timeout=10)
        assert tserver.undeploy(host, port, scheme="https")
        srv._thread.join(timeout=10)
        assert srv._httpd is None
    finally:
        srv.stop()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_undeploy_and_the_stale_server_probe():
    port = free_port()
    first = serve(port=port)
    assert first.address == ("127.0.0.1", port)
    # a second server on the same port stops the first before it binds
    second = serve(port=port)
    try:
        if first._thread is not None:
            first._thread.join(timeout=10)
        assert first._httpd is None
        assert second.address == ("127.0.0.1", port)
        assert status_of("GET", f"http://127.0.0.1:{port}/")[0] == 200
        assert tserver.undeploy("127.0.0.1", port)
        second._thread.join(timeout=10)
        assert second._httpd is None
        assert not tserver.undeploy("127.0.0.1", port)
        assert not tserver.undeploy("127.0.0.1", port, scheme="https")
    finally:
        first.stop()
        second.stop()
