"""The port's ``pio`` console against the JAX package's, on the CPU.

- ``build_parser`` of both packages has the same verbs and the same
  options on each (the port adds ``--device`` to ``train``, ``eval`` and
  ``deploy``), and ``eval``'s arguments parse alike.
- ``pio app`` and ``pio accesskey`` print what the JAX console prints,
  access keys aside.
- ``pio export`` of a store the JAX package wrote, the port's ``pio
  import`` of that file, and the port's ``pio export`` give JAX's file
  byte for byte, in JSONL and (member by member) in the columnar npz.
- ``template get`` -> ``build`` -> ``train --device cpu`` -> ``deploy
  --device cpu`` (a second process) -> ``undeploy`` answers what the
  port's library path answers for the same instance; afterwards the port
  answers nothing.
- ``train`` and ``deploy`` without ``--device`` raise where CUDA is
  absent, and each verb or option whose module is not ported raises and
  names its ROADMAP item.
- The same events written through ``insert_raw_batch`` and through
  ``pio import`` plus the event server's ``/batch/events.json`` train to
  the same factors.
"""

import argparse
import datetime as dt
import json
import os
import pathlib
import re
import subprocess
import sys
import threading
import urllib.error
import urllib.request
import zipfile

import numpy as np
import pytest
import torch

from predictionio_tpu.data import storage as jstorage
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.tools import cli as jcli
from predictionio_tpu_torch.core.context import ComputeContext
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.data.api import EventServer, EventServerConfig
from predictionio_tpu_torch.data.event import Event as TEvent
from predictionio_tpu_torch.tools import cli as tcli
from predictionio_tpu_torch.workflow import create_server as tserver
from predictionio_tpu_torch.workflow import create_workflow as tcw

from test_torch_lifecycle import configure, fill

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = ComputeContext(device="cpu")
UTC = dt.timezone.utc
PORT_ONLY = {("train", "--device"), ("eval", "--device"),
             ("deploy", "--device"), ("batchpredict", "--device")}


def surface(parser):
    """{verb path: {option: (nargs, default, choices, type, required)}}
    over every (sub)parser."""
    out = {}

    def walk(p, path):
        opts = {}
        for a in p._actions:
            if isinstance(a, argparse._SubParsersAction):
                for name, sp in a.choices.items():
                    walk(sp, path + (name,))
            elif not isinstance(a, argparse._HelpAction):
                key = a.option_strings[-1] if a.option_strings else a.dest
                opts[key] = (a.nargs, repr(a.default), a.choices,
                             getattr(a.type, "__name__", None), a.required,
                             type(a).__name__)
        out[path] = opts
    walk(parser, ())
    return out


JAX_SURFACE = surface(jcli.build_parser())
PORT_SURFACE = surface(tcli.build_parser())


@pytest.mark.parametrize("verb", sorted(JAX_SURFACE), ids=" ".join)
def test_parser_has_the_jax_verbs_and_options(verb):
    assert verb in PORT_SURFACE
    port = {k: v for k, v in PORT_SURFACE[verb].items()
            if (verb[0] if verb else "", k) not in PORT_ONLY}
    assert port == JAX_SURFACE[verb]


def test_parser_adds_only_the_device_option():
    assert set(PORT_SURFACE) == set(JAX_SURFACE)
    extra = {(v[0], k) for v, opts in PORT_SURFACE.items() for k in opts
             if k not in JAX_SURFACE[v]}
    assert extra == PORT_ONLY
    assert PORT_SURFACE[("train",)]["--device"][1] == repr("cuda")


@pytest.mark.parametrize("argv", [
    ["eval", "m:Ev"],
    ["eval", "m:Ev", "m:Gen", "--batch", "b1"],
    ["eval", "--grid", "g.json", "--grid-out", "out.json", "--topk", "5"],
    ["eval", "--grid", "g.json", "--device", "cpu"],
], ids=" ".join)
def test_eval_parses_as_the_jax_eval(argv):
    """``eval`` (once refused): both parsers give the same arguments and
    handlers of the same name; the port's ``--device`` defaults to
    cuda."""
    jargv = [a for a in argv if a not in ("--device", "cpu")]
    want = vars(jcli.build_parser().parse_args(jargv))
    got = vars(tcli.build_parser().parse_args(argv))
    assert got.pop("device") == ("cpu" if "--device" in argv else "cuda")
    assert got.pop("func").__name__ == want.pop("func").__name__ == \
        "cmd_eval"
    assert got == want


@pytest.fixture
def both_stores(tmp_path):
    configure(jstorage, "sqlite", tmp_path / "jax.db")
    configure(tstorage, "sqlite", tmp_path / "port.db")
    yield tmp_path
    jstorage.reset()
    tstorage.reset()


KEY_RE = re.compile(r"[A-Za-z0-9_-]{64}")


def run_cli(cli, argv, capsys):
    rc = cli.main(argv)
    out = capsys.readouterr()
    return rc, KEY_RE.sub("<key>", out.out), KEY_RE.sub("<key>", out.err)


APP_VERBS = [
    ["app", "new", "shop", "--description", "the shop"],
    ["app", "new", "shop"],
    ["app", "new", "films", "--access-key", "given-key"],
    ["app", "list"],
    ["app", "show", "shop"],
    ["app", "show", "nothing"],
    ["app", "channel-new", "shop", "mobile"],
    ["app", "channel-new", "shop", "mobile"],
    ["app", "channel-new", "shop", "bad name!"],
    ["app", "show", "shop"],
    ["accesskey", "new", "shop", "--events", "rate", "view"],
    ["accesskey", "new", "shop", "fixed-key"],
    ["accesskey", "new", "nothing"],
    ["accesskey", "list"],
    ["accesskey", "list", "films"],
    ["accesskey", "delete", "fixed-key"],
    ["accesskey", "delete", "fixed-key"],
    ["app", "data-delete", "shop", "-f"],
    ["app", "data-delete", "shop", "--channel", "mobile", "-f"],
    ["app", "data-cleanup", "shop", "--before", "2024-01-01T00:00:00Z",
     "-f"],
    ["app", "data-trim", "shop", "--dst", "films"],
    ["app", "channel-delete", "shop", "mobile", "-f"],
    ["app", "delete", "films", "-f"],
    ["app", "list"],
    ["app"],
    ["accesskey"],
]


def test_app_and_accesskey_print_what_jax_prints(both_stores, capsys):
    for argv in APP_VERBS:
        want = run_cli(jcli, argv, capsys)
        got = run_cli(tcli, argv, capsys)
        if argv[:2] == ["accesskey", "list"]:
            # the listing sorts by (app, key), and generated keys are
            # random: compare its lines as a set of masked lines
            want, got = [(rc, sorted(out.splitlines()), err)
                         for rc, out, err in (want, got)]
        assert got == want, argv


def _jax_events():
    t0 = dt.datetime(2024, 2, 1, tzinfo=UTC)
    evs = []
    for j in range(40):
        kw = dict(event="rate", entity_type="user", entity_id=f"u{j % 7}",
                  target_entity_type="item", target_entity_id=f"i{j % 5}",
                  properties={"rating": float(j % 5) + 0.5},
                  event_time=t0 + dt.timedelta(minutes=j),
                  creation_time=t0 + dt.timedelta(days=1, seconds=j),
                  event_id=f"e{j:03d}")
        if j % 6 == 1:
            kw.update(tags=("a", "b"), pr_id=f"pr{j}")
        if j % 9 == 2:
            kw.update(event="$set", entity_type="item",
                      entity_id=f"i{j}", target_entity_type=None,
                      target_entity_id=None,
                      properties={"categories": ["g1", "g2"],
                                  "meta": {"n": j, "s": "é \"q\""}})
        evs.append(JEvent(**kw))
    return evs


@pytest.mark.parametrize("fmt", ["jsonl", "columnar"])
def test_export_import_export_matches_jax_byte_for_byte(both_stores, fmt,
                                                        capsys):
    tmp = both_stores
    assert jcli.main(["app", "new", "shop"]) == 0
    aid = jstorage.get_metadata_apps().get_by_name("shop").id
    jstorage.get_levents().insert_batch(_jax_events(), aid)
    jax_file, port_file = tmp / f"jax.{fmt}", tmp / f"port.{fmt}"
    assert jcli.main(["export", "--app-name", "shop", "--output",
                      str(jax_file), "--format", fmt]) == 0
    assert tcli.main(["app", "new", "shop"]) == 0
    assert tcli.main(["import", "--app-name", "shop", "--input",
                      str(jax_file)]) == 0
    assert tcli.main(["export", "--app-name", "shop", "--output",
                      str(port_file), "--format", fmt]) == 0
    out = capsys.readouterr().out
    assert "(40 events)" in out
    if fmt == "jsonl":
        assert port_file.read_bytes() == jax_file.read_bytes()
        assert len(jax_file.read_bytes().splitlines()) == 40
    else:
        # an npz is a zip, whose headers stamp the time of writing:
        # every member (one .npy array each) must be equal byte for byte
        with zipfile.ZipFile(jax_file) as zj, zipfile.ZipFile(port_file) as zp:
            assert zp.namelist() == zj.namelist()
            for name in zj.namelist():
                assert zp.read(name) == zj.read(name), name


def _engine_dir(tmp, capsys):
    eng = tmp / "eng"
    assert tcli.main(["template", "get", "recommendation", str(eng)]) == 0
    path = eng / "engine.json"
    variant = json.loads(path.read_text())
    assert variant["engineFactory"] == (
        "predictionio_tpu_torch.templates.recommendation.engine:"
        "engine_factory")
    variant["datasource"]["params"].update(appName="MyApp",
                                           readItemCategories=True)
    variant["algorithms"][0]["params"].update(rank=4, numIterations=3)
    path.write_text(json.dumps(variant))
    assert tcli.main(["build", "--engine-variant", str(path)]) == 0
    capsys.readouterr()
    return path


def _env(db):
    env = dict(os.environ, PIO_STORAGE_SOURCES_S_TYPE="sqlite",
               PIO_STORAGE_SOURCES_S_PATH=str(db),
               PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = "S"
    return env


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type":
                                          "application/json"},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


QUERIES = [{"user": "u1", "num": 4}, {"user": "u7", "num": 6},
           {"items": ["i3", "i9"], "num": 3},
           {"user": "u2", "num": 5, "categories": ["g1"]},
           {"user": "nobody", "num": 2}]


def test_template_build_train_deploy_undeploy(both_stores, capsys):
    tmp = both_stores
    fill(tstorage, "predictionio_tpu_torch")
    path = _engine_dir(tmp, capsys)
    trace_dir = tmp / "traces"
    assert tcli.main(["train", "--device", "cpu", "--engine-variant",
                      str(path), "--trace-dir", str(trace_dir)]) == 0
    iid = re.search(r"Engine instance ID: (\S+)",
                    capsys.readouterr().out).group(1)
    from predictionio_tpu_torch.utils import tracing

    tracing.set_trace_dir(None)
    roots = [r for r in tracing.load_traces_from_dir(str(trace_dir))
             if r.get("root") == "pio.train"]
    names = {s["name"] for r in roots for s in r["spans"]}
    assert {"dase.read", "dase.prepare", "dase.train"} <= names

    inst = tserver.resolve_engine_instance(None, "default", "default",
                                           str(path))
    assert inst.id == iid
    dep = tserver.build_deployment(inst, CPU)
    want = [tserver.to_jsonable(tserver.serve_query(
        dep, tserver.query_from_json(q, dep.algorithms[0].query_class)))
        for q in QUERIES]

    child = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.console",
         "deploy", "--device", "cpu", "--ip", "127.0.0.1", "--port", "0",
         "--engine-variant", str(path)],
        env=_env(tmp / "port.db"), stdout=subprocess.PIPE, text=True)
    try:
        line = child.stdout.readline()
        port = int(re.search(r"live at http://127\.0\.0\.1:(\d+)",
                             line).group(1))
        base = f"http://127.0.0.1:{port}"
        got = [_post(base + "/queries.json", q) for q in QUERIES]
        assert got == [(200, w) for w in want]
        assert tcli.main(["undeploy", "--ip", "127.0.0.1", "--port",
                          str(port)]) == 0
        assert child.wait(timeout=60) == 0
        with pytest.raises(urllib.error.URLError):
            urllib.request.urlopen(base + "/", timeout=5)
        assert tcli.main(["undeploy", "--ip", "127.0.0.1", "--port",
                          str(port)]) == 1
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)


@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA is present")
@pytest.mark.parametrize("verb", ["train", "deploy"])
def test_train_and_deploy_default_to_cuda_and_raise_without_it(
        both_stores, verb, capsys):
    path = _engine_dir(both_stores, capsys)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main([verb, "--engine-variant", str(path)])


@pytest.mark.parametrize("argv,handler", [
    (["batchpredict", "--engine-instance-id", "i1", "--input", "q.jsonl",
      "--output", "out", "--chunk-size", "64", "--format", "npz",
      "--device", "cpu"], "cmd_batchpredict"),
    (["batchpredict", "--synthesize-app", "MyApp", "--synthesize-base",
      '{"num": 5}', "--query-partitions", "3", "--serve-precision",
      "bf16", "--output", "o"], "cmd_batchpredict"),
    (["top", "--url", "http://127.0.0.1:9", "--once", "--interval", "0.5"],
     "cmd_top"),
    (["adminserver", "--ip", "127.0.0.1", "--port", "0"],
     "cmd_adminserver"),
    (["dashboard", "--port", "0", "--server-config", "s.json"],
     "cmd_dashboard"),
    (["deploy", "--feedback", "--accesskey", "k", "--event-server-ip",
      "127.0.0.1", "--event-server-port", "7071", "--device", "cpu"],
     "cmd_deploy"),
], ids=lambda v: " ".join(v) if isinstance(v, list) else v)
def test_operator_verbs_parse_as_the_jax_verbs(argv, handler):
    """``batchpredict``, ``top``, ``adminserver``, ``dashboard`` and
    ``deploy --feedback`` (once refused): both parsers give the same
    arguments and handlers of the same name; the port's ``--device``
    defaults to cuda."""
    jargv = [a for a in argv if a not in ("--device", "cpu")]
    want = vars(jcli.build_parser().parse_args(jargv))
    got = vars(tcli.build_parser().parse_args(argv))
    if "device" in got:
        assert got.pop("device") == ("cpu" if "--device" in argv
                                     else "cuda")
    assert got.pop("func").__name__ == want.pop("func").__name__ == handler
    assert got == want


UNPORTED = [
    (["status", "--fleet", "http://127.0.0.1:1"], "A2.6"),
    (["top", "--fleet", "--once"], "A2.6"),
    (["template", "get", "sequentialrec", "d"], "A7"),
    (["train", "--device", "cpu", "--num-hosts", "2"], "A6"),
    (["train", "--device", "cpu", "--coordinator", "h:1"], "A6"),
    (["deploy", "--device", "cpu", "--fleet", "2"], "A2.6"),
]


@pytest.mark.parametrize("argv,item", UNPORTED, ids=lambda v: (
    " ".join(v) if isinstance(v, list) else v))
def test_unported_verbs_and_options_raise_with_their_item(argv, item,
                                                          tmp_path):
    with pytest.raises(NotImplementedError, match=re.escape(item)):
        tcli.main(argv)


def test_version_status_and_template_list(both_stores, capsys):
    assert tcli.main(["version"]) == 0
    from predictionio_tpu_torch import __version__

    assert capsys.readouterr().out.strip() == __version__
    assert tcli.main(["status"]) == 0
    assert "all ready to go" in capsys.readouterr().out
    assert tcli.main(["template", "list"]) == 0
    listing = capsys.readouterr().out
    assert "recommendation" in listing and "not ported yet" in listing
    assert tcli.main([]) == 2


# -- the same events, two ways in --------------------------------------------

N_USERS, N_ITEMS, N_RATINGS = 40, 60, 900
BASE = dt.datetime(2003, 2, 28, tzinfo=UTC).timestamp()
WHEN = dt.datetime(2003, 3, 1, tzinfo=UTC)


def ratings(seed=5):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, N_USERS, N_RATINGS)
    cols = rng.integers(0, N_ITEMS, N_RATINGS)
    stars = rng.integers(1, 11, N_RATINGS) * 0.5
    extra = [(int(rng.integers(0, N_USERS)), int(rng.integers(0, N_ITEMS)),
              float(rng.integers(1, 11) * 0.5)) for _ in range(70)]
    cats = {f"i{i}": [f"g{i % 5}", f"g{(i * 7) % 11}"]
            for i in range(N_ITEMS)}
    return rows.tolist(), cols.tolist(), stars.tolist(), extra, cats


def extra_json(extra, cats):
    evs = [{"event": "rate", "entityType": "user", "entityId": f"u{u}",
            "targetEntityType": "item", "targetEntityId": f"i{i}",
            "properties": {"rating": r}, "eventTime": WHEN.isoformat()}
           for u, i, r in extra]
    evs += [{"event": "$set", "entityType": "item", "entityId": iid,
             "properties": {"categories": c}, "eventTime": WHEN.isoformat()}
            for iid, c in cats.items()]
    return evs


def write_direct(app_id):
    rows, cols, stars, extra, cats = ratings()
    le = tstorage.get_levents()
    le.init(app_id)
    le.insert_raw_batch([
        (f"ev{j}", "rate", "user", f"u{rows[j]}", "item", f"i{cols[j]}",
         json.dumps({"rating": stars[j]}), BASE + j, "[]", None, BASE + j)
        for j in range(len(rows))], app_id)
    le.insert_batch([TEvent.from_dict(d)
                     for d in extra_json(extra, cats)], app_id)


def write_through_the_front_door(tmp, key):
    rows, cols, stars, extra, cats = ratings()
    jsonl = tmp / "ratings.jsonl"
    with open(jsonl, "w") as f:
        for j in range(len(rows)):
            f.write(TEvent(
                event="rate", entity_type="user", entity_id=f"u{rows[j]}",
                target_entity_type="item", target_entity_id=f"i{cols[j]}",
                properties={"rating": stars[j]},
                event_time=dt.datetime.fromtimestamp(BASE + j, UTC),
                creation_time=dt.datetime.fromtimestamp(BASE + j, UTC),
                event_id=f"ev{j}").to_json() + "\n")
    assert tcli.main(["import", "--app-name", "ML", "--input",
                      str(jsonl)]) == 0
    server = EventServer(EventServerConfig(ip="127.0.0.1", port=0)).start()
    try:
        url = "http://{}:{}/batch/events.json?accessKey={}".format(
            *server.address, key)
        evs = extra_json(extra, cats)
        chunks = [evs[a:a + 50] for a in range(0, len(evs), 50)]
        failed = []

        def client(mine):
            for chunk in mine:
                status, items = _post(url, chunk)
                failed.extend(x for x in items if x["status"] != 201)
                assert status == 200

        threads = [threading.Thread(target=client, args=(chunks[t::4],))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not failed
    finally:
        server.stop()


def train_factors(variant):
    iid = tcw.create_workflow(
        tcw.WorkflowConfig(engine_factory=variant["engineFactory"]),
        variant, ctx=CPU)
    inst = tserver.resolve_engine_instance(iid)
    model = tserver.build_deployment(inst, CPU).models[0]
    out = {}
    for side, bimap, X in (("user", model.user_map, model.user_factors),
                           ("item", model.item_map, model.item_factors)):
        labels = np.asarray(bimap.labels)
        order = np.argsort(labels)
        out[side] = (labels[order], np.asarray(X)[order])
    return out


def test_import_and_event_server_train_to_the_insert_factors(tmp_path,
                                                             capsys):
    variant = {"engineFactory": "predictionio_tpu_torch.templates."
                                "recommendation.engine:engine_factory",
               "datasource": {"params": {"appName": "ML",
                                         "streamingBlockSize": 250,
                                         "readItemCategories": True}},
               "preparator": {"params": {"bucketed": True}},
               "algorithms": [{"name": "als", "params": {
                   "rank": 6, "numIterations": 3, "lambda": 0.05,
                   "seed": 11}}]}
    trained = {}
    try:
        for way in ("direct", "front door"):
            configure(tstorage, "sqlite", tmp_path / f"{way}.db")
            assert tcli.main(["app", "new", "ML"]) == 0
            key = KEY_RE.search(capsys.readouterr().out).group(0)
            app_id = tstorage.get_metadata_apps().get_by_name("ML").id
            if way == "direct":
                write_direct(app_id)
            else:
                write_through_the_front_door(tmp_path, key)
            n = len(list(tstorage.get_levents().find(app_id=app_id)))
            assert n == N_RATINGS + 70 + N_ITEMS
            trained[way] = train_factors(variant)
    finally:
        tstorage.reset()
    for side in ("user", "item"):
        ids_a, X_a = trained["direct"][side]
        ids_b, X_b = trained["front door"][side]
        assert ids_a.tolist() == ids_b.tolist()
        np.testing.assert_array_equal(X_b, X_a)
