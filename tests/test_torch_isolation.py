"""The port stands alone: no module of ``predictionio_tpu_torch`` (nor
``chip_smoke.py``) imports ``jax`` or anything of ``predictionio_tpu``,
and the training and query paths, from a data source in memory, from
the event store through a stored engine instance (and a fold-in of a
new user into it, and a bf16 checkpointed training read back by ``pio
runs list``), and from a ``jsonlfs`` store through the pipelined read,
import, train and serve in a process where both are unimportable, as
does the console's quick start (``pio app
new``, ``import``, the event server, ``template get``, ``train``,
``export``) and the tuning grid (``pio eval --grid``). ``chip_smoke.py``
refuses to run without a GPU."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "predictionio_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "predictionio_tpu")


def port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    offenders = [
        f"{p.relative_to(ROOT)}: {mod}" for p in port_sources()
        for mod in imported_modules(p)
        if mod.split(".")[0] in FORBIDDEN]
    assert len(port_sources()) > 10
    assert offenders == []


BLOCKED_RUN = r"""
import sys
sys.modules["jax"] = None
sys.modules["predictionio_tpu"] = None
import importlib, pathlib, pkgutil
import numpy as np
import predictionio_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from predictionio_tpu_torch.templates.recommendation.engine import engine_factory
from predictionio_tpu_torch.weights import als_model_from_numpy
from predictionio_tpu_torch.workflow.create_server import (
    deployment_from_models, serve_query, to_jsonable)
rng = np.random.default_rng(0)
X = rng.integers(-3, 4, (5, 4)).astype(np.float32)
Y = rng.integers(-3, 4, (40, 4)).astype(np.float32)
model = als_model_from_numpy(X, Y, [f"u{i}" for i in range(5)],
                             [f"i{i}" for i in range(40)], {0: [1, 2]},
                             device="cpu")
engine = engine_factory()
dep = deployment_from_models(engine, engine.engine_params_from_variant({}), [model])
out = to_jsonable(serve_query(dep, {"user": "u0", "num": 3}))
assert len(out["itemScores"]) == 3, out
from predictionio_tpu_torch.controller import Engine, PDataSource
from predictionio_tpu_torch.core.context import ComputeContext
from predictionio_tpu_torch.templates.recommendation.engine import TrainingData

class Source(PDataSource):
    def read_training(self, ctx):
        return TrainingData(users=np.asarray([f"u{u}" for u in rng.integers(0, 9, 80)], object),
                            items=np.asarray([f"i{i}" for i in rng.integers(0, 12, 80)], object),
                            values=np.ones(80, np.float32))

trainer = Engine(Source, engine.preparator_class_map, engine.algorithm_class_map,
                 engine.serving_class_map)
for bucketed in (False, True):
    tp = trainer.engine_params_from_variant({
        "preparator": {"params": {"bucketed": bucketed}},
        "algorithms": [{"name": "als", "params": {"rank": 3, "numIterations": 1}}]})
    trained, = trainer.train(ComputeContext(device="cpu"), tp)
    dep = deployment_from_models(trainer, tp, [trained])
    out = to_jsonable(serve_query(dep, {"user": "u1", "num": 2}))
    assert 1 <= len(out["itemScores"]) <= 2, out
from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.workflow.create_server import (
    build_deployment, resolve_engine_instance)
from predictionio_tpu_torch.workflow.create_workflow import (
    WorkflowConfig, create_workflow)

storage.reset(storage.StorageConfig(
    {"M": {"type": "memory"}}, {r: "M" for r in storage.REPOSITORIES}))
aid = storage.get_metadata_apps().insert(App(0, "app"))
storage.get_levents().insert_batch([
    Event(event="rate", entity_type="user", entity_id=f"u{u}",
          target_entity_type="item", target_entity_id=f"i{i}",
          properties={"rating": 1.0})
    for u, i in zip(rng.integers(0, 9, 80), rng.integers(0, 12, 80))], aid)
iid = create_workflow(
    WorkflowConfig(engine_factory="predictionio_tpu_torch.templates."
                                  "recommendation.engine:engine_factory"),
    {"datasource": {"params": {"appName": "app", "streamingBlockSize": 16}},
     "preparator": {"params": {"bucketed": True}},
     "algorithms": [{"name": "als", "params": {"rank": 3,
                                               "numIterations": 1}}]},
    ctx=ComputeContext(device="cpu"))
dep = build_deployment(resolve_engine_instance(None),
                       ComputeContext(device="cpu"))
assert dep.instance.id == iid
out = to_jsonable(serve_query(dep, {"user": "u1", "num": 2}))
assert 1 <= len(out["itemScores"]) <= 2, out
from predictionio_tpu_torch.online.foldin import FoldInConfig, FoldInConsumer
from predictionio_tpu_torch.ops.als import ALSParams

consumer = FoldInConsumer(dep.models[0], FoldInConfig(app_name="app",
                                                      interval=0.0),
                          ALSParams(rank=3, num_iterations=1))
consumer._scope = (aid, None)
consumer._cursor = storage.get_levents().tail_cursor(aid, None)
storage.get_levents().insert_batch([
    Event(event="rate", entity_type="user", entity_id="fresh",
          target_entity_type="item", target_entity_id=f"i{i}",
          properties={"rating": 5.0}) for i in (1, 2, 3)], aid)
consumer._cycle()
assert consumer.stats()["newUsers"] == 1, consumer.stats()
out = to_jsonable(serve_query(dep, {"user": "fresh", "num": 2}))
assert len(out["itemScores"]) == 2, out
import contextlib, io, os, tempfile
from predictionio_tpu_torch.tools import cli
with tempfile.TemporaryDirectory() as ckpt_dir:
    os.environ.update(PIO_CHECKPOINT_DIR=ckpt_dir, PIO_CHECKPOINT_EVERY="1")
    iid = create_workflow(
        WorkflowConfig(engine_factory="predictionio_tpu_torch.templates."
                                      "recommendation.engine:engine_factory"),
        {"datasource": {"params": {"appName": "app"}},
         "preparator": {"params": {"bucketed": True}},
         "algorithms": [{"name": "als", "params": {
             "rank": 3, "numIterations": 2, "precision": "bf16"}}]},
        ctx=ComputeContext(device="cpu"))
    assert sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".json")) \
        == ["ckpt-00000001.json", "ckpt-00000002.json"]
    listing = io.StringIO()
    with contextlib.redirect_stdout(listing):
        assert cli.main(["runs", "list", "--dir", ckpt_dir]) == 0
    assert "2/2" in listing.getvalue(), listing.getvalue()
    del os.environ["PIO_CHECKPOINT_DIR"], os.environ["PIO_CHECKPOINT_EVERY"]
with tempfile.TemporaryDirectory() as events_dir:
    storage.reset(storage.StorageConfig(
        {"J": {"type": "jsonlfs", "path": events_dir, "part_max_events": 25},
         "M": {"type": "memory"}},
        {"EVENTDATA": "J", "METADATA": "M", "MODELDATA": "M"}))
    aid = storage.get_metadata_apps().insert(App(0, "app"))
    storage.get_levents().init(aid)
    storage.get_levents().append_raw_lines([
        '{"event":"rate","entityType":"user","entityId":"u%d",'
        '"targetEntityType":"item","targetEntityId":"i%d",'
        '"properties":{"rating":%d},"eventTime":"2020-01-01T00:00:00Z"}'
        % (u, i, 1 + u % 5)
        for u, i in zip(rng.integers(0, 9, 80), rng.integers(0, 12, 80))],
        aid)
    iid = create_workflow(
        WorkflowConfig(engine_factory="predictionio_tpu_torch.templates."
                                      "recommendation.engine:engine_factory"),
        {"datasource": {"params": {"appName": "app", "streamingBlockSize": 16,
                                   "pipelinedIngest": True,
                                   "decodePrefetch": 2}},
         "preparator": {"params": {"bucketed": True}},
         "algorithms": [{"name": "als", "params": {"rank": 3,
                                                   "numIterations": 1}}]},
        ctx=ComputeContext(device="cpu"))
    dep = build_deployment(resolve_engine_instance(None),
                           ComputeContext(device="cpu"))
    assert dep.instance.id == iid
    out = to_jsonable(serve_query(dep, {"user": "u1", "num": 2}))
    assert 1 <= len(out["itemScores"]) <= 2, out
    storage.reset()
assert not any(m == "jax" or m.startswith(("jax.", "predictionio_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("served", len(names), "modules; trained five times")
"""


def test_query_path_runs_with_jax_unimportable():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("PIO_SERVE_PRECISION", None)
    proc = subprocess.run([sys.executable, "-c", BLOCKED_RUN], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("served")


CONSOLE_RUN = r"""
import sys
sys.modules["jax"] = None
sys.modules["predictionio_tpu"] = None
import json, os, pathlib
from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.api import EventServer, EventServerConfig
from predictionio_tpu_torch.tools import cli

work = pathlib.Path(sys.argv[1])
storage.reset(storage.StorageConfig(
    {"S": {"type": "sqlite", "path": str(work / "pio.db")}},
    {r: "S" for r in storage.REPOSITORIES}))
assert cli.main(["app", "new", "app"]) == 0
with open(work / "events.jsonl", "w") as f:
    for j in range(120):
        f.write(json.dumps({"event": "rate", "entityType": "user",
                            "entityId": f"u{j % 9}",
                            "targetEntityType": "item",
                            "targetEntityId": f"i{(j * 7) % 13}",
                            "properties": {"rating": 1.0 + j % 5}}) + "\n")
assert cli.main(["import", "--app-name", "app", "--input",
                 str(work / "events.jsonl")]) == 0
server = EventServer(EventServerConfig(ip="127.0.0.1", port=0)).start()
server.stop()
assert cli.main(["template", "get", "recommendation", str(work / "eng")]) == 0
variant = json.loads((work / "eng" / "engine.json").read_text())
variant["datasource"]["params"]["appName"] = "app"
variant["algorithms"][0]["params"].update(rank=3, numIterations=1)
(work / "eng" / "engine.json").write_text(json.dumps(variant))
assert cli.main(["train", "--device", "cpu", "--engine-variant",
                 str(work / "eng" / "engine.json")]) == 0
assert cli.main(["export", "--app-name", "app", "--output",
                 str(work / "out.jsonl")]) == 0
assert len((work / "out.jsonl").read_text().splitlines()) == 120
(work / "grid.json").write_text(json.dumps({
    "base": {"rank": 3, "numIterations": 1, "seed": 1},
    "configs": [{"lambda": 0.1}, {"rank": 2}], "data": {"appName": "app"}}))
assert cli.main(["eval", "--grid", str(work / "grid.json"), "--grid-out",
                 str(work / "board.json"), "--topk", "3",
                 "--device", "cpu"]) == 0
assert json.loads((work / "board.json").read_text())["winner"] is not None
storage.reset()
assert not any(m == "jax" or m.startswith(("jax.", "predictionio_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("console ran")
"""


def test_console_path_runs_with_jax_unimportable(tmp_path):
    """``pio app new`` -> ``import`` -> the event server ->
    ``template get`` -> ``train --device cpu`` -> ``export`` -> ``eval
    --grid --device cpu`` in a process where ``jax`` and
    ``predictionio_tpu`` cannot be imported. The store,
    the engine directory and the export live in ``tmp_path``, which is
    also the child's working directory."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", CONSOLE_RUN,
                           str(tmp_path)], env=env,
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "console ran" in proc.stdout


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_a_gpu(tmp_path, alone):
    """No GPU here: exit non-zero and print no result, whether run from
    the checkout or from a directory holding only the script."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
