"""``pio batchpredict`` on the port against the JAX package, on the CPU,
for the recommendation template, and the similarproduct and
classification cases of ``tests/test_batchpredict.py``.

- The chunk plan, ``shard_spans``, ``input_fingerprint`` and
  ``ordered_batch_results`` equal the JAX package's on the same inputs.
- Each package trains on a memory store of its own holding the same
  events, the port from the JAX package's initial factors (injected as
  in the training differentials). Both batch-predict one query file:
  the query lines are byte-equal, the item ids equal and the scores
  within 1e-5 relative (fp32 stores; the two trainers sum in other
  orders, about 4e-6 apart at these sizes). Each package's
  ``read_results`` reads the other's output directory.
- similarproduct (ALS from one injected init) and classification (naive
  Bayes, bitwise on the host) on the JAX test's events: the query lines
  byte-equal, the ids and labels equal, the scores within 1e-5 of their
  scale (the summed cosine's range); the port's shards bytewise its looped
  ``serve_one``.
- Inside the port, bytes: its shards equal its looped ``serve_one``
  records byte for byte, a resumed run's shards a clean run's.
- Crash-resume without re-scoring, a torn shard re-scored, a mismatched
  job and an empty input refused, npz agreeing with jsonl,
  ``--query-partitions``, the metrics; the console end to end with
  ``--device cpu`` and a resume, ``--smoke --device cpu``, and
  ``batchpredict`` without ``--device`` raising where CUDA is absent.
"""

import dataclasses
import datetime as dt
import importlib
import json
import os

import numpy as np
import pytest
import torch

from predictionio_tpu.batch import predict as jbp
from predictionio_tpu.controller.algorithms import (
    ordered_batch_results as j_ordered,
)
from predictionio_tpu.data import storage as jstorage
from predictionio_tpu.ops import als as jals
from predictionio_tpu.parallel.mesh import shard_spans as j_shard_spans
from predictionio_tpu_torch.batch import predict as tbp
from predictionio_tpu_torch.controller.algorithms import (
    ordered_batch_results as t_ordered,
)
from predictionio_tpu_torch.core.context import ComputeContext
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.ops import als as tals
from predictionio_tpu_torch.parallel.mesh import shard_spans as t_shard_spans
from predictionio_tpu_torch.tools import cli as tcli
from predictionio_tpu_torch.utils import metrics as tmetrics

from test_torch_lifecycle import configure, jax_init

CPU = ComputeContext(device="cpu")
T0 = dt.datetime(2021, 1, 1, tzinfo=dt.timezone.utc)
SCORE_RTOL = 1e-5
PKGS = ("predictionio_tpu", "predictionio_tpu_torch")


# -- mechanics --------------------------------------------------------------

@pytest.mark.parametrize("n,parts", [(10, 3), (2, 5), (0, 3), (1000, 7),
                                     (7, 7), (1, 1), (138_589, 13)])
def test_shard_spans_equal_jax(n, parts):
    assert t_shard_spans(n, parts) == j_shard_spans(n, parts)


@pytest.mark.parametrize("n,chunk,partitions", [
    (1000, 100, None), (5, 256, None), (20, 8, 2), (138_589, 256, None),
    (0, 8, None), (9, 8, None), (300, 3, None), (31, 1000, 4)])
def test_chunk_spans_equal_jax(n, chunk, partitions):
    assert tbp.chunk_spans(n, chunk, partitions) == \
        jbp.chunk_spans(n, chunk, partitions)


def test_chunk_spans_refuse_a_bad_size_as_jax():
    for mod in (tbp, jbp):
        with pytest.raises(ValueError, match="chunk_size must be positive"):
            mod.chunk_spans(10, 0)


@pytest.mark.parametrize("lines", [
    ['{"user":"u1"}', '{"user":"u2"}'], ['{"user":"u1"}{"user":"u2"}'],
    [], ['{"num":3,"user":"é"}']])
def test_input_fingerprint_equals_jax(lines):
    assert tbp.input_fingerprint(lines) == jbp.input_fingerprint(lines)
    queries = [json.loads(x) for x in lines if x.count("{") == 1]
    assert tbp._canonical_query_lines(queries) == \
        jbp._canonical_query_lines(queries)


@pytest.mark.parametrize("results", [
    [(1, "B"), (0, "A")], [(0, "A"), (0, "A2")], [(0, "A")],
    [(0, "A"), (1, "B"), (7, "X")]])
def test_ordered_batch_results_equals_jax(results):
    indexed = [(0, "a"), (1, "b")]
    outcomes = []
    for fn in (j_ordered, t_ordered):
        try:
            outcomes.append(("ok", fn(indexed, results, who="Algo")))
        except RuntimeError as e:
            outcomes.append(("raised", str(e)))
    assert outcomes[0] == outcomes[1]


def test_config_requires_one_source(tmp_path):
    with pytest.raises(ValueError, match="exactly one query source"):
        tbp.BatchPredictor(tbp.BatchPredictConfig(output_dir=str(tmp_path)))
    with pytest.raises(ValueError, match="exactly one query source"):
        tbp.BatchPredictor(tbp.BatchPredictConfig(
            output_dir=str(tmp_path), input_path="x", synthesize_app="y"))
    with pytest.raises(ValueError, match="unknown output format"):
        tbp.BatchPredictor(tbp.BatchPredictConfig(
            output_dir=str(tmp_path), input_path="x", format="parquet"))


# -- one store, both packages -----------------------------------------------

def seed(st, pkg, app="bprec"):
    """The JAX test's recommendation fixture: 20 users ``$set`` and 8
    ratings each in two item groups; trains rank 8, 3 iterations."""
    base = importlib.import_module(f"{pkg}.data.storage.base")
    Event = importlib.import_module(f"{pkg}.data.event").Event
    aid = st.get_metadata_apps().insert(base.App(0, app))
    le = st.get_levents()
    le.init(aid)
    rng = np.random.default_rng(0)
    events = [Event(event="$set", entity_type="user", entity_id=f"u{u:02d}",
                    properties={"active": True}, event_time=T0)
              for u in range(20)]
    for u in range(20):
        group = "a" if u < 10 else "b"
        for _ in range(8):
            events.append(Event(
                event="rate", entity_type="user", entity_id=f"u{u:02d}",
                target_entity_type="item",
                target_entity_id=f"{group}{rng.integers(0, 10)}",
                properties={"rating": float(rng.integers(4, 6))},
                event_time=T0))
    le.insert_batch(events, aid)
    engine = importlib.import_module(
        f"{pkg}.templates.recommendation.engine")
    EngineParams = importlib.import_module(
        f"{pkg}.controller.engine").EngineParams
    ALSParams = importlib.import_module(f"{pkg}.ops.als").ALSParams
    cw = importlib.import_module(f"{pkg}.workflow.create_workflow")
    params = EngineParams(
        data_source_params=("", engine.DataSourceParams(app_name=app)),
        algorithm_params_list=[
            ("als", ALSParams(rank=8, num_iterations=3, seed=0))])
    instance = cw.new_engine_instance(cw.WorkflowConfig(
        engine_factory=f"{pkg}.templates.recommendation.engine:"
                       "engine_factory"), params)
    if pkg == "predictionio_tpu":
        from predictionio_tpu.controller import ComputeContext as JCtx
        from predictionio_tpu.workflow import run_train
        iid = run_train(engine.engine_factory(), params, instance,
                        ctx=JCtx())
    else:
        from predictionio_tpu_torch.workflow.core_workflow import run_train
        iid = run_train(engine.engine_factory(), params, instance, ctx=CPU)
    assert iid is not None
    return iid


QUERIES = ([{"user": f"u{u:02d}", "num": 3} for u in range(20)]
           + [{"user": "ghost", "num": 3},
              {"items": ["a1", "a2"], "num": 4},
              {"user": "u03", "num": 4, "blacklist": ["a1", "a2", "zz"]},
              {"user": "u15", "num": 2},
              {"items": ["b9", "nope"], "num": 3}])


def write_queries(tmp_path, queries=QUERIES, name="queries.jsonl"):
    path = str(tmp_path / name)
    with open(path, "w", encoding="utf-8") as f:
        for q in queries:
            f.write(json.dumps(q) + "\n")
    return path


def shard_bytes(out_dir):
    manifest = tbp.Manifest.load(os.path.join(out_dir, tbp.MANIFEST_NAME))
    blobs = []
    for chunk in manifest.chunks:
        with open(os.path.join(out_dir, chunk["file"]), "rb") as f:
            blobs.append(f.read())
    return b"".join(blobs)


@pytest.fixture
def trained(tmp_path, monkeypatch):
    """(JAX instance id, port instance id): each package trained on its
    own memory store of the same events, from one initial state."""
    monkeypatch.setattr(tals, "init_factors", jax_init)
    monkeypatch.delenv("PIO_SERVE_PRECISION", raising=False)
    configure(jstorage, "memory", tmp_path / "jax.db")
    configure(tstorage, "memory", tmp_path / "port.db")
    ids = (seed(jstorage, PKGS[0]), seed(tstorage, PKGS[1]))
    yield ids
    jstorage.reset()
    tstorage.reset()


def port_config(iid, tmp_path, out="out", **kw):
    kw.setdefault("input_path", write_queries(tmp_path))
    kw.setdefault("chunk_size", 8)
    return tbp.BatchPredictConfig(output_dir=str(tmp_path / out),
                                  engine_instance_id=iid, **kw)


def run_port(config):
    return tbp.run_batch_predict(config, ctx=CPU)


def assert_records_agree(mine, want):
    assert len(mine) == len(want)
    for m, w in zip(mine, want):
        assert m["query"] == w["query"]
        mi = [s["item"] for s in m["prediction"]["itemScores"]]
        wi = [s["item"] for s in w["prediction"]["itemScores"]]
        assert mi == wi, m["query"]
        ms = np.asarray([s["score"] for s in m["prediction"]["itemScores"]])
        ws = np.asarray([s["score"] for s in w["prediction"]["itemScores"]])
        np.testing.assert_allclose(ms, ws, rtol=SCORE_RTOL, atol=0)


@pytest.mark.parametrize("fmt", ["jsonl", "npz"])
def test_batch_agrees_with_jax_and_reads_across(trained, tmp_path, fmt):
    jid, tid = trained
    qfile = write_queries(tmp_path)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    jsum = jbp.run_batch_predict(jbp.BatchPredictConfig(
        output_dir=jout, engine_instance_id=jid, input_path=qfile,
        chunk_size=8, format=fmt))
    tsum = run_port(port_config(tid, tmp_path, "port", input_path=qfile,
                                format=fmt))
    for key in ("queries", "chunks", "chunksScored", "chunksSkipped",
                "format"):
        assert tsum[key] == jsum[key]
    assert sorted(tsum) == sorted(jsum)
    # the manifests: the same keys, spans, files and input fingerprint
    jm = json.load(open(os.path.join(jout, jbp.MANIFEST_NAME)))
    tm = json.load(open(os.path.join(tout, tbp.MANIFEST_NAME)))
    assert sorted(tm) == sorted(jm) and tm["input"] == jm["input"]
    strip = [{k: c[k] for k in ("id", "start", "count", "file", "status")}
             for c in jm["chunks"]]
    assert [{k: c[k] for k in ("id", "start", "count", "file", "status")}
            for c in tm["chunks"]] == strip
    # the query lines byte-equal, the predictions within the tolerance
    if fmt == "jsonl":
        for c in tm["chunks"]:
            with open(os.path.join(tout, c["file"]), "rb") as f:
                tq = [ln.split(b',"query":', 1)[1] for ln in f.read()
                      .splitlines()]
            with open(os.path.join(jout, c["file"]), "rb") as f:
                jq = [ln.split(b',"query":', 1)[1] for ln in f.read()
                      .splitlines()]
            assert tq == jq
    mine, want = tbp.read_results(tout), jbp.read_results(jout)
    assert_records_agree(mine, want)
    # each package reads the other's output
    assert jbp.read_results(tout) == mine
    assert tbp.read_results(jout) == want


def test_port_shards_equal_its_looped_records(trained, tmp_path):
    _, tid = trained
    config = port_config(tid, tmp_path)
    summary = run_port(config)
    assert summary["queries"] == len(QUERIES)
    assert summary["chunksScored"] == summary["chunks"] == 4
    bp = tbp.BatchPredictor(dataclasses.replace(
        config, output_dir=str(tmp_path / "probe")), ctx=CPU)
    lines = tbp._canonical_query_lines(QUERIES)
    looped = [bp.serve_one(q) for q in QUERIES]
    expected = b"".join((rec + "\n").encode("utf-8")
                        for rec in tbp.BatchPredictor._render_records(
                            lines, looped))
    assert shard_bytes(config.output_dir) == expected


def test_results_read_back_in_order(trained, tmp_path):
    _, tid = trained
    config = port_config(tid, tmp_path)
    run_port(config)
    results = tbp.read_results(config.output_dir)
    assert [r["query"] for r in results] == QUERIES
    assert results[0]["prediction"]["itemScores"]
    ghost = next(r for r in results if r["query"].get("user") == "ghost")
    assert ghost["prediction"]["itemScores"] == []
    black = next(r for r in results if "blacklist" in r["query"])
    assert not {"a1", "a2"} & {s["item"] for s in
                               black["prediction"]["itemScores"]}


def test_killed_run_resumes_without_rescoring(trained, tmp_path):
    _, tid = trained
    clean = port_config(tid, tmp_path, "clean")
    resumed = port_config(tid, tmp_path, "resumed")
    run_port(clean)
    with pytest.raises(RuntimeError, match="fault injection"):
        run_port(dataclasses.replace(resumed, fail_after_chunks=1))
    partial = tbp.Manifest.load(os.path.join(resumed.output_dir,
                                             tbp.MANIFEST_NAME))
    done = {c["id"]: c["sha256"] for c in partial.chunks
            if c["status"] == "done"}
    assert len(done) == 1
    assert any(c["status"] == "pending" for c in partial.chunks)
    summary = run_port(resumed)
    assert summary["chunksSkipped"] == 1
    assert summary["chunksScored"] == summary["chunks"] - 1
    after = tbp.Manifest.load(os.path.join(resumed.output_dir,
                                           tbp.MANIFEST_NAME))
    for c in after.chunks:
        if c["id"] in done:
            assert c["sha256"] == done[c["id"]]
    assert shard_bytes(resumed.output_dir) == shard_bytes(clean.output_dir)
    again = run_port(resumed)
    assert again["chunksScored"] == 0
    assert again["chunksSkipped"] == again["chunks"]


def test_torn_shard_is_rescored(trained, tmp_path):
    _, tid = trained
    config = port_config(tid, tmp_path)
    run_port(config)
    reference = shard_bytes(config.output_dir)
    manifest = tbp.Manifest.load(os.path.join(config.output_dir,
                                              tbp.MANIFEST_NAME))
    with open(os.path.join(config.output_dir, manifest.chunks[1]["file"]),
              "r+b") as f:
        f.truncate(10)
    summary = run_port(config)
    assert summary["chunksScored"] == 1
    assert summary["chunksSkipped"] == summary["chunks"] - 1
    assert shard_bytes(config.output_dir) == reference


def test_a_torn_journal_line_rescores_its_chunk(trained, tmp_path):
    """A kill mid-append leaves a torn last journal line: its chunk is
    pending on resume, the rest done."""
    _, tid = trained
    config = port_config(tid, tmp_path)
    with pytest.raises(RuntimeError, match="fault injection"):
        run_port(dataclasses.replace(config, fail_after_chunks=2))
    journal = os.path.join(config.output_dir, tbp.JOURNAL_NAME)
    with open(journal, "rb") as f:
        lines = f.read().splitlines()
    with open(journal, "wb") as f:
        f.write(lines[0] + b"\n" + lines[1][:7])
    summary = run_port(config)
    assert (summary["chunksSkipped"], summary["chunksScored"]) == (1, 3)


def test_mismatched_job_refused(trained, tmp_path):
    _, tid = trained
    config = port_config(tid, tmp_path)
    run_port(config)
    other = write_queries(tmp_path, QUERIES[:-1], name="other.jsonl")
    with pytest.raises(ValueError, match="different job"):
        run_port(dataclasses.replace(config, input_path=other))
    with pytest.raises(ValueError, match="different job"):
        run_port(dataclasses.replace(config, format="npz"))


def test_synthesized_queries_and_empty_input_refused(trained, tmp_path):
    _, tid = trained
    qs = tbp.synthesize_queries("bprec", entity_type="user", field="user",
                                base={"num": 5})
    assert qs == [{"num": 5, "user": f"u{u:02d}"} for u in range(20)]
    with pytest.raises(ValueError, match="entity field"):
        tbp.synthesize_queries("bprec", base={"user": "clash"})
    summary = run_port(tbp.BatchPredictConfig(
        output_dir=str(tmp_path / "syn"), engine_instance_id=tid,
        synthesize_app="bprec", synthesize_base={"num": 3}, chunk_size=8))
    assert summary["queries"] == 20
    assert all(r["prediction"]["itemScores"]
               for r in tbp.read_results(str(tmp_path / "syn")))
    with pytest.raises(ValueError, match="no queries to score"):
        run_port(tbp.BatchPredictConfig(
            output_dir=str(tmp_path / "empty"), engine_instance_id=tid,
            synthesize_app="bprec", synthesize_entity_type="item"))
    empty = write_queries(tmp_path, [], name="empty.jsonl")
    with pytest.raises(ValueError, match="is empty"):
        run_port(port_config(tid, tmp_path, "e2", input_path=empty))


def test_npz_agrees_with_jsonl(trained, tmp_path):
    _, tid = trained
    run_port(port_config(tid, tmp_path, "j"))
    summary = run_port(port_config(tid, tmp_path, "n", format="npz"))
    assert summary["format"] == "npz"
    assert tbp.read_results(str(tmp_path / "n")) == \
        tbp.read_results(str(tmp_path / "j"))
    manifest = tbp.Manifest.load(str(tmp_path / "n" / tbp.MANIFEST_NAME))
    assert all(c["file"].endswith(".npz") for c in manifest.chunks)
    z = np.load(str(tmp_path / "n" / manifest.chunks[0]["file"]),
                allow_pickle=False)
    assert int(z["count"]) == manifest.chunks[0]["count"]


def test_query_partitions(trained, tmp_path):
    _, tid = trained
    summary = run_port(port_config(tid, tmp_path, query_partitions=4))
    assert summary["chunks"] == 4
    assert [r["query"] for r in tbp.read_results(str(tmp_path / "out"))] \
        == QUERIES


def test_metrics_recorded(trained, tmp_path):
    _, tid = trained
    before = tmetrics.BATCHPREDICT_QUERIES.value(status="scored")
    run_port(port_config(tid, tmp_path))
    assert tmetrics.BATCHPREDICT_QUERIES.value(status="scored") \
        == before + len(QUERIES)
    assert tmetrics.BATCHPREDICT_QPS.value() > 0


# -- the console --------------------------------------------------------------

def test_cli_end_to_end_with_resume(trained, tmp_path, capsys):
    _, tid = trained
    qfile = write_queries(tmp_path)
    out = str(tmp_path / "cli")
    argv = ["batchpredict", "--engine-instance-id", tid, "--input", qfile,
            "--output", out, "--chunk-size", "8", "--device", "cpu"]
    assert tcli.main(argv) == 0
    said = capsys.readouterr().out
    assert "Batch predict completed: 25 queries in 4 chunks" in said
    assert '[INFO] Kernel launches: {"fused_gather_score_topk": 0}' in said
    assert tcli.main(argv) == 0
    assert "4 resumed" in capsys.readouterr().out
    assert tcli.main(argv[:5] + ["--device", "cpu"]) == 1   # no --output
    assert tcli.main(["batchpredict", "--engine-instance-id", "nope",
                      "--input", qfile, "--output", str(tmp_path / "x"),
                      "--device", "cpu"]) == 1


def test_smoke_entry_point(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert tcli.main(["batchpredict", "--smoke", "--device", "cpu"]) == 0
    assert "batchpredict smoke OK" in capsys.readouterr().out


@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA is present")
@pytest.mark.parametrize("argv", [["batchpredict", "--smoke"],
                                  ["batchpredict", "--input", "q",
                                   "--output", "o"]], ids=" ".join)
def test_batchpredict_defaults_to_cuda_and_raises_without_it(argv):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(argv)


# -- similarproduct and classification ---------------------------------------

def template_events(pkg, template):
    """``tests/test_batchpredict.py``'s fixture events for ``template``,
    as ``pkg``'s events."""
    Event = importlib.import_module(f"{pkg}.data.event").Event

    def ev(event, etype, eid, tet=None, tei=None, props=None):
        return Event(event=event, entity_type=etype, entity_id=eid,
                     target_entity_type=tet, target_entity_id=tei,
                     properties=props or {}, event_time=T0)

    if template == "classification":
        rng = np.random.default_rng(2)
        events = []
        for u in range(30):
            label = float(u % 3)
            feats = (rng.integers(0, 5, size=3)
                     + np.array([3, 0, 0]) * (label == 0)
                     + np.array([0, 3, 0]) * (label == 1))
            events.append(ev("$set", "user", f"u{u}", props={
                "plan": label, "attr0": float(feats[0]),
                "attr1": float(feats[1]), "attr2": float(feats[2])}))
        return events
    rng = np.random.default_rng(1)
    events = [ev("$set", "user", f"u{u}") for u in range(12)]
    events += [ev("$set", "item", f"i{i}", props={
        "categories": ["c1" if i < 5 else "c2"]}) for i in range(10)]
    for u in range(12):
        base = 0 if u < 6 else 5
        events += [ev("view", "user", f"u{u}", "item",
                      f"i{base + rng.integers(0, 5)}") for _ in range(6)]
    return events


TEMPLATE_CASES = {
    "similarproduct": (
        {"algorithms": [{"name": "als", "params": {
            "rank": 6, "numIterations": 3, "seed": 0}}]},
        [{"items": [f"i{i}"], "num": 3} for i in range(10)]
        + [{"items": ["i0", "i1"], "num": 2, "categories": ["c1"]}]),
    "classification": (
        {"algorithms": [{"name": "naive", "params": {}}]},
        [{"features": [float(a), float(b), 1.0]}
         for a in range(4) for b in range(3)]),
}


def train_template(st, pkg, template, app):
    base = importlib.import_module(f"{pkg}.data.storage.base")
    aid = st.get_metadata_apps().insert(base.App(0, app))
    st.get_levents().init(aid)
    st.get_levents().insert_batch(template_events(pkg, template), aid)
    factory = f"{pkg}.templates.{template}:engine_factory"
    cw = importlib.import_module(f"{pkg}.workflow.create_workflow")
    variant = {"datasource": {"params": {"appName": app}},
               **TEMPLATE_CASES[template][0]}
    engine = importlib.import_module(
        f"{pkg}.workflow.core_workflow").load_engine_factory(factory)()
    params = engine.engine_params_from_variant(variant)
    instance = cw.new_engine_instance(
        cw.WorkflowConfig(engine_factory=factory), params)
    if pkg == PKGS[0]:
        from predictionio_tpu.controller import ComputeContext as JCtx
        from predictionio_tpu.workflow import run_train
        iid = run_train(engine, params, instance, ctx=JCtx())
    else:
        from predictionio_tpu_torch.workflow.core_workflow import run_train
        iid = run_train(engine, params, instance, ctx=CPU)
    assert iid is not None
    return iid


def assert_predictions_agree(mine, want):
    """Query lines equal; ids, labels and every other field equal;
    scores within 1e-5 of their scale: the answer's largest score, or
    the summed cosine's range (one per query item) when larger."""
    assert len(mine) == len(want)
    for m, w in zip(mine, want):
        assert m["query"] == w["query"]
        mp, wp = m["prediction"], w["prediction"]
        if "itemScores" not in wp:
            assert mp == wp, m["query"]
            continue
        assert [s["item"] for s in mp["itemScores"]] == \
            [s["item"] for s in wp["itemScores"]], m["query"]
        ws = np.asarray([s["score"] for s in wp["itemScores"]])
        # a summed cosine ranges over one unit per query item
        scale = max([np.abs(ws).max()] if len(ws) else [0.0])
        scale = max(scale, len(m["query"].get("items", ())))
        np.testing.assert_allclose(
            [s["score"] for s in mp["itemScores"]], ws, rtol=0,
            atol=SCORE_RTOL * scale)


@pytest.mark.parametrize("template", sorted(TEMPLATE_CASES))
def test_template_batches_agree_with_jax(template, tmp_path, monkeypatch):
    monkeypatch.setattr(tals, "init_factors", jax_init)
    configure(jstorage, "memory", tmp_path / "jax.db")
    configure(tstorage, "memory", tmp_path / "port.db")
    try:
        jid = train_template(jstorage, PKGS[0], template, "bpt")
        tid = train_template(tstorage, PKGS[1], template, "bpt")
        queries = TEMPLATE_CASES[template][1]
        qfile = write_queries(tmp_path, queries, f"{template}.jsonl")
        jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
        jbp.run_batch_predict(jbp.BatchPredictConfig(
            output_dir=jout, engine_instance_id=jid, input_path=qfile,
            chunk_size=4))
        config = port_config(tid, tmp_path, "port", input_path=qfile,
                             chunk_size=4)
        summary = run_port(config)
        assert summary["queries"] == len(queries)
        # the query lines byte-equal
        tm = json.load(open(os.path.join(tout, tbp.MANIFEST_NAME)))
        for c in tm["chunks"]:
            with open(os.path.join(tout, c["file"]), "rb") as f:
                tq = [ln.split(b',"query":', 1)[1]
                      for ln in f.read().splitlines()]
            with open(os.path.join(jout, c["file"]), "rb") as f:
                jq = [ln.split(b',"query":', 1)[1]
                      for ln in f.read().splitlines()]
            assert tq == jq
        assert_predictions_agree(tbp.read_results(tout),
                                 jbp.read_results(jout))
        # inside the port: the shards are its looped serve_one, bytewise
        bp = tbp.BatchPredictor(dataclasses.replace(
            config, output_dir=str(tmp_path / "probe")), ctx=CPU)
        lines = tbp._canonical_query_lines(queries)
        expected = b"".join((rec + "\n").encode("utf-8")
                            for rec in tbp.BatchPredictor._render_records(
                                lines, [bp.serve_one(q) for q in queries]))
        assert shard_bytes(tout) == expected
    finally:
        jstorage.reset()
        tstorage.reset()
