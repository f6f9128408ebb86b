"""The port's sequentialrec template against the JAX package's.

Both packages read one chain stream from memory stores: the single-scan
and streamed reads, the targetless filter, leave-last-out and the
sliding windows, and the preparator (maps, buckets byte for byte, seen
sets) are compared value for value. A JAX-trained model carried into the
port by ``seqrec_model_from_numpy`` answers as JAX's does on an fp32
store (ids equal, scores 1e-5), through ``predict``, ``batch_predict``,
a pickle round trip and ``fold_in_rows``. The repair of the positive
filter: a model whose unseen scores are all negative still ranks, ALS
keeps its filter. Then the port alone: a trained instance deployed in a
``QueryServer`` with fold-in, the template registry, and a ``pio eval``
of ``SeqRecEvaluation`` writing ``best.json``."""

import datetime as dt
import http.client
import json
import time

import numpy as np
import pytest

from predictionio_tpu.data import storage as jstorage
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage.base import App as JApp
from predictionio_tpu.templates import sequentialrec as jseq
from predictionio_tpu_torch.controller import EngineParams
from predictionio_tpu_torch.core.context import ComputeContext
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.data.event import Event as TEvent
from predictionio_tpu_torch.data.storage.base import App as TApp
from predictionio_tpu_torch.templates import sequentialrec as tseq
from predictionio_tpu_torch.tools import cli as tcli
from predictionio_tpu_torch.weights import (
    als_model_from_numpy,
    seqrec_model_from_numpy,
)
from predictionio_tpu_torch.workflow import core_workflow as tcore
from predictionio_tpu_torch.workflow import create_server as tserver
from predictionio_tpu_torch.workflow import create_workflow as tcw

from jax_native_ready import require_jax_native


@pytest.fixture(autouse=True, scope="module")
def _jax_native_loaded(tmp_path_factory):
    """The JAX package's native libraries loaded before any comparison
    (``jax_native_ready``): a build raced by another worker is waited
    out, never compared against as the Python fallback."""
    require_jax_native(tmp_path_factory.getbasetemp().parent)

UTC = dt.timezone.utc
T0 = dt.datetime(2024, 1, 1, tzinfo=UTC)
APP = "seqapp"
N_ITEMS = 40
CPU = ComputeContext(device="cpu")
FACTORY = "predictionio_tpu_torch.templates.sequentialrec:engine_factory"


def chain_events(Event, n_users=40, n_items=N_ITEMS, seed=0):
    """Each user walks item (start + stride * j) % M, one view a
    minute, written in a shuffled order (so time order is the
    preparator's work), plus a targetless event."""
    rng = np.random.default_rng(seed)
    evs = []
    for u in range(n_users):
        start = int(rng.integers(0, n_items))
        stride = int(rng.integers(1, 3))
        for j in range(int(rng.integers(3, 14))):
            evs.append(Event(
                event="view", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item",
                target_entity_id=f"i{(start + stride * j) % n_items}",
                event_time=T0 + dt.timedelta(minutes=j + 100 * u)))
    order = rng.permutation(len(evs))
    evs = [evs[i] for i in order]
    evs.append(Event(event="view", entity_type="user", entity_id="u0",
                     event_time=T0))
    return evs


def fill(st, App, Event, seed=0):
    aid = st.get_metadata_apps().insert(App(0, APP))
    st.get_levents().init(aid)
    st.get_levents().insert_batch(chain_events(Event, seed=seed), aid)
    return aid


@pytest.fixture
def stores(monkeypatch, tmp_path):
    monkeypatch.delenv("PIO_SERVE_PRECISION", raising=False)
    monkeypatch.delenv("PIO_SERVING_BACKEND", raising=False)
    monkeypatch.delenv("PIO_FOLDIN", raising=False)
    for st, App, Event in ((jstorage, JApp, JEvent),
                           (tstorage, TApp, TEvent)):
        st.reset(st.StorageConfig(
            sources={"S": {"type": "memory"}},
            repositories={r: "S" for r in ("METADATA", "EVENTDATA",
                                           "MODELDATA")}))
        fill(st, App, Event)
    yield tmp_path
    jstorage.reset()
    tstorage.reset()


def sources(**over):
    kw = dict(app_name=APP, **over)
    return (jseq.SequenceDataSource(jseq.DataSourceParams(**kw)),
            tseq.SequenceDataSource(tseq.DataSourceParams(**kw)))


def columns(td):
    return ([str(u) for u in td.users], [str(i) for i in td.items],
            [float(t) for t in td.times])


@pytest.mark.parametrize("stream", [None, 7])
def test_data_source_reads_equal_jax(stores, stream):
    jds, tds = sources(streaming_block_size=stream,
                       decode_prefetch=2 if stream else 0)
    jtd, ttd = jds.read_training(None), tds.read_training(CPU)
    assert columns(ttd) == columns(jtd)
    assert len(ttd) == len(jtd) and None not in set(ttd.items.tolist())


def test_streamed_read_equals_single_scan(stores):
    (_, a), (_, b) = sources(), sources(streaming_block_size=5)
    assert sorted(zip(*columns(a.read_training(CPU)))) == sorted(
        zip(*columns(b.read_training(CPU))))


@pytest.mark.parametrize("stream", [None, 7])
def test_preparator_equals_jax(stores, stream):
    jds, _ = sources()
    _, tds = sources(streaming_block_size=stream)
    jpd = jseq.SequencePreparator(jseq.SeqPreparatorParams(
        max_seq_len=8)).prepare(None, jds.read_training(None))
    tpd = tseq.SequencePreparator(tseq.SeqPreparatorParams(
        max_seq_len=8)).prepare(CPU, tds.read_training(CPU))
    tpd.sanity_check()
    assert list(tpd.user_map.labels) == list(jpd.user_map.labels)
    assert list(tpd.item_map.labels) == list(jpd.item_map.labels)
    assert len(tpd.buckets) == len(jpd.buckets)
    for a, b in zip(tpd.buckets, jpd.buckets):
        for name in ("rows", "ids", "mask"):
            assert getattr(a, name).tobytes() == getattr(b, name).tobytes()
    assert tpd.seen.keys() == jpd.seen.keys()
    for u in jpd.seen:
        np.testing.assert_array_equal(tpd.seen[u], jpd.seen[u])
    assert tpd.max_seq_len == 8


def test_encoded_jsonlfs_blocks_index_as_jax(stores):
    """A ``jsonlfs`` store's dictionary-encoded blocks: the streamed
    read's own indexing gives the JAX preparator's maps, buckets and
    seen sets."""
    tstorage.reset(tstorage.StorageConfig(
        sources={"J": {"type": "jsonlfs", "path": str(stores / "ev"),
                       "part_max_events": 50},
                 "M": {"type": "memory"}},
        repositories={"EVENTDATA": "J", "METADATA": "M", "MODELDATA": "M"}))
    fill(tstorage, TApp, TEvent)
    jds, _ = sources()
    _, tds = sources(streaming_block_size=64, decode_prefetch=2)
    blocks = list(__import__(
        "predictionio_tpu_torch.data.store", fromlist=["PEventStore"])
        .PEventStore.find_columnar_blocks(app_name=APP, block_size=64,
                                          entity_type="user",
                                          target_entity_type="item"))
    assert blocks and all(b.is_encoded for b in blocks)
    ttd = tds.read_training(CPU)
    assert ttd.index is not None
    jtd = jds.read_training(None)
    assert sorted(zip(*columns(ttd))) == sorted(zip(*columns(jtd)))
    u_labels, rows = np.unique(ttd.users.astype(str), return_inverse=True)
    np.testing.assert_array_equal(ttd.index[0], u_labels)
    np.testing.assert_array_equal(ttd.index[1], rows)
    jpd = jseq.SequencePreparator(jseq.SeqPreparatorParams(
        max_seq_len=8)).prepare(None, jtd)
    tpd = tseq.SequencePreparator(tseq.SeqPreparatorParams(
        max_seq_len=8)).prepare(CPU, ttd)
    assert list(tpd.user_map.labels) == list(jpd.user_map.labels)
    assert list(tpd.item_map.labels) == list(jpd.item_map.labels)
    for a, b in zip(tpd.buckets, jpd.buckets):
        for name in ("rows", "ids", "mask"):
            assert getattr(a, name).tobytes() == getattr(b, name).tobytes()


def test_leave_last_out_equals_jax(stores):
    jds, tds = sources()
    [(jtr, _, jqa)] = jds.read_eval(None)
    [(ttr, ei, tqa)] = tds.read_eval(CPU)
    assert type(ei).__name__ == "EmptyEvalInfo"
    assert columns(ttr) == columns(jtr)
    assert [(q.user, q.num, a.items) for q, a in tqa] == \
        [(q.user, q.num, a.items) for q, a in jqa]


def test_streamed_eval_reads_from_the_index(stores):
    """A streamed read keeps its index and no label columns; leave-last-out
    and the sliding windows over it equal the JAX package's streamed
    read's, and each training split carries an index compacted to the
    labels it uses."""
    jds, tds = sources(streaming_block_size=7)
    ttd = tds.read_training(CPU)
    assert ttd.index is not None and ttd._users is None \
        and ttd._items is None
    [(jtr, _, jqa)] = jds.read_eval(None)
    [(ttr, _, tqa)] = tds.read_eval(CPU)
    assert ttr.index is not None and ttr._users is None
    assert columns(ttr) == columns(jtr)
    assert [(q.user, q.num, a.items) for q, a in tqa] == \
        [(q.user, q.num, a.items) for q, a in jqa]
    u_labels, rows = np.unique(ttr.users.astype(str), return_inverse=True)
    np.testing.assert_array_equal(ttr.index[0], u_labels)
    np.testing.assert_array_equal(ttr.index[1], rows)
    over = dict(streaming_block_size=7, eval_duration_days=0.25,
                eval_first_until="2024-01-01T20:00:00Z", eval_count=3)
    jds, tds = sources(**over)
    js, ts = jds.read_eval(None), tds.read_eval(CPU)
    assert len(ts) == len(js) == 3
    for (jtr, _, jqa), (ttr, _, tqa) in zip(js, ts):
        assert columns(ttr) == columns(jtr)
        i_labels, cols = np.unique(ttr.items.astype(str),
                                   return_inverse=True)
        np.testing.assert_array_equal(ttr.index[2], i_labels)
        np.testing.assert_array_equal(ttr.index[3], cols)
        assert [(q.user, a.items) for q, a in tqa] == \
            [(q.user, a.items) for q, a in jqa]


def test_sliding_windows_equal_jax(stores):
    over = dict(eval_first_until="2024-01-01T20:00:00Z",
                eval_duration_days=0.25, eval_count=3)
    jds, tds = sources(**over)
    js, ts = jds.read_eval(None), tds.read_eval(CPU)
    assert len(ts) == len(js) == 3
    for (jtr, _, jqa), (ttr, _, tqa) in zip(js, ts):
        assert columns(ttr) == columns(jtr)
        assert [(q.user, a.items) for q, a in tqa] == \
            [(q.user, a.items) for q, a in jqa]
    with pytest.raises(ValueError, match="eval_first_until"):
        sources(eval_count=2)[1].read_eval(CPU)


# -- a JAX-trained model carried into the port --------------------------------

PARAMS = dict(rank=16, n_layers=2, n_heads=2, max_seq_len=16,
              num_steps=60, batch_size=16, n_negatives=16,
              learning_rate=0.01, seed=3)


@pytest.fixture
def carried(stores):
    """One model trained by the JAX package, and the port's copy of it."""
    jds, _ = sources()
    jpd = jseq.SequencePreparator(jseq.SeqPreparatorParams(
        max_seq_len=16)).prepare(None, jds.read_training(None))
    jalgo = jseq.SeqRecAlgorithm(jseq.SeqRecParams(**PARAMS))
    jmodel = jalgo.train(None, jpd)
    tmodel = seqrec_model_from_numpy(
        jmodel.theta, jmodel.user_vectors, list(jmodel.user_map.labels),
        list(jmodel.item_map.labels), jmodel.seen, jmodel.enc_params,
        device="cpu")
    return jalgo, jmodel, tseq.SeqRecAlgorithm(tseq.SeqRecParams(**PARAMS)), \
        tmodel


def scored(result):
    return [(s.item, s.score) for s in result.item_scores]


def assert_same_answer(got, want):
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               atol=1e-5, rtol=1e-5)


QUERIES = [{"user": f"u{u}", "num": n} for u, n in
           ((0, 5), (3, 10), (7, 3), (11, 40), (20, 8), (39, 6))] + [
    {"user": "u5", "num": 4, "blacklist": ["i1", "i2", "i3"]},
    {"user": "nobody", "num": 4}, {"items": ["i1", "i4"], "num": 5}]


def test_carried_model_answers_as_jax(carried, monkeypatch):
    """Under ``auto`` this size serves from the host lane (as JAX's
    does); under ``device`` from the fp32 device store. Both answer as
    JAX's model."""
    from predictionio_tpu_torch.ops import serving as tserving

    jalgo, jmodel, talgo, tmodel = carried
    for backend, lane in (("auto", tserving.HostTopK),
                          ("device", tserving.DeviceTopK)):
        monkeypatch.setenv("PIO_SERVING_BACKEND", backend)
        tmodel._server = None
        assert isinstance(tmodel.device_server(), lane)
        if lane is tserving.DeviceTopK:
            assert tmodel.device_server().precision == "fp32"
        for q in QUERIES:
            assert_same_answer(scored(talgo.predict(tmodel, q)),
                               scored(jalgo.predict(jmodel, jseq.Query(
                                   user=q.get("user"),
                                   items=tuple(q.get("items", ())),
                                   num=q["num"],
                                   blacklist=tuple(q.get("blacklist",
                                                         ()))))))
        tmodel.device_server().close()


def test_batch_predict_equals_single_queries(carried):
    _, _, talgo, tmodel = carried
    batch = talgo.batch_predict(CPU, tmodel, list(enumerate(QUERIES)))
    assert [qx for qx, _ in batch] == list(range(len(QUERIES)))
    for (qx, res), q in zip(batch, QUERIES):
        assert scored(res) == scored(talgo.predict(tmodel, q))


def test_pickle_round_trip_serves_the_same(carried):
    _, _, talgo, tmodel = carried
    before = [scored(talgo.predict(tmodel, q)) for q in QUERIES]
    tmodel.fold_in_rows([np.array([1, 2])], [np.ones(2)])
    assert tmodel._theta_device is not None
    [back] = tcore.deserialize_models(tcore.serialize_models([tmodel]))
    assert back._server is None
    assert "_theta_device" not in back.__dict__
    assert all(isinstance(v, np.ndarray) for v in back.theta.values())
    assert [scored(talgo.predict(back, q)) for q in QUERIES] == before


def test_fold_in_rows_re_encodes_as_jax(carried):
    _, jmodel, _, tmodel = carried
    rng = np.random.default_rng(4)
    cols = [rng.integers(0, N_ITEMS, n) for n in (1, 5, 16, 23, 9)]
    vals = [np.ones(len(c)) for c in cols]
    got = tmodel.fold_in_rows(cols, vals)
    want = jmodel.fold_in_rows(cols, vals)
    assert got.shape == (5, 16)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # a user's training encode is its re-encode from the same history
    pd = tseq.SequencePreparator(tseq.SeqPreparatorParams(
        max_seq_len=16)).prepare(CPU, sources()[1].read_training(CPU))
    seqs = {}
    for b in pd.buckets:
        for r, ids, m in zip(b.rows, b.ids, b.mask):
            seqs[int(r)] = ids[m > 0]
    rows = sorted(seqs)[:6]
    np.testing.assert_allclose(
        tmodel.fold_in_rows([seqs[r] for r in rows], [None] * 6),
        tmodel.user_vectors[rows], atol=1e-5, rtol=1e-5)
    assert tmodel.fold_in_rows([], []).shape == (0, 16)


# -- the positive filter -------------------------------------------------------

def negative_model():
    p = tseq.SeqRecParams(rank=16, n_heads=2, max_seq_len=16)
    from predictionio_tpu_torch.ops.seqrec import init_theta

    return seqrec_model_from_numpy(
        init_theta(6, p), -np.ones((2, 16), dtype=np.float32),
        ["u0", "u1"], [f"i{j}" for j in range(6)],
        {0: np.asarray([0, 1])}, p, device="cpu")


def test_all_negative_scores_still_serve_a_ranking():
    model = negative_model()
    model.item_vectors = np.ones((6, 16), dtype=np.float32)
    algo = tseq.SeqRecAlgorithm(model.enc_params)
    r = algo.predict(model, {"user": "u0", "num": 3})
    assert len(r.item_scores) == 3
    assert all(s.score < 0 for s in r.item_scores)
    assert {s.item for s in r.item_scores}.isdisjoint({"i0", "i1"})
    [(_, b)] = algo.batch_predict(CPU, model, [(0, {"user": "u0",
                                                     "num": 3})])
    assert scored(b) == scored(r)
    # the seen mask still drops: u0 has 4 unseen items of 6
    assert len(algo.predict(model, {"user": "u0", "num": 9})
               .item_scores) == 4


def test_als_keeps_its_positive_filter():
    from predictionio_tpu_torch.templates.recommendation.engine import (
        ALSAlgorithm,
    )
    from predictionio_tpu_torch.ops.als import ALSParams

    model = als_model_from_numpy(
        -np.ones((2, 4), dtype=np.float32), np.ones((6, 4), np.float32),
        ["u0", "u1"], [f"i{j}" for j in range(6)], {0: [0, 1]},
        device="cpu")
    algo = ALSAlgorithm(ALSParams(rank=4))
    assert algo.predict(model, {"user": "u0", "num": 3}).item_scores == ()
    [(_, b)] = algo.batch_predict(CPU, model, [(0, {"user": "u0",
                                                     "num": 3})])
    assert b.item_scores == ()


# -- the port alone: train, deploy with fold-in, registry, eval ------------------

def variant(num_steps=60):
    return {"id": "default", "engineFactory": FACTORY,
            "datasource": {"params": {"appName": APP,
                                      "streamingBlockSize": 50}},
            "preparator": {"params": {"maxSeqLen": 16}},
            "algorithms": [{"name": "seqrec", "params": {
                **{k: v for k, v in PARAMS.items() if k != "num_steps"},
                "numSteps": num_steps}}]}


def post(addr, path, body):
    conn = http.client.HTTPConnection(*addr, timeout=30)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"null")
    finally:
        conn.close()


def test_trained_instance_serves_and_folds_in(stores, monkeypatch):
    monkeypatch.setenv("PIO_FOLDIN_INTERVAL", "0.2")
    iid = tcw.create_workflow(tcw.WorkflowConfig(engine_factory=FACTORY),
                              variant(), ctx=CPU)
    inst = tserver.resolve_engine_instance(iid)
    dep = tserver.build_deployment(inst, CPU)
    [model] = dep.models
    assert isinstance(model, tseq.SeqRecModel) and model.device == "cpu"
    assert np.isfinite(model.user_vectors).all()
    srv = tserver.QueryServer(tserver.ServerConfig(
        ip="127.0.0.1", port=0, foldin=True), dep).start()
    try:
        status, before = post(srv.address, "/queries.json",
                              {"user": "u2", "num": 5})
        assert status == 200 and len(before["itemScores"]) == 5
        le = tstorage.get_levents()
        aid = tstorage.get_metadata_apps().get_by_name(APP).id
        new = [f"i{j}" for j in (30, 31, 32)]
        le.insert_batch([TEvent(
            event="view", entity_type="user", entity_id=who,
            target_entity_type="item", target_entity_id=it,
            event_time=T0 + dt.timedelta(days=30, minutes=j))
            for who in ("u2", "fresh") for j, it in enumerate(new)], aid)
        deadline = time.time() + 30
        while time.time() < deadline:
            st = srv._foldin.stats()
            if st["usersPatched"] >= 2 and st["pendingEvents"] == 0:
                break
            time.sleep(0.05)
        assert srv._foldin.stats()["newUsers"] == 1
        status, fresh = post(srv.address, "/queries.json",
                             {"user": "fresh", "num": 5})
        assert status == 200 and len(fresh["itemScores"]) == 5
        assert {s["item"] for s in fresh["itemScores"]}.isdisjoint(new)
        # the patched row is the re-encode of the user's whole history
        hist = [c for c in model.seen[model.user_map["u2"]]]
        assert set(model.item_map[i] for i in new) <= set(hist)
        row = model.device_server()._X[model.user_map["fresh"]].numpy()
        want = model.fold_in_rows(
            [np.asarray([model.item_map[i] for i in new])], [None])[0]
        np.testing.assert_allclose(row, want, atol=1e-6)
        status, after = post(srv.address, "/queries.json",
                             {"user": "u2", "num": 5})
        assert after["itemScores"] != before["itemScores"]
    finally:
        srv.stop()


def test_template_registry(tmp_path, capsys):
    assert tcli.main(["template", "list"]) == 0
    listing = capsys.readouterr().out
    line = next(ln for ln in listing.splitlines() if "sequentialrec" in ln)
    assert "not ported" not in line
    assert tcli.main(["template", "get", "sequentialrec",
                      str(tmp_path / "e")]) == 0
    got = json.loads((tmp_path / "e" / "engine.json").read_text())
    from predictionio_tpu.tools.template_commands import BUILTIN_TEMPLATES

    want = BUILTIN_TEMPLATES["sequentialrec"]["variant"]
    assert got["engineFactory"] == FACTORY
    assert {k: v for k, v in got.items() if k != "engineFactory"} == \
        {k: v for k, v in want.items() if k != "engineFactory"}
    engine = tseq.engine_factory()
    ep = engine.engine_params_from_variant(got)
    assert ep.algorithm_params_list[0][1] == tseq.SeqRecParams(
        rank=32, n_layers=2, n_heads=2, num_steps=300, seed=7)


def make_evaluation():
    """The template's Evaluation over the test app."""
    return tseq.SeqRecEvaluation(app_name=APP, k=5)


def test_pio_eval_of_the_evaluation_writes_best_json(stores, monkeypatch,
                                                     capsys):
    import functools
    import importlib

    monkeypatch.chdir(stores)
    # the grid's 300 steps a config, cut to 15 for the CPU
    monkeypatch.setattr(
        importlib.import_module(
            "predictionio_tpu_torch.templates.sequentialrec.engine"),
        "SeqRecParams", functools.partial(tseq.SeqRecParams, num_steps=15))
    assert tcli.main(["eval", f"{__name__}:make_evaluation",
                      "--device", "cpu"]) == 0
    assert "[INFO] Best Params Index:" in capsys.readouterr().out
    best = json.loads((stores / "best.json").read_text())
    assert best["algorithms"][0]["params"]["rank"] in (16, 32)
    assert best["algorithms"][0]["params"]["n_layers"] in (1, 2)
    [inst] = tstorage.get_metadata_evaluation_instances().get_all()
    assert inst.status == "EVALCOMPLETED"
    result = json.loads(inst.evaluator_results_json)
    assert result["metricHeader"] == "Precision@5"
    assert len(result["engineParamsScores"]) == 4


def test_engine_params_type():
    assert isinstance(tseq.SeqRecParamsList("a").engine_params_list[0],
                      EngineParams)
