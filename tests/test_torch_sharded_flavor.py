"""The port's PAlgorithm flavor of the recommendation template
(``sharded_engine_factory``: ``ALSShardedAlgorithm`` and
``ShardedALSModel``) against the JAX package's, on the CPU: the port
over a context of four logical shards of one device (``["cpu"] * 4``),
JAX on its forced host platform.

Mirrors JAX ``tests/test_serving_device.py``'s ``TestShardedFlavor``:
training persists ``RETRAIN``, deploy trains again into a model whose
factors stay on the mesh, the answers exclude seen items, and the
bucketed layout answers like the uniform one. Then: the answers equal
``ALSAlgorithm``'s (item ids exactly, scores within ``rtol=1e-3``) and
JAX's sharded flavor's, no host copy of the factor tables is made from
training to the first answer (``Tensor.numpy`` and ``_to_host`` raise
for them), ``pio batchpredict`` over the model writes the looped path's
records byte for byte, ``ALSAlgorithm`` trains over a context of
several devices, and a secondary host's ``run_train`` writes nothing.
"""

import dataclasses
import datetime as dt
import importlib

import numpy as np
import pytest
import torch

from predictionio_tpu.data import storage as jstorage
from predictionio_tpu_torch.batch import predict as tbp
from predictionio_tpu_torch.core.base import RETRAIN
from predictionio_tpu_torch.core.context import workflow_context
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.ops import als as tals
from predictionio_tpu_torch.parallel import distributed as tdist
from predictionio_tpu_torch.parallel import mesh as tmesh
from predictionio_tpu_torch.templates import recommendation as trec
from predictionio_tpu_torch.workflow import create_workflow as tcw
from predictionio_tpu_torch.workflow.core_workflow import run_train
from test_torch_lifecycle import configure, jax_init

pytestmark = pytest.mark.multichip

CPU4 = ["cpu"] * 4
PLANE = workflow_context(devices=CPU4, device="cpu")
ONE = workflow_context(device="cpu")
T0 = dt.datetime(2021, 1, 1, tzinfo=dt.timezone.utc)
USERS = [f"u{u}" for u in range(20)]


def seed(st, pkg, app="recapp"):
    """JAX's ``_seed``: 20 users, 8 ratings each within one of two item
    groups."""
    base = importlib.import_module(f"{pkg}.data.storage.base")
    Event = importlib.import_module(f"{pkg}.data.event").Event
    aid = st.get_metadata_apps().insert(base.App(0, app))
    le = st.get_levents()
    le.init(aid)
    rng = np.random.default_rng(0)
    events = []
    for u in range(20):
        group = "a" if u < 10 else "b"
        for _ in range(8):
            events.append(Event(
                event="rate", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item",
                target_entity_id=f"{group}{rng.integers(0, 10)}",
                properties={"rating": float(rng.integers(4, 6))},
                event_time=T0))
    le.insert_batch(events, aid)


def engine_params(pkg=trec, rank=8, bucketed=False):
    als = importlib.import_module(
        "predictionio_tpu.ops.als" if pkg is not trec
        else "predictionio_tpu_torch.ops.als")
    ep = importlib.import_module(
        "predictionio_tpu.controller" if pkg is not trec
        else "predictionio_tpu_torch.controller").EngineParams
    return ep(
        data_source_params=("", pkg.DataSourceParams(app_name="recapp")),
        preparator_params=("", pkg.PreparatorParams(bucketed=bucketed)),
        algorithm_params_list=[
            ("als", als.ALSParams(rank=rank, num_iterations=3, seed=0))])


@pytest.fixture
def store(tmp_path, monkeypatch):
    monkeypatch.setattr(tals, "init_factors", jax_init)
    for name in ("PIO_SERVING_BACKEND", "PIO_SERVE_PRECISION",
                 "PIO_SERVE_SHARDS", "PIO_CHECKPOINT_DIR"):
        monkeypatch.delenv(name, raising=False)
    configure(tstorage, "memory", tmp_path / "port.db")
    seed(tstorage, "predictionio_tpu_torch")
    yield
    tstorage.reset()


def deploy(engine, params, iid, ctx=PLANE):
    persisted = engine.train(ctx, params, engine_instance_id=iid)
    [model] = engine.prepare_deploy(ctx, params, iid, persisted)
    return persisted, engine._algorithms(params)[0], model


def ask(algo, model, user, num=5):
    return algo.predict(model, trec.Query(user=user, num=num))


def same_answers(got, want, rtol=1e-3):
    assert [s.item for s in got.item_scores] == \
        [s.item for s in want.item_scores]
    np.testing.assert_allclose([s.score for s in got.item_scores],
                               [s.score for s in want.item_scores],
                               rtol=rtol)


class TestShardedFlavor:
    def test_train_persists_retrain_and_serves_from_the_mesh(self, store):
        persisted, algo, model = deploy(trec.sharded_engine_factory(),
                                        engine_params(), "t1")
        assert persisted == [RETRAIN]   # a sharded model never pickles
        assert isinstance(model, trec.ShardedALSModel)
        for t in (model.user_factors, model.item_factors):
            assert isinstance(t, tmesh.ShardedTensor)
            assert t.mesh.size == 4 and all(
                b.device == torch.device("cpu") for b in t.blocks)
        assert model.item_layout.n_shards == 4
        assert model.device_server().shard_count == 4
        result = ask(algo, model, "u1")
        assert 0 < len(result.item_scores) <= 5
        assert {s.item[0] for s in result.item_scores[:3]} <= {"a", "b"}
        # seen items excluded on the device
        seen = set(model.item_map.decode(model.seen[model.user_map["u1"]]))
        full = ask(algo, model, "u1", 50)
        assert not ({s.item for s in full.item_scores} & seen)

    def test_answers_equal_als_algorithm(self, store):
        _, algo, model = deploy(trec.sharded_engine_factory(),
                                engine_params(), "s")
        _, ref_algo, ref = deploy(trec.engine_factory(), engine_params(),
                                  "p", ONE)
        assert isinstance(ref, trec.ALSModel)
        # the same factors from the same init
        assert np.array_equal(
            tdist.process_allgather(model.user_factors).numpy()[:20],
            ref.user_factors)
        for u in USERS + ["nobody"]:
            same_answers(ask(algo, model, u), ask(ref_algo, ref, u))

    def test_answers_agree_with_the_jax_flavor(self, store, tmp_path):
        from predictionio_tpu.controller import ComputeContext as JCtx
        from predictionio_tpu.templates import recommendation as jrec

        configure(jstorage, "memory", tmp_path / "jax.db")
        try:
            seed(jstorage, "predictionio_tpu")
            jengine = jrec.sharded_engine_factory()
            jparams = engine_params(jrec)
            [jmodel] = jengine.prepare_deploy(
                JCtx(), jparams, "j", jengine.train(JCtx(), jparams,
                                                    engine_instance_id="j"))
            jalgo = jengine._algorithms(jparams)[0]
            _, algo, model = deploy(trec.sharded_engine_factory(),
                                    engine_params(), "t")
            for u in USERS:
                got = ask(algo, model, u)
                want = jalgo.predict(jmodel, jrec.Query(user=u, num=5))
                same_answers(got, want)
        finally:
            jstorage.reset()

    def test_bucketed_equals_uniform(self, store):
        _, algo_u, model_u = deploy(trec.sharded_engine_factory(),
                                    engine_params(), "du")
        _, algo_b, model_b = deploy(trec.sharded_engine_factory(),
                                    engine_params(bucketed=True), "db")
        assert isinstance(model_b, trec.ShardedALSModel)
        for u in ("u1", "u7", "u15"):
            same_answers(ask(algo_b, model_b, u), ask(algo_u, model_u, u))

    def test_no_host_copy_of_the_factor_tables(self, store, monkeypatch):
        """``Tensor.numpy`` raises for a factor table (rank 7 columns) and
        the trainers' ``_to_host`` raises outright, from training to the
        first answer: the model never passes through host numpy."""
        rank = 7
        numpy = torch.Tensor.numpy

        def guarded(t, *a, **kw):
            if t.dim() == 2 and t.shape[1] == rank:
                raise AssertionError(f"a host copy of {tuple(t.shape)}")
            return numpy(t, *a, **kw)

        def refuse(t):
            raise AssertionError("_to_host called")

        monkeypatch.setattr(torch.Tensor, "numpy", guarded)
        monkeypatch.setattr(tals, "_to_host", refuse)
        with pytest.raises(AssertionError, match="host copy"):
            torch.zeros(3, rank).numpy()
        params = engine_params(rank=rank)
        # the guard catches the host-model flavor, whose factors land
        # on the host
        with pytest.raises(AssertionError, match="_to_host"):
            deploy(trec.engine_factory(), params, "h")
        _, algo, model = deploy(trec.sharded_engine_factory(), params, "g")
        model.sanity_check()
        answer = ask(algo, model, "u3")
        assert len(answer.item_scores) == 5

    def test_does_not_pickle(self, store):
        import pickle

        _, _, model = deploy(trec.sharded_engine_factory(), engine_params(),
                             "n")
        with pytest.raises(TypeError, match="RETRAIN"):
            pickle.dumps(model)
        model.sanity_check()
        bad = dataclasses.replace(model, user_factors=tdist.make_global_array(
            model.user_factors.mesh, tmesh.P(None, None),
            torch.full(model.user_factors.shape, float("nan"))))
        with pytest.raises(AssertionError, match="non-finite"):
            bad.sanity_check()

    def test_batch_predict_groups_like_predict(self, store):
        _, algo, model = deploy(trec.sharded_engine_factory(),
                                engine_params(), "bp")
        queries = [(0, trec.Query(user="u1", num=5)),
                   (1, trec.Query(user="u2", num=5)),
                   (2, trec.Query(user="nobody", num=5)),
                   (3, trec.Query(user="u3", num=4, blacklist=("a1",))),
                   (4, trec.Query(items=("a1", "a2"), num=3))]
        got = dict(algo.batch_predict(PLANE, model, queries))
        for qx, q in queries:
            assert got[qx] == algo.predict(model, q)


def test_batchpredict_records_equal_the_looped_path(store, tmp_path):
    """``pio batchpredict`` over the sharded flavor's instance: deploy
    trains again over the context's four shards, each chunk's user
    queries are scored against the shards, and the records are the
    looped ``serve_one``'s byte for byte."""
    params = engine_params()
    instance = tcw.new_engine_instance(tcw.WorkflowConfig(
        engine_factory="predictionio_tpu_torch.templates.recommendation."
                       "engine:sharded_engine_factory"), params)
    iid = run_train(trec.sharded_engine_factory(), params, instance,
                    ctx=PLANE)
    assert iid is not None
    queries = [{"user": u, "num": 3} for u in USERS] + [
        {"user": "ghost", "num": 3}, {"items": ["a1", "a2"], "num": 4},
        {"user": "u3", "num": 4, "blacklist": ["a1", "a2", "zz"]}]
    qfile = tmp_path / "queries.jsonl"
    qfile.write_text("".join(f"{__import__('json').dumps(q)}\n"
                             for q in queries))
    config = tbp.BatchPredictConfig(output_dir=str(tmp_path / "out"),
                                    engine_instance_id=iid,
                                    input_path=str(qfile), chunk_size=8)
    summary = tbp.run_batch_predict(config, ctx=PLANE)
    assert summary["queries"] == len(queries)
    bp = tbp.BatchPredictor(dataclasses.replace(
        config, output_dir=str(tmp_path / "probe")), ctx=PLANE)
    dep = bp.load()
    assert dep.models[0].device_server().shard_count == 4
    lines = tbp._canonical_query_lines(queries)
    expected = b"".join((rec + "\n").encode("utf-8")
                        for rec in tbp.BatchPredictor._render_records(
                            lines, [bp.serve_one(q) for q in queries]))
    manifest = tbp.Manifest.load(str(tmp_path / "out" / tbp.MANIFEST_NAME))
    got = b"".join((tmp_path / "out" / c["file"]).read_bytes()
                   for c in manifest.chunks)
    assert got == expected


def test_als_algorithm_trains_over_a_context_plane(store, monkeypatch):
    """``ALSAlgorithm.train`` hands a context of several devices to
    ``train_als_auto``, which trains sharded over them: the factors equal
    one device's."""
    from predictionio_tpu_torch.parallel import als_sharding as tshard

    meshes = []
    sharded = tshard.train_als_sharded
    monkeypatch.setattr(tshard, "train_als_sharded", lambda *a, **kw: (
        meshes.append(a[3]) or sharded(*a, **kw)))
    params = engine_params()
    _, _, model = deploy(trec.engine_factory(), params, "pl")
    _, _, ref = deploy(trec.engine_factory(), params, "one", ONE)
    assert [m.size for m in meshes] == [4]
    assert np.array_equal(model.user_factors, ref.user_factors)
    assert np.array_equal(model.item_factors, ref.item_factors)


def test_secondary_host_writes_nothing(store, monkeypatch):
    """JAX's ``test_secondary_host_skips_persistence``: on a host other
    than 0, ``run_train`` trains but writes neither an EngineInstance nor
    a model, and returns None."""
    trained = []
    algo_train = trec.ALSAlgorithm.train
    monkeypatch.setattr(trec.ALSAlgorithm, "train", lambda self, ctx, pd: (
        trained.append(1) or algo_train(self, ctx, pd)))
    monkeypatch.setattr(tdist, "process_index", lambda: 1)
    assert not tdist.is_primary_host()
    params = engine_params()
    instance = tcw.new_engine_instance(tcw.WorkflowConfig(
        engine_factory="predictionio_tpu_torch.templates.recommendation."
                       "engine:engine_factory"), params)
    assert run_train(trec.engine_factory(), params, instance,
                     ctx=ONE) is None
    assert trained == [1]
    assert tstorage.get_metadata_engine_instances().get_all() == []
