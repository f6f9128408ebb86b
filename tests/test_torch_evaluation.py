"""The port's evaluation stack against the JAX package's, on the CPU.

- Every metric class (Average, OptionAverage, population Stdev,
  OptionStdev, Sum, Zero) gives the JAX package's value on the same
  evaluation data; ``MetricEvaluator`` picks the same best (ties keep the
  first), scores the other metrics, renders the same JSON, and writes a
  ``best.json`` byte-equal to the JAX one (the clock pinned);
  ``Evaluation`` / ``EngineParamsGenerator`` keep their set-once rules.
- ``FastEvalEngine``'s memo: the data source read once, the preparator
  once per eval set, the algorithm once per distinct params, counts
  equal to the JAX engine's; its caches stay within their bound.
- ``data/sliding.py``: the same windows, splits and NDCG.
- The template: ``read_eval`` (leave-last-out, and sliding windows) on
  one memory store read by both packages gives equal sets;
  ``PrecisionAtK`` / ``NDCGAtK`` equal; ``FileBlacklistServing`` serves a
  query as the JAX one does with one disabled file.
- ``FakeRun`` through ``run_evaluation`` runs its function once and
  stores nothing, as the JAX one does.
"""

import dataclasses
import datetime as dt
import importlib
import json
import math

import numpy as np
import pytest

from predictionio_tpu.controller import evaluation as jev
from predictionio_tpu.data import sliding as jsl
from predictionio_tpu.data import storage as jstorage
from predictionio_tpu.templates.recommendation import engine as jeng
from predictionio_tpu_torch.controller import evaluation as tev
from predictionio_tpu_torch.controller.fast_eval import FastEvalEngineWorkflow
from predictionio_tpu_torch.core.base import WorkflowParams
from predictionio_tpu_torch.data import sliding as tsl
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.templates.recommendation import engine as teng

UTC = dt.timezone.utc
PACKAGES = ("predictionio_tpu", "predictionio_tpu_torch")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


# -- metrics -------------------------------------------------------------------------

def metric_classes(pkg):
    """Per-(Q, P, A) metrics of ``pkg``: q, None when q is odd (the
    optional ones), 2q (the sum)."""
    m = mod(pkg, "controller.metrics")

    class QAvg(m.AverageMetric):
        def calculate_qpa(self, q, p, a):
            return q

    class QOpt(m.OptionAverageMetric):
        def calculate_qpa(self, q, p, a):
            return None if q % 2 else q

    class QStd(m.StdevMetric):
        def calculate_qpa(self, q, p, a):
            return q

    class QOptStd(m.OptionStdevMetric):
        def calculate_qpa(self, q, p, a):
            return None if q % 2 else q

    class QSum(m.SumMetric):
        def calculate_qpa(self, q, p, a):
            return 2 * q

    return [QAvg(), QOpt(), QStd(), QOptStd(), QSum(), m.ZeroMetric()]


EVAL_DATA = [("ei0", [(1, None, None), (2, None, None), (4, None, None)]),
             ("ei1", [(7, None, None), (10, None, None)])]


@pytest.mark.parametrize("data", [EVAL_DATA, [("ei", [])], []],
                         ids=["sets", "empty set", "none"])
def test_every_metric_equals_the_jax_one(data):
    for jm, tm in zip(metric_classes(PACKAGES[0]),
                      metric_classes(PACKAGES[1])):
        want, got = jm.calculate(None, data), tm.calculate(None, data)
        assert type(got) is type(want)
        assert got == want or (math.isnan(got) and math.isnan(want))
        assert tm.header == jm.header
        assert tm.compare(1.0, 2.0) == jm.compare(1.0, 2.0) == -1


# -- MetricEvaluator, Evaluation, EngineParamsGenerator --------------------------------

def dase(pkg):
    """A small engine of ``pkg``: eval set ``e`` of a data source with
    ``id`` holds queries ``(id, e, j)``; each prediction echoes its query
    with the algorithm's ``id``."""
    c = mod(pkg, "controller")
    base = mod(pkg, "core.base")

    @dataclasses.dataclass(frozen=True)
    class IdParams(base.Params):
        id: int = 0
        en: int = 2
        qn: int = 2

    class Counts:
        reads = prepares = trains = 0

    class DS(c.PDataSource):
        params_class = IdParams

        def read_training(self, ctx):
            return ("td", self.params.id)

        def read_eval(self, ctx):
            Counts.reads += 1
            return [(("td", self.params.id, e), ("ei", e),
                     [((self.params.id, e, j), ("a", j))
                      for j in range(self.params.qn)])
                    for e in range(self.params.en)]

    class Prep(c.PPreparator):
        params_class = IdParams

        def prepare(self, ctx, td):
            Counts.prepares += 1
            return ("pd", td)

    class Algo(c.P2LAlgorithm):
        params_class = IdParams

        def train(self, ctx, pd):
            Counts.trains += 1
            return ("model", self.params.id, pd)

        def predict(self, model, q):
            return (q, model[1])

    class Serve(c.LServing):
        params_class = IdParams

        def serve(self, q, ps):
            return ps[0]

    def params(ds=1, algo=3, serving=0, en=2):
        return c.EngineParams(
            data_source_params=("", IdParams(ds, en=en)),
            preparator_params=("", IdParams(0)),
            algorithm_params_list=[("", IdParams(algo))],
            serving_params=("", IdParams(serving)))

    return c, IdParams, Counts, (DS, Prep, Algo, Serve), params


class DSMetric:
    """Scores each query by its data source's id."""

    def calculate_qpa(self, q, p, a):
        return float(q[0])


def score_classes():
    return [type("DSIdMetric", (DSMetric, mod(pkg, "controller.metrics")
                                .AverageMetric), {}) for pkg in PACKAGES]


@pytest.mark.parametrize("ds_ids,best", [([3, 7, 5], 1), ([4, 4], 0),
                                         ([2], 0), ([5, 9, 9], 1)])
def test_metric_evaluator_and_best_json_equal_the_jax_ones(
        ds_ids, best, tmp_path, monkeypatch):
    class Clock:
        @staticmethod
        def now(tz=None):
            return dt.datetime(2024, 1, 2, 3, 4, 5, tzinfo=UTC)

    pinned = type("dt", (), {"datetime": Clock, "timezone": dt.timezone})
    monkeypatch.setattr(jev, "_dt", pinned)
    monkeypatch.setattr(tev, "_dt", pinned)
    results, files = [], []
    for pkg, metric_cls in zip(PACKAGES, score_classes()):
        c, _, _, classes, params = dase(pkg)
        zero = mod(pkg, "controller.metrics").ZeroMetric
        engine = c.Engine(*classes[:2], {"": classes[2]}, classes[3])
        eps = [params(ds=i) for i in ds_ids]
        data = engine.batch_eval(None, eps,
                                 mod(pkg, "core.base").WorkflowParams())
        out = tmp_path / f"{pkg}.json"
        ev = mod(pkg, "controller.evaluation").MetricEvaluator(
            metric_cls(), [zero()], output_path=str(out))
        res = ev.evaluate_base(None, None, data, None)
        assert res.best_engine_params is eps[best]
        results.append(res)
        files.append(out.read_bytes())
    jres, tres = results
    assert tres.best_idx == jres.best_idx == best
    assert tres.to_one_liner() == jres.to_one_liner()
    assert json.loads(tres.to_json()) | {"outputPath": None} == \
        json.loads(jres.to_json()) | {"outputPath": None}
    assert tres.to_html() == jres.to_html()
    assert files[1] == files[0]
    with pytest.raises(ValueError, match="at least one"):
        tev.MetricEvaluator(score_classes()[1]()).evaluate_base(
            None, None, [], None)


def test_parallel_scoring_equals_serial():
    c, _, _, classes, params = dase(PACKAGES[1])
    engine = c.Engine(*classes[:2], {"": classes[2]}, classes[3])
    data = engine.batch_eval(None, [params(ds=i) for i in range(4)])
    ev = tev.MetricEvaluator(score_classes()[1]())
    serial = ev.evaluate_base(None, None, data,
                              WorkflowParams(eval_parallelism=1))
    parallel = ev.evaluate_base(None, None, data,
                                WorkflowParams(eval_parallelism=4))
    assert [s.score for _, s in serial.engine_params_scores] == \
        [s.score for _, s in parallel.engine_params_scores]


def test_evaluation_and_generator_set_once_rules():
    for pkg in PACKAGES:
        c, _, _, classes, params = dase(pkg)
        ev_mod = mod(pkg, "controller.evaluation")
        engine = c.Engine(*classes[:2], {"": classes[2]}, classes[3])
        ev = ev_mod.Evaluation()
        with pytest.raises(AssertionError, match="Engine not set"):
            ev.engine
        ev.engine_metric = (engine, score_classes()[0]())
        assert ev.evaluator.output_path == "best.json"
        with pytest.raises(AssertionError, match="at most once"):
            ev.engine_metrics = (engine, score_classes()[0](), [])
        with pytest.raises(NotImplementedError):
            ev.engine_metric
        other = ev_mod.Evaluation()
        other.engine_metrics = (engine, score_classes()[0](), [])
        assert other.evaluator.output_path is None
        gen = ev_mod.EngineParamsGenerator()
        with pytest.raises(AssertionError, match="not set"):
            gen.engine_params_list
        gen.engine_params_list = [params(), params(ds=2)]
        assert len(gen.engine_params_list) == 2
        with pytest.raises(AssertionError, match="at most once"):
            gen.engine_params_list = []


# -- FastEvalEngine --------------------------------------------------------------------

def fast_counts(pkg, param_kw, cache_size=None, parallelism=0):
    c, _, counts, classes, params = dase(pkg)
    engine = mod(pkg, "controller.fast_eval").FastEvalEngine(
        *classes[:2], {"": classes[2]}, classes[3])
    if cache_size is not None:
        engine.cache_size = cache_size
    out = engine.batch_eval(
        None, [params(**kw) for kw in param_kw],
        mod(pkg, "core.base").WorkflowParams(eval_parallelism=parallelism))
    return (counts.reads, counts.prepares, counts.trains), out


@pytest.mark.parametrize("param_kw", [
    [{"algo": 3}, {"algo": 4}, {"algo": 3}, {"algo": 5}],
    [{"serving": 1}, {"serving": 2}],
    [{"ds": 1}, {"ds": 2}],
    [{"ds": i} for i in range(5)],
], ids=["4 params, one read", "serving only", "two sources", "five sources"])
def test_fast_eval_memo_counts_equal_the_jax_ones(param_kw):
    want, jout = fast_counts(PACKAGES[0], param_kw)
    got, tout = fast_counts(PACKAGES[1], param_kw)
    assert got == want
    assert [[(ei, qpa) for ei, qpa in evs] for _, evs in tout] == \
        [[(ei, qpa) for ei, qpa in evs] for _, evs in jout]
    if param_kw[0] == {"algo": 3}:
        # 4 params sharing a data source: one read, one prepare per eval
        # set, one training per distinct algorithm params and eval set
        assert got == (1, 2, 6)


def test_fast_eval_cache_stays_bounded():
    captured = {}
    original = FastEvalEngineWorkflow.get

    def capture(self, eps, workers=1):
        captured["wf"] = self
        return original(self, eps, workers)

    FastEvalEngineWorkflow.get = capture
    try:
        counts, _ = fast_counts(PACKAGES[1], [{"ds": i} for i in range(5)],
                                cache_size=2, parallelism=1)
    finally:
        FastEvalEngineWorkflow.get = original
    wf = captured["wf"]
    for cache in (wf.data_source_cache, wf.preparator_cache,
                  wf.algorithms_cache, wf.serving_cache):
        assert len(cache) <= 2
    assert counts[0] == 5


def test_fast_eval_output_equals_the_plain_engine():
    c, _, _, classes, params = dase(PACKAGES[1])
    slow = c.Engine(*classes[:2], {"": classes[2]}, classes[3])
    fast = mod(PACKAGES[1], "controller.fast_eval").FastEvalEngine(
        *classes[:2], {"": classes[2]}, classes[3])
    assert fast.eval(None, params(en=3)) == slow.eval(None, params(en=3))


# -- data/sliding.py -------------------------------------------------------------------

def test_sliding_helpers_equal_the_jax_ones():
    rng = np.random.default_rng(4)
    times = rng.uniform(0, 100, 300)
    got = [(k, a.tolist(), b.tolist())
           for k, a, b in tsl.sliding_window_masks(times, 20.0, 15.0, 4)]
    want = [(k, a.tolist(), b.tolist())
            for k, a, b in jsl.sliding_window_masks(times, 20.0, 15.0, 4)]
    assert got == want
    for bad in ((times, 20.0, 0.0, 2), (times, -5.0, 10.0, 2)):
        with pytest.raises(ValueError) as te:
            list(tsl.sliding_window_masks(*bad))
        with pytest.raises(ValueError) as je:
            list(jsl.sliding_window_masks(*bad))
        assert str(te.value) == str(je.value)
    ents = [f"u{x}" for x in rng.integers(0, 9, 60)]
    groups = tsl.group_by_entity(ents, list(range(60)))
    assert groups == jsl.group_by_entity(ents, list(range(60)))
    assert tsl.leave_last_out(groups) == jsl.leave_last_out(groups)
    for ranked, rel, k in (([3, 1, 2], {1}, 3), ([5, 6], {9}, 2),
                           ([1, 2, 3, 4], {4, 1}, 3), ([1], set(), 5)):
        assert tsl.ndcg_at_k(ranked, rel, k) == jsl.ndcg_at_k(ranked, rel, k)


# -- the template ---------------------------------------------------------------------

def fill(pkg, st, n=400):
    """``EvalApp``: rate events of 12 users over 30 items, one an hour,
    and a user with a single rating."""
    base = mod(pkg, "data.storage.base")
    Event = mod(pkg, "data.event").Event
    aid = st.get_metadata_apps().insert(base.App(0, "EvalApp"))
    rng = np.random.default_rng(9)
    t0 = dt.datetime(2021, 6, 1, tzinfo=UTC)
    evs = [Event(event="rate", entity_type="user",
                 entity_id=f"u{rng.integers(0, 12)}",
                 target_entity_type="item",
                 target_entity_id=f"i{rng.integers(0, 30)}",
                 properties={"rating": float(rng.integers(1, 6))},
                 event_time=t0 + dt.timedelta(hours=j)) for j in range(n)]
    evs.append(Event(event="rate", entity_type="user", entity_id="lonely",
                     target_entity_type="item", target_entity_id="i1",
                     properties={"rating": 4.0}, event_time=t0))
    st.get_levents().init(aid)
    st.get_levents().insert_batch(evs, aid)


@pytest.fixture
def both_stores():
    for pkg, st in zip(PACKAGES, (jstorage, tstorage)):
        st.reset(st.StorageConfig(
            sources={"S": {"type": "memory"}},
            repositories={r: "S" for r in ("METADATA", "EVENTDATA",
                                           "MODELDATA")}))
        fill(pkg, st)
    yield
    jstorage.reset()
    tstorage.reset()


def eval_sets(sets):
    """``read_eval``'s sets as comparable values: each training set's
    (user, item, rating) triples in order, and its (user, actuals)
    queries."""
    out = []
    for td, ei, qa in sets:
        assert type(ei).__name__ == "EmptyEvalInfo"
        triples = [(str(u), str(i), float(v))
                   for u, i, v in zip(td.users, td.items, td.values)]
        out.append((triples, [(q.user, q.num, a.items) for q, a in qa]))
    return out


@pytest.mark.parametrize("params", [
    {},
    {"streaming_block_size": 64},
    {"eval_count": 3, "eval_first_until": "2021-06-08T00:00:00Z",
     "eval_duration_days": 3.0},
    {"eval_count": 2, "eval_first_until": "2021-06-10T12:00:00+00:00",
     "eval_duration_days": 0.5},
], ids=["leave-last-out", "leave-last-out streamed", "sliding 3x3d",
        "sliding 2x12h"])
def test_read_eval_equals_the_jax_one(both_stores, params):
    want = jeng.EventDataSource(jeng.DataSourceParams(
        app_name="EvalApp", **params)).read_eval(None)
    got = teng.EventDataSource(teng.DataSourceParams(
        app_name="EvalApp", **params)).read_eval(None)
    assert eval_sets(got) == eval_sets(want)
    assert len(got) == max(1, params.get("eval_count", 0))
    if not params.get("eval_count"):
        users = {q[0] for q in eval_sets(got)[0][1]}
        assert "lonely" not in users and len(users) == 12


def test_read_eval_refusals_equal_the_jax_ones(both_stores):
    for params in ({"eval_count": 2},
                   {"eval_count": 2, "eval_first_until": "2021-06-08",
                    "streaming_block_size": 8},
                   {"eval_count": 2, "eval_first_until": "2021-05-01"}):
        with pytest.raises(ValueError) as je:
            jeng.EventDataSource(jeng.DataSourceParams(
                app_name="EvalApp", **params)).read_eval(None)
        with pytest.raises(ValueError) as te:
            teng.EventDataSource(teng.DataSourceParams(
                app_name="EvalApp", **params)).read_eval(None)
        assert str(te.value) == str(je.value)


def results(pkg, items):
    e = jeng if pkg == PACKAGES[0] else teng
    return e.PredictedResult(tuple(e.ItemScore(i, 1.0 - 0.1 * n)
                                   for n, i in enumerate(items)))


@pytest.mark.parametrize("k", [1, 3, 10])
def test_precision_and_ndcg_at_k_equal_the_jax_ones(k):
    cases = [(["a", "b", "c", "d"], ["c", "x"]), ([], ["a"]),
             (["a", "b"], []), (["q"] * 3, ["q"]),
             ([f"i{n}" for n in range(12)], ["i11", "i0", "i5"])]
    for e, pkg in ((jeng, PACKAGES[0]), (teng, PACKAGES[1])):
        assert e.PrecisionAtK(k).header == f"Precision@{k}"
        assert e.NDCGAtK(k).header == f"NDCG@{k}"
    for predicted, actual in cases:
        for metric in ("PrecisionAtK", "NDCGAtK"):
            want = getattr(jeng, metric)(k).calculate_qpa(
                None, results(PACKAGES[0], predicted),
                jeng.ActualResult(actual))
            got = getattr(teng, metric)(k).calculate_qpa(
                None, results(PACKAGES[1], predicted),
                teng.ActualResult(actual))
            assert got == want


def test_recommendation_evaluation_wiring_equals_the_jax_one():
    want = jeng.RecommendationEvaluation(app_name="A", k=5)
    got = teng.RecommendationEvaluation(app_name="A", k=5)
    assert got.evaluator.output_path == want.evaluator.output_path
    assert got.evaluator.metric.header == want.evaluator.metric.header
    assert [dataclasses.asdict(ep.algorithm_params_list[0][1])
            for ep in got.engine_params_list] == [
        dataclasses.asdict(ep.algorithm_params_list[0][1])
        for ep in want.engine_params_list]
    assert [ep.data_source_params[1].app_name
            for ep in got.engine_params_list] == ["A"] * 4


def test_file_blacklist_serving_equals_the_jax_one(tmp_path):
    disabled = tmp_path / "disabled.txt"
    disabled.write_text("i2\n\n i4 \n")
    query_items = ["i1", "i2", "i3", "i4", "i5"]
    served = []
    for e, pkg in ((jeng, PACKAGES[0]), (teng, PACKAGES[1])):
        engine = e.engine_factory()
        assert engine.serving_class_map["fileblacklist"] \
            is e.FileBlacklistServing
        params = engine.engine_params_from_variant(
            {"datasource": {"params": {"appName": "A"}},
             "serving": {"name": "fileblacklist",
                         "params": {"filepath": str(disabled)}}})
        serving = engine._make(engine.serving_class_map,
                               *params.serving_params, "serving")
        query = e.Query(user="u1", num=5)
        first = serving.serve_base(query, [results(pkg, query_items),
                                           results(pkg, ["zz"])])
        disabled.write_text("i2\n\n i4 \n")
        served.append([(s.item, s.score) for s in first.item_scores])
        # the file is read again on every query
        disabled.write_text("i1\n")
        again = serving.serve_base(query, [results(pkg, query_items)])
        served.append([s.item for s in again.item_scores])
        disabled.write_text("i2\n\n i4 \n")
    assert served[2:] == served[:2]
    assert [i for i, _ in served[0]] == ["i1", "i3", "i5"]
    assert served[1] == ["i2", "i3", "i4", "i5"]


def test_fake_run_runs_its_function_and_stores_nothing():
    """``FakeRun(fn)`` through ``run_evaluation``: ``fn`` runs once with
    the context, the result says ``no_save``, and the instance stays as
    inserted, in both packages."""
    now = dt.datetime(2024, 1, 1, tzinfo=UTC)
    seen = []
    for pkg, st in zip(PACKAGES, (jstorage, tstorage)):
        st.reset(st.StorageConfig(
            sources={"S": {"type": "memory"}},
            repositories={r: "S" for r in ("METADATA", "EVENTDATA",
                                           "MODELDATA")}))
        fake = mod(pkg, "workflow.fake").FakeRun(lambda ctx: seen.append(pkg))
        instance = mod(pkg, "data.storage.base").EvaluationInstance(
            id="", status="INIT", start_time=now, end_time=now)
        ctx = None
        if pkg == PACKAGES[1]:
            from predictionio_tpu_torch.core.context import ComputeContext

            ctx = ComputeContext(device="cpu")
        result = mod(pkg, "workflow.core_workflow").run_evaluation(
            fake.engine, fake.engine_params_list, instance, fake.evaluator,
            evaluation=fake, ctx=ctx)
        assert result.no_save and result.to_one_liner() == \
            "FakeRun completed"
        [stored] = st.get_metadata_evaluation_instances().get_all()
        assert stored.status == "INIT"
        st.reset()
    assert seen == list(PACKAGES)
