"""The other templates on the port against the JAX package, on the CPU:
classification, similarproduct (every flavor), helloworld and
ecommercerecommendation, as ``tests/test_templates.py`` drives them.

Each package gets a memory store of its own holding the same events.
The ALS flavors (similarproduct's ``ALSAlgorithm``, ``LikeAlgorithm``
and ``RecommendedUserAlgorithm``, ``ECommAlgorithm``) train from one
initial state (the JAX package's draws, injected into the port's
``init_factors``): the factors must agree within 1e-4 of their largest
entry, the served ids be equal and the scores within 1e-5 of the
answer's largest score.
They train at rank 4 where the JAX tests train at rank 8: on these
catalogs of 8 items (12 users for who-to-follow) one side's normal
equations are ill-conditioned at rank 8, and one fp32 half-step there
lands 1e-4 (JAX) to 3e-4 (port) of the largest entry away from a float64
solve, so no two fp32 trainers meet 1e-4 of each other.
The host models (naive Bayes, e2's categorical NB, the forest, DIMSUM's
numpy oracle) agree bitwise or to the stated tolerance. Then the JAX
test's own checks run on the port's answers, and every template the
port lists trains, deploys and answers over HTTP as it does in process
(``TestCrossTemplateEngineSmoke``)."""

import datetime as dt
import http.client
import importlib
import json

import numpy as np
import pytest

from predictionio_tpu.data import storage as jstorage
from predictionio_tpu_torch.core.context import ComputeContext
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.ops import als as tals

from test_torch_lifecycle import configure, jax_init

JAX, PORT = PKGS = ("predictionio_tpu", "predictionio_tpu_torch")
CPU = ComputeContext(device="cpu")
UTC = dt.timezone.utc
T0 = dt.datetime(2021, 6, 1, tzinfo=UTC)
FACTOR_TOL = 1e-4   # of the largest entry
SCORE_RTOL = 1e-5


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def store_of(pkg):
    return jstorage if pkg == JAX else tstorage


def ctx_of(pkg):
    return mod(JAX, "controller").ComputeContext() if pkg == JAX else CPU


@pytest.fixture
def both(tmp_path, monkeypatch):
    """A memory store for each package; the port's ALS starts from the
    JAX package's initial factors."""
    monkeypatch.setattr(tals, "init_factors", jax_init)
    monkeypatch.delenv("PIO_SERVE_PRECISION", raising=False)
    configure(jstorage, "memory", tmp_path / "jax.db")
    configure(tstorage, "memory", tmp_path / "port.db")
    yield
    jstorage.reset()
    tstorage.reset()


def ev(event, etype, eid, tet=None, tei=None, props=None, t=T0):
    return (event, etype, eid, tet, tei, props or {}, t)


def make_app(name):
    """The app in both stores; returns ``{pkg: app id}``."""
    ids = {}
    for pkg in PKGS:
        base = mod(pkg, "data.storage.base")
        st = store_of(pkg)
        ids[pkg] = st.get_metadata_apps().insert(base.App(0, name))
        st.get_levents().init(ids[pkg])
    return ids


def insert(ids, events):
    """The same events into both stores."""
    for pkg in PKGS:
        Event = mod(pkg, "data.event").Event
        store_of(pkg).get_levents().insert_batch([
            Event(event=e, entity_type=et, entity_id=eid,
                  target_entity_type=tet, target_entity_id=tei,
                  properties=props, event_time=t)
            for e, et, eid, tet, tei, props, t in events], ids[pkg])


class Trained:
    """One package's engine, params, algorithms and models."""

    def __init__(self, pkg, template, variant, factory="engine_factory"):
        self.pkg = pkg
        self.engine = getattr(mod(pkg, f"templates.{template}"), factory)()
        self.params = self.engine.engine_params_from_variant(variant)
        self.models = self.engine.train(ctx_of(pkg), self.params)
        self.algos = self.engine._algorithms(self.params)
        self.server = mod(pkg, "workflow.create_server")

    def query(self, q):
        return self.server.query_from_json(q, self.algos[0].query_class)

    def predict(self, q, ax=0):
        return self.algos[ax].predict(self.models[ax], self.query(q))

    def answer(self, q):
        """The served answer: every algorithm, then the serving."""
        query = self.query(q)
        name, params = self.params.serving_params
        serving = self.engine._make(self.engine.serving_class_map, name,
                                    params, "serving")
        preds = [a.predict(m, query) for a, m in zip(self.algos, self.models)]
        return self.server.to_jsonable(serving.serve(query, preds))


def train_both(template, variant, factory="engine_factory"):
    return [Trained(pkg, template, variant, factory) for pkg in PKGS]


def assert_factors_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= FACTOR_TOL * np.abs(want).max()


def assert_answers_agree(got, want, scale=0.0):
    """Ids and every other field equal, scores within 1e-5 of the
    query's score scale: the answer's largest score, or ``scale`` (the
    same query's unfiltered top score) when larger, since a filtered
    score near zero carries the rounding of the larger terms it sums."""
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, list) and w and isinstance(w[0], dict) \
                and "score" in w[0]:
            strip = [{k: v for k, v in s.items() if k != "score"} for s in g]
            assert strip == [{k: v for k, v in s.items() if k != "score"}
                             for s in w], key
            ws = np.asarray([s["score"] for s in w])
            np.testing.assert_allclose(
                [s["score"] for s in g], ws, rtol=0,
                atol=SCORE_RTOL * max(np.abs(ws).max(), scale))
        else:
            assert g == w, key


def top_score(trained, q):
    """The largest score of ``q``'s answer with every filter off."""
    plain = {k: v for k, v in q.items() if k in ("user", "users", "items")}
    out = trained.answer({**plain, "num": 1})
    scores = out.get("itemScores") or out.get("similarUserScores") or []
    return abs(scores[0]["score"]) if scores else 0.0


def agree_on(pair, queries, scale=0.0):
    """Both packages answer each query alike; returns the port's."""
    out = []
    for q in queries:
        want, got = pair[0].answer(q), pair[1].answer(q)
        assert_answers_agree(got, want, max(scale, top_score(pair[0], q)))
        out.append(got)
    return out


def variant_of(ds, algos, **extra):
    return {"datasource": {"params": ds},
            "algorithms": [{"name": n, "params": p} for n, p in algos],
            **extra}


# ---------------------------------------------------------------------------
# the controller pieces and the host scorers
# ---------------------------------------------------------------------------

def test_controller_pieces_as_jax():
    jc, tc = mod(JAX, "controller"), mod(PORT, "controller")
    for name in ("LPreparator", "LAverageServing", "SimpleEngine",
                 "PIdentityPreparator"):
        assert name in tc.__all__ and name in jc.__all__
    assert tc.PIdentityPreparator is tc.IdentityPreparator
    preds = [1, 2.5, 4]
    assert tc.LAverageServing().serve(None, preds) == \
        jc.LAverageServing().serve(None, preds)

    class Halve(tc.LPreparator):
        def prepare(self, td):
            return td / 2

    assert Halve().prepare_base(CPU, 5) == 2.5
    hello = mod(PORT, "templates.helloworld")
    engine = tc.SimpleEngine(hello.HelloWorldDataSource,
                             hello.HelloWorldAlgorithm)
    assert engine.preparator_class_map == {"": tc.IdentityPreparator}
    assert engine.serving_class_map == {"": tc.LFirstServing}
    assert engine.algorithm_class_map == {"": hello.HelloWorldAlgorithm}


@pytest.mark.parametrize("shape", [(1, 4, 30), (3, 8, 50), (2, 1, 7)])
def test_host_scorers_bitwise_jax(shape):
    q, r, m = shape
    rng = np.random.default_rng(q * 100 + r)
    Q = rng.normal(size=(q, r)).astype(np.float32)
    Y = rng.normal(size=(m, r)).astype(np.float32)
    Y[0] = 0.0   # a zero row scores 0, not NaN
    jals, pals = mod(JAX, "ops.als"), mod(PORT, "ops.als")
    got = pals.cosine_scores(Q, Y)
    assert np.array_equal(got, jals.cosine_scores(Q, Y))
    assert got.dtype == np.float32 and got[0] == 0.0
    assert np.array_equal(pals.predict_scores_for_user(Q[0], Y),
                          jals.predict_scores_for_user(Q[0], Y))


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------

def classification_events(rng):
    events = []
    for i in range(30):
        label = i % 2
        base = [1.0, 3.0, 1.0]
        base[0 if label == 0 else 2] += 10.0 + rng.random()
        events.append(ev("$set", "user", f"u{i}", props={
            "plan": float(label),
            "attr0": base[0], "attr1": base[1], "attr2": base[2]}))
    events.append(ev("$set", "user", "unlabeled", props={
        "attr0": 1.0, "attr1": 1.0, "attr2": 1.0}))
    return events


class TestClassificationTemplate:
    @pytest.fixture
    def app(self, both):
        insert(make_app("clsapp"), classification_events(
            np.random.default_rng(0)))

    def variant(self, *algos):
        return variant_of({"appName": "clsapp"}, algos)

    def test_naive_bayes_bitwise_and_predicts(self, app):
        j, t = train_both("classification",
                          self.variant(("naive", {"lambda": 1.0})))
        jm, tm = j.models[0], t.models[0]
        for field in ("labels", "pi", "theta"):
            assert np.array_equal(getattr(tm, field), getattr(jm, field))
        assert t.predict({"features": [12.0, 3.0, 1.0]}).label == 0.0
        assert t.predict({"features": [1.0, 3.0, 12.0]}).label == 1.0
        qs = [{"features": [float(a), 2.0, float(b)]}
              for a in range(5) for b in range(5)]
        assert [t.answer(q) for q in qs] == [j.answer(q) for q in qs]

    def test_jax_model_carried_by_weights_answers_as_jax(self, app):
        from predictionio_tpu_torch import weights

        j, t = train_both("classification", self.variant(("naive", {})))
        jm = j.models[0]
        t.models[0] = weights.naive_bayes_model_from_numpy(
            jm.labels, jm.pi, jm.theta)
        qs = [{"features": [float(a), 3.0, 1.0]} for a in range(0, 14, 3)]
        assert [t.answer(q) for q in qs] == [j.answer(q) for q in qs]

    def test_multi_algorithm_ensemble(self, app):
        j, t = train_both("classification", self.variant(
            ("naive", {}), ("categorical", {})))
        assert len(t.models) == 2
        assert t.models[1].priors == j.models[1].priors
        assert t.models[1].likelihoods == j.models[1].likelihoods
        q = {"features": [12.0, 3.0, 1.0]}
        assert t.server.to_jsonable(t.predict(q, 1)) == \
            j.server.to_jsonable(j.predict(q, 1))

    def test_random_forest_bitwise(self, app):
        j, t = train_both("classification", self.variant(
            ("randomforest", {"numTrees": 5, "maxDepth": 4, "seed": 3})))
        for jt, tt in zip(j.models[0].trees, t.models[0].trees):
            for field in ("feature", "threshold", "left", "right",
                          "leaf_class"):
                assert np.array_equal(getattr(tt, field), getattr(jt, field))
        qs = [{"features": [float(a), 3.0, float(b)]}
              for a in range(0, 14, 2) for b in range(0, 14, 3)]
        assert [t.answer(q) for q in qs] == [j.answer(q) for q in qs]

    def test_eval_accuracy(self, app):
        j, t = train_both("classification", self.variant(("naive", {})))
        got = t.engine.eval(CPU, t.params)
        want = j.engine.eval(ctx_of(JAX), j.params)
        assert len(got) == len(want) == 3
        for (_, gq), (_, wq) in zip(got, want):
            assert [(q.features, p.label, a.label) for q, p, a in gq] == \
                [(q.features, p.label, a.label) for q, p, a in wq]
        score = mod(PORT, "templates.classification").Accuracy().calculate(
            CPU, got)
        assert score == mod(JAX, "templates.classification").Accuracy() \
            .calculate(ctx_of(JAX), want)
        assert score > 0.9

    @pytest.mark.parametrize("algo", ["naive", "randomforest"])
    def test_batch_predict_matches_single(self, app, algo):
        _, t = train_both("classification", self.variant((algo, {})))
        queries = [(i, t.query({"features": [float(i), 2.0, 5.0]}))
                   for i in range(5)]
        batch = dict(t.algos[0].batch_predict(CPU, t.models[0], queries))
        for qx, q in queries:
            assert batch[qx] == t.algos[0].predict(t.models[0], q)


# ---------------------------------------------------------------------------
# similarproduct
# ---------------------------------------------------------------------------

def group_views(rng, n_users=12, n_items=8, per_user=6, cats=True):
    events = [ev("$set", "user", f"u{u}") for u in range(n_users)]
    half = n_items // 2
    for i in range(n_items):
        props = {"categories": ["electronics" if i < half else "books"]} \
            if cats else {}
        events.append(ev("$set", "item", f"i{i}", props=props))
    for u in range(n_users):
        lo, hi = (0, half) if u < n_users // 2 else (half, n_items)
        for _ in range(per_user):
            events.append(ev("view", "user", f"u{u}", "item",
                             f"i{rng.integers(lo, hi)}"))
    return events


def als(rank, iters, **kw):
    return {"rank": rank, "numIterations": iters, "seed": 0, **kw}


class TestSimilarProductTemplate:
    @pytest.fixture
    def app(self, both):
        ids = make_app("simapp")
        insert(ids, group_views(np.random.default_rng(1)))
        return ids

    def train(self, rank=4, iters=5, **ds):
        return train_both("similarproduct", variant_of(
            {"appName": "simapp", **ds}, [("als", als(rank, iters))]))

    def test_similar_items_same_group(self, app):
        j, t = self.train(rank=4, iters=20)
        assert_factors_close(t.models[0].product_features,
                             j.models[0].product_features)
        [r] = agree_on((j, t), [{"items": ["i0"], "num": 3}])
        assert r["itemScores"][0]["item"] in {"i1", "i2", "i3"}
        assert "i0" not in {s["item"] for s in r["itemScores"]}

    def test_filters(self, app):
        j, t = self.train()
        assert_factors_close(t.models[0].product_features,
                             j.models[0].product_features)
        books, white, black, unknown = agree_on((j, t), [
            {"items": ["i0"], "num": 8, "categories": ["books"]},
            {"items": ["i0"], "num": 8, "whiteList": ["i1", "i2"]},
            {"items": ["i0"], "num": 8, "blackList": ["i1"]},
            {"items": ["zzz"]}])
        assert all(s["item"] in {"i4", "i5", "i6", "i7"}
                   for s in books["itemScores"])
        assert {s["item"] for s in white["itemScores"]} <= {"i1", "i2"}
        assert "i1" not in {s["item"] for s in black["itemScores"]}
        assert unknown["itemScores"] == []

    def test_multi_variant_like_ensemble(self, app):
        likes = []
        for u in range(6):
            for i in range(3):
                likes.append(ev("like", "user", f"u{u}", "item", f"i{i}"))
            likes.append(ev("dislike", "user", f"u{u}", "item", "i3",
                            t=T0 + dt.timedelta(seconds=1)))
        insert(app, likes)
        j, t = train_both("similarproduct", variant_of(
            {"appName": "simapp", "readLikeEvents": True},
            [("als", als(4, 5)), ("likealgo", als(2, 5))]),
            "engine_factory_multi")
        assert len(t.models) == 2
        for jm, tm in zip(j.models, t.models):
            assert_factors_close(tm.product_features, jm.product_features)
        assert t.engine.serving_class_map[""].__name__ == "MultiServing"
        [combined] = agree_on((j, t), [{"items": ["i0"], "num": 4}])
        items = {s["item"] for s in combined["itemScores"]}
        assert items and "i0" not in items
        assert items <= {f"i{i}" for i in range(8)}

    def test_like_flip_uses_latest(self, app):
        evs = [ev("like", "user", f"u{u}", "item", f"i{i}")
               for u in range(6) for i in range(4)]
        evs.append(ev("dislike", "user", "u0", "item", "i0",
                      t=T0 + dt.timedelta(hours=1)))
        insert(app, evs)
        out = []
        for pkg in PKGS:
            sp = mod(pkg, "templates.similarproduct")
            ds = sp.EventDataSource(sp.DataSourceParams(
                app_name="simapp", read_like_events=True))
            td = ds.read_training_base(ctx_of(pkg))
            algo = sp.LikeAlgorithm(sp.ALSAlgorithmParams(
                rank=4, num_iterations=3, seed=0))
            out.append(algo.train(ctx_of(pkg), td).product_features)
        assert np.isfinite(out[1]).all()
        assert_factors_close(out[1], out[0])

    def test_jax_model_carried_by_weights_answers_as_jax(self, app):
        from predictionio_tpu_torch import weights

        j, t = self.train(rank=4, iters=5)
        jm = j.models[0]
        t.models[0] = weights.similar_product_model_from_numpy(
            jm.product_features, jm.item_map.labels, jm.items)
        qs = [{"items": ["i0"], "num": 8, "categories": ["books"]},
              {"items": ["i1", "i5"], "num": 4, "blackList": ["i2"]}]
        assert [t.answer(q) for q in qs] == [j.answer(q) for q in qs]

    def test_view_of_unknown_entity_skipped(self, both):
        ids = make_app("simapp")
        insert(ids, [ev("$set", "user", "u0"), ev("$set", "item", "i0"),
                     ev("view", "user", "u0", "item", "i0"),
                     ev("view", "user", "ghost", "item", "i0")])
        sp = mod(PORT, "templates.similarproduct")
        td = sp.EventDataSource(sp.DataSourceParams(app_name="simapp")) \
            .read_training_base(CPU)
        assert len(td.view_events) == 2


class TestDIMSUMVariant:
    @pytest.fixture
    def app(self, both):
        insert(make_app("simapp"), group_views(np.random.default_rng(6)))

    def train(self, threshold=0.0):
        return train_both("similarproduct", variant_of(
            {"appName": "simapp"}, [("dimsum", {"threshold": threshold})]),
            "engine_factory_dimsum")

    def test_exact_cosine_vs_numpy_oracle_and_jax(self, app):
        j, t = self.train()
        model = t.models[0]
        assert type(model).__name__ == "DIMSUMModel"
        aid = tstorage.get_metadata_apps().get_by_name("simapp").id
        pairs = {(e.entity_id, e.target_entity_id)
                 for e in tstorage.get_levents().find(
                     app_id=aid, event_names=["view"])}
        users = sorted({u for u, _ in pairs})
        A = np.zeros((len(users), 8), dtype=np.float64)
        uix = {u: i for i, u in enumerate(users)}
        for u, i in pairs:
            A[uix[u], model.item_map[i]] = 1.0
        An = A / np.maximum(np.linalg.norm(A, axis=0), 1e-12)
        S = An.T @ An
        np.fill_diagonal(S, 0.0)
        np.testing.assert_allclose(model.similarities, S, atol=1e-5)
        np.testing.assert_allclose(model.similarities,
                                   j.models[0].similarities, atol=1e-6)

    def test_similar_items_same_group(self, app):
        j, t = self.train()
        r, rb = agree_on((j, t), [
            {"items": ["i0"], "num": 3},
            {"items": ["i0"], "num": 8, "categories": ["books"]}])
        assert r["itemScores"][0]["item"] in {"i1", "i2", "i3"}
        assert "i0" not in {s["item"] for s in r["itemScores"]}
        assert all(s["item"] in {"i4", "i5", "i6", "i7"}
                   for s in rb["itemScores"])

    def test_jax_model_carried_by_weights_answers_as_jax(self, app):
        from predictionio_tpu_torch import weights

        j, t = self.train()
        jm = j.models[0]
        t.models[0] = weights.dimsum_model_from_numpy(
            jm.similarities, jm.item_map.labels, jm.items)
        qs = [{"items": ["i0"], "num": 8}, {"items": ["i6"], "num": 3,
                                            "categories": ["electronics"]}]
        assert [t.answer(q) for q in qs] == [j.answer(q) for q in qs]

    def test_threshold_cuts_similarities(self, app):
        _, t = self.train(threshold=0.9)
        nz = t.models[0].similarities[t.models[0].similarities > 0]
        assert (nz >= 0.9).all()


class TestFilterByYearVariant:
    @pytest.fixture
    def app(self, both):
        ids = make_app("simapp")
        rng = np.random.default_rng(2)
        events = [ev("$set", "user", f"u{u}") for u in range(10)]
        events += [ev("$set", "item", f"i{i}", props={
            "categories": ["film"], "year": 1990 + i * 5}) for i in range(8)]
        events += [ev("view", "user", f"u{u}", "item",
                      f"i{rng.integers(0, 8)}")
                   for u in range(10) for _ in range(8)]
        insert(ids, events)
        return ids

    def train(self):
        return train_both("similarproduct", variant_of(
            {"appName": "simapp"}, [("als", als(4, 5))]))

    def test_year_floor_filters_results(self, app):
        j, t = self.train()
        floor, everything = agree_on((j, t), [
            {"items": ["i0"], "num": 8, "recommendFromYear": 2005},
            {"items": ["i0"], "num": 8}])
        assert floor["itemScores"]
        assert {s["item"] for s in floor["itemScores"]} <= \
            {"i4", "i5", "i6", "i7"}
        assert all(s["year"] > 2005 for s in floor["itemScores"])
        assert set(floor["itemScores"][0]) == {"item", "score", "year"}
        assert len(everything["itemScores"]) > len(floor["itemScores"])
        assert set(everything["itemScores"][0]) == {"item", "score"}

    def test_item_without_year_excluded_under_floor(self, app):
        insert(app, [ev("$set", "item", "noyear"),
                     *[ev("view", "user", f"u{u}", "item", "noyear")
                       for u in range(10)]])
        j, t = self.train()
        r, r_white = agree_on((j, t), [
            {"items": ["i0"], "num": 9, "recommendFromYear": 1900},
            {"items": ["i0"], "num": 9, "whiteList": ["noyear"],
             "recommendFromYear": 1900}])
        assert "noyear" not in {s["item"] for s in r["itemScores"]}
        assert r_white["itemScores"] == []


class TestNoSetUserAndItemPropertiesVariants:
    @pytest.fixture
    def app(self, both):
        ids = make_app("simapp")
        rng = np.random.default_rng(4)
        events = [ev("$set", "item", f"i{i}", props={
            "categories": ["film"], "title": f"Movie {i}",
            "date": f"199{i}-01-01", "imdbUrl": f"http://imdb/{i}"})
            for i in range(6)]
        for u in range(12):
            lo, hi = (0, 3) if u < 6 else (3, 6)
            events += [ev("view", "user", f"u{u}", "item",
                          f"i{rng.integers(lo, hi)}") for _ in range(10)]
        insert(ids, events)

    def test_no_set_user_trains_from_view_events(self, app):
        j, t = train_both("similarproduct", variant_of(
            {"appName": "simapp", "noSetUser": True},
            [("als", als(2, 8))]))
        assert_factors_close(t.models[0].product_features,
                             j.models[0].product_features)
        [r] = agree_on((j, t), [{"items": ["i0"], "num": 2}])
        assert r["itemScores"][0]["item"] in {"i1", "i2"}

    def test_without_flag_no_set_users_fails_sanity(self, app):
        with pytest.raises(AssertionError, match="users"):
            Trained(PORT, "similarproduct", variant_of(
                {"appName": "simapp"}, [("als", als(8, 5))]))

    def test_return_item_properties(self, app):
        j, t = train_both("similarproduct", variant_of(
            {"appName": "simapp", "noSetUser": True,
             "readItemProperties": True},
            [("als", als(4, 5, returnItemProperties=True))]))
        [r] = agree_on((j, t), [{"items": ["i0"], "num": 2}])
        top = r["itemScores"][0]
        assert set(top) == {"item", "title", "date", "imdbUrl", "score"}
        n = top["item"][1:]
        assert top["title"] == f"Movie {n}"
        assert top["imdbUrl"] == f"http://imdb/{n}"
        assert type(t.predict({"items": ["i0"], "num": 2})
                    .item_scores[0]).__name__ == "RichItemScore"

    def test_return_without_read_flag_refused(self, app):
        with pytest.raises(ValueError, match="read_item_properties"):
            Trained(PORT, "similarproduct", variant_of(
                {"appName": "simapp", "noSetUser": True},
                [("als", als(4, 2, returnItemProperties=True))]))


class TestRecommendedUserVariant:
    @pytest.fixture
    def app(self, both):
        ids = make_app("followapp")
        rng = np.random.default_rng(3)
        events = [ev("$set", "user", f"u{u}") for u in range(12)]
        for u in range(12):
            lo, hi = (0, 6) if u < 6 else (6, 12)
            for _ in range(6):
                v = int(rng.integers(lo, hi))
                if v != u:
                    events.append(ev("follow", "user", f"u{u}", "user",
                                     f"u{v}"))
        insert(ids, events)

    def train(self):
        return train_both("similarproduct", variant_of(
            {"appName": "followapp"}, [("als", als(4, 5))]),
            "engine_factory_recommended_user")

    def test_recommends_same_community(self, app):
        j, t = self.train()
        assert_factors_close(t.models[0].similar_user_features,
                             j.models[0].similar_user_features)
        [r] = agree_on((j, t), [{"users": ["u1"], "num": 3}])
        top = r["similarUserScores"][0]
        assert top["user"] in {f"u{i}" for i in range(6)} - {"u1"}
        assert "u1" not in {s["user"] for s in r["similarUserScores"]}

    def test_white_and_black_lists(self, app):
        j, t = self.train()
        white, black, unknown = agree_on((j, t), [
            {"users": ["u1"], "num": 8, "whiteList": ["u2", "u3"]},
            {"users": ["u1"], "num": 8, "blackList": ["u2"]},
            {"users": ["zzz"]}])
        assert {s["user"] for s in white["similarUserScores"]} <= \
            {"u2", "u3"}
        assert "u2" not in {s["user"] for s in black["similarUserScores"]}
        assert unknown["similarUserScores"] == []

    def test_jax_model_carried_by_weights_answers_as_jax(self, app):
        from predictionio_tpu_torch import weights

        j, t = self.train()
        jm = j.models[0]
        t.models[0] = weights.recommended_user_model_from_numpy(
            jm.similar_user_features, jm.user_map.labels)
        qs = [{"users": ["u1", "u7"], "num": 5}, {"users": ["u3"]}]
        assert [t.answer(q) for q in qs] == [j.answer(q) for q in qs]

    def test_follow_of_unset_user_skipped(self, both):
        ids = make_app("followapp")
        insert(ids, [ev("$set", "user", "u0"), ev("$set", "user", "u1"),
                     ev("$set", "user", "u2"),
                     ev("follow", "user", "u0", "user", "u1"),
                     ev("follow", "user", "u2", "user", "u1"),
                     ev("follow", "user", "u0", "user", "ghost")])
        j, t = self.train()
        [r] = agree_on((j, t), [{"users": ["u0"], "num": 5}])
        assert "ghost" not in {s["user"] for s in r["similarUserScores"]}


# ---------------------------------------------------------------------------
# helloworld
# ---------------------------------------------------------------------------

def post(addr, body, path="/queries.json"):
    host, port = addr
    conn = http.client.HTTPConnection(host, port, timeout=30)
    conn.request("POST", path, body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read().decode("utf-8"))
    conn.close()
    return resp.status, data


def train_instance(template, variant, factory="engine_factory"):
    """``run_train`` on the port: the stored instance's id."""
    from predictionio_tpu_torch.workflow import core_workflow
    from predictionio_tpu_torch.workflow.create_workflow import (
        WorkflowConfig,
        new_engine_instance,
    )

    name = f"{PORT}.templates.{template}:{factory}"
    engine = core_workflow.load_engine_factory(name)()
    params = engine.engine_params_from_variant(variant)
    iid = core_workflow.run_train(
        engine, params, new_engine_instance(
            WorkflowConfig(engine_factory=name), params), ctx=CPU)
    assert iid is not None
    return iid


class TestHelloWorldTemplate:
    @pytest.fixture
    def data_file(self, tmp_path):
        f = tmp_path / "data.csv"
        f.write_text("Mon,75\nTue,80\nWed,70\nThu,65\nFri,60\n"
                     "Mon,70\nTue,70\n")
        return str(f)

    def test_train_and_predict(self, both, data_file):
        j, t = train_both("helloworld", {"datasource": {"params": {
            "dataPath": data_file}}})
        assert t.models[0].temperatures == j.models[0].temperatures
        assert t.predict({"day": "Mon"}).temperature == 72.5
        assert t.predict({"day": "Wed"}).temperature == 70.0
        with pytest.raises(KeyError):
            t.predict({"day": "Sun"})

    def test_full_lifecycle_through_query_server(self, both, data_file):
        from predictionio_tpu_torch.workflow.create_server import (
            QueryServer,
            ServerConfig,
            build_deployment,
            resolve_engine_instance,
        )

        iid = train_instance("helloworld", {"datasource": {"params": {
            "dataPath": data_file}}})
        dep = build_deployment(resolve_engine_instance(iid), CPU)
        srv = QueryServer(ServerConfig(ip="127.0.0.1", port=0), dep).start()
        try:
            assert post(srv.address, {"day": "Tue"}) == \
                (200, {"temperature": 75.0})
            status, _ = post(srv.address, {"day": "Sun"})
            assert status == 500
        finally:
            srv.stop()


# ---------------------------------------------------------------------------
# ecommercerecommendation
# ---------------------------------------------------------------------------

class TestECommerceTemplate:
    @pytest.fixture
    def app(self, both):
        ids = make_app("ecomapp")
        rng = np.random.default_rng(2)
        events = [ev("$set", "user", f"u{u}") for u in range(10)]
        events += [ev("$set", "item", f"i{i}", props={
            "categories": ["phones" if i < 4 else "laptops"]})
            for i in range(8)]
        for u in range(10):
            lo, hi = (0, 4) if u < 5 else (4, 8)
            events += [ev("view", "user", f"u{u}", "item",
                          f"i{rng.integers(lo, hi)}") for _ in range(5)]
            events.append(ev("buy", "user", f"u{u}", "item", f"i{lo}"))
        insert(ids, events)
        return ids

    def train(self, rank=4, **kw):
        pair = train_both("ecommercerecommendation", variant_of(
            {"appName": "ecomapp"}, [("als", {
                "appName": "ecomapp", "rank": rank, "numIterations": 10,
                "seed": 0, **kw})]))
        j, t = pair
        assert_factors_close(t.models[0].user_features,
                             j.models[0].user_features)
        assert_factors_close(t.models[0].product_features,
                             j.models[0].product_features)
        return pair

    def test_recommends_own_group(self, app):
        pair = self.train()
        [r] = agree_on(pair, [{"user": "u1", "num": 3}])
        assert r["itemScores"]
        assert {s["item"] for s in r["itemScores"]} <= \
            {f"i{i}" for i in range(4)}

    def test_unavailable_items_filtered_live(self, app):
        pair = self.train()
        [before] = agree_on(pair, [{"user": "u1", "num": 8}])
        top_before = sorted({s["item"] for s in before["itemScores"]})
        assert top_before
        insert(app, [ev("$set", "constraint", "unavailableItems",
                        props={"items": top_before})])
        [after] = agree_on(pair, [{"user": "u1", "num": 8}])
        assert not {s["item"] for s in after["itemScores"]} & \
            set(top_before)

    def test_weighted_items(self, app):
        pair = self.train()
        [base] = agree_on(pair, [{"user": "u0", "num": 8}])
        boost = next(s["item"] for s in base["itemScores"][1:]
                     if s["score"] > 0)
        insert(app, [ev("$set", "constraint", "weightedItems", props={
            "weights": [{"items": [boost], "weight": 1000.0}]})])
        [boosted] = agree_on(pair, [{"user": "u0", "num": 8}])
        assert boosted["itemScores"][0]["item"] == boost
        insert(app, [ev("$set", "constraint", "weightedItems",
                        props={"weights": []},
                        t=T0 + dt.timedelta(seconds=5))])
        [restored] = agree_on(pair, [{"user": "u0", "num": 8}])
        assert restored["itemScores"][0]["item"] == \
            base["itemScores"][0]["item"]

    def test_unseen_only(self, app):
        pair = self.train(unseenOnly=True, seenEvents=["buy", "view"])
        aid = app[PORT]
        seen = {e.target_entity_id for e in tstorage.get_levents().find(
            app_id=aid, entity_type="user", entity_id="u1",
            event_names=["view", "buy"])}
        m = pair[0].models[0]
        scale = np.abs(m.product_features
                       @ m.user_features[m.user_map["u1"]]).max()
        [r] = agree_on(pair, [{"user": "u1", "num": 8}], scale)
        assert not {s["item"] for s in r["itemScores"]} & seen

    def test_unknown_user_recent_view_fallback(self, app):
        pair = self.train(rank=2)
        [empty] = agree_on(pair, [{"user": "stranger"}])
        assert empty["itemScores"] == []
        insert(app, [ev("view", "user", "stranger", "item", "i5")])
        [r] = agree_on(pair, [{"user": "stranger", "num": 3,
                               "blackList": ["i5"]}])
        assert r["itemScores"]
        assert {s["item"] for s in r["itemScores"]} <= {"i4", "i6", "i7"}

    def test_jax_model_carried_by_weights_answers_as_jax(self, app):
        from predictionio_tpu_torch import weights

        j, t = self.train()
        jm = j.models[0]
        t.models[0] = weights.ecomm_model_from_numpy(
            jm.user_features, jm.product_features, jm.user_map.labels,
            jm.item_map.labels, jm.items)
        insert(app, [ev("view", "user", "newbie", "item", "i6")])
        qs = [{"user": "u1", "num": 8, "categories": ["laptops"]},
              {"user": "u8", "num": 3}, {"user": "newbie", "num": 4}]
        assert [t.answer(q) for q in qs] == [j.answer(q) for q in qs]

    def test_category_filter(self, app):
        pair = self.train()
        [r] = agree_on(pair, [{"user": "u1", "num": 8,
                               "categories": ["laptops"]}])
        assert all(s["item"] in {"i4", "i5", "i6", "i7"}
                   for s in r["itemScores"])

    def test_store_failure_degrades_as_jax(self, app, monkeypatch):
        """A failed live read logs and degrades (no seen filter, no
        constraint, no fallback), as the JAX template does."""
        pair = self.train(unseenOnly=True)
        for pkg in PKGS:
            store = mod(pkg, "data.store")

            def broken(*a, **k):
                raise RuntimeError("store down")

            monkeypatch.setattr(store.LEventStore, "find_by_entity",
                                staticmethod(broken))
        [known, stranger] = agree_on(pair, [{"user": "u1", "num": 8},
                                            {"user": "stranger"}])
        assert known["itemScores"] and stranger["itemScores"] == []


# ---------------------------------------------------------------------------
# friendrecommendation and regression (host models: bitwise)
# ---------------------------------------------------------------------------

@pytest.fixture
def kdd_files(tmp_path):
    (tmp_path / "item.txt").write_text(
        "101 cat1 1;2;3\n102 cat2 3;4\n103 cat1 9\n104 cat3\n")
    (tmp_path / "user_key_word.txt").write_text(
        "7 1:0.5;2:0.25;3:0.25\n8 4:1.0\n9 5:0.7;6:0.3\n10\n")
    (tmp_path / "user_action.txt").write_text(
        "7 8 1 2 3\n8 9 1 0 0\n7 999 5 5 5\n9\n")
    return {"itemFilePath": str(tmp_path / "item.txt"),
            "userKeywordFilePath": str(tmp_path / "user_key_word.txt"),
            "userActionFilePath": str(tmp_path / "user_action.txt")}


FRIEND_QUERIES = [{"user": u, "item": i} for u in (7, 8, 9, 10, 12345)
                  for i in (101, 102, 103, 104, 999)]


class TestFriendRecommendation:
    def test_kdd_formats_parsed_as_jax(self, kdd_files):
        tds = []
        for pkg in PKGS:
            fr = mod(pkg, "templates.friendrecommendation")
            ds = fr.FriendRecommendationDataSource(fr.DataSourceParams(
                item_file_path=kdd_files["itemFilePath"],
                user_keyword_file_path=kdd_files["userKeywordFilePath"],
                user_action_file_path=kdd_files["userActionFilePath"]))
            tds.append(ds.read_training_base(ctx_of(pkg)))
        jtd, ttd = tds
        for field in ("user_id_map", "item_id_map", "user_keyword",
                      "item_keyword", "social_action"):
            assert getattr(ttd, field) == getattr(jtd, field), field
        assert ttd.social_action[ttd.user_id_map[7]] == \
            [(ttd.user_id_map[8], 6)]

    def test_keyword_similarity_answers_as_jax(self, kdd_files):
        j, t = train_both("friendrecommendation",
                          {"datasource": {"params": kdd_files}})
        got = [t.answer(q) for q in FRIEND_QUERIES]
        assert got == [j.answer(q) for q in FRIEND_QUERIES]
        assert t.answer({"user": 7, "item": 101}) == \
            {"confidence": 1.0, "acceptance": True}
        assert t.answer({"user": 7, "item": 102}) == \
            {"confidence": 0.25, "acceptance": False}
        kw = mod(PORT, "templates.friendrecommendation.engine")
        assert kw.keyword_similarity({1: 0.5, 2: 0.5},
                                     {2: 2.0, 3: 9.0}) == 1.0

    @pytest.mark.parametrize("seed", [5, None])
    def test_random_baseline_as_jax(self, kdd_files, seed):
        variant = {"datasource": {"params": kdd_files},
                   "algorithms": [{"name": "random",
                                   "params": {"seed": seed}}]}
        j, t = train_both("friendrecommendation", variant,
                          "engine_factory_random")
        if seed is None:
            p = t.predict({"user": 7, "item": 101})
            assert 0.0 <= p.confidence < 1.0
            assert p.acceptance == (p.confidence >= 0.5)
            return
        got = [t.answer(q) for q in FRIEND_QUERIES]
        assert got == [j.answer(q) for q in FRIEND_QUERIES]
        assert got[0] == t.answer(FRIEND_QUERIES[0])


@pytest.fixture
def lr_file(tmp_path):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(80, 3))
    y = X @ np.asarray([2.0, -3.0, 0.5]) + rng.normal(scale=0.01, size=80)
    f = tmp_path / "lr_data.txt"
    f.write_text("\n".join(f"{yi} " + " ".join(str(v) for v in row)
                           for yi, row in zip(y, X)))
    return str(f)


class TestRegression:
    @pytest.mark.parametrize("n,k", [(0, 0), (2, 0), (3, 1)])
    def test_coefficients_bitwise_jax(self, lr_file, n, k):
        j, t = train_both("regression", {
            "datasource": {"params": {"filepath": lr_file}},
            "preparator": {"params": {"n": n, "k": k}}})
        assert np.array_equal(t.models[0], j.models[0])
        np.testing.assert_allclose(t.models[0], [2.0, -3.0, 0.5],
                                   atol=0.02)
        q = {"features": [1.0, 1.0, 2.0]}
        assert t.answer(q) == j.answer(q)

    def test_eval_mse_as_jax(self, lr_file):
        j, t = train_both("regression", {
            "datasource": {"params": {"filepath": lr_file}},
            "preparator": {"params": {"n": 2, "k": 0}}})
        mse = []
        for tr in (j, t):
            results = tr.engine.eval(ctx_of(tr.pkg), tr.params)
            metric = mod(tr.pkg, "templates.regression").MeanSquareError()
            mse.append(metric.calculate(ctx_of(tr.pkg), results))
        assert mse[1] == mse[0] and 0 <= mse[1] < 0.01
        metric = mod(PORT, "templates.regression").MeanSquareError()
        assert metric.compare(0.001, 0.5) > 0
        assert metric.header == "MeanSquareError"


# ---------------------------------------------------------------------------
# every template the port lists: train -> deploy -> query over HTTP
# ---------------------------------------------------------------------------

def _views(app):
    rng = np.random.default_rng(0)
    events = [ev("$set", "user", f"u{u}") for u in range(12)]
    events += [ev("$set", "item", f"i{i}", props={
        "categories": [f"c{i % 2}"], "year": 2000 + i}) for i in range(10)]
    for u in range(12):
        start = int(rng.integers(0, 10))
        for j in range(5):
            events.append(ev("view", "user", f"u{u}", "item",
                             f"i{(start + j) % 10}",
                             t=T0 + dt.timedelta(minutes=j)))
            events.append(ev("follow", "user", f"u{u}", "user",
                             f"u{(u + j + 1) % 12}"))
    events += [ev("buy", "user", f"u{u}", "item", f"i{u % 10}")
               for u in range(12)]
    insert(make_app(app), events)


def _rates(app):
    rng = np.random.default_rng(0)
    insert(make_app(app), [
        ev("rate", "user", f"u{u}", "item", f"i{int(rng.integers(0, 10))}",
           props={"rating": float(rng.integers(3, 6))},
           t=T0 + dt.timedelta(minutes=j))
        for u in range(12) for j in range(5)])


def _plans(app):
    insert(make_app(app), classification_events(np.random.default_rng(0)))


def _docs(app):
    rng = np.random.default_rng(0)
    insert(make_app(app), [
        ev("$set", "doc", f"d{i}", props={
            "text": " ".join(f"{lb}{int(rng.integers(0, 5))}"
                             for _ in range(6)), "label": lb})
        for i, lb in enumerate(["sports", "tech"] * 20)])


def _files(tmp):
    (tmp / "data.csv").write_text("Mon,75\nTue,80\nMon,70\n")
    (tmp / "lr.txt").write_text(
        "".join(f"{1 + 2 * a - b} {a} {b}\n"
                for a in range(4) for b in range(3)))
    (tmp / "item.txt").write_text("100 1 1;2\n101 2 3\n")
    (tmp / "user.txt").write_text("1 1:0.5;2:1.0\n2 3:2.0\n")
    (tmp / "act.txt").write_text("1 2 1 0 0\n")


SEQ = {"rank": 8, "nLayers": 1, "nHeads": 2, "maxSeqLen": 8,
       "numSteps": 5, "batchSize": 8, "nNegatives": 4, "seed": 0}

# template -> (seed, variant minus engineFactory, query, check)
SMOKE = {
    "recommendation": (_rates, {
        "datasource": {"params": {"appName": "smokeapp"}},
        "algorithms": [{"name": "als", "params": als(4, 2)}]},
        {"user": "u1", "num": 3}, "itemScores"),
    "classification": (_plans, {
        "datasource": {"params": {"appName": "smokeapp"}},
        "algorithms": [{"name": "naive", "params": {"lambda": 1.0}}]},
        {"features": [12.0, 3.0, 1.0]}, "label"),
    "similarproduct": (_views, {
        "datasource": {"params": {"appName": "smokeapp"}},
        "algorithms": [{"name": "als", "params": als(4, 2)}]},
        {"items": ["i1"], "num": 3}, "itemScores"),
    "similarproduct-recommended-user": (_views, {
        "datasource": {"params": {"appName": "smokeapp"}},
        "algorithms": [{"name": "als", "params": als(4, 2)}]},
        {"users": ["u1"], "num": 3}, "similarUserScores"),
    "helloworld": (None, {
        "datasource": {"params": {"dataPath": "{tmp}/data.csv"}}},
        {"day": "Mon"}, "temperature"),
    "friendrecommendation": (None, {
        "datasource": {"params": {
            "itemFilePath": "{tmp}/item.txt",
            "userKeywordFilePath": "{tmp}/user.txt",
            "userActionFilePath": "{tmp}/act.txt"}}},
        {"user": 1, "item": 100}, "acceptance"),
    "similarproduct-dimsum": (_views, {
        "datasource": {"params": {"appName": "smokeapp"}},
        "algorithms": [{"name": "dimsum", "params": {"threshold": 0.0}}]},
        {"items": ["i1"], "num": 3}, "itemScores"),
    "regression": (None, {
        "datasource": {"params": {"filepath": "{tmp}/lr.txt"}},
        "preparator": {"params": {"n": 0, "k": 0}}},
        {"features": [1.0, 2.0]}, None),
    "ecommercerecommendation": (_views, {
        "datasource": {"params": {"appName": "smokeapp"}},
        "algorithms": [{"name": "als", "params": {
            "appName": "smokeapp", **als(4, 2)}}]},
        {"user": "u1", "num": 3}, "itemScores"),
    "sequentialrec": (_views, {
        "datasource": {"params": {"appName": "smokeapp"}},
        "preparator": {"params": {"maxSeqLen": 8}},
        "algorithms": [{"name": "seqrec", "params": SEQ}]},
        {"user": "u1", "num": 3}, "itemScores"),
    "twostage": (_views, {
        "datasource": {"params": {"appName": "smokeapp"}},
        "preparator": {"params": {"maxSeqLen": 8}},
        "algorithms": [{"name": "als", "params": als(4, 2)},
                       {"name": "seqrec", "params": SEQ}]},
        {"user": "u1", "num": 3}, "itemScores"),
    "textclassification": (_docs, {
        "datasource": {"params": {"appName": "smokeapp"}},
        "preparator": {"params": {"vocabSize": 64, "maxTokens": 8}},
        "algorithms": [{"name": "lr", "params": {
            "embeddingDim": 8, "epochs": 2, "seed": 0}}]},
        {"text": "sports1 sports2"}, "label"),
}


def _fill_paths(obj, tmp):
    if isinstance(obj, dict):
        return {k: _fill_paths(v, tmp) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_fill_paths(v, tmp) for v in obj]
    if isinstance(obj, str):
        return obj.replace("{tmp}", str(tmp))
    return obj


class TestCrossTemplateEngineSmoke:
    def test_every_listed_template_has_a_case(self):
        from predictionio_tpu.tools.template_commands import (
            BUILTIN_TEMPLATES as JAX_TEMPLATES,
        )
        from predictionio_tpu_torch.tools.template_commands import (
            BUILTIN_TEMPLATES,
        )

        assert list(BUILTIN_TEMPLATES) == list(JAX_TEMPLATES)
        assert sorted(SMOKE) == sorted(BUILTIN_TEMPLATES)

    @pytest.mark.parametrize("template", sorted(SMOKE))
    def test_train_deploy_query(self, template, both, tmp_path):
        from predictionio_tpu_torch.tools.template_commands import (
            BUILTIN_TEMPLATES,
        )
        from predictionio_tpu_torch.workflow import core_workflow
        from predictionio_tpu_torch.workflow.create_server import (
            QueryServer,
            ServerConfig,
            build_deployment,
            query_from_json,
            resolve_engine_instance,
            serve_query,
            to_jsonable,
        )
        from predictionio_tpu_torch.workflow.create_workflow import (
            WorkflowConfig,
            new_engine_instance,
        )

        seed, variant, query, key = SMOKE[template]
        factory = BUILTIN_TEMPLATES[template]["engineFactory"]
        assert factory.startswith(f"{PORT}.templates.")
        _files(tmp_path)
        if seed is not None:
            seed("smokeapp")
        variant = _fill_paths(variant, tmp_path)
        engine = core_workflow.load_engine_factory(factory)()
        params = engine.engine_params_from_variant(variant)
        iid = core_workflow.run_train(
            engine, params, new_engine_instance(
                WorkflowConfig(engine_factory=factory), params), ctx=CPU)
        dep = build_deployment(resolve_engine_instance(iid), CPU)
        want = to_jsonable(serve_query(dep, query_from_json(
            query, dep.algorithms[0].query_class)))
        if key is not None:
            assert want[key] not in ([], None)
        srv = QueryServer(ServerConfig(ip="127.0.0.1", port=0), dep).start()
        try:
            assert post(srv.address, query) == (200, want)
            if key == "itemScores":
                scores = [s["score"] for s in want[key]]
                assert scores == sorted(scores, reverse=True)
        finally:
            srv.stop()
