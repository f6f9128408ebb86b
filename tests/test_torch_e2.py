"""The port's ``e2`` library (categorical naive Bayes, Markov chain,
binary vectorizer, k-fold splitting, random forest) against the JAX
package's, on the CPU: the same inputs give bitwise the same models and
answers. Mirrors ``tests/test_e2.py`` and ``tests/test_forest.py``."""

import math
import pickle

import numpy as np
import pytest

from predictionio_tpu import e2 as je2
from predictionio_tpu.e2 import forest as jforest
from predictionio_tpu_torch import e2 as te2
from predictionio_tpu_torch.core.context import ComputeContext
from predictionio_tpu_torch.e2 import forest as tforest

POINTS = [
    ("play", ("sunny", "hot", "weak")),
    ("play", ("overcast", "mild", "strong")),
    ("play", ("rain", "mild", "weak")),
    ("stay", ("rain", "cool", "strong")),
    ("stay", ("sunny", "hot", "strong")),
]
PROBES = [("rain", "mild", "weak"), ("rain", "cool", "strong"),
          ("foggy", "mild", "weak"), ("sunny", "hot", "strong")]


def points(lib, raw=POINTS):
    return [lib.LabeledPoint(label, feats) for label, feats in raw]


def random_points(seed, n=200):
    rng = np.random.default_rng(seed)
    return [(f"l{int(rng.integers(0, 3))}",
             tuple(f"v{int(rng.integers(0, 4))}" for _ in range(4)))
            for _ in range(n)]


class TestCategoricalNaiveBayes:
    @pytest.mark.parametrize("raw", [POINTS, random_points(1),
                                     random_points(2, 40)],
                             ids=["tennis", "random200", "random40"])
    def test_model_bitwise_jax(self, raw):
        tm = te2.CategoricalNaiveBayes.train(points(te2, raw))
        jm = je2.CategoricalNaiveBayes.train(points(je2, raw))
        assert tm.priors == jm.priors
        assert tm.likelihoods == jm.likelihoods
        assert tm.feature_count == jm.feature_count
        probes = [f for _, f in raw[:20]] + PROBES[:2]
        assert [tm.predict(f) for f in probes] == \
            [jm.predict(f) for f in probes]
        assert tm.predict_batch(probes) == jm.predict_batch(probes)

    def test_priors_and_likelihoods(self):
        model = te2.CategoricalNaiveBayes.train(points(te2))
        assert model.priors["play"] == pytest.approx(math.log(3 / 5))
        assert model.likelihoods["play"][0]["sunny"] == pytest.approx(
            math.log(1 / 3))
        assert model.likelihoods["stay"][2]["strong"] == pytest.approx(0.0)

    def test_log_score_as_jax(self):
        tm = te2.CategoricalNaiveBayes.train(points(te2))
        jm = je2.CategoricalNaiveBayes.train(points(je2))
        for label in ("play", "stay", "nope"):
            for f in PROBES:
                assert tm.log_score(te2.LabeledPoint(label, f)) == \
                    jm.log_score(je2.LabeledPoint(label, f))
                assert tm.log_score(
                    te2.LabeledPoint(label, f),
                    default_likelihood=lambda ls: min(ls) - 1.0) == \
                    jm.log_score(je2.LabeledPoint(label, f),
                                 default_likelihood=lambda ls: min(ls) - 1.0)

    def test_predict_batch_matches_single(self):
        model = te2.CategoricalNaiveBayes.train(points(te2))
        feats = [f for _, f in POINTS]
        assert model.predict_batch(feats) == [model.predict(f)
                                              for f in feats]

    def test_empty_raises(self):
        with pytest.raises(ValueError):
            te2.CategoricalNaiveBayes.train([])


class TestMarkovChain:
    @pytest.mark.parametrize("top_n", [1, 2, 3, 6])
    def test_transition_bitwise_jax(self, top_n):
        rng = np.random.default_rng(top_n)
        rows, cols = rng.integers(0, 6, 80), rng.integers(0, 6, 80)
        vals = rng.integers(1, 4, 80).astype(float)
        tm = te2.MarkovChain.train(rows, cols, vals, 6, top_n)
        jm = je2.MarkovChain.train(rows, cols, vals, 6, top_n)
        assert tm.transition.dtype == jm.transition.dtype
        assert np.array_equal(tm.transition, jm.transition)
        state = rng.random(6)
        assert np.array_equal(tm.predict(state), jm.predict(state))

    def test_top_n_truncation_keeps_full_total(self):
        model = te2.MarkovChain.train([0, 0, 0], [0, 1, 2], [5, 3, 2],
                                      n_states=3, top_n=2)
        assert model.transition[0] == pytest.approx([0.5, 0.3, 0.0])


class TestBinaryVectorizer:
    def test_from_maps_as_jax(self):
        maps = [{"color": "red", "size": "L", "junk": "x"},
                {"color": "blue", "size": "L"}]
        tv = te2.BinaryVectorizer.from_maps(maps, ["color", "size"])
        jv = je2.BinaryVectorizer.from_maps(maps, ["color", "size"])
        assert tv.property_map == jv.property_map
        assert str(tv) == str(jv)
        rows = [[("color", "red"), ("size", "L")], [("color", "green")]]
        assert np.array_equal(tv.to_binary_batch(rows),
                              jv.to_binary_batch(rows))

    def test_batch_and_str(self):
        bv = te2.BinaryVectorizer.from_pairs([("a", "1"), ("b", "2")])
        out = bv.to_binary_batch([[("a", "1")], [("b", "2"), ("a", "1")]])
        assert out.tolist() == [[1.0, 0.0], [1.0, 1.0]]
        assert "BinaryVectorizer(2)" in str(bv)


class TestSplitData:
    @pytest.mark.parametrize("k,n", [(3, 10), (1, 4), (5, 3)])
    def test_folds_as_jax(self, k, n):
        data = list(range(n))
        args = (data, "EI", list, lambda d: f"q{d}", lambda d: f"a{d}")
        assert te2.split_data(k, *args) == je2.split_data(k, *args)

    def test_bad_k(self):
        with pytest.raises(ValueError):
            te2.split_data(0, [1], None, list, str, str)


def blobs(n=300, seed=0, centers=((0, 0, 0), (3, 3, 0))):
    rng = np.random.default_rng(seed)
    X = np.vstack([rng.normal(loc=c, scale=0.7, size=(n // len(centers),
                                                      len(c)))
                   for c in centers])
    y = np.repeat(np.arange(len(centers)), n // len(centers))
    return X, y


def assert_forests_equal(tm, jm):
    assert tm.n_classes == jm.n_classes and len(tm.trees) == len(jm.trees)
    for tt, jt in zip(tm.trees, jm.trees):
        for f in ("feature", "threshold", "left", "right", "leaf_class"):
            a, b = getattr(tt, f), getattr(jt, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f


class TestForest:
    @pytest.mark.parametrize("kw", [
        dict(num_trees=10, max_depth=4, seed=1),
        dict(num_trees=7, impurity="entropy", max_depth=6, seed=3,
             feature_subset_strategy="all"),
        dict(num_trees=3, max_depth=2, max_bins=4, seed=5,
             feature_subset_strategy="onethird"),
        dict(num_trees=4, seed=0, feature_subset_strategy="log2")],
        ids=["gini", "entropy-all", "bins4", "log2"])
    def test_trees_bitwise_jax(self, kw):
        X, y = blobs(240, seed=4, centers=((0, 0, 0), (2, 2, 0), (0, 3, 1)))
        tm = tforest.train_classifier(X, y, num_classes=3, **kw)
        jm = jforest.train_classifier(X, y, num_classes=3, **kw)
        assert_forests_equal(tm, jm)
        probe = np.random.default_rng(7).normal(size=(60, 3)) * 3
        assert np.array_equal(tm.predict_batch(probe),
                              jm.predict_batch(probe))

    def test_learns_separable_blobs(self):
        X, y = blobs()
        m = tforest.train_classifier(X, y, num_classes=2, num_trees=10,
                                     max_depth=4, seed=1)
        assert (m.predict_batch(X) == y).mean() > 0.97
        assert m.predict(X[0]) == m.predict_batch(X[:1])[0]

    def test_pure_node_stops(self):
        X = np.asarray([[0.0, 1.0]] * 10)
        m = tforest.train_classifier(X, np.zeros(10, dtype=np.int64),
                                     num_classes=2, num_trees=2, seed=0)
        assert all(len(t.feature) == 1 for t in m.trees)

    @pytest.mark.parametrize("kw,match", [
        (dict(num_classes=2, impurity="variance"), "impurity"),
        (dict(num_classes=2, max_depth=100), "max_depth"),
        (dict(num_classes=2, num_trees=0), "num_trees"),
        (dict(num_classes=2, max_bins=0), "max_bins"),
        (dict(num_classes=2, feature_subset_strategy="sqr"),
         "feature_subset_strategy"),
        (dict(num_classes=1), "labels")])
    def test_validation_errors_as_jax(self, kw, match):
        X, y = blobs(40)
        errors = []
        for lib in (tforest, jforest):
            with pytest.raises(ValueError, match=match) as info:
                lib.train_classifier(X, y, **kw)
            errors.append(str(info.value))
        assert errors[0] == errors[1]

    def test_model_from_numpy_carries_jax_forest(self):
        from predictionio_tpu_torch.weights import (
            random_forest_model_from_numpy,
        )

        X, y = blobs(120, seed=2)
        jm = jforest.train_classifier(X, y, num_classes=2, num_trees=4,
                                      seed=6)
        tm = random_forest_model_from_numpy(jm.trees, jm.n_classes)
        assert_forests_equal(tm, jm)
        tm = pickle.loads(pickle.dumps(tm))
        assert np.array_equal(tm.predict_batch(X), jm.predict_batch(X))

    def test_non_integer_labels_refused_by_template(self):
        from predictionio_tpu_torch.templates.classification.engine import (
            LabeledPoint,
            RandomForestAlgorithm,
            RandomForestParams,
            TrainingData,
        )

        algo = RandomForestAlgorithm(RandomForestParams(num_classes=2))
        td = TrainingData([LabeledPoint(label=1.5, features=(1.0, 2.0)),
                           LabeledPoint(label=0.0, features=(0.0, 1.0))])
        with pytest.raises(ValueError, match="non-integer labels"):
            algo.train(ComputeContext(device="cpu"), td)
