"""The textclassification template on the port against the JAX package,
on the CPU (mirrors ``tests/test_textclassification.py``).

- Tokenizing, hashing, encoding and the preparator's tables are bitwise
  the JAX package's; so is the naive-Bayes model.
- The embedding + LR trainer: ``jax.random`` cannot be matched, so the
  JAX package's own draws (its initial ``E``, ``W``, ``b`` and each
  epoch's permutation, replayed from its key splits) are injected into
  the port's trainer. After 3 epochs on a 300-document corpus, ``E``,
  ``W`` and ``b`` are within 1e-4 of each tensor's largest entry of the
  JAX trainer's, and the held-out labels are equal.
- End to end through the DASE engine on a memory store: the LR and NB
  algorithms classify held-out documents, the model pickles, the k-fold
  evaluation scores, ``pio eval``'s grid writes ``best.json``, and a
  JAX-trained model carried by ``weights`` answers as the JAX one.
"""

import datetime as dt
import json
import pickle

import numpy as np
import pytest

from predictionio_tpu.templates import textclassification as jtc
from predictionio_tpu.templates.textclassification import engine as jeng
from predictionio_tpu_torch.core.context import ComputeContext
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.templates import textclassification as ttc
from predictionio_tpu_torch.templates.textclassification import (
    engine as teng,
)

from test_torch_lifecycle import configure

CPU = ComputeContext(device="cpu")
UTC = dt.timezone.utc
LR_TOL = 1e-4   # of each tensor's largest entry


def corpus(n_per_class=60, seed=0, lib=ttc):
    """Separable synthetic corpus: per-class signature vocabulary plus
    shared noise words (the JAX test's)."""
    rng = np.random.default_rng(seed)
    vocab = {label: [f"{label[:5]}{i}" for i in range(25)]
             for label in ("sports", "tech", "food")}
    noise = [f"the{i}" for i in range(15)]
    docs = []
    for label, words in vocab.items():
        for _ in range(n_per_class):
            toks = list(rng.choice(words, size=int(rng.integers(4, 10)))) \
                + list(rng.choice(noise, size=int(rng.integers(2, 6))))
            rng.shuffle(toks)
            docs.append(lib.Document(text=" ".join(toks), label=label))
    order = rng.permutation(len(docs))
    return [docs[i] for i in order]


class TestEncoding:
    def test_tokenize_and_hash_as_jax(self):
        text = "Hello, World! it's 2x FUN -- don't stop 42"
        assert ttc.tokenize(text) == jtc.tokenize(text) == \
            ["hello", "world", "it's", "2x", "fun", "don't", "stop", "42"]
        toks = ttc.tokenize(" ".join(d.text for d in corpus(3)))
        for vocab in (2, 128, 4096):
            h = ttc.hash_tokens(toks, vocab)
            assert h.dtype == np.int32
            assert np.array_equal(h, jtc.hash_tokens(toks, vocab))
            assert (h >= 1).all() and (h < vocab).all()

    @pytest.mark.parametrize("vocab,length", [(256, 8), (1024, 32)])
    def test_encode_as_jax(self, vocab, length):
        texts = ["a b c", "", " ".join(f"w{i}" for i in range(99))] + \
            [d.text for d in corpus(4)]
        ids, mask = ttc.encode_texts(texts, vocab, length)
        jids, jmask = jtc.encode_texts(texts, vocab, length)
        assert ids.dtype == jids.dtype and mask.dtype == jmask.dtype
        assert np.array_equal(ids, jids) and np.array_equal(mask, jmask)
        assert mask[1].sum() == 0 and mask[2].sum() == length

    def test_preparator_as_jax(self):
        docs = corpus(n_per_class=4)
        pd = ttc.TextPreparator(ttc.PreparatorParams(
            vocab_size=128, max_tokens=6)).prepare(CPU, ttc.TrainingData(docs))
        jpd = jtc.TextPreparator(jtc.PreparatorParams(
            vocab_size=128, max_tokens=6)).prepare(
                None, jtc.TrainingData(corpus(n_per_class=4, lib=jtc)))
        assert pd.labels == jpd.labels == ("food", "sports", "tech")
        for field in ("token_ids", "mask", "label_codes"):
            assert np.array_equal(getattr(pd, field), getattr(jpd, field))


def prepared(n_per_class=100, vocab=512, length=16, seed=0):
    docs = corpus(n_per_class, seed)
    return ttc.TextPreparator(ttc.PreparatorParams(
        vocab_size=vocab, max_tokens=length)).prepare(
            CPU, ttc.TrainingData(docs))


def jax_draws(vocab, n_classes, n, params):
    """The JAX trainer's own draws, replayed from its key splits: the
    initial ``(E, W, b)`` and each epoch's permutation of the padded
    documents."""
    import jax
    import jax.numpy as jnp

    _, pad, _ = teng.lr_batch_layout(n, params.batch_size)
    D = params.embedding_dim
    key = jax.random.PRNGKey(params.seed)
    k_emb, k_w, k_perm = jax.random.split(key, 3)
    E0 = jax.random.normal(k_emb, (vocab, D), jnp.float32) / np.sqrt(D)
    W0 = jax.random.normal(k_w, (D, n_classes), jnp.float32) * 0.01
    keys = jax.random.split(k_perm, params.epochs)
    perms = np.stack([np.asarray(jax.random.permutation(k, n + pad))
                      for k in keys])
    return ((np.asarray(E0), np.asarray(W0),
             np.zeros(n_classes, np.float32)), perms)


def within(got, want, tol=LR_TOL):
    return np.abs(got - want).max() <= tol * np.abs(want).max()


class TestEmbeddingLRTrainer:
    @pytest.mark.parametrize("kw", [
        dict(embedding_dim=16, epochs=3, batch_size=64, seed=1),
        dict(embedding_dim=8, epochs=3, batch_size=128, seed=4,
             learning_rate=0.3, l2=1e-3)], ids=["pad", "no-momentum-l2"])
    def test_three_epochs_match_jax_from_its_draws(self, kw):
        pd = prepared()
        assert len(pd.label_codes) == 300
        params = ttc.TextLRParams(**kw)
        C = len(pd.labels)
        init, perms = jax_draws(pd.vocab_size, C, 300, params)
        got = teng._train_embedding_lr(
            pd.token_ids, pd.mask, pd.label_codes, C, pd.vocab_size,
            params, device="cpu", init=init, perms=perms)
        want = jeng._train_embedding_lr(
            pd.token_ids, pd.mask, pd.label_codes, C, pd.vocab_size,
            jtc.TextLRParams(**kw))
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and g.shape == w.shape
            assert within(g, w)
        held = corpus(n_per_class=30, seed=9)
        ids, mask = ttc.encode_texts([d.text for d in held],
                                     pd.vocab_size, pd.max_tokens)
        tm = teng.TextLRModel(*got, pd.labels, pd.vocab_size, pd.max_tokens)
        jm = jeng.TextLRModel(*want, pd.labels, pd.vocab_size,
                              pd.max_tokens)
        assert np.array_equal(tm.predict_scores(ids, mask).argmax(axis=1),
                              jm.predict_scores(ids, mask).argmax(axis=1))

    def test_loss_falls_and_defaults_are_seeded(self):
        pd = prepared(n_per_class=20)
        params = ttc.TextLRParams(embedding_dim=8, epochs=5, seed=2)
        losses = []
        a = teng._train_embedding_lr(
            pd.token_ids, pd.mask, pd.label_codes, 3, pd.vocab_size, params,
            device="cpu", losses=losses)
        b = teng._train_embedding_lr(
            pd.token_ids, pd.mask, pd.label_codes, 3, pd.vocab_size, params,
            device="cpu")
        assert len(losses) == 5 and losses[-1] < losses[0]
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
        bs, pad, nb = teng.lr_batch_layout(60, params.batch_size)
        assert (bs, pad, nb) == (60, 0, 1)
        assert teng.lr_permutations(64, params).shape == (5, 64)

    def test_bad_permutations_refused(self):
        pd = prepared(n_per_class=4)
        params = ttc.TextLRParams(embedding_dim=4, epochs=2)
        with pytest.raises(ValueError, match="perms must be"):
            teng._train_embedding_lr(
                pd.token_ids, pd.mask, pd.label_codes, 3, pd.vocab_size,
                params, device="cpu", perms=np.zeros((1, 12), np.int64))


@pytest.fixture
def store(tmp_path):
    configure(tstorage, "memory", tmp_path / "port.db")
    yield
    tstorage.reset()


def insert_docs(app, docs):
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage.base import App

    aid = tstorage.get_metadata_apps().insert(App(0, app))
    le = tstorage.get_levents()
    le.init(aid)
    t0 = dt.datetime(2022, 1, 1, tzinfo=UTC)
    le.insert_batch([Event(event="$set", entity_type="doc",
                           entity_id=f"d{i}",
                           properties={"text": d.text, "label": d.label},
                           event_time=t0) for i, d in enumerate(docs)], aid)


def train_engine(algo_name, algo_params, docs, prep=None):
    insert_docs("textapp", docs)
    engine = ttc.engine_factory()
    params = teng.EngineParams(
        data_source_params=("", ttc.DataSourceParams(app_name="textapp")),
        preparator_params=("", prep or ttc.PreparatorParams(
            vocab_size=1024, max_tokens=32)),
        algorithm_params_list=[(algo_name, algo_params)])
    persistable = engine.train(CPU, params)
    [model] = engine.prepare_deploy(CPU, params, "tx1", persistable)
    return engine, params, engine._algorithms(params)[0], model


def accuracy(algo, model, docs):
    return sum(algo.predict(model, ttc.Query(text=d.text)).label == d.label
               for d in docs) / len(docs)


class TestEndToEnd:
    def test_lr_trains_and_classifies(self, store):
        _, _, algo, model = train_engine("lr", ttc.TextLRParams(
            embedding_dim=16, epochs=25, batch_size=64, seed=1), corpus())
        assert accuracy(algo, model, corpus(n_per_class=15, seed=9)) >= 0.9
        res = algo.predict(model, ttc.Query(text="sport1 sport2 sport3"))
        assert res.label == "sports"
        assert abs(sum(res.scores.values()) - 1.0) < 1e-5

    def test_nb_bitwise_jax_and_classifies(self, store):
        docs = corpus()
        _, _, algo, model = train_engine("nb", ttc.TextNBParams(lambda_=1.0),
                                         docs)
        pd = jtc.TextPreparator(jtc.PreparatorParams(
            vocab_size=1024, max_tokens=32)).prepare(
                None, jtc.TrainingData(
                    [jtc.Document(d.text, d.label) for d in
                     tstorage_docs()]))
        jm = jtc.TextNBAlgorithm(jtc.TextNBParams(lambda_=1.0)).train(None,
                                                                      pd)
        assert np.array_equal(model.pi, jm.pi)
        assert np.array_equal(model.theta, jm.theta)
        assert model.labels == jm.labels
        held = corpus(n_per_class=15, seed=9)
        assert accuracy(algo, model, held) >= 0.9
        queries = [(i, ttc.Query(text=d.text)) for i, d in enumerate(held)]
        assert algo.batch_predict(CPU, model, queries) == \
            [(i, ttc.PredictedResult(label=algo.predict(model, q).label))
             for i, q in queries]

    def test_model_pickles_and_serves(self, store):
        _, _, algo, model = train_engine("lr", ttc.TextLRParams(
            embedding_dim=8, epochs=10, seed=0), corpus(n_per_class=20))
        clone = pickle.loads(pickle.dumps(model))
        q = ttc.Query(text="tech3 tech4 tech5 tech6")
        assert algo.predict(clone, q).label == \
            algo.predict(model, q).label == "tech"

    def test_eval_folds_and_accuracy_metric(self, store):
        insert_docs("evalapp", corpus(n_per_class=20))
        engine = ttc.engine_factory()
        params = teng.EngineParams(
            data_source_params=("", ttc.DataSourceParams(
                app_name="evalapp", eval_k=3)),
            preparator_params=("", ttc.PreparatorParams(vocab_size=512,
                                                        max_tokens=16)),
            algorithm_params_list=[("nb", ttc.TextNBParams())])
        folds = [(info, list(qpas)) for info, qpas in engine.eval(CPU,
                                                                   params)]
        assert len(folds) == 3 and all(qpas for _, qpas in folds)
        assert ttc.Accuracy().calculate(CPU, folds) >= 0.85

    def test_needs_two_labels(self, store):
        docs = [ttc.Document(text="aaa bbb", label="only")] * 5
        with pytest.raises(AssertionError, match="distinct labels"):
            train_engine("nb", ttc.TextNBParams(), docs)

    def test_jax_models_carried_by_weights_answer_as_jax(self):
        from predictionio_tpu_torch import weights

        pd = jtc.TextPreparator(jtc.PreparatorParams(
            vocab_size=256, max_tokens=16)).prepare(
                None, jtc.TrainingData(corpus(20, lib=jtc)))
        jlr = jtc.TextEmbeddingLRAlgorithm(jtc.TextLRParams(
            embedding_dim=8, epochs=3, seed=0))
        jnb = jtc.TextNBAlgorithm(jtc.TextNBParams())
        pairs = []
        for jalgo, talgo, carry in (
                (jlr, ttc.TextEmbeddingLRAlgorithm(ttc.TextLRParams()),
                 lambda m: weights.text_lr_model_from_numpy(
                     m.embeddings, m.w, m.b, m.labels, m.vocab_size,
                     m.max_tokens)),
                (jnb, ttc.TextNBAlgorithm(ttc.TextNBParams()),
                 lambda m: weights.text_nb_model_from_numpy(
                     m.pi, m.theta, m.labels, m.vocab_size, m.max_tokens))):
            jm = jalgo.train(None, pd)
            pairs.append((jalgo, jm, talgo, carry(jm)))
        for jalgo, jm, talgo, tm in pairs:
            for d in corpus(5, seed=3):
                jp = jalgo.predict(jm, jtc.Query(text=d.text))
                tp = talgo.predict(tm, ttc.Query(text=d.text))
                assert tp.label == jp.label
                assert tp.scores == jp.scores


def tstorage_docs():
    """The documents the port's store holds, in its read order."""
    return ttc.EventDataSource(ttc.DataSourceParams(
        app_name="textapp")).read_training(CPU).documents


class TestTuning:
    def test_pio_eval_grid_writes_best(self, store, tmp_path, monkeypatch):
        from predictionio_tpu_torch.data.storage.base import (
            EvaluationInstance,
        )
        from predictionio_tpu_torch.workflow.core_workflow import (
            run_evaluation,
        )

        insert_docs("text-app", corpus(n_per_class=15))
        monkeypatch.chdir(tmp_path)
        ev = ttc.TextEvaluation()
        assert len(ev.engine_params_list) == 4
        now = dt.datetime.now(tz=UTC)
        result = run_evaluation(
            ev.engine, ev.engine_params_list,
            EvaluationInstance(id="", status="INIT", start_time=now,
                               end_time=now),
            ev.evaluator, evaluation=ev, ctx=CPU)
        assert float(result.best_score.score) >= 0.8
        best = json.loads((tmp_path / "best.json").read_text())
        assert best["algorithms"]
