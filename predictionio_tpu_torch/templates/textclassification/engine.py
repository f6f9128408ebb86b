"""Text-classification engine: documents -> label.

The port's copy of ``predictionio_tpu/templates/textclassification/engine.py``.

Net-new template named by ``BASELINE.json`` configs ("experimental
text-classification template (word2vec + LR, device embedding table)") —
absent from the reference snapshot (SURVEY §2.5 note), so the SHAPE
follows the classification templates
(``examples/scala-parallel-classification/``: DataSource requiring
labeled entities, P2L algorithms, LFirst serving, k-fold eval with an
accuracy metric) while the compute path trains on the device:

- ``$set`` events on ``doc`` entities carry ``text`` + ``label``
  properties; the DataSource aggregates them (DataSource.scala:31-65
  pattern).
- The Preparator tokenizes host-side and FEATURE-HASHES tokens into a
  fixed vocabulary (no dictionary to ship), padding each document to a
  static ``[N, L]`` token-id table + mask — the same static-shape
  discipline as the ALS tables.
- ``TextEmbeddingLRAlgorithm`` (P2L) trains an embedding table
  ``[V, D]`` + softmax head END TO END on device: mean of token
  embeddings (the word2vec-style document vector, learned jointly) ->
  logits. Minibatch SGD with momentum under ``torch.autograd`` on the
  context's device (None = cuda); serving is host numpy.
- ``TextNBAlgorithm`` = multinomial Naive Bayes over hashed token
  counts (the MLlib-NB analog, one bincount + log) — the second
  registered algorithm, mirroring the add-algorithm variant slot.
- k-fold ``read_eval`` via e2 ``split_data`` + ``Accuracy``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from predictionio_tpu_torch.controller import (
    Engine,
    EngineParams,
    EngineParamsGenerator,
    Evaluation,
    LFirstServing,
    P2LAlgorithm,
    Params,
    PDataSource,
    PPreparator,
)
from predictionio_tpu_torch.controller.metrics import AverageMetric
from predictionio_tpu_torch.core.context import ComputeContext
from predictionio_tpu_torch.data.store import PEventStore
from predictionio_tpu_torch.e2 import split_data

TEXT_PROP = "text"
LABEL_PROP = "label"

_TOKEN_RE = re.compile(r"[a-z0-9']+")


def tokenize(text: str) -> List[str]:
    """Lowercase word tokens (the host-side text -> tokens step)."""
    return _TOKEN_RE.findall(text.lower())


def hash_tokens(tokens: Sequence[str], vocab_size: int) -> np.ndarray:
    """Feature hashing: token -> stable bucket in [1, vocab_size).
    Bucket 0 is reserved for padding. Stable across processes (md5, not
    Python's salted hash) so models serve correctly after reload."""
    import hashlib

    out = np.empty(len(tokens), dtype=np.int32)
    for i, tok in enumerate(tokens):
        h = int.from_bytes(
            hashlib.md5(tok.encode("utf-8")).digest()[:8], "little")
        out[i] = 1 + h % (vocab_size - 1)
    return out


# -- data types --------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str
    channel_name: Optional[str] = None
    entity_type: str = "doc"
    eval_k: int = 3


@dataclasses.dataclass(frozen=True)
class Document:
    text: str
    label: str


@dataclasses.dataclass
class TrainingData:
    documents: List[Document]

    def sanity_check(self) -> None:
        assert self.documents, (
            "documents in TrainingData cannot be empty. Please check if "
            "DataSource generates TrainingData correctly.")


@dataclasses.dataclass(frozen=True)
class Query:
    text: str = ""


@dataclasses.dataclass(frozen=True)
class PredictedResult:
    label: str
    scores: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class ActualResult:
    label: str


@dataclasses.dataclass(frozen=True)
class EmptyEvalInfo:
    pass


class EventDataSource(PDataSource):
    """Aggregated ``$set`` doc properties -> labeled documents."""

    params_class = DataSourceParams

    def _documents(self) -> List[Document]:
        p: DataSourceParams = self.params
        props = PEventStore.aggregate_properties(
            app_name=p.app_name,
            channel_name=p.channel_name,
            entity_type=p.entity_type,
            required=[TEXT_PROP, LABEL_PROP],
        )
        return [Document(text=pm.get(TEXT_PROP, str),
                         label=str(pm.get(LABEL_PROP, str)))
                for pm in props.values()]

    def read_training(self, ctx: ComputeContext) -> TrainingData:
        return TrainingData(self._documents())

    def read_eval(self, ctx: ComputeContext):
        p: DataSourceParams = self.params
        return split_data(
            p.eval_k,
            self._documents(),
            EmptyEvalInfo(),
            TrainingData,
            lambda d: Query(text=d.text),
            lambda d: ActualResult(label=d.label),
        )


@dataclasses.dataclass(frozen=True)
class PreparatorParams(Params):
    """``vocab_size`` hashed-token buckets (bucket 0 = padding);
    ``max_tokens`` pads/truncates every document to one static length —
    the [N, L] static-shape table the device programs need."""

    vocab_size: int = 4096
    max_tokens: int = 64


@dataclasses.dataclass
class PreparedDocs:
    """Static-shape token table + the label dictionary."""

    token_ids: np.ndarray     # int32 [N, L], 0 = padding
    mask: np.ndarray          # float32 [N, L]
    label_codes: np.ndarray   # int64 [N]
    labels: Tuple[str, ...]   # code -> label string
    vocab_size: int
    max_tokens: int

    def sanity_check(self) -> None:
        assert len(self.labels) >= 2, (
            "need at least 2 distinct labels to classify; got "
            f"{list(self.labels)}")


def encode_texts(texts: Sequence[str], vocab_size: int,
                 max_tokens: int) -> Tuple[np.ndarray, np.ndarray]:
    """Texts -> ([N, L] hashed token ids, [N, L] mask)."""
    n = len(texts)
    ids = np.zeros((n, max_tokens), dtype=np.int32)
    mask = np.zeros((n, max_tokens), dtype=np.float32)
    for i, text in enumerate(texts):
        toks = tokenize(text)[:max_tokens]
        if toks:
            h = hash_tokens(toks, vocab_size)
            ids[i, :len(h)] = h
            mask[i, :len(h)] = 1.0
    return ids, mask


class TextPreparator(PPreparator):
    params_class = PreparatorParams

    def prepare(self, ctx: ComputeContext, td: TrainingData) -> PreparedDocs:
        p: PreparatorParams = self.params
        labels = tuple(sorted({d.label for d in td.documents}))
        code_of = {lb: i for i, lb in enumerate(labels)}
        ids, mask = encode_texts([d.text for d in td.documents],
                                 p.vocab_size, p.max_tokens)
        codes = np.asarray([code_of[d.label] for d in td.documents],
                           dtype=np.int64)
        return PreparedDocs(ids, mask, codes, labels,
                            p.vocab_size, p.max_tokens)


# -- embedding + LR algorithm (the device path) ------------------------------

@dataclasses.dataclass(frozen=True)
class TextLRParams(Params):
    """Embedding dim, SGD schedule, L2. ``batch_size`` is a static
    shape: the document count pads up to a batch multiple."""

    embedding_dim: int = 64
    epochs: int = 30
    batch_size: int = 128
    learning_rate: float = 0.5
    momentum: float = 0.9
    l2: float = 1e-4
    seed: int = 0


@dataclasses.dataclass
class TextLRModel:
    """Embedding table + softmax head, served host-side (tiny matmuls)."""

    embeddings: np.ndarray   # [V, D]
    w: np.ndarray            # [D, C]
    b: np.ndarray            # [C]
    labels: Tuple[str, ...]
    vocab_size: int
    max_tokens: int

    def predict_scores(self, ids: np.ndarray,
                       mask: np.ndarray) -> np.ndarray:
        """[N, L] -> [N, C] logits."""
        emb = self.embeddings[ids]                     # [N, L, D]
        denom = np.maximum(mask.sum(axis=1, keepdims=True), 1.0)
        doc = (emb * mask[..., None]).sum(axis=1) / denom
        return doc @ self.w + self.b

    def sanity_check(self) -> None:
        assert np.isfinite(self.embeddings).all()
        assert np.isfinite(self.w).all() and np.isfinite(self.b).all()


def lr_batch_layout(n: int, batch_size: int) -> Tuple[int, int, int]:
    """``(batch, pad, batches)`` of an epoch over ``n`` documents: the
    batch is ``min(batch_size, max(8, n))``, and the documents pad up to
    a batch multiple with weight-0 rows."""
    bs = min(batch_size, max(8, n))
    pad = (-n) % bs
    return bs, pad, (n + pad) // bs


def lr_init(vocab: int, n_classes: int, params: "TextLRParams"
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The initial ``(E [V, D], W [D, C], b [C])``: ``E`` normal over
    ``sqrt(D)``, ``W`` normal times 0.01, ``b`` zero, drawn on the host
    from a ``torch.Generator`` seeded with ``params.seed`` (the JAX
    package draws the same laws from ``jax.random``)."""
    import torch

    g = torch.Generator().manual_seed(int(params.seed))
    D = params.embedding_dim
    E = torch.randn((vocab, D), generator=g) / np.sqrt(D)
    W = torch.randn((D, n_classes), generator=g) * 0.01
    return (E.numpy(), W.numpy(), np.zeros(n_classes, dtype=np.float32))


def lr_permutations(n_padded: int, params: "TextLRParams") -> np.ndarray:
    """``[epochs, n_padded]``: each epoch's order of the padded
    documents, from a ``torch.Generator`` seeded with ``params.seed +
    1``."""
    import torch

    g = torch.Generator().manual_seed(int(params.seed) + 1)
    return np.stack([torch.randperm(n_padded, generator=g).numpy()
                     for _ in range(int(params.epochs))]) \
        if params.epochs > 0 else np.zeros((0, n_padded), dtype=np.int64)


def _train_embedding_lr(ids, mask, codes, n_classes: int, vocab: int,
                        params: "TextLRParams", device=None,
                        init=None, perms=None, losses=None):
    """Minibatch SGD with momentum and L2 over every epoch, with
    ``torch.autograd`` on ``device`` (None = cuda): gather -> masked
    mean -> ``[D, C]`` head -> log-softmax cross-entropy, the padding
    documents weighted 0. ``init`` (``(E, W, b)``) and ``perms``
    (``[epochs, n_padded]``) default to :func:`lr_init` and
    :func:`lr_permutations`; a caller may pass others (the JAX
    package's draws, or one set shared by two devices). ``losses``, a
    list, gains each epoch's mean batch loss. Returns host fp32
    ``(E, W, b)``."""
    import torch

    from predictionio_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    n = ids.shape[0]
    bs, pad, nb = lr_batch_layout(n, params.batch_size)
    if pad:
        ids = np.concatenate([ids, np.zeros((pad, ids.shape[1]),
                                            ids.dtype)])
        mask = np.concatenate([mask, np.zeros((pad, mask.shape[1]),
                                              mask.dtype)])
        codes = np.concatenate([codes, np.zeros(pad, codes.dtype)])
    weight = np.concatenate([np.ones(n, np.float32),
                             np.zeros(pad, np.float32)])
    if init is None:
        init = lr_init(vocab, n_classes, params)
    if perms is None:
        perms = lr_permutations(n + pad, params)
    perms = np.asarray(perms, dtype=np.int64)
    if perms.shape != (params.epochs, n + pad):
        raise ValueError(f"perms must be [{params.epochs}, {n + pad}]; "
                         f"got {list(perms.shape)}")

    def put(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    f32 = torch.float32
    ids_d, mask_d = put(ids, torch.int64), put(mask, f32)
    codes_d, weight_d = put(codes, torch.int64), put(weight, f32)
    perms_d = put(perms, torch.int64)
    theta = [put(t, f32) for t in init]
    vel = [torch.zeros_like(t) for t in theta]
    lr, mom, l2 = params.learning_rate, params.momentum, params.l2

    def loss_fn(E, W, b, bi, bm, bc, bw):
        emb = E[bi]                                     # [B, L, D]
        denom = torch.clamp(bm.sum(dim=1, keepdim=True), min=1.0)
        doc = (emb * bm[..., None]).sum(dim=1) / denom
        logp = torch.log_softmax(doc @ W + b, dim=1)
        nll = -logp.gather(1, bc[:, None])[:, 0]
        reg = l2 * ((W * W).sum() + (E * E).sum() / E.shape[0])
        return (nll * bw).sum() / torch.clamp(bw.sum(), min=1.0) + reg

    for e in range(int(params.epochs)):
        total = torch.zeros((), dtype=f32, device=dev)
        for i in range(nb):
            sel = perms_d[e, i * bs:(i + 1) * bs]
            leaves = [t.detach().requires_grad_(True) for t in theta]
            loss = loss_fn(*leaves, ids_d[sel], mask_d[sel], codes_d[sel],
                           weight_d[sel])
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                vel = [mom * v - lr * g for v, g in zip(vel, grads)]
                theta = [t + v for t, v in zip(theta, vel)]
                total += loss.detach()
        if losses is not None:
            losses.append(float(total) / nb)
    return tuple(t.detach().cpu().numpy() for t in theta)


class TextEmbeddingLRAlgorithm(P2LAlgorithm):
    """The flagship path: embedding table + LR head trained end to end
    on the context's device, served from host numpy."""

    params_class = TextLRParams
    query_cls = Query

    def train(self, ctx: ComputeContext, pd: PreparedDocs) -> TextLRModel:
        p: TextLRParams = self.params
        E, W, b = _train_embedding_lr(
            pd.token_ids, pd.mask, pd.label_codes,
            n_classes=len(pd.labels), vocab=pd.vocab_size, params=p,
            device=getattr(ctx, "device", None))
        return TextLRModel(E, W, b, pd.labels, pd.vocab_size,
                           pd.max_tokens)

    def _encode(self, model: TextLRModel, texts: Sequence[str]):
        return encode_texts(texts, model.vocab_size, model.max_tokens)

    def predict(self, model: TextLRModel, query: Query) -> PredictedResult:
        ids, mask = self._encode(model, [query.text])
        logits = model.predict_scores(ids, mask)[0]
        exp = np.exp(logits - logits.max())
        probs = exp / exp.sum()
        return PredictedResult(
            label=model.labels[int(np.argmax(logits))],
            scores={lb: float(pr) for lb, pr in zip(model.labels, probs)})

    def batch_predict(self, ctx: ComputeContext, model: TextLRModel,
                      indexed_queries: Sequence[Tuple[int, Query]]):
        if not indexed_queries:
            return []
        ids, mask = self._encode(model,
                                 [q.text for _, q in indexed_queries])
        best = np.argmax(model.predict_scores(ids, mask), axis=1)
        return [(qx, PredictedResult(label=model.labels[int(bi)]))
                for (qx, _), bi in zip(indexed_queries, best)]


# -- NB over token counts (the MLlib-NB analog) ------------------------------

@dataclasses.dataclass(frozen=True)
class TextNBParams(Params):
    lambda_: float = 1.0


@dataclasses.dataclass
class TextNBModel:
    pi: np.ndarray       # [C]
    theta: np.ndarray    # [C, V]
    labels: Tuple[str, ...]
    vocab_size: int
    max_tokens: int

    def predict_scores(self, ids: np.ndarray,
                       mask: np.ndarray) -> np.ndarray:
        counts = _token_counts(ids, mask, self.theta.shape[1])
        return self.pi + counts @ self.theta.T

    def sanity_check(self) -> None:
        assert np.isfinite(self.pi).all() and np.isfinite(self.theta).all()


def _token_counts(ids: np.ndarray, mask: np.ndarray,
                  vocab: int) -> np.ndarray:
    """[N, L] token ids -> [N, V] counts (bucket 0/padding excluded)."""
    n = ids.shape[0]
    counts = np.zeros((n, vocab), dtype=np.float64)
    rows = np.repeat(np.arange(n), ids.shape[1])
    flat = ids.reshape(-1)
    keep = mask.reshape(-1) > 0
    np.add.at(counts, (rows[keep], flat[keep]), 1.0)
    counts[:, 0] = 0.0
    return counts


class TextNBAlgorithm(P2LAlgorithm):
    """Multinomial NB over hashed token counts — same math as the
    classification template's NaiveBayesAlgorithm, vocabulary-sized."""

    params_class = TextNBParams
    query_cls = Query

    def train(self, ctx: ComputeContext, pd: PreparedDocs) -> TextNBModel:
        lam = self.params.lambda_
        C, V = len(pd.labels), pd.vocab_size
        counts = _token_counts(pd.token_ids, pd.mask, V)
        n_c = np.bincount(pd.label_codes, minlength=C).astype(np.float64)
        pi = np.log(n_c + lam) - np.log(len(pd.label_codes) + C * lam)
        sums = np.zeros((C, V), dtype=np.float64)
        np.add.at(sums, pd.label_codes, counts)
        theta = (np.log(sums + lam)
                 - np.log(sums.sum(axis=1, keepdims=True) + V * lam))
        return TextNBModel(pi, theta, pd.labels, V, pd.max_tokens)

    def predict(self, model: TextNBModel, query: Query) -> PredictedResult:
        ids, mask = encode_texts([query.text], model.vocab_size,
                                 model.max_tokens)
        scores = model.predict_scores(ids, mask)[0]
        return PredictedResult(
            label=model.labels[int(np.argmax(scores))])

    def batch_predict(self, ctx: ComputeContext, model: TextNBModel,
                      indexed_queries):
        if not indexed_queries:
            return []
        ids, mask = encode_texts([q.text for _, q in indexed_queries],
                                 model.vocab_size, model.max_tokens)
        best = np.argmax(model.predict_scores(ids, mask), axis=1)
        return [(qx, PredictedResult(label=model.labels[int(bi)]))
                for (qx, _), bi in zip(indexed_queries, best)]


class Accuracy(AverageMetric):
    """Fraction of exact label matches."""

    def calculate_qpa(self, q, p, a) -> float:
        return 1.0 if p.label == a.label else 0.0


class TextParamsList(EngineParamsGenerator):
    """Tuning grid: NB smoothing vs LR capacity (EngineParamsGenerator
    shape of the reference's evaluation templates)."""

    def __init__(self, app_name: str = "text-app"):
        super().__init__()
        ds = ("", DataSourceParams(app_name=app_name))
        prep = ("", PreparatorParams())
        self.engine_params_list = [
            EngineParams(data_source_params=ds, preparator_params=prep,
                         algorithm_params_list=[
                             ("nb", TextNBParams(lambda_=lam))])
            for lam in (0.1, 1.0)
        ] + [
            EngineParams(data_source_params=ds, preparator_params=prep,
                         algorithm_params_list=[
                             ("lr", TextLRParams(embedding_dim=dim,
                                                 epochs=20, seed=1))])
            for dim in (16, 64)
        ]


class TextEvaluation(Evaluation, TextParamsList):
    """``pio eval`` entry: the 4-point NB/LR grid scored by Accuracy
    over the k-fold split; best params land in best.json."""

    def __init__(self, app_name: str = "text-app"):
        Evaluation.__init__(self)
        TextParamsList.__init__(self, app_name=app_name)
        self.engine_metric = (engine_factory(), Accuracy())


def engine_factory() -> Engine:
    return Engine(
        EventDataSource,
        TextPreparator,
        {"lr": TextEmbeddingLRAlgorithm,
         "nb": TextNBAlgorithm,
         "": TextEmbeddingLRAlgorithm},
        LFirstServing,
    )
