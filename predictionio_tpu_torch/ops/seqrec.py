"""Sequential recommendation: a SASRec-style next-item encoder, the port's
copy of ``predictionio_tpu/ops/seqrec.py``.

The model is a small causal transformer over each user's time-ordered
item sequence:

- learned item and position embeddings, the item table TIED: the same
  ``[M, D]`` matrix embeds the inputs and scores the output, so a trained
  model serves through the factor-store top-k path (user vector = the
  hidden state at the last real position, item vectors = the table,
  score = dot product);
- N pre-LN blocks of causal multi-head self-attention
  (:func:`~predictionio_tpu_torch.ops.attention.mha_reference` with the
  key-padding mask) and a pointwise FFN;
- trained by Adam steps on a sampled softmax over the item vocabulary,
  with gradients from autograd; the update is the JAX package's Adam
  form, not ``torch.optim.Adam`` (whose eps sits inside the bias
  correction); on the card each bucket's step replays a CUDA graph;
- sequences are grouped into power-of-two length buckets (the
  ``ops/als.PAD_MULTIPLE`` discipline).

Every op here is plain PyTorch, as the JAX package's are jnp (no Pallas
kernel runs on this path). Encodes split a bucket into row chunks under
a byte budget (:data:`ENCODE_BYTES`): at ML-20M width a whole bucket's
attention scores would take about 9 GB a layer.

Mesh lane: given a mesh, :func:`encode_users` runs each layer's
attention sequence-parallel (:func:`~predictionio_tpu_torch.ops.attention.
ring_attention` / :func:`~predictionio_tpu_torch.ops.attention.
ulysses_attention`, picked per length class by :func:`select_sp_kernel`:
Ulysses when the head count divides the mesh axis, else the ring). The
rest of the encoder runs once, on the mesh's first device, where the
JAX package replicates it over the mesh. Training never reads
``sp_mode``, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.core.base import Params
from predictionio_tpu_torch.device import DeviceLike, resolve_device
from predictionio_tpu_torch.ops.als import PAD_MULTIPLE
from predictionio_tpu_torch.ops.attention import (
    mha_reference,
    ring_attention,
    sp_axis_size,
    ulysses_attention,
)

# device bytes one encode chunk may take for its attention scores and
# activations; a bucket larger than that encodes in row chunks
ENCODE_BYTES = 256 << 20

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

# eager training steps on the card before a bucket's step is captured as
# a CUDA graph and replayed
GRAPH_WARMUP_STEPS = 3


@dataclasses.dataclass(frozen=True)
class SeqRecParams(Params):
    """SASRec-style hyperparameters, field for field the JAX package's.

    ``rank`` is also the model width, so a trained model drops into the
    ``[N, R] x [M, R]`` serving store. ``sp_mode`` picks the
    sequence-parallel attention lane when an encode is given a mesh:
    ``auto`` (Ulysses when the heads divide the mesh axis, else the
    ring), ``ring``, ``ulysses``, or ``off`` (dense attention even on a
    mesh). Without a mesh every mode encodes densely."""

    rank: int = 32
    n_layers: int = 2
    n_heads: int = 2
    max_seq_len: int = 32
    num_steps: int = 300
    batch_size: int = 128
    learning_rate: float = 1e-3
    n_negatives: int = 64
    ffn_mult: int = 2
    l2: float = 0.0
    seed: int = 0
    sp_mode: str = "auto"


@dataclasses.dataclass
class SequenceBucket:
    """One static-shape batch of same-length-class sequences.

    ``rows[i]`` is the original row (user) index of padded row i; ``ids``
    are item indices (0 in pad slots, which are masked); ``mask`` is 1.0
    on real positions."""

    rows: np.ndarray   # int64 [B]
    ids: np.ndarray    # int32 [B, L]
    mask: np.ndarray   # float32 [B, L]

    @property
    def seq_len(self) -> int:
        return int(self.ids.shape[1])

    def __len__(self) -> int:
        return int(self.ids.shape[0])


def length_bucket(n: int, lo: int = PAD_MULTIPLE) -> int:
    """The power-of-two length class ``n`` pads to (min ``lo``), through
    the serving bucket rounder, so train-time length classes and
    serve-time shape buckets share one ladder."""
    from predictionio_tpu_torch.ops.serving import bucket_size

    return bucket_size(n, lo)


def bucket_sequences(seqs: Sequence[np.ndarray],
                     max_len: Optional[int] = None) -> List[SequenceBucket]:
    """Group ragged per-user item sequences into power-of-two length
    buckets. Sequences longer than ``max_len`` keep their LAST
    ``max_len`` items; empty sequences are dropped (their rows appear in
    no bucket). Buckets come back shortest class first."""
    by_len: Dict[int, List[Tuple[int, np.ndarray]]] = {}
    for row, seq in enumerate(seqs):
        seq = np.asarray(seq, dtype=np.int32)
        if max_len is not None and len(seq) > max_len:
            seq = seq[-int(max_len):]
        if not len(seq):
            continue
        by_len.setdefault(length_bucket(len(seq)), []).append((row, seq))
    buckets: List[SequenceBucket] = []
    for L in sorted(by_len):
        members = by_len[L]
        B = len(members)
        ids = np.zeros((B, L), dtype=np.int32)
        mask = np.zeros((B, L), dtype=np.float32)
        rows = np.empty(B, dtype=np.int64)
        for i, (row, seq) in enumerate(members):
            rows[i] = row
            ids[i, :len(seq)] = seq
            mask[i, :len(seq)] = 1.0
        buckets.append(SequenceBucket(rows, ids, mask))
    return buckets


# -- parameters and the forward pass ------------------------------------------

def theta_shapes(n_items: int, params: SeqRecParams
                 ) -> List[Tuple[str, Tuple[int, ...]]]:
    """θ's keys and shapes, in the JAX package's order."""
    D = int(params.rank)
    if D % int(params.n_heads):
        raise ValueError(
            f"rank {D} not divisible by n_heads {params.n_heads}")
    F = D * int(params.ffn_mult)
    L = length_bucket(int(params.max_seq_len))
    out: List[Tuple[str, Tuple[int, ...]]] = [
        ("item_emb", (n_items, D)), ("pos_emb", (L, D)),
        ("ln_f_g", (D,)), ("ln_f_b", (D,))]
    for i in range(int(params.n_layers)):
        for name, shape in (("wq", (D, D)), ("wk", (D, D)), ("wv", (D, D)),
                            ("wo", (D, D)), ("w1", (D, F)), ("w2", (F, D))):
            out.append((f"l{i}_{name}", shape))
        out += [(f"l{i}_b1", (F,)), (f"l{i}_b2", (D,))]
        for ln in ("ln1", "ln2"):
            out += [(f"l{i}_{ln}_g", (D,)), (f"l{i}_{ln}_b", (D,))]
    return out


def init_theta(n_items: int, params: SeqRecParams) -> Dict[str, np.ndarray]:
    """The encoder's parameters as host numpy arrays, with the JAX
    package's names, shapes and scales: embeddings and weights normal
    (the item table over √D, positions times 0.01, each weight over
    √fan_in), LayerNorm gains one, biases zero. Drawn from a CPU
    ``torch.Generator`` seeded with ``params.seed`` (the values differ
    from ``jax.random``'s; a model carried over from the JAX package
    brings its own θ)."""
    gen = torch.Generator().manual_seed(int(params.seed))
    D = int(params.rank)
    theta: Dict[str, np.ndarray] = {}
    for name, shape in theta_shapes(n_items, params):
        short = name.split("_", 1)[1] if name[0] == "l" and name[1].isdigit() \
            else name
        if name == "item_emb":
            t = torch.randn(shape, generator=gen) / math.sqrt(D)
        elif name == "pos_emb":
            t = torch.randn(shape, generator=gen) * 0.01
        elif short in ("wq", "wk", "wv", "wo", "w1", "w2"):
            t = torch.randn(shape, generator=gen) / math.sqrt(shape[0])
        elif name.endswith("_g"):
            t = torch.ones(shape)
        else:
            t = torch.zeros(shape)
        theta[name] = t.to(torch.float32).numpy()
    return theta


def theta_to_device(theta: Dict[str, Any], device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """θ as fp32 tensors on ``device`` (numpy or tensors in)."""
    out = {}
    for k, v in theta.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v, dtype=np.float32))
        out[k] = t.to(device=device, dtype=torch.float32)
    return out


def _layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * g + b


def _heads_split(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    # [B, L, D] -> [B, H, L, D/H]
    B, L, D = x.shape
    return x.reshape(B, L, n_heads, D // n_heads).permute(0, 2, 1, 3)


def _heads_join(x: torch.Tensor) -> torch.Tensor:
    # [B, H, L, Dh] -> [B, L, D]
    B, H, L, Dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(B, L, H * Dh)


def encoder_forward(theta: Dict[str, torch.Tensor], ids: torch.Tensor,
                    mask: torch.Tensor, *, n_layers: int, n_heads: int,
                    attention_fn=None) -> torch.Tensor:
    """The SASRec encoder: ``[B, L]`` item ids and mask -> ``[B, L, D]``
    hidden states, pad positions exactly zero.

    Pre-LN blocks (``x += Wo·MHA(LN(x))``, then ``x += FFN(LN(x))``),
    LayerNorm eps 1e-6, ``item_emb·√D + pos_emb`` times the keep mask at
    the input, a final LayerNorm times the mask; causal and key-padding
    masking inside the attention. ``attention_fn(q, k, v, mask)``
    replaces the dense :func:`mha_reference` (the mesh lane passes the
    sequence-parallel schemes); None keeps the dense call itself, so the
    training step runs the same kernels with or without this hook."""
    L = ids.shape[1]
    D = theta["item_emb"].shape[1]
    keep = mask[..., None]
    x = theta["item_emb"][ids.long()] * math.sqrt(D)
    x = (x + theta["pos_emb"][:L]) * keep
    for i in range(n_layers):
        h = _layer_norm(x, theta[f"l{i}_ln1_g"], theta[f"l{i}_ln1_b"])
        q = _heads_split(h @ theta[f"l{i}_wq"], n_heads)
        k = _heads_split(h @ theta[f"l{i}_wk"], n_heads)
        v = _heads_split(h @ theta[f"l{i}_wv"], n_heads)
        if attention_fn is None:
            a = mha_reference(q, k, v, causal=True, key_padding_mask=mask)
        else:
            a = attention_fn(q, k, v, mask)
        a = _heads_join(a)
        x = x + (a @ theta[f"l{i}_wo"]) * keep
        h2 = _layer_norm(x, theta[f"l{i}_ln2_g"], theta[f"l{i}_ln2_b"])
        f = torch.clamp_min(h2 @ theta[f"l{i}_w1"] + theta[f"l{i}_b1"], 0.0)
        x = x + (f @ theta[f"l{i}_w2"] + theta[f"l{i}_b2"]) * keep
    x = _layer_norm(x, theta["ln_f_g"], theta["ln_f_b"])
    return x * keep


def last_hidden(h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The hidden state at each row's last real position -> ``[B, D]``
    user vectors; all-pad rows come back zero."""
    lens = torch.sum(mask, dim=1).to(torch.int64)
    last = torch.clamp_min(lens - 1, 0)
    vec = h[torch.arange(h.shape[0], device=h.device), last]
    return vec * (lens > 0).to(h.dtype)[:, None]


class SeqRecEncoder(torch.nn.Module):
    """The encoder as an ``nn.Module``: one parameter per θ key, under
    θ's own name. ``forward(ids, mask)`` gives the hidden states
    (:func:`encoder_forward`), :meth:`user_vectors` the last real
    position's state per row."""

    def __init__(self, theta: Dict[str, Any], n_layers: int, n_heads: int,
                 device: DeviceLike = None):
        super().__init__()
        self.n_layers, self.n_heads = int(n_layers), int(n_heads)
        for k, t in theta_to_device(theta, resolve_device(device)).items():
            self.register_parameter(k, torch.nn.Parameter(t))

    def theta(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters())

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return encoder_forward(self.theta(), ids, mask,
                               n_layers=self.n_layers, n_heads=self.n_heads)

    def user_vectors(self, ids: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
        return last_hidden(self.forward(ids, mask), mask)


# -- encoding -------------------------------------------------------------------

def encode_chunk_rows(L: int, D: int, n_heads: int, ffn_mult: int = 2,
                      budget: int = ENCODE_BYTES) -> int:
    """Rows of one encode chunk: a layer's attention scores and
    probabilities (``2·H·L²`` floats a row) plus its activations (about
    ``(8 + 2·ffn_mult)·L·D`` floats a row) under ``budget`` bytes."""
    per_row = 4 * (2 * n_heads * L * L + (8 + 2 * ffn_mult) * L * D)
    return max(1, int(budget) // per_row)


@torch.no_grad()
def encode_bucket(theta: Dict[str, Any], bucket: SequenceBucket,
                  params: SeqRecParams, device: DeviceLike = None,
                  budget: int = ENCODE_BYTES) -> np.ndarray:
    """One bucket's user vectors ``[B, D]`` (host fp32), encoded on
    ``device`` (None = cuda) in row chunks of :func:`encode_chunk_rows`
    rows. ``theta`` may be numpy arrays or tensors already on the
    device (the fold-in passes a cached device copy)."""
    return _encode_chunks(theta, bucket, params, resolve_device(device),
                          budget)


def _encode_chunks(theta: Dict[str, Any], bucket: SequenceBucket,
                   params: SeqRecParams, dev: torch.device, budget: int,
                   attention_fn=None) -> np.ndarray:
    """:func:`encoder_forward` over ``bucket`` on ``dev`` in row chunks of
    :func:`encode_chunk_rows` rows; each row's last real state, on the
    host."""
    th = theta_to_device(theta, dev)
    D = int(th["item_emb"].shape[1])
    B, L = bucket.ids.shape
    step = encode_chunk_rows(L, D, int(params.n_heads),
                             int(params.ffn_mult), budget)
    ids = torch.from_numpy(np.ascontiguousarray(bucket.ids)).to(dev)
    mask = torch.from_numpy(np.ascontiguousarray(bucket.mask)).to(dev)
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    for lo in range(0, B, step):
        m = mask[lo:lo + step]
        h = encoder_forward(th, ids[lo:lo + step], m,
                            n_layers=int(params.n_layers),
                            n_heads=int(params.n_heads),
                            attention_fn=attention_fn)
        out[lo:lo + step] = last_hidden(h, m)
    return out.cpu().numpy()


def encode_users(theta: Dict[str, Any], buckets: Sequence[SequenceBucket],
                 n_users: int, params: SeqRecParams,
                 device: DeviceLike = None, mesh=None) -> np.ndarray:
    """All users' vectors ``[n_users, D]``; rows in no bucket (users with
    no events) stay zero. Encoded on ``device`` (None = cuda), or, given
    a ``mesh`` and an ``sp_mode`` other than ``off``, by
    :func:`encode_bucket_mesh` on the mesh's devices."""
    sp = mesh is not None and params.sp_mode != "off"
    dev = mesh.device_list()[0] if sp else resolve_device(device)
    th = theta_to_device(theta, dev)
    out = np.zeros((n_users, int(params.rank)), dtype=np.float32)
    for bucket in buckets:
        out[bucket.rows] = encode_bucket_mesh(th, bucket, params, mesh) \
            if sp else encode_bucket(th, bucket, params, dev)
    return out


# -- the mesh lane --------------------------------------------------------------

def select_sp_kernel(mesh, axis_name: str, n_heads: int, seq_len: int,
                     sp_mode: str = "auto") -> Optional[str]:
    """Which sequence-parallel scheme a (mesh, shape) pair can run:
    ``ulysses`` when both heads and length divide the axis, else
    ``ring`` when the length divides, else None (the dense encode: a
    class shorter than two positions a shard leaves nothing to shard).
    An explicit ``sp_mode`` forces its scheme and raises when the shape
    cannot take it; ``off`` is None. The axis counts every process's
    shards when a process group exists (:func:`~predictionio_tpu_torch.
    ops.attention.sp_axis_size`)."""
    size = sp_axis_size(mesh, axis_name)
    if sp_mode == "off":
        return None
    ring_ok = seq_len % size == 0 and seq_len >= 2 * size
    uly_ok = ring_ok and n_heads % size == 0
    if sp_mode == "ulysses":
        if not uly_ok:
            raise ValueError(
                f"sp_mode=ulysses needs heads ({n_heads}) and length "
                f"({seq_len}) divisible by the {size}-way mesh axis")
        return "ulysses"
    if sp_mode == "ring":
        if not ring_ok:
            raise ValueError(
                f"sp_mode=ring needs length ({seq_len}) divisible by "
                f"the {size}-way mesh axis")
        return "ring"
    if uly_ok:
        return "ulysses"
    if ring_ok:
        return "ring"
    return None


@torch.no_grad()
def encode_bucket_mesh(theta: Dict[str, Any], bucket: SequenceBucket,
                       params: SeqRecParams, mesh, axis_name: str = "data",
                       budget: int = ENCODE_BYTES) -> np.ndarray:
    """One bucket's user vectors ``[B, D]`` (host fp32) with each layer's
    attention sequence-parallel over ``mesh[axis_name]`` (the scheme
    :func:`select_sp_kernel` picks), in the row chunks of
    :func:`encode_bucket`. Only the attention is sharded: the rest of
    the encoder runs once, on the mesh's first device. A length class
    the axis cannot shard falls back to :func:`encode_bucket` on that
    device."""
    dev = mesh.device_list()[0]
    kernel = select_sp_kernel(mesh, axis_name, int(params.n_heads),
                              bucket.seq_len, params.sp_mode)
    if kernel is None:
        return encode_bucket(theta, bucket, params, dev, budget)
    sp = ring_attention if kernel == "ring" else ulysses_attention

    def attention_fn(q, k, v, mask):
        return sp(q, k, v, mesh, axis_name=axis_name, causal=True,
                  key_padding_mask=mask)

    return _encode_chunks(theta, bucket, params, dev, budget, attention_fn)


# -- training ---------------------------------------------------------------------

def sampled_softmax_loss(theta: Dict[str, torch.Tensor], ids: torch.Tensor,
                         mask: torch.Tensor, negs: torch.Tensor, *,
                         n_layers: int, n_heads: int,
                         l2: float) -> torch.Tensor:
    """Next-item sampled softmax: position t's hidden state scores the
    true next item ``ids[t+1]`` against ``negs``, negatives shared by the
    batch (drawn uniformly, so one may be the positive); the mean over
    valid positions, plus ``l2·ΣE²/M``. The full ``[B, L, M]`` logits
    never materialize."""
    h = encoder_forward(theta, ids, mask, n_layers=n_layers,
                        n_heads=n_heads)
    ctx = h[:, :-1, :]                              # [B, L-1, D]
    pos_ids = ids[:, 1:].long()                     # [B, L-1]
    valid = mask[:, :-1] * mask[:, 1:]              # [B, L-1]
    E = theta["item_emb"]
    pos_e = E[pos_ids]                              # [B, L-1, D]
    pos_logit = torch.sum(ctx * pos_e, dim=-1)      # [B, L-1]
    neg_e = E[negs.long()]                          # [Nn, D]
    neg_logit = torch.einsum("bld,nd->bln", ctx, neg_e)
    logits = torch.cat([pos_logit[..., None], neg_logit], dim=-1)
    lse = torch.logsumexp(logits, dim=-1)
    nll = (lse - pos_logit) * valid
    loss = torch.sum(nll) / torch.clamp_min(torch.sum(valid), 1.0)
    if l2:
        loss = loss + l2 * torch.sum(torch.square(E)) / E.shape[0]
    return loss


def loss_and_grads(theta: Dict[str, torch.Tensor], ids: torch.Tensor,
                   mask: torch.Tensor, negs: torch.Tensor, *,
                   n_layers: int, n_heads: int, l2: float
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss and its gradient with respect to every θ tensor
    (autograd; θ's tensors need not require grad)."""
    keys = list(theta)
    with torch.enable_grad():
        leaves = {k: theta[k].detach().requires_grad_(True) for k in keys}
        loss = sampled_softmax_loss(leaves, ids, mask, negs,
                                    n_layers=n_layers, n_heads=n_heads,
                                    l2=l2)
        grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
    return loss.detach(), dict(zip(keys, grads))


@torch.no_grad()
def adam_update_(theta: List[torch.Tensor], m: List[torch.Tensor],
                 v: List[torch.Tensor], t: torch.Tensor,
                 grads: Sequence[torch.Tensor], lr: float) -> None:
    """One Adam step in place, in the JAX package's form, each op in its
    order: ``m = b1·m + (1-b1)·g``, ``v = b2·v + (1-b2)·g·g``, ``scale =
    lr·√(1-b2ᵗ)/(1-b1ᵗ)`` and ``θ -= scale·m / (√v + eps)``, ``t`` (an
    fp32 scalar tensor) counting up first. In place, so a captured step
    keeps its tensors."""
    b1, b2, eps = ADAM_B1, ADAM_B2, ADAM_EPS
    grads = list(grads)
    t.add_(1)
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, torch._foreach_mul(grads, 1 - b1))
    torch._foreach_mul_(v, b2)
    torch._foreach_add_(v, torch._foreach_mul(
        torch._foreach_mul(grads, 1 - b2), grads))
    scale = lr * torch.sqrt(1 - torch.pow(b2, t)) / (1 - torch.pow(b1, t))
    torch._foreach_sub_(theta, torch._foreach_div(
        torch._foreach_mul(m, scale),
        torch._foreach_add(torch._foreach_sqrt(v), eps)))


def plan_steps(buckets: Sequence[SequenceBucket],
               params: SeqRecParams) -> List[Tuple[int, int]]:
    """Per-bucket ``(steps, batch_size)`` the trainer runs: ``num_steps``
    split in proportion to the buckets' rows (at least 1 each), the batch
    clipped to the bucket."""
    total_rows = sum(len(b) for b in buckets)
    if not total_rows:
        raise ValueError("plan_steps: no non-empty sequences to train "
                         "on (every user history was empty)")
    return [(max(1, round(int(params.num_steps) * len(b) / total_rows)),
             min(int(params.batch_size), len(b)))
            for b in buckets]


Draws = Sequence[Tuple[np.ndarray, np.ndarray]]


def train_seqrec(buckets: Sequence[SequenceBucket], n_items: int,
                 params: SeqRecParams,
                 theta: Optional[Dict[str, Any]] = None,
                 device: DeviceLike = None,
                 draws: Optional[Draws] = None
                 ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Train the encoder over bucketed sequences on ``device`` (None =
    cuda).

    ``num_steps`` Adam steps are split over the buckets by
    :func:`plan_steps`, each bucket one loop of steps on the device
    (Adam's moments and step count start afresh per bucket). A
    step draws its ``bs`` rows and ``n_negatives`` negatives uniformly
    from one device ``torch.Generator`` seeded ``seed + 1`` (the
    negatives may hold the positive), takes the gradient of
    :func:`sampled_softmax_loss` by autograd and applies
    :func:`adam_update_`. On the card a bucket's step, after
    ``GRAPH_WARMUP_STEPS`` eager ones, is captured once as a CUDA graph
    and replayed (the same kernels on the same tensors: the step is
    hundreds of small launches). ``draws``, one ``(sel [steps, bs], negs
    [steps, n_negatives])`` pair per bucket, replaces the generator (the
    tests replay the JAX package's draws). ``sp_mode`` is not read: the
    trainer's attention is dense. Returns ``(θ as numpy, the loss of
    every step in execution order)``."""
    if not buckets:
        raise ValueError("train_seqrec: no non-empty sequences to train "
                         "on (every user history was empty)")
    dev = resolve_device(device)
    if theta is None:
        theta = init_theta(n_items, params)
    th = theta_to_device(theta, dev)
    keys = list(th)
    # updated in place (a captured step keeps its tensors)
    vals = [th[k].clone() for k in keys]
    gen = torch.Generator(device=dev).manual_seed(int(params.seed) + 1)
    n_layers, n_heads = int(params.n_layers), int(params.n_heads)
    n_negs, lr, l2 = int(params.n_negatives), float(params.learning_rate), \
        float(params.l2)
    plan = plan_steps(buckets, params)
    losses = torch.empty(sum(s for s, _ in plan), dtype=torch.float32,
                         device=dev)
    at = 0
    for bi, (bucket, (steps, bs)) in enumerate(zip(buckets, plan)):
        ids = torch.from_numpy(np.ascontiguousarray(bucket.ids)).to(dev)
        mask = torch.from_numpy(np.ascontiguousarray(bucket.mask)).to(dev)
        # each bucket's loop starts Adam afresh, as the JAX package's
        # per-bucket program does
        m = [torch.zeros_like(x) for x in vals]
        v = [torch.zeros_like(x) for x in vals]
        t = torch.zeros((), dtype=torch.float32, device=dev)
        sel = torch.empty(bs, dtype=torch.int64, device=dev)
        negs = torch.empty(n_negs, dtype=torch.int64, device=dev)
        loss = torch.empty((), dtype=torch.float32, device=dev)
        if draws is not None:
            sels = torch.as_tensor(np.asarray(draws[bi][0]), device=dev)
            negss = torch.as_tensor(np.asarray(draws[bi][1]), device=dev)

        def step():
            value, g = loss_and_grads(dict(zip(keys, vals)), ids[sel],
                                      mask[sel], negs, n_layers=n_layers,
                                      n_heads=n_heads, l2=l2)
            adam_update_(vals, m, v, t, [g[k] for k in keys], lr)
            loss.copy_(value)

        step_graph = None
        for s in range(steps):
            if draws is None:
                torch.randint(0, len(bucket), (bs,), generator=gen,
                              device=dev, out=sel)
                torch.randint(0, n_items, (n_negs,), generator=gen,
                              device=dev, out=negs)
            else:
                sel.copy_(sels[s])
                negs.copy_(negss[s])
            if dev.type == "cuda" and s == GRAPH_WARMUP_STEPS \
                    and steps > s + 1:
                # the step is launch-bound (hundreds of small kernels):
                # after a few eager steps, capture one and replay it
                step_graph = _capture(step)
            if step_graph is not None:
                step_graph.replay()
            else:
                step()
            losses[at].copy_(loss)
            at += 1
    theta_np = {k: x.detach().cpu().numpy().astype(np.float32, copy=False)
                for k, x in zip(keys, vals)}
    return theta_np, losses.cpu().numpy()


def _capture(step) -> "torch.cuda.CUDAGraph":
    """``step`` captured as a CUDA graph on a side stream (not run: the
    caller replays it). Autograd and the caching allocator warmed up in
    the eager steps before."""
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    return graph


def training_tokens(buckets: Sequence[SequenceBucket],
                    params: SeqRecParams) -> int:
    """Padded sequence positions the trainer processes: ``steps · batch
    · bucket length`` summed over the buckets (the JAX bench's tokens/s
    accounting)."""
    return int(sum(steps * bs * b.seq_len for b, (steps, bs)
                   in zip(buckets, plan_steps(buckets, params))))


__all__ = [
    "ENCODE_BYTES",
    "SeqRecEncoder",
    "SeqRecParams",
    "SequenceBucket",
    "adam_update_",
    "bucket_sequences",
    "encode_bucket",
    "encode_bucket_mesh",
    "encode_chunk_rows",
    "encode_users",
    "encoder_forward",
    "init_theta",
    "last_hidden",
    "length_bucket",
    "loss_and_grads",
    "plan_steps",
    "sampled_softmax_loss",
    "select_sp_kernel",
    "theta_shapes",
    "theta_to_device",
    "train_seqrec",
    "training_tokens",
]
