"""Multi-config ALS training: one program trains the whole
hyperparameter grid.

The port's copy of ``predictionio_tpu/ops/tuning.py``. A
:class:`ConfigGrid` of k :class:`~predictionio_tpu_torch.ops.als.ALSParams`
variants (lambda, alpha and, through rank padding, rank) is stacked on a
leading config axis and trained together
(:func:`~predictionio_tpu_torch.ops.als._als_iterations_grid`; JAX
``vmap``s the half-step):

- the bucketed ratings tables are on the card once: the device holds k
  factor sets, never k copies of the tables;
- each bucket's normal equations for all k configs are one launch of
  B3's config-axis route (``als_cuda.assemble_normal_equations_grid``),
  and their solves one launch of B2 over ``k * B`` systems;
- rank sweeps ride zero-padded factor columns: each config initializes
  at its true rank (the same draw as its serial run) and pads to the
  grid's largest; a unit ridge on the pad diagonals makes the padded
  coordinates solve to exact zeros, so the leading r columns match the
  serial rank-r run;
- divergence is per config: a non-finite config is masked out (factors
  zeroed) while its neighbours keep training
  (:func:`~predictionio_tpu_torch.workflow.checkpoint.run_chunked_grid`,
  which also carries the alive mask through checkpoints).

Grid-spec validation is loud and per field (:func:`grid_from_spec`):
unknown ``ALSParams`` fields and non-sweepable ones are each named with
the reason. :func:`grid_topk` ranks every held-out user under every
config through B1 (``fused_gather_score_topk``), and
:func:`grid_leaderboard` scores them.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Set, \
    Tuple

import numpy as np
import torch

from predictionio_tpu_torch.device import DeviceLike, resolve_device
from predictionio_tpu_torch.ops import als as _als
from predictionio_tpu_torch.ops import als_cuda
from predictionio_tpu_torch.ops.als import ALSParams, BucketedRatings

logger = logging.getLogger("pio.torch.tuning")


class GridConfigError(ValueError):
    """A grid spec referenced unknown or non-sweepable fields; the
    message carries one line per offending field."""


#: The ALSParams fields a grid may vary per config. Everything else is
#: shared by the whole grid (set it in the spec's "base").
SWEEPABLE_FIELDS = ("rank", "lambda_", "alpha")

_NOT_SWEEPABLE_WHY = {
    "num_iterations": "every config advances inside the SAME compiled "
                      "scan, so the trip count is shared",
    "implicit_prefs": "the implicit/explicit switch selects a different "
                      "traced program (static jit arg)",
    "seed": "the per-config init already varies by rank; a per-config "
            "seed would break the grid==serial differential contract",
    "solve_block_rows": "uniform-path execution knob, not part of the "
                        "bucketed grid program",
    "bucket_slot_budget": "static shape knob of the shared program",
    "precision": "the factor dtype is the stacked array's dtype — one "
                 "per grid",
    "solve_refine": "static jit arg of the shared program",
    "checkpoint_every": "execution knob (excluded from checkpoint "
                        "fingerprints); set via base or PIO_CHECKPOINT_EVERY",
}

# the fields every config of a grid must share: the non-sweepable ones
_SHARED_FIELDS = tuple(_NOT_SWEEPABLE_WHY)


def _als_field_names() -> Set[str]:
    return {f.name for f in dataclasses.fields(ALSParams)}


def _canonical_field(key: str, fields: Set[str]) -> Optional[str]:
    """A spec key as an ALSParams field name, accepting the camelCase and
    keyword aliases ``params_from_dict`` does (``lambda`` -> ``lambda_``,
    ``numIterations`` -> ``num_iterations``)."""
    if key in fields:
        return key
    snake = "".join("_" + c.lower() if c.isupper() else c for c in key)
    for alt in (snake, key + "_", snake + "_"):
        if alt in fields:
            return alt
    return None


def _coerce(canon: str, value):
    """A sweepable field's value, typed; raises ValueError/TypeError on
    garbage (the caller makes that one problem line)."""
    if canon == "rank":
        r = int(value)
        if r < 1:
            raise ValueError(f"rank must be >= 1, got {r}")
        return r
    return float(value)


@dataclasses.dataclass(frozen=True)
class ConfigGrid:
    """k resolved ALSParams variants trained together. Construction
    checks what the shared program depends on: at least one config, and
    every non-sweepable field the same across configs. ``rank_floor``
    raises the factor width ``max_rank`` to at least that rank: a
    :meth:`subset` keeps its parent's width, so its configs pad as they
    do in the full grid."""

    configs: Tuple[ALSParams, ...]
    rank_floor: int = 0

    def __post_init__(self):
        if not self.configs:
            raise GridConfigError("a ConfigGrid needs at least 1 config")
        base = self.configs[0]
        problems = []
        for i, c in enumerate(self.configs):
            if int(c.rank) < 1:
                problems.append(f"configs[{i}]: rank must be >= 1")
            for f in _SHARED_FIELDS:
                if getattr(c, f) != getattr(base, f):
                    problems.append(
                        f"configs[{i}].{f}: differs from configs[0] — "
                        f"{_NOT_SWEEPABLE_WHY[f]}")
        if problems:
            raise GridConfigError(
                "invalid config grid:\n  " + "\n  ".join(problems))

    @property
    def k(self) -> int:
        return len(self.configs)

    @property
    def base(self) -> ALSParams:
        return self.configs[0]

    @property
    def max_rank(self) -> int:
        return max([int(c.rank) for c in self.configs]
                   + [int(self.rank_floor)])

    @property
    def ranks(self) -> Tuple[int, ...]:
        return tuple(int(c.rank) for c in self.configs)

    def subset(self, indices: Sequence[int]) -> "ConfigGrid":
        """The sub-grid at ``indices``, at this grid's factor width.
        Configs are independent, each config's init depends only on its
        own params, and each pads to the same width as here (so its Gram
        is the same product), so a subset trains those configs to exactly
        the factors they get in the full grid, bit for bit (how the
        memory plan's sub-batches stay equal to it)."""
        return ConfigGrid(tuple(self.configs[int(i)] for i in indices),
                          rank_floor=self.max_rank)

    def describe(self) -> List[Dict]:
        return [{"rank": int(c.rank), "lambda": float(c.lambda_),
                 "alpha": float(c.alpha)} for c in self.configs]


def make_grid(base: ALSParams, overrides: Sequence[Mapping]) -> ConfigGrid:
    """A ConfigGrid from a base ALSParams and one override mapping per
    config. Every offending field of every config is named in one
    :class:`GridConfigError`, not just the first."""
    fields = _als_field_names()
    problems: List[str] = []
    configs: List[ALSParams] = []
    valid = ", ".join(("lambda" if f == "lambda_" else f)
                      for f in SWEEPABLE_FIELDS)
    for i, ov in enumerate(overrides):
        if not isinstance(ov, Mapping):
            problems.append(
                f"configs[{i}]: expected an object of field overrides, "
                f"got {type(ov).__name__}")
            continue
        kw = {}
        for key, value in ov.items():
            canon = _canonical_field(str(key), fields)
            if canon is None:
                problems.append(
                    f"configs[{i}].{key}: unknown ALSParams field "
                    f"(sweepable fields: {valid})")
            elif canon not in SWEEPABLE_FIELDS:
                why = _NOT_SWEEPABLE_WHY.get(
                    canon, "static argument of the shared program")
                problems.append(
                    f"configs[{i}].{key}: not sweepable — {why}; set it "
                    f"in 'base' instead")
            else:
                try:
                    kw[canon] = _coerce(canon, value)
                except (TypeError, ValueError) as e:
                    problems.append(f"configs[{i}].{key}: {e}")
        configs.append(dataclasses.replace(base, **kw))
    if problems:
        raise GridConfigError(
            "grid rejected:\n  " + "\n  ".join(problems))
    if not configs:
        raise GridConfigError("grid rejected: 'configs' is empty — "
                              "give at least one override object")
    return ConfigGrid(tuple(configs))


def grid_from_spec(spec: Mapping) -> ConfigGrid:
    """``{"base": {...ALSParams...}, "configs": [{...}, ...]}`` (the
    ``pio eval --grid`` file's shape) as a ConfigGrid, with per-field
    errors for both sections."""
    if not isinstance(spec, Mapping):
        raise GridConfigError(
            f"grid spec must be an object, got {type(spec).__name__}")
    unknown = sorted(set(spec) - {"base", "configs"})
    if unknown:
        raise GridConfigError(
            "grid rejected:\n  " + "\n  ".join(
                f"{k}: unknown grid section (expected: base, configs)"
                for k in unknown))
    fields = _als_field_names()
    problems: List[str] = []
    base_kw = {}
    base_raw = spec.get("base", {})
    if not isinstance(base_raw, Mapping):
        raise GridConfigError(
            f"base: expected an object of ALSParams fields, got "
            f"{type(base_raw).__name__}")
    for key, value in base_raw.items():
        canon = _canonical_field(str(key), fields)
        if canon is None:
            problems.append(
                f"base.{key}: unknown ALSParams field (valid: "
                + ", ".join(sorted(fields)) + ")")
        else:
            base_kw[canon] = value
    if problems:
        raise GridConfigError("grid rejected:\n  " + "\n  ".join(problems))
    try:
        base = ALSParams(**base_kw)
    except (TypeError, ValueError) as e:
        raise GridConfigError(f"grid rejected:\n  base: {e}") from e
    overrides = spec.get("configs")
    if not isinstance(overrides, (list, tuple)) or not overrides:
        raise GridConfigError(
            "grid rejected:\n  configs: expected a non-empty list of "
            "override objects")
    return make_grid(base, overrides)


# -- training ------------------------------------------------------------------

@dataclasses.dataclass
class GridTrainResult:
    """One grid training's result on the host: fp32 factors stacked
    ``[k, N, R_max]`` / ``[k, M, R_max]`` (rank-padded columns exact
    zeros), the grid, and the per-config ``alive`` mask (False = diverged
    and masked out; its factors are zeros). ``loss_history`` holds the
    objective samples (``{"step", "fit", "l2", "total"}`` with ``[k]``
    lists, None for dead configs) when training telemetry is on."""

    user_factors: np.ndarray
    item_factors: np.ndarray
    grid: ConfigGrid
    alive: np.ndarray
    loss_history: Optional[List[dict]] = None

    def factors_for(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """Config ``i``'s factors at its true rank: what the serial
        ``train_als_bucketed`` run of that config returns."""
        r = int(self.grid.configs[i].rank)
        return (self.user_factors[i][:, :r],
                self.item_factors[i][:, :r])


def init_grid_factors(n_users: int, n_items: int, grid: ConfigGrid,
                      precision: str, device: DeviceLike = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked factor init ``[k, N, R_max]`` / ``[k, M, R_max]`` on
    ``device`` (None = cuda), in the precision's factor dtype: each
    config draws at its true rank with the shared seed (the serial run's
    init, the ``1/sqrt(rank)`` scale included) and pads its columns with
    zeros."""
    r_max = grid.max_rank
    xs, ys = [], []
    for c in grid.configs:
        X, Y = _als.init_policy_factors(n_users, n_items, int(c.rank),
                                        c.seed, precision, device)
        pad = r_max - int(c.rank)
        if pad:
            X = torch.nn.functional.pad(X, (0, pad))
            Y = torch.nn.functional.pad(Y, (0, pad))
        xs.append(X)
        ys.append(Y)
    return torch.stack(xs), torch.stack(ys)


def grid_checkpoint_layout(user_side: BucketedRatings,
                           item_side: BucketedRatings, grid: ConfigGrid):
    """Layout half of the grid checkpoint fingerprint: the bucketed
    layout and every config's sweep coordinates, so a manifest another
    grid wrote does not resume this one."""
    return ("grid",
            _als.checkpoint_layout_bucketed(user_side, item_side),
            tuple((int(c.rank), float(c.lambda_), float(c.alpha))
                  for c in grid.configs))


def train_als_grid_bucketed(user_side: BucketedRatings,
                            item_side: BucketedRatings, grid: ConfigGrid,
                            device: DeviceLike = None) -> GridTrainResult:
    """Train all k configs together against the shared bucketed tables
    on ``device`` (None = cuda); see the module docstring. The lifecycle
    is :func:`~predictionio_tpu_torch.ops.als.train_als_bucketed`'s: the
    precision policy resolved per call, crash-safe chunks when
    ``PIO_CHECKPOINT_DIR`` is set (the alive mask in the manifest), host
    fp32 factors out. Raises ``TrainingDivergedError`` when every config
    diverged. After :func:`~predictionio_tpu_torch.ops.als.
    warmup_train_als_bucketed` with this grid on the same
    device-resident sides, the iterations and the objective samples replay the warmed programs,
    bitwise the eager run."""
    assert user_side.n_rows >= item_side.n_cols
    assert item_side.n_rows >= user_side.n_cols
    base = grid.base
    precision = _als._als_precision_mode(base)
    dev = resolve_device(device)
    X, Y = init_grid_factors(user_side.n_rows, item_side.n_rows, grid,
                             precision, dev)
    (_, _, lam, alpha, ridge, u_t, i_t), kw = _als._grid_call_args(
        user_side, item_side, grid.configs, precision, dev,
        r_max=grid.max_rank)
    ckpt = _als._maybe_checkpointer(
        grid_checkpoint_layout(user_side, item_side, grid), base,
        _als._solver_route(dev), precision)
    fdt = X.dtype

    def run_iters(Xc, Yc, n):
        return _als._als_iterations_grid(
            Xc, Yc, lam, alpha, ridge, u_t, i_t,
            **dict(kw, num_iterations=int(n)))

    objective = history = None
    if _als._train_telemetry_enabled():
        implicit = bool(base.implicit_prefs)
        history = []

        def objective(Xc, Yc):
            return _als._objective_pack_grid(Xc, Yc, lam, alpha, u_t,
                                             implicit=implicit)

    # both lanes go through the grid loop: it owns the per-config finite
    # guard and mask either way (ckpt=None runs all iterations at once)
    from predictionio_tpu_torch.workflow import checkpoint as _checkpoint

    X, Y, alive = _checkpoint.run_chunked_grid(
        run_iters, X, Y, int(base.num_iterations), ckpt,
        to_host=_als._to_host,
        from_host=lambda a: torch.from_numpy(np.ascontiguousarray(
            a, dtype=np.float32)).to(dev).to(fdt),
        objective=objective, history=history)
    return GridTrainResult(
        user_factors=_als._to_host(X), item_factors=_als._to_host(Y),
        grid=grid, alive=np.asarray(alive, dtype=bool),
        loss_history=history)


# -- evaluation on the card: every config's top-k through B1 -------------------

def _grid_topk(result: GridTrainResult, user_ids: Sequence[int],
               train_rows: np.ndarray, train_cols: np.ndarray, topk: int,
               chunk: int, device: DeviceLike, topk_fn: Callable
               ) -> Tuple[np.ndarray, np.ndarray]:
    """``(idx [k, U, topk] int64, scores [k, U, topk] fp32)`` of
    ``topk_fn`` (B1's wrapper or its plain version) per config per
    ``chunk`` users, each user's training items masked as seen."""
    dev = resolve_device(device)
    k = result.user_factors.shape[0]
    n_items = result.item_factors.shape[1]
    users = np.asarray(list(user_ids), dtype=np.int64)
    train_rows = np.asarray(train_rows)
    # host seen lookup: user -> its training items (shared by the
    # configs), from a stable sort of the ranked users' triples only
    ranked = np.zeros(max(int(train_rows.max(initial=-1)),
                          int(users.max(initial=-1))) + 1, dtype=bool)
    ranked[users] = True
    sel = np.flatnonzero(ranked[train_rows])
    order = sel[np.argsort(train_rows[sel], kind="stable")]
    scols = np.asarray(train_cols)[order]
    lo, hi = np.searchsorted(train_rows[order], [users, users + 1])
    idx_out = np.empty((k, len(users), int(topk)), dtype=np.int64)
    val_out = np.empty((k, len(users), int(topk)), dtype=np.float32)
    Ys = [torch.from_numpy(np.ascontiguousarray(result.item_factors[z])).to(
        dev) for z in range(k)]
    chunk = max(1, int(chunk))
    for start in range(0, len(users), chunk):
        u = users[start:start + chunk]
        b = len(u)
        lengths = hi[start:start + b] - lo[start:start + b]
        L = max(1, int(lengths.max()) if b else 1)
        # seen lists [L, B]: slot l of user j is its l-th training item
        seen_cols = np.zeros((L, b), dtype=np.int32)
        seen_mask = np.zeros((L, b), dtype=np.float32)
        for j in range(b):
            n = int(lengths[j])
            seen_cols[:n, j] = scols[lo[start + j]:hi[start + j]]
            seen_mask[:n, j] = 1.0
        sc = torch.from_numpy(seen_cols).to(dev)
        sm = torch.from_numpy(seen_mask).to(dev)
        for z in range(k):
            Q = torch.from_numpy(np.ascontiguousarray(
                result.user_factors[z][u])).to(dev)
            vals, idx = topk_fn(Q, Ys[z], sc, sm, k=int(topk),
                                n_items=n_items, mask_seen=True)
            idx_out[z, start:start + b] = idx.cpu().numpy()
            val_out[z, start:start + b] = vals.cpu().numpy()
    return idx_out, val_out


def grid_topk(result: GridTrainResult, user_ids: Sequence[int],
              train_rows: np.ndarray, train_cols: np.ndarray, topk: int,
              chunk: int = 512, device: DeviceLike = None,
              with_scores: bool = False):
    """The top ``topk`` unseen items of ``user_ids`` under every config:
    ``[k, U, topk]`` item indices (with ``with_scores``, also the
    ``[k, U, topk]`` scores). Per config, per ``chunk`` users, one launch
    of B1 (``fused_gather_score_topk``, ``mask_seen=True``) on
    ``device`` (None = cuda), each user's training items as its seen
    list; ties go to the lowest item id. A user with fewer than ``topk``
    unseen items gets ``-inf`` slots, whose ids B1 leaves unspecified."""
    idx, vals = _grid_topk(result, user_ids, train_rows, train_cols, topk,
                           chunk, device, als_cuda.fused_gather_score_topk)
    return (idx, vals) if with_scores else idx


def grid_topk_plain(result: GridTrainResult, user_ids: Sequence[int],
                    train_rows: np.ndarray, train_cols: np.ndarray,
                    topk: int, chunk: int = 512, device: DeviceLike = None,
                    with_scores: bool = False):
    """:func:`grid_topk` through B1's plain version (an fp32 product and
    a stable sort), the reference it is held against."""
    idx, vals = _grid_topk(result, user_ids, train_rows, train_cols, topk,
                           chunk, device,
                           als_cuda.fused_gather_score_topk_plain)
    return (idx, vals) if with_scores else idx


def grid_leaderboard(result: GridTrainResult, train_rows: np.ndarray,
                     train_cols: np.ndarray, held: Mapping[int, set],
                     topk: int = 10, device: DeviceLike = None,
                     topk_fn: Optional[Callable] = None) -> Dict:
    """Score every config on the held-out interactions (Precision@k and
    NDCG@k over :func:`grid_topk`) and rank them: ``rows`` best-first
    (diverged configs last with ``metric: None``) and ``winner``.
    ``topk_fn`` (default :func:`grid_topk`) ranks the users."""
    from predictionio_tpu_torch.data import sliding

    users = sorted(int(u) for u in held if held[u])
    rows: List[Dict] = []
    if users:
        idx = (topk_fn or grid_topk)(result, users, train_rows, train_cols,
                                     topk, device=device)
    for i in range(result.grid.k):
        entry = {"config": i,
                 "params": result.grid.describe()[i],
                 "diverged": not bool(result.alive[i]),
                 # the config's objective curve: one point per telemetry
                 # sample it survived
                 "lossTrajectory": [
                     {"step": e["step"], "fit": e["fit"][i],
                      "l2": e["l2"][i], "total": e["total"][i]}
                     for e in (result.loss_history or [])
                     if i < len(e["total"])
                     and e["total"][i] is not None]}
        if entry["diverged"] or not users:
            entry["metric"] = None
            entry["precisionAtK"] = None
            entry["ndcgAtK"] = None
        else:
            prec, ndcg = [], []
            for j, u in enumerate(users):
                rel = held[u]
                ranked = [int(t) for t in idx[i, j]]
                hits = sum(1 for t in ranked if t in rel)
                prec.append(hits / float(topk))
                ndcg.append(sliding.ndcg_at_k(ranked, rel, topk))
            entry["precisionAtK"] = float(np.mean(prec))
            entry["ndcgAtK"] = float(np.mean(ndcg))
            entry["metric"] = entry["precisionAtK"]
        rows.append(entry)
    rows.sort(key=lambda r: (r["metric"] is None, -(r["metric"] or 0.0),
                             r["config"]))
    winner = next((r for r in rows if r["metric"] is not None), None)
    return {"metricName": f"precision@{int(topk)}", "k": int(topk),
            "nTestUsers": len(users), "rows": rows,
            "winner": dict(winner) if winner else None}
