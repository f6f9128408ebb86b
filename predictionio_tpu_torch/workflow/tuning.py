"""Memory-aware grid tuning: size the config batch against the card's
free memory, and fall back to serial sub-batches when k factor sets do
not fit.

The port's copy of ``predictionio_tpu/workflow/tuning.py``. The grid
(:mod:`~predictionio_tpu_torch.ops.tuning`) holds one copy of the
bucketed tables plus k stacked factor sets and their solve transients.
:func:`plan_grid_batches` turns the budget (the card's free memory from
``torch.cuda.mem_get_info``, ``PIO_TUNING_HBM_BUDGET`` overriding it,
minus the byte totals of any reports the caller passes for stores about
to be deployed) into ordered sub-batches; :func:`run_grid` trains them
back to back (configs are independent and each config's init depends
only on its own params, so the sub-batched factors equal the full
grid's) and merges one leaderboard, the winner pinned with its full
EngineParams.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.device import DeviceLike, resolve_device
from predictionio_tpu_torch.ops import als as _als
from predictionio_tpu_torch.ops import tuning as _tuning
from predictionio_tpu_torch.ops.tuning import ConfigGrid, GridTrainResult
from predictionio_tpu_torch.workflow.checkpoint import TrainingDivergedError

logger = logging.getLogger("pio.torch.workflow.tuning")


def _report_bytes(report: Optional[Mapping]) -> int:
    """The byte total of a ``memory_report`` / ``ladder_report`` dict
    (both spell it ``totalBytes``; the ladder nests it under
    ``memory``)."""
    if not isinstance(report, Mapping):
        return 0
    total = int(report.get("totalBytes", 0) or 0)
    nested = report.get("memory")
    if isinstance(nested, Mapping):
        total += int(nested.get("totalBytes", 0) or 0)
    return total


def hbm_budget_bytes(reports: Sequence[Mapping] = (),
                     device: DeviceLike = None) -> Optional[int]:
    """Device memory free for the grid on ``device`` (None = cuda): the
    free bytes ``torch.cuda.mem_get_info`` reports, or None on the CPU
    (no meaningful ceiling). ``PIO_TUNING_HBM_BUDGET`` (bytes) overrides
    it; ``reports`` are byte totals to reserve for stores the caller is
    about to deploy on top."""
    reserved = sum(_report_bytes(r) for r in reports)
    forced = os.environ.get("PIO_TUNING_HBM_BUDGET", "").strip()
    if forced:
        return max(0, int(forced) - reserved)
    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    import torch

    free, _total = torch.cuda.mem_get_info(dev)
    return max(0, int(free) - reserved)


def grid_bytes_per_config(n_users: int, n_items: int, grid: ConfigGrid,
                          user_side=None, item_side=None) -> int:
    """Device bytes one config adds to the grid: its factor pair x2 (a
    half-step's new factors are written beside the old) plus its slice
    of the largest solve transients, the largest bucket's ``[B, L, R]``
    term (the JAX gather; in the port the ``[B, L]`` weights and the
    solve's workspace take less) and ``[B, R, R]`` normal-equation
    batch. The shared bucket tables are not counted: they are on the
    card once whatever k is."""
    r = grid.max_rank
    itemsize = 2 if _als._als_precision_mode(grid.base) == "bf16" else 4
    factors = (int(n_users) + int(n_items)) * r * itemsize * 2
    transient = 0
    for side in (user_side, item_side):
        if side is None:
            continue
        for b in side.buckets:
            rows, length = int(b.cols.shape[0]), int(b.cols.shape[1])
            budget = grid.base.bucket_slot_budget
            if budget and rows * length > int(budget):
                rows = max(8, (int(budget) // length) // 8 * 8)
            transient = max(transient,
                            rows * length * r * itemsize  # gather
                            + rows * r * r * 4)           # fp32 A batch
    return factors + transient


def plan_grid_batches(grid: ConfigGrid, n_users: int, n_items: int,
                      user_side=None, item_side=None,
                      budget_bytes: Optional[int] = None,
                      reports: Sequence[Mapping] = (),
                      device: DeviceLike = None) -> List[List[int]]:
    """Ordered config-index batches sized to the memory budget. No
    budget (the CPU) -> one batch, the whole grid. A budget smaller than
    one config still gives 1-config batches: the serial fallback is the
    k = 1 grid, the same code."""
    k = grid.k
    if budget_bytes is None:
        budget_bytes = hbm_budget_bytes(reports, device)
    if budget_bytes is None:
        return [list(range(k))]
    per = max(1, grid_bytes_per_config(n_users, n_items, grid,
                                       user_side, item_side))
    max_k = max(1, int(budget_bytes) // per)
    batches = [list(range(i, min(i + max_k, k)))
               for i in range(0, k, max_k)]
    if len(batches) > 1:
        logger.info(
            "grid of %d configs exceeds the memory budget (%d bytes, ~%d "
            "bytes/config): training %d sub-batches of <= %d",
            k, budget_bytes, per, len(batches), max_k)
    return batches


def run_grid(user_side, item_side, grid: ConfigGrid, *,
             train_rows: np.ndarray, train_cols: np.ndarray,
             held: Mapping[int, set], topk: int = 10,
             budget_bytes: Optional[int] = None,
             reports: Sequence[Mapping] = (),
             engine_params_base=None, algo_name: str = "als",
             warmup: bool = True, on_partial=None,
             device: DeviceLike = None) -> Dict[str, Any]:
    """Train the whole grid on ``device`` (None = cuda; sub-batched to
    the memory budget), rank every config's held-out users there through
    B1, and return the leaderboard artifact:
    ``rows`` best-first, ``winner`` pinned with its full EngineParams
    (when ``engine_params_base`` is given), plus the schedule the
    batches actually ran under.

    ``on_partial`` (when given) receives an intermediate leaderboard
    after every completed sub-batch except the last — rows whose
    configs haven't trained yet carry ``pending: True`` and the board
    ``partial: True`` — so a killed sweep leaves a usable artifact
    (``pio eval --grid`` streams these through ``atomic_write_bytes``).
    Callback failures are logged, never fatal. ``warmup`` builds and sets
    up the training kernels before the first batch; no batch is captured
    as a CUDA graph, so every batch trains eagerly within the plan."""
    n_users, n_items = user_side.n_rows, item_side.n_rows
    if budget_bytes is None:
        budget_bytes = hbm_budget_bytes(reports, device)
    batches = plan_grid_batches(grid, n_users, n_items, user_side,
                                item_side, budget_bytes, reports, device)
    # the tables go to the device once, after the plan read its free
    # memory: every batch trains on the same tables
    user_side = user_side.to_device(device)
    item_side = item_side.to_device(device)
    if warmup:
        # kernels only: a captured grid program would hold its scratch
        # (and its capture an eager iteration's cache) outside what the
        # plan counts, to save under 1% of a grid iteration
        _als.prepare_training_kernels(device)
    r_max = grid.max_rank
    uf = np.zeros((grid.k, n_users, r_max), np.float32)
    itf = np.zeros((grid.k, n_items, r_max), np.float32)
    alive = np.zeros(grid.k, dtype=bool)
    trained: set = set()
    # sub-batch loss histories merged by step into full-k vectors (the
    # chunk schedule is shared, so steps align across batches); configs
    # from batches that never sampled stay None holes
    merged_history: Dict[int, dict] = {}

    def _merge_history(batch, hist):
        for e in hist or ():
            m = merged_history.setdefault(
                int(e["step"]), {"step": int(e["step"]),
                                 "fit": [None] * grid.k,
                                 "l2": [None] * grid.k,
                                 "total": [None] * grid.k})
            for j, i in enumerate(batch):
                m["fit"][i] = e["fit"][j]
                m["l2"][i] = e["l2"][j]
                m["total"][i] = e["total"][j]

    def _make_board(partial: bool, done: int) -> Dict[str, Any]:
        merged = GridTrainResult(
            user_factors=uf, item_factors=itf, grid=grid, alive=alive,
            loss_history=[merged_history[s]
                          for s in sorted(merged_history)] or None)
        board = _tuning.grid_leaderboard(merged, train_rows, train_cols,
                                         held, topk=topk, device=device)
        board["gridK"] = grid.k
        board["batches"] = [len(b) for b in batches]
        board["hbmBudgetBytes"] = budget_bytes
        if partial:
            board["partial"] = True
            board["batchesCompleted"] = int(done)
            for row in board["rows"]:
                if row["config"] not in trained:
                    # zero factors read as "diverged" to the scorer;
                    # an untrained config is pending, not dead
                    row["pending"] = True
                    row["diverged"] = False
        return board

    for bi, batch in enumerate(batches):
        sub = grid.subset(batch)
        try:
            res = _tuning.train_als_grid_bucketed(user_side, item_side,
                                                  sub, device)
        except TrainingDivergedError as e:
            # a fully-diverged SUB-BATCH must not kill the sweep: its
            # configs are already counted dead (the per-chunk guard
            # fired before the abort); neighbors in other batches keep
            # their lanes. Factors stay zero, alive stays False.
            logger.warning(
                "grid sub-batch %s diverged entirely (%s); its configs "
                "are marked dead, remaining batches continue", batch, e)
            res = None
        if res is not None:
            for j, i in enumerate(batch):
                r = int(sub.configs[j].rank)
                uf[i, :, :r] = res.user_factors[j][:, :r]
                itf[i, :, :r] = res.item_factors[j][:, :r]
                alive[i] = res.alive[j]
            _merge_history(batch, res.loss_history)
        trained.update(int(i) for i in batch)
        if on_partial is not None and bi < len(batches) - 1:
            try:
                on_partial(_make_board(partial=True, done=bi + 1))
            except Exception:
                logger.warning("on_partial leaderboard callback failed",
                               exc_info=True)
    board = _make_board(partial=False, done=len(batches))
    if board["winner"] is not None and engine_params_base is not None:
        from predictionio_tpu_torch.controller.engine import (
            expand_engine_params,
        )
        from predictionio_tpu_torch.controller.evaluation import (
            _engine_params_to_jsonable,
        )

        variants = expand_engine_params(
            engine_params_base, algo_name,
            [grid.configs[r["config"]] for r in board["rows"]])
        for row, ep in zip(board["rows"], variants):
            if row["config"] == board["winner"]["config"]:
                board["winner"]["engineParams"] = \
                    _engine_params_to_jsonable(ep)
        # rows keep only sweep coordinates; the winner carries the full
        # trainable parameterization (the MetricEvaluator idiom)
    return board
