"""The fold-in consumer: tail the event stream, solve, patch the store.

The port's copy of ``predictionio_tpu/online/foldin.py``. Lifecycle (one
daemon thread per deployed engine with ``--foldin on``):

1. **Tail** — poll ``LEvents.find_since`` from the cursor minted at
   start (``tail_cursor``: only events AFTER deployment fold — history
   is already in the trained factors). The cursor shape is the
   backend's own (memory sequence / sqlite rowid / jsonlfs byte
   watermark / opaque over the resthttp wire; a ``fleet`` source
   composes one per shard, ``{"fleetShards": {url: cursor}}``, and
   keeps a dead shard's entry where it was, so its events fold late,
   never lost).
2. **Accumulate** — rating events (the datasource's event names,
   user->item with a numeric value property) mark their user touched;
   everything else is ignored.
3. **Fold** — when touched users are pending and either the cadence
   (``PIO_FOLDIN_INTERVAL``) elapsed or the pending-event count crossed
   ``PIO_FOLDIN_COUNT``: gather each touched user's FULL rating set
   from the store (indexed per-entity read), solve all of them in one
   batch (:func:`~predictionio_tpu_torch.ops.als.fold_in_users`: the
   training half-step against the fixed item factors, on the card the
   assembly kernel then the solve kernel), and patch the live
   ``DeviceTopK`` store (:meth:`~predictionio_tpu_torch.ops.serving.
   DeviceTopK.patch_users`: in-place writes enqueued under the store
   lock the queries' gathers are enqueued under, so in-flight queries
   never see a torn store). Unknown users grow the store via the
   power-of-two bucket ladder and land in the model's ``user_map`` only
   AFTER the store holds their row.

   Precision interplay: the solve runs the training lane
   (``ALSParams.precision`` / ``PIO_ALS_PRECISION``) whatever the
   serving store holds (``DeviceTopK.item_factors_as``): under fp32 a
   bf16 store hands the solve its item factors cast through fp32; under
   bf16 a bf16 store hands over its rows as they are, and an fp32 store
   its rows rounded to bf16; an int8 store (``PIO_SERVE_PRECISION=int8``)
   a dequantized view in the lane's dtype; and
   ``patch_users`` re-quantizes the fresh rows with RECOMPUTED per-row
   absmax scales, so a folded row is bit-identical to what
   quantize-at-load would have produced for the same factors.

Degradation: a failing tail read flips ``stale`` —
serving continues from the last-good factors and the query server
stamps responses ``degradedReasons: ["foldin_stale"]``; the next
successful read clears it. Every fold is a ``pio.foldin`` trace root
with gather/solve/patch child spans, and the ``pio_foldin_*`` metric
family (folds, users patched, event->servable freshness histogram)
feeds ``/metrics`` and ``/stats.json``.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from predictionio_tpu_torch.ops.als import (
    ALSParams,
    _als_precision_mode,
    factor_dtype,
    fold_in_users,
)
from predictionio_tpu_torch.utils import device_telemetry, metrics
from predictionio_tpu_torch.utils.resilience import _env_float
from predictionio_tpu_torch.utils.tracing import span, trace_scope

logger = logging.getLogger("pio.torch.foldin")

UTC = _dt.timezone.utc

# creation timestamps kept for the freshness histogram are capped: a
# catch-up burst must not hold one float per backlog event
_FRESHNESS_SAMPLE_CAP = 4096

# consecutive fold failures before the re-merged batch is dropped
# (dropped users re-enter on their next event)
_MAX_FAILED_ROUNDS = 3


@dataclasses.dataclass(frozen=True)
class FoldInConfig:
    """What to tail and when to fold.

    ``interval`` (seconds, ``PIO_FOLDIN_INTERVAL``, default 2.0) is the
    fold cadence: pending deltas are solved at most this often — unless
    ``count_threshold`` (``PIO_FOLDIN_COUNT``, default 64) pending
    events accumulate first, which folds immediately (a hot stream must
    not wait out the clock). The tail itself is polled a few times per
    interval so a fold fires close to the cadence boundary, not one
    poll late."""

    app_name: str
    channel_name: Optional[str] = None
    event_names: Tuple[str, ...] = ("rate",)
    entity_type: str = "user"
    target_entity_type: str = "item"
    value_property: Optional[str] = "rating"
    default_value: float = 1.0
    interval: float = 2.0
    count_threshold: int = 64
    tail_batch: int = 10_000
    # the preparator's per-row truncation, mirrored at fold time: an
    # engine trained with max_len must fold truncated or long-history
    # users solve a different objective than their trained rows
    max_len: Optional[int] = None

    @classmethod
    def from_env(cls, **kwargs) -> "FoldInConfig":
        kwargs.setdefault("interval",
                          _env_float("PIO_FOLDIN_INTERVAL", 2.0))
        kwargs.setdefault("count_threshold",
                          int(_env_float("PIO_FOLDIN_COUNT", 64)))
        return cls(**kwargs)


class FoldInConsumer:
    """Background fold-in for ONE deployed model (see module docstring).

    ``model`` must expose the ALS-template model surface: ``user_map`` /
    ``item_map`` (StringIndexBiMap), ``seen`` (user idx -> item idx
    array) and ``device_server()`` returning a store with
    ``patch_users`` (DeviceTopK). ``als_params`` carries the SAME
    hyperparameters the model trained with — the fold-in solve is the
    training half-step, and a different lambda/alpha would silently
    solve a different objective.
    """

    def __init__(self, model: Any, config: FoldInConfig,
                 als_params: Optional[ALSParams] = None,
                 patch_lock: Optional[threading.Lock] = None):
        self._model = model
        self._cfg = config
        self._params = als_params
        # serializes _patch's read-assign-append on user_map; a
        # composite whose targets SHARE one vocabulary (the two-stage
        # deployment) passes the same lock to every sharing consumer,
        # else two tails folding the same new user race the append
        self._patch_lock = patch_lock or threading.Lock()
        # model-provided solve hook (e.g. the sequentialrec template's
        # re-encode): when present it replaces the ALS half-step, and
        # ``foldin_time_ordered`` asks the gather to hand histories in
        # EVENT-TIME order (sequence encoders are order-sensitive; the
        # ALS normal equations are not)
        self._fold_hook = getattr(model, "fold_in_rows", None)
        self._ordered = bool(getattr(model, "foldin_time_ordered",
                                     False))
        if self._fold_hook is None and als_params is None:
            raise ValueError(
                "FoldInConsumer needs either ALSParams (the training "
                "half-step lane) or a model with fold_in_rows (the "
                "model-encoder lane)")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._cursor: Optional[Dict] = None
        self._scope: Optional[Tuple[int, Optional[int]]] = None
        # pending user id -> delta event count since the last fold
        self._pending: Dict[str, int] = {}
        self._pending_events = 0
        self._fresh_ts: List[float] = []
        self._last_fold = time.monotonic()
        # consecutive failed folds: re-merged batches retry a bounded
        # number of times, then drop (a poison batch must not kill
        # fold-in for every OTHER user forever)
        self._failed_rounds = 0
        self._stats_lock = threading.Lock()
        self.stale = False
        self.folds = 0
        self.fold_errors = 0
        self.tail_errors = 0
        self.users_patched = 0
        self.new_users = 0
        self.events_folded = 0
        self.last_fold_at: Optional[_dt.datetime] = None
        # device µs of the most recent fold solve (flight recorder)
        self.last_solve_device_us: Optional[float] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FoldInConsumer":
        """Resolve the scope, pin the cursor at the CURRENT stream end
        (history up to the training read is inside the trained factors)
        and start the tail thread. Raises early — at deploy, not first
        fold — when the serving backend cannot be patched or the tail
        is unsupported.

        Known window: events that arrive between the training read and
        this deploy are behind the cursor AND absent from the trained
        factors. A user touched by any post-deploy event is re-solved
        from their FULL history (the gather reads the store, not the
        tail), so one later event heals the gap for that user; only a
        user whose entire activity falls inside the window stays
        unservable until the next train or their next event."""
        from predictionio_tpu_torch.data.store import app_name_to_id

        server = self._model.device_server()
        if not hasattr(server, "patch_users"):
            raise ValueError(
                "online fold-in requires an updatable device factor "
                f"store; {type(server).__name__} has no patch_users — "
                "the port serves every model from DeviceTopK")
        if not getattr(server, "growable", True):
            # refuse at deploy, not first unknown user: a non-growable
            # store's refusal inside a fold would poison every batch
            # that contains a new user
            raise ValueError(
                "online fold-in requires a growable user factor store; "
                f"{type(server).__name__} cannot grow its user rows")
        self._scope = app_name_to_id(self._cfg.app_name,
                                     self._cfg.channel_name)
        self._cursor = self._levents().tail_cursor(*self._scope)
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="pio-foldin")
        self._thread.start()
        logger.info(
            "fold-in consumer started: app=%s channel=%s interval=%.2fs "
            "count=%d", self._cfg.app_name, self._cfg.channel_name,
            self._cfg.interval, self._cfg.count_threshold)
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
            self._thread = None

    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            return {
                "folds": self.folds,
                "foldErrors": self.fold_errors,
                "tailErrors": self.tail_errors,
                "usersPatched": self.users_patched,
                "newUsers": self.new_users,
                "eventsFolded": self.events_folded,
                "pendingEvents": self._pending_events,
                "stale": self.stale,
                "lastFoldAt": None if self.last_fold_at is None
                else self.last_fold_at.isoformat(),
                "lastSolveDeviceUs": self.last_solve_device_us,
                "intervalSec": self._cfg.interval,
                "countThreshold": self._cfg.count_threshold,
                "cursor": self._cursor,
            }

    # -- the tail loop -----------------------------------------------------

    @staticmethod
    def _levents():
        from predictionio_tpu_torch.data import storage

        return storage.get_levents()

    def _run(self) -> None:
        poll = min(self._cfg.interval, 0.25) if self._cfg.interval > 0 \
            else 0.25
        while not self._stop.wait(poll):
            try:
                self._cycle()
            except Exception:
                # belt-and-braces: the loop must survive anything
                logger.exception("fold-in cycle failed")

    def _cycle(self) -> None:
        try:
            while not self._stop.is_set():
                events, self._cursor = self._levents().find_since(
                    *self._scope, cursor=self._cursor,
                    limit=self._cfg.tail_batch)
                if self.stale:
                    with self._stats_lock:
                        self.stale = False
                    metrics.FOLDIN_STALE.set(0)
                    logger.info("fold-in tail recovered")
                self._ingest(events)
                if len(events) < self._cfg.tail_batch or \
                        self._pending_events >= self._cfg.count_threshold:
                    break
        except Exception as e:
            # a failing tail must NOT take serving down: flag stale
            # (responses go out degraded from the last-good factors)
            # and try again next poll — the DAO layer's retries and
            # breaker already absorbed what was absorbable
            first = not self.stale
            with self._stats_lock:
                self.stale = True
                self.tail_errors += 1
            metrics.FOLDIN_STALE.set(1)
            metrics.FOLDIN_TAIL_ERRORS.inc()
            if first:
                logger.warning("fold-in tail read failed (serving "
                               "continues degraded): %s", e)
            return
        now = time.monotonic()
        if self._pending and (
                self._pending_events >= self._cfg.count_threshold
                or now - self._last_fold >= self._cfg.interval):
            self._fold()

    def _ingest(self, events) -> None:
        cfg = self._cfg
        names = set(cfg.event_names)
        now = time.time()
        for e in events:
            if e.event not in names or e.entity_type != cfg.entity_type \
                    or e.target_entity_type != cfg.target_entity_type \
                    or not e.target_entity_id:
                continue
            self._pending[e.entity_id] = \
                self._pending.get(e.entity_id, 0) + 1
            self._pending_events += 1
            if len(self._fresh_ts) < _FRESHNESS_SAMPLE_CAP:
                t = e.creation_time or e.event_time
                self._fresh_ts.append(min(t.timestamp(), now))

    # -- the fold ----------------------------------------------------------

    def _gather(self, user_ids: List[str]):
        """Each touched user's FULL rating set from the store, mapped
        onto item indices. Items the model has never seen carry no
        factors and are skipped; a user left with zero known items is
        dropped from this fold (their next event against a known item
        re-touches them).

        Read shape: backends that declare ``indexed_entity_reads``
        (sqlite from an index; a ``fleet`` source from the one owner
        shard, filtered server-side) answer an ``entity_id``-filtered
        find cheaply, so they are read per user. Scan-based backends (memory /
        jsonlfs) pay a FULL-store pass per find — there a
        catch-up fold of k users must not cost k whole-store scans
        inside the live query server, so beyond a handful of users one
        shared scan is bucketed client-side instead."""
        cfg = self._cfg
        item_map = self._model.item_map
        le = self._levents()
        per_user: Dict[str, Tuple[List[int], List[float], List[float]]] \
            = {uid: ([], [], []) for uid in user_ids}
        ordered = self._ordered

        def take(bucket, e) -> None:
            idx = item_map.get(e.target_entity_id)
            if idx is None:
                return
            raw = e.properties.fields.get(cfg.value_property) \
                if cfg.value_property else None
            try:
                val = float(raw) if raw is not None \
                    else cfg.default_value
            except (TypeError, ValueError):
                val = cfg.default_value
            bucket[0].append(int(idx))
            bucket[1].append(val)
            if ordered:
                bucket[2].append(e.event_time.timestamp())

        find_kwargs = dict(
            channel_id=self._scope[1], entity_type=cfg.entity_type,
            event_names=list(cfg.event_names),
            target_entity_type=cfg.target_entity_type)
        if getattr(le, "indexed_entity_reads", False) \
                or len(user_ids) <= 4:
            for uid in user_ids:
                for e in le.find(self._scope[0], entity_id=uid,
                                 **find_kwargs):
                    take(per_user[uid], e)
        else:
            for e in le.find(self._scope[0], **find_kwargs):
                bucket = per_user.get(e.entity_id)
                if bucket is not None:
                    take(bucket, e)
        kept_ids: List[str] = []
        cols_list: List[np.ndarray] = []
        vals_list: List[np.ndarray] = []
        for uid in user_ids:
            cols, vals, times = per_user[uid]
            if not cols:
                continue
            kept_ids.append(uid)
            c = np.asarray(cols, dtype=np.int64)
            v = np.asarray(vals, dtype=np.float32)
            if ordered:
                # stable: equal timestamps keep the scan's arrival order
                o = np.argsort(np.asarray(times, dtype=np.float64),
                               kind="stable")
                c, v = c[o], v[o]
            cols_list.append(c)
            vals_list.append(v)
        return kept_ids, cols_list, vals_list

    def _fold(self) -> None:
        pending, self._pending = self._pending, {}
        n_events, self._pending_events = self._pending_events, 0
        fresh_ts, self._fresh_ts = self._fresh_ts, []
        self._last_fold = time.monotonic()
        model = self._model
        try:
            with trace_scope("pio.foldin",
                             attributes={"users": len(pending),
                                         "events": n_events},
                             slow_exempt=True):
                with span("foldin.gather",
                          attributes={"users": len(pending)}):
                    kept_ids, cols_list, vals_list = self._gather(
                        list(pending))
                if not kept_ids:
                    return
                server = model.device_server()
                with span("foldin.solve",
                          attributes={"users": len(kept_ids)}) as ssp:
                    if self._fold_hook is not None:
                        # model-encoder lane: re-encode the touched
                        # users' (time-ordered) sequences on device.
                        # The hook records no flight record of its own,
                        # so do NOT consult last_record() here — under
                        # live traffic it would hand back a concurrent
                        # QUERY dispatch's record and publish a wrong
                        # lane/deviceUs as the fold solve's
                        rows = self._fold_hook(cols_list, vals_list)
                        rec = None
                    else:
                        Y = server.item_factors_as(factor_dtype(
                            _als_precision_mode(self._params)))
                        rows = fold_in_users(Y, cols_list, vals_list,
                                             self._params,
                                             max_len=self._cfg.max_len)
                        # the solve's flight record: fold_in_users just
                        # recorded the "foldin"-lane dispatch; pin it to
                        # the span so a slow fold's trace names its
                        # bucket shape and device time, and keep the µs
                        # for stats(). The ring is shared with the query
                        # lanes, so a record of another lane (a query
                        # dispatched in between) is not taken for it
                        rec = device_telemetry.last_record() \
                            if device_telemetry.enabled() else None
                        if rec is not None and rec.get("lane") != "foldin":
                            rec = None
                    if rec is not None:
                        if ssp is not None:
                            ssp.attributes["dispatch"] = rec
                        with self._stats_lock:
                            self.last_solve_device_us = rec["deviceUs"]
                with span("foldin.patch",
                          attributes={"users": len(kept_ids)}):
                    known, new = self._patch(server, kept_ids, cols_list,
                                             rows)
            now = time.time()
            self._failed_rounds = 0
            with self._stats_lock:
                self.folds += 1
                self.users_patched += known + new
                self.new_users += new
                self.events_folded += n_events
                self.last_fold_at = _dt.datetime.now(tz=UTC)
            metrics.FOLDIN_FOLDS.inc(status="ok")
            if known:
                metrics.FOLDIN_USERS.inc(amount=known, kind="known")
            if new:
                metrics.FOLDIN_USERS.inc(amount=new, kind="new")
            metrics.FOLDIN_EVENTS.inc(amount=n_events)
            for t in fresh_ts:
                metrics.FOLDIN_FRESHNESS.observe(max(0.0, now - t))
        except Exception:
            # put the batch back: the cursor already advanced past these
            # events, so dropping the touched-user set here would leave
            # them unfolded until their NEXT event. Re-merging retries
            # the whole batch at the next cadence instead (gather reads
            # full histories, so a re-fold is exact, not additive) —
            # BOUNDED: a batch that fails _MAX_FAILED_ROUNDS times in a
            # row is dropped, or one poison user would stop every other
            # user's folds forever (dropped users heal on their next
            # event, which re-touches them).
            self._failed_rounds += 1
            with self._stats_lock:
                self.fold_errors += 1
            if self._failed_rounds >= _MAX_FAILED_ROUNDS:
                self._failed_rounds = 0
                metrics.FOLDIN_FOLDS.inc(status="dropped")
                logger.exception(
                    "fold-in batch failed %d consecutive times; "
                    "DROPPING %d touched users (they re-enter on their "
                    "next event)", _MAX_FAILED_ROUNDS, len(pending))
            else:
                for uid, c in pending.items():
                    self._pending[uid] = self._pending.get(uid, 0) + c
                self._pending_events += n_events
                self._fresh_ts = (fresh_ts
                                  + self._fresh_ts)[:_FRESHNESS_SAMPLE_CAP]
                metrics.FOLDIN_FOLDS.inc(status="error")
                logger.exception(
                    "fold-in batch failed (serving continues from the "
                    "previous factors; batch retries next cadence)")

    def _patch(self, server, kept_ids: List[str],
               cols_list: List[np.ndarray],
               rows: np.ndarray) -> Tuple[int, int]:
        """Write the solved rows into the live store and publish the new
        users. Order is load-bearing: the store is patched (and grown)
        BEFORE new labels land in ``user_map``, so a racing predict
        never resolves an index the store does not hold. The whole
        read-assign-append runs under ``patch_lock`` so two consumers
        sharing one vocabulary assign each new user exactly one row."""
        model = self._model
        user_map = model.user_map
        with self._patch_lock:
            uidxs: List[int] = []
            new_labels: List[str] = []
            next_idx = len(user_map)
            for uid in kept_ids:
                idx = user_map.get(uid)
                if idx is None:
                    idx = next_idx
                    next_idx += 1
                    new_labels.append(uid)
                uidxs.append(int(idx))
            seen_updates = {
                uidx: np.unique(cols).astype(np.int64)
                for uidx, cols in zip(uidxs, cols_list)}
            server.patch_users(np.asarray(uidxs, dtype=np.int64), rows,
                               seen_items=seen_updates)
            seen = getattr(model, "seen", None)
            if isinstance(seen, dict):
                seen.update(seen_updates)
            if new_labels:
                user_map.append(new_labels)
        return len(kept_ids) - len(new_labels), len(new_labels)


class CompositeFoldInConsumer:
    """Fold-in for EVERY qualifying model of a multi-algorithm
    deployment: each target keeps its own
    :class:`FoldInConsumer` — its own cursor, its own solve lane, so
    the ALS half-step and a seqrec re-encode coexist, each patching its
    own (facet of the) device store — while this wrapper presents the
    QueryServer's one-consumer surface (start/stop/stats/stale)."""

    def __init__(self, consumers: List[FoldInConsumer]):
        if not consumers:
            raise ValueError(
                "CompositeFoldInConsumer needs at least one consumer")
        self._consumers = list(consumers)

    @property
    def consumers(self) -> List[FoldInConsumer]:
        return list(self._consumers)

    def start(self) -> "CompositeFoldInConsumer":
        started: List[FoldInConsumer] = []
        try:
            for c in self._consumers:
                c.start()
                started.append(c)
        except Exception:
            # start() raises at deploy (not first fold) — a half-
            # started composite must not leak tail threads
            for c in started:
                c.stop()
            raise
        return self

    def stop(self, timeout: float = 5.0) -> None:
        for c in self._consumers:
            c.stop(timeout=timeout)

    @property
    def stale(self) -> bool:
        return any(c.stale for c in self._consumers)

    def stats(self) -> Dict[str, Any]:
        per = [c.stats() for c in self._consumers]
        out = dict(per[0])
        for other in per[1:]:
            for key in ("folds", "foldErrors", "tailErrors",
                        "usersPatched", "newUsers", "eventsFolded",
                        "pendingEvents"):
                out[key] += other[key]
            out["stale"] = bool(out["stale"] or other["stale"])
            stamps = [t for t in (out["lastFoldAt"],
                                  other["lastFoldAt"]) if t]
            out["lastFoldAt"] = max(stamps) if stamps else None
        out["targets"] = per
        return out


def attach_foldin(deployment: Any,
                  interval: Optional[float] = None,
                  count_threshold: Optional[int] = None) -> Any:
    """Build the fold-in consumer(s) for a loaded deployment
    (``workflow.create_server.Deployment``): EVERY algorithm whose
    model exposes the ALS device-serving surface is a fold-in target
    (one algorithm on classic deployments; BOTH stages of a two-stage
    deployment, whose facets route the writes to their half of the
    fused store), its ``ALSParams`` or model-side ``fold_in_rows``
    hook is the solve, and the datasource params name the (app,
    channel, event names) to tail. Returns one
    :class:`FoldInConsumer`, or a :class:`CompositeFoldInConsumer`
    over several. Raises when no deployed algorithm qualifies, or when
    a qualifying one has no usable solve — ``--foldin on`` on an
    incompatible engine must fail at deploy, not silently no-op."""
    targets = [(i, model) for i, model in enumerate(deployment.models)
               if all(hasattr(model, a) for a in
                      ("user_map", "item_map", "device_server"))]
    if not targets:
        raise ValueError(
            "--foldin on: no deployed algorithm serves an ALS-style "
            "device model (user_map/item_map/device_server); online "
            "fold-in has nothing to patch")
    dsp = deployment.engine_params.data_source_params[1]
    app_name = getattr(dsp, "app_name", None)
    if not app_name:
        raise ValueError(
            "--foldin on: the datasource params carry no app_name; the "
            "fold-in consumer cannot resolve which event stream to tail")
    prep = deployment.engine_params.preparator_params[1]
    raw_max_len = getattr(prep, "max_len", None)
    kwargs: Dict[str, Any] = dict(
        app_name=app_name,
        channel_name=getattr(dsp, "channel_name", None),
        event_names=tuple(getattr(dsp, "event_names", ("rate",))),
        max_len=None if raw_max_len is None else int(raw_max_len))
    if interval is not None:
        kwargs["interval"] = float(interval)
    if count_threshold is not None:
        kwargs["count_threshold"] = int(count_threshold)
    config = FoldInConfig.from_env(**kwargs)
    consumers: List[FoldInConsumer] = []
    # one patch lock per DISTINCT user_map object: two-stage targets
    # share their vocabulary, and concurrent tails must not both
    # append the same new user to it
    locks: List[Tuple[Any, threading.Lock]] = []

    def _lock_for(user_map: Any) -> threading.Lock:
        for owner, lock in locks:
            if owner is user_map:
                return lock
        lock = threading.Lock()
        locks.append((user_map, lock))
        return lock

    for i, model in targets:
        _, aparams = deployment.engine_params.algorithm_params_list[i]
        has_hook = callable(getattr(model, "fold_in_rows", None))
        if not has_hook and not isinstance(aparams, ALSParams):
            # refuse rather than guess: the fold-in solve is the
            # training half-step, and hyperparameters inferred by
            # getattr-with-defaults could silently solve a DIFFERENT
            # objective than the one the deployed factors were trained
            # under. A model that carries its OWN solve (fold_in_rows
            # — e.g. the sequentialrec re-encode, whose
            # hyperparameters travel inside the model) needs no
            # ALSParams.
            raise ValueError(
                "--foldin on: the deployed algorithm's params "
                f"({type(aparams).__name__}) are not ALSParams and the "
                "model has no fold_in_rows hook, so the fold-in solve "
                "cannot take its hyperparameters from training; give "
                "the algorithm ALSParams (or a subclass), or a "
                "model-side fold_in_rows encoder, to enable online "
                "fold-in")
        consumers.append(FoldInConsumer(
            model, config,
            aparams if isinstance(aparams, ALSParams) else None,
            patch_lock=_lock_for(model.user_map)))
    if len(consumers) == 1:
        return consumers[0]
    return CompositeFoldInConsumer(consumers)


__all__ = ["CompositeFoldInConsumer", "FoldInConfig", "FoldInConsumer",
           "attach_foldin"]
