"""FastEvalEngine — per-prefix memoization for hyper-parameter tuning.

The port's copy of ``predictionio_tpu/controller/fast_eval.py``.
Parity target: ``controller/FastEvalEngine.scala:50-342``. Exploits
controller immutability: when many EngineParams share a prefix
(datasource / +preparator / +algorithms / +serving params), each distinct
prefix computes once and later param sets reuse the cached result.

Faithful quirk kept from the reference: the algorithms stage batch-predicts
on the RAW queries — ``FastEvalEngine.scala:178`` maps out ``_._1`` with no
``supplementBase`` call (the algorithms prefix cannot see serving params),
unlike ``Engine.eval`` which supplements first.

Cache keys: the reference hashes Params case classes structurally
(``DataSourcePrefix`` etc., ``FastEvalEngine.scala:50-83``); here prefixes
are keyed by canonical JSON of the (name, params) pairs, so params classes
need not be hashable.
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.controller.engine import (
    Engine, EngineParams, params_to_dict,
)
from predictionio_tpu_torch.core.base import WorkflowParams


def _canonical(value: Any) -> Any:
    """Lossless JSON-able form for cache keys. numpy arrays hash by dtype +
    shape + raw bytes (repr would elide large arrays and collide); objects
    without a value-based form are rejected rather than silently keyed by
    identity."""
    import hashlib

    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    if isinstance(value, (list, tuple)):
        return [_canonical(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _canonical(v) for k, v in sorted(value.items())}
    if isinstance(value, bytes):
        return ["__bytes__", hashlib.sha256(value).hexdigest()]
    try:
        import numpy as np

        if isinstance(value, np.ndarray):
            return ["__ndarray__", str(value.dtype), list(value.shape),
                    hashlib.sha256(np.ascontiguousarray(value).tobytes())
                    .hexdigest()]
        if isinstance(value, np.generic):
            return value.item()
    except ImportError:
        pass
    raise TypeError(
        f"FastEvalEngine cannot derive a value-based cache key for params "
        f"field of type {type(value).__name__}; use plain "
        f"JSON-able values or numpy arrays in Params")


def _np_key(name_params: Tuple[str, Any]) -> str:
    name, params = name_params
    return json.dumps([name, _canonical(params_to_dict(params))],
                      sort_keys=True)


def _ds_key(ep: EngineParams) -> str:
    return _np_key(ep.data_source_params)


def _prep_key(ep: EngineParams) -> str:
    return _ds_key(ep) + "|" + _np_key(ep.preparator_params)


def _algo_key(ep: EngineParams) -> str:
    return (_prep_key(ep) + "|" +
            json.dumps([_np_key(np) for np in ep.algorithm_params_list]))


def _serving_key(ep: EngineParams) -> str:
    return _algo_key(ep) + "|" + _np_key(ep.serving_params)


_MISS = object()


class _LRUCache:
    """Thread-safe bounded LRU for prefix results. The reference keeps
    every prefix result alive for the whole sweep (mutable.Maps,
    FastEvalEngine.scala:295-298) — an unbounded model/dataset leak at
    scale; bounding to the last-used N prefixes
    keeps the memoization win for grouped grids while releasing old
    trained models to the GC."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._data: "OrderedDict[str, Any]" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key: str):
        with self._lock:
            val = self._data.get(key, _MISS)
            if val is not _MISS:
                self._data.move_to_end(key)
            return val

    def put(self, key: str, value: Any) -> None:
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._data


class FastEvalEngineWorkflow:
    """The four prefix caches (FastEvalEngineWorkflow, :295-298), bounded
    (LRU, ``cache_size`` entries per stage) and safe under the parallel
    param-set sweep: per-key locks serialize duplicate prefix work while
    distinct prefixes compute concurrently."""

    def __init__(self, engine: "FastEvalEngine", ctx: Any,
                 cache_size: int = 8):
        self.engine = engine
        self.ctx = ctx
        # key -> [(td, ei, [(qx, (q, a)), ...]), ...]   per eval set
        self.data_source_cache = _LRUCache(cache_size)
        # key -> [pd, ...] per eval set
        self.preparator_cache = _LRUCache(cache_size)
        # key -> [{qx: [p per algorithm]}, ...] per eval set
        self.algorithms_cache = _LRUCache(cache_size)
        # key -> [(ei, [(q, p, a), ...]), ...]
        self.serving_cache = _LRUCache(cache_size)
        self._key_locks: Dict[str, threading.Lock] = {}
        self._key_locks_lock = threading.Lock()

    def _memo(self, cache: _LRUCache, key: str, compute):
        """Compute-once-per-key memoization: callers racing on the SAME
        prefix serialize on its lock (one computes, the rest reuse);
        different prefixes proceed concurrently. The returned value is a
        local reference, so a later eviction cannot invalidate it."""
        val = cache.get(key)
        if val is not _MISS:
            return val
        with self._key_locks_lock:
            lock = self._key_locks.setdefault(key, threading.Lock())
        with lock:
            val = cache.get(key)
            if val is _MISS:
                val = compute()
                cache.put(key, val)
            return val

    def get_data_source_result(self, ep: EngineParams):
        def compute():
            name, params = ep.data_source_params
            ds = self.engine._make(self.engine.data_source_class_map, name,
                                   params, "datasource")
            return [
                (td, ei, list(enumerate(qa_pairs)))
                for td, ei, qa_pairs in ds.read_eval_base(self.ctx)
            ]
        return self._memo(self.data_source_cache, _ds_key(ep), compute)

    def get_preparator_result(self, ep: EngineParams):
        """-> (ds_result, pds): each downstream cache entry CARRIES the
        upstream realization it was computed from, so an eviction of the
        data-source entry can never pair a re-read (possibly stochastic)
        eval split with models/predictions built on the old one."""
        def compute():
            name, params = ep.preparator_params
            prep = self.engine._make(self.engine.preparator_class_map, name,
                                     params, "preparator")
            ds_result = self.get_data_source_result(ep)
            pds = [prep.prepare_base(self.ctx, td)
                   for td, _ei, _qas in ds_result]
            return ds_result, pds
        return self._memo(self.preparator_cache, _prep_key(ep), compute)

    def get_algorithms_result(self, ep: EngineParams):
        """-> (ds_result, per_eval) — ds_result is the realization the
        models were trained/predicted on (see get_preparator_result)."""
        def compute():
            algorithms = self.engine._algorithms(ep)
            ds_result, pds = self.get_preparator_result(ep)
            per_eval: List[Dict[int, List[Any]]] = []
            for pd, (_td, _ei, indexed_qas) in zip(pds, ds_result):
                models = [a.train_base(self.ctx, pd) for a in algorithms]
                queries = [(qx, q) for qx, (q, _a) in indexed_qas]
                by_qx: Dict[int, Dict[int, Any]] = {}
                for ax, (algo, model) in enumerate(zip(algorithms, models)):
                    for qx, p in algo.batch_predict_base(
                            self.ctx, model, queries):
                        by_qx.setdefault(qx, {})[ax] = p
                for qx, ps in by_qx.items():
                    if len(ps) != len(algorithms):
                        raise RuntimeError(
                            f"query {qx}: got predictions from "
                            f"{sorted(ps)} but expected all "
                            f"{len(algorithms)} algorithms")
                per_eval.append({
                    qx: [ps[ax] for ax in range(len(algorithms))]
                    for qx, ps in by_qx.items()
                })
            return ds_result, per_eval
        return self._memo(self.algorithms_cache, _algo_key(ep), compute)

    def get_serving_result(self, ep: EngineParams):
        def compute():
            name, params = ep.serving_params
            serving = self.engine._make(self.engine.serving_class_map, name,
                                        params, "serving")
            # zip predictions with the SAME ds realization they were
            # computed from (carried in the algorithms entry), never a
            # fresh re-read
            ds_result, predicts = self.get_algorithms_result(ep)
            result: List[Tuple[Any, List]] = []
            for ps_map, (_td, ei, indexed_qas) in zip(predicts, ds_result):
                missing = [qx for qx, _qa in indexed_qas if qx not in ps_map]
                if missing:
                    raise RuntimeError(
                        f"queries {missing} got no predictions from any "
                        f"algorithm")
                qpa = [(q, serving.serve_base(q, ps_map[qx]), a)
                       for qx, (q, a) in indexed_qas]
                result.append((ei, qpa))
            return result
        return self._memo(self.serving_cache, _serving_key(ep), compute)

    def get(self, engine_params_list: Sequence[EngineParams],
            workers: int = 1):
        """Evaluate every params set; with ``workers > 1`` distinct
        prefixes run concurrently (FastEvalEngine.scala:176's `.par`)
        while shared prefixes still compute exactly once."""
        from predictionio_tpu_torch.utils.concurrency import parallel_map

        return parallel_map(
            lambda ep: (ep, self.get_serving_result(ep)),
            engine_params_list, workers)


class FastEvalEngine(Engine):
    """Engine whose batch_eval memoizes shared prefixes
    (FastEvalEngine.scala:306-342), with bounded caches and a
    thread-parallel sweep (``WorkflowParams.eval_parallelism``)."""

    cache_size: int = 8

    def eval(self, ctx: Any, engine_params: EngineParams,
             params: Optional[WorkflowParams] = None):
        return self.batch_eval(ctx, [engine_params], params)[0][1]

    def batch_eval(self, ctx: Any,
                   engine_params_list: Sequence[EngineParams],
                   params: Optional[WorkflowParams] = None):
        from predictionio_tpu_torch.utils.concurrency import eval_workers

        wp = params or WorkflowParams()
        workflow = FastEvalEngineWorkflow(self, ctx,
                                          cache_size=self.cache_size)
        return workflow.get(
            list(engine_params_list),
            workers=eval_workers(wp.eval_parallelism,
                                 len(engine_params_list)))
