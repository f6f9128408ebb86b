"""Engine, EngineParams and the train and eval dataflows.

The port's copy of ``predictionio_tpu/controller/engine.py``: name ->
class maps for the four DASE stages, typed params from engine.json
blocks, the variant -> ``EngineParams`` step, ``Engine.train`` /
``train_pipeline`` (read -> prepare -> train each algorithm, with the
sanity checks and stop-after interruptions; each model in its stored
form), ``Engine.prepare_deploy`` (stored forms -> models to serve), and
``Engine.eval`` / ``batch_eval`` / ``eval_pipeline`` (each eval set:
prepare, train, batch-predict, serve; param sets thread-parallel) with
``expand_engine_params`` (one full EngineParams per swept algorithm
Params, the tuning grid's rows).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from predictionio_tpu_torch.core.base import (
    RETRAIN,
    BaseAlgorithm,
    BaseDataSource,
    BasePreparator,
    Doer,
    EmptyParams,
    Params,
    PersistentModelManifest,
    StopAfterPrepareInterruption,
    StopAfterReadInterruption,
    WorkflowParams,
    run_sanity_check,
)
from predictionio_tpu_torch.utils import metrics
from predictionio_tpu_torch.utils.tracing import span


def _stage_span(stage: str):
    """One DASE stage: an INFO span (request-id tagged) feeding the
    ``pio_train_stage_seconds{stage=...}`` histogram."""
    return span(f"dase.{stage}", level=logging.INFO,
                histogram=metrics.TRAIN_STAGE_LATENCY.child(stage=stage)
                if metrics.REGISTRY.enabled else None)


class EngineConfigError(ValueError):
    """Bad engine wiring or variant params."""


def _snake_name(name: str) -> str:
    return "".join("_" + c.lower() if c.isupper() else c for c in name)


@dataclasses.dataclass
class EngineParams:
    """One engine parameterization: (name, params) for the data source,
    the preparator, each algorithm and the serving."""

    data_source_params: Tuple[str, Params] = ("", EmptyParams())
    preparator_params: Tuple[str, Params] = ("", EmptyParams())
    algorithm_params_list: Sequence[Tuple[str, Params]] = (("", EmptyParams()),)
    serving_params: Tuple[str, Params] = ("", EmptyParams())

    def replace(self, **kw) -> "EngineParams":
        return dataclasses.replace(self, **kw)


def params_from_dict(params_cls: Optional[type],
                     data: Optional[Mapping[str, Any]],
                     where: str = "") -> Params:
    """Build a dataclass Params from a JSON object with explicit errors.
    engine.json's camelCase keys ("numIterations") and raw keywords
    ("lambda") map onto snake_case / escaped fields."""
    data = dict(data or {})
    if params_cls is None:
        if data:
            raise EngineConfigError(
                f"{where}: params given but controller declares no "
                f"params_class: {sorted(data)}")
        return EmptyParams()
    if not dataclasses.is_dataclass(params_cls):
        raise EngineConfigError(
            f"{where}: params_class {params_cls.__name__} must be a dataclass")
    fields = {f.name: f for f in dataclasses.fields(params_cls)}
    for key in list(data):
        if key in fields:
            continue
        for alt in (_snake_name(key), key + "_", _snake_name(key) + "_"):
            if alt in fields and alt not in data:
                data[alt] = data.pop(key)
                break
    unknown = sorted(set(data) - set(fields))
    if unknown:
        raise EngineConfigError(
            f"{where}: unknown param(s) {unknown} for "
            f"{params_cls.__name__}; valid: {sorted(fields)}")
    missing = [n for n, f in fields.items()
               if n not in data and f.default is dataclasses.MISSING
               and f.default_factory is dataclasses.MISSING]
    if missing:
        raise EngineConfigError(
            f"{where}: missing required param(s) {missing} for "
            f"{params_cls.__name__}")
    try:
        return params_cls(**data)
    except (TypeError, ValueError) as e:
        raise EngineConfigError(
            f"{where}: cannot construct {params_cls.__name__}: {e}") from e


def params_to_dict(params: Params) -> Dict[str, Any]:
    if dataclasses.is_dataclass(params):
        return dataclasses.asdict(params)
    return dict(getattr(params, "__dict__", {}))


def expand_engine_params(base: EngineParams, algo_name: str,
                         variants: Sequence[Params]) -> List[EngineParams]:
    """One full EngineParams per swept algorithm Params: every other
    stage is ``base``'s, only the named algorithm's params vary. The
    grid tuner (``pio eval --grid``) pins each leaderboard row, and the
    winner, to a complete, trainable parameterization this way."""
    return [base.replace(algorithm_params_list=[(algo_name, p)])
            for p in variants]


def _named_block(block: Any, where: str) -> Tuple[str, Mapping[str, Any]]:
    """``{"name": ..., "params": {...}}`` or bare ``{...}`` params for
    the default ("") controller."""
    if not isinstance(block, Mapping):
        raise EngineConfigError(f"{where}: expected an object, got {block!r}")
    if "name" in block or "params" in block:
        return block.get("name", ""), block.get("params", {})
    return "", block


class Engine:
    """Name -> class maps for the data source, the preparator, the
    algorithms and the serving; a bare class means ``{"": cls}``."""

    def __init__(self, data_source_class_map: Any, preparator_class_map: Any,
                 algorithm_class_map: Mapping[str, type],
                 serving_class_map: Any):
        def one_or_map(x) -> Dict[str, type]:
            return dict(x) if isinstance(x, Mapping) else {"": x}

        self.data_source_class_map = one_or_map(data_source_class_map)
        self.preparator_class_map = one_or_map(preparator_class_map)
        self.algorithm_class_map = dict(algorithm_class_map)
        self.serving_class_map = one_or_map(serving_class_map)

    def _make(self, class_map: Mapping[str, type], name: str,
              params: Params, stage: str) -> Any:
        if name not in class_map:
            raise EngineConfigError(
                f"{stage}: controller named {name!r} not registered; "
                f"known: {sorted(class_map)}")
        return Doer(class_map[name], params)

    def _algorithms(self, engine_params: EngineParams) -> List[BaseAlgorithm]:
        algo_params_list = list(engine_params.algorithm_params_list)
        if not algo_params_list:
            raise EngineConfigError(
                "EngineParams.algorithm_params_list must have at least "
                "1 element.")
        return [self._make(self.algorithm_class_map, name, params,
                           f"algorithms[{i}]")
                for i, (name, params) in enumerate(algo_params_list)]

    def _serving(self, engine_params: EngineParams) -> Any:
        name, params = engine_params.serving_params
        return self._make(self.serving_class_map, name, params, "serving")

    def _data_source_and_preparator(self, engine_params: EngineParams
                                    ) -> Tuple[Any, Any]:
        ds_name, ds_params = engine_params.data_source_params
        prep_name, prep_params = engine_params.preparator_params
        return (self._make(self.data_source_class_map, ds_name, ds_params,
                           "datasource"),
                self._make(self.preparator_class_map, prep_name,
                           prep_params, "preparator"))

    def train(self, ctx: Any, engine_params: EngineParams,
              params: Optional[WorkflowParams] = None,
              engine_instance_id: str = "") -> List[Any]:
        """Run the train dataflow and return one model per algorithm in
        its stored form (``make_persistent_model``: the model itself for
        the template's ALS). ``ctx`` names the device (a
        :class:`~predictionio_tpu_torch.core.context.ComputeContext`;
        None = cuda)."""
        data_source, preparator = self._data_source_and_preparator(
            engine_params)
        algorithms = self._algorithms(engine_params)
        models = train_pipeline(ctx, data_source, preparator, algorithms,
                                params or WorkflowParams())
        return [
            algo.make_persistent_model(
                ctx, model_id=f"{engine_instance_id}-{ax}-{name}",
                algo_params=algo_params, model=model)
            for ax, ((name, algo_params), algo, model) in enumerate(
                zip(engine_params.algorithm_params_list, algorithms,
                    models))]

    def eval(self, ctx: Any, engine_params: EngineParams,
             params: Optional[WorkflowParams] = None
             ) -> List[Tuple[Any, List[Tuple[Any, Any, Any]]]]:
        """The eval dataflow for one param set: ``[(EI, [(Q, P, A),
        ...]), ...]``, one entry per eval set the data source reads."""
        data_source, preparator = self._data_source_and_preparator(
            engine_params)
        return eval_pipeline(ctx, data_source, preparator,
                             self._algorithms(engine_params),
                             self._serving(engine_params))

    def batch_eval(self, ctx: Any, engine_params_list: Sequence[EngineParams],
                   params: Optional[WorkflowParams] = None
                   ) -> List[Tuple[EngineParams,
                                   List[Tuple[Any, List[Tuple[Any, Any, Any]]]]]]:
        """Evaluate every param set, thread-parallel: param sets are
        independent full evals, so threads overlap the host work and keep
        the card's queue fed. ``WorkflowParams.eval_parallelism`` sets
        the width (1 = serial)."""
        from predictionio_tpu_torch.utils.concurrency import (
            eval_workers,
            parallel_map,
        )

        wp = params or WorkflowParams()
        workers = eval_workers(wp.eval_parallelism, len(engine_params_list))
        return parallel_map(lambda ep: (ep, self.eval(ctx, ep, params)),
                            engine_params_list, workers)

    def prepare_deploy(self, ctx: Any, engine_params: EngineParams,
                       engine_instance_id: str,
                       persisted_models: Sequence[Any]) -> List[Any]:
        """Models to serve from their stored forms: ``RETRAIN`` entries
        are trained again from the data source, manifests load through
        their class, stored models pass through."""
        from predictionio_tpu_torch.controller.persistent import (
            load_persistent_model,
        )

        algorithms = self._algorithms(engine_params)
        persisted = list(persisted_models)
        if len(persisted) != len(algorithms):
            raise EngineConfigError(
                f"{len(persisted)} persisted models for "
                f"{len(algorithms)} algorithms")
        if any(m is RETRAIN for m in persisted):
            data_source, preparator = self._data_source_and_preparator(
                engine_params)
            pd = preparator.prepare_base(
                ctx, data_source.read_training_base(ctx))
            persisted = [algo.train_base(ctx, pd) if m is RETRAIN else m
                         for algo, m in zip(algorithms, persisted)]
        return [
            load_persistent_model(m, f"{engine_instance_id}-{ax}-{name}",
                                  algo_params, ctx)
            if isinstance(m, PersistentModelManifest) else m
            for ax, (m, (name, algo_params)) in enumerate(
                zip(persisted, engine_params.algorithm_params_list))]

    def engine_params_from_variant(
            self, variant: Mapping[str, Any]) -> EngineParams:
        """A variant's ``datasource``, ``preparator``, ``algorithms`` and
        ``serving`` sections as EngineParams; an absent section means the
        default ("") controller with EmptyParams."""
        return EngineParams(
            data_source_params=_stage(variant, "datasource",
                                      self.data_source_class_map),
            preparator_params=_stage(variant, "preparator",
                                     self.preparator_class_map),
            algorithm_params_list=self._algorithm_params(variant),
            serving_params=_stage(variant, "serving",
                                  self.serving_class_map))

    def _algorithm_params(self, variant: Mapping[str, Any]
                          ) -> List[Tuple[str, Params]]:
        algo_blocks = variant.get("algorithms")
        if algo_blocks is None:
            return [("", EmptyParams())]
        if not isinstance(algo_blocks, Sequence):
            raise EngineConfigError("'algorithms' must be a list")
        algos = []
        for i, block in enumerate(algo_blocks):
            name, data = _named_block(block, f"algorithms[{i}]")
            if name not in self.algorithm_class_map:
                raise EngineConfigError(
                    f"algorithms[{i}]: {name!r} not registered; known: "
                    f"{sorted(self.algorithm_class_map)}")
            cls = self.algorithm_class_map[name]
            algos.append((name, params_from_dict(
                getattr(cls, "params_class", None), data,
                where=f"algorithms[{i}][{name!r}]")))
        return algos


class SimpleEngine(Engine):
    """One data source and one algorithm: the identity preparator and
    first-serving."""

    def __init__(self, data_source_class: type, algorithm_class: type):
        from predictionio_tpu_torch.controller.controllers import (
            IdentityPreparator,
            LFirstServing,
        )

        super().__init__(data_source_class, IdentityPreparator,
                         {"": algorithm_class}, LFirstServing)


def _stage(variant: Mapping[str, Any], field: str,
           class_map: Mapping[str, type]) -> Tuple[str, Params]:
    """One stage's (name, params) from its variant section."""
    if variant.get(field) is None:
        return "", EmptyParams()
    name, data = _named_block(variant[field], field)
    if name not in class_map:
        raise EngineConfigError(
            f"{field}: controller named {name!r} not registered; "
            f"known: {sorted(class_map)}")
    return name, params_from_dict(
        getattr(class_map[name], "params_class", None), data,
        where=f"{field}[{name!r}]")


def train_pipeline(ctx: Any, data_source: BaseDataSource,
                   preparator: BasePreparator,
                   algorithms: Sequence[BaseAlgorithm],
                   params: WorkflowParams) -> List[Any]:
    """The train dataflow: read -> sanity -> [stop after read] ->
    prepare -> sanity -> [stop after prepare] -> train each algorithm
    -> sanity each model. Each stage is a ``dase.*`` span timed into
    ``pio_train_stage_seconds``."""
    with _stage_span("read"):
        td = data_source.read_training_base(ctx)
    if not params.skip_sanity_check:
        run_sanity_check(td)
    if params.stop_after_read:
        raise StopAfterReadInterruption(
            "Stopping after read (stop_after_read)")
    with _stage_span("prepare"):
        pd = preparator.prepare_base(ctx, td)
    if not params.skip_sanity_check:
        run_sanity_check(pd)
    if params.stop_after_prepare:
        raise StopAfterPrepareInterruption(
            "Stopping after prepare (stop_after_prepare)")
    with _stage_span("train"):
        models = [algo.train_base(ctx, pd) for algo in algorithms]
    if not params.skip_sanity_check:
        for m in models:
            run_sanity_check(m)
    return models


def eval_pipeline(ctx: Any, data_source: BaseDataSource,
                  preparator: BasePreparator,
                  algorithms: Sequence[BaseAlgorithm], serving: Any
                  ) -> List[Tuple[Any, List[Tuple[Any, Any, Any]]]]:
    """The eval dataflow (a ``dase.eval`` span): for each eval set,
    prepare, train every algorithm, supplement the queries,
    batch-predict per algorithm, regroup per query in algorithm order,
    and serve with the original (unsupplemented) query, the reference's
    join."""
    with _stage_span("eval"):
        out: List[Tuple[Any, List[Tuple[Any, Any, Any]]]] = []
        for td, eval_info, qa_pairs in data_source.read_eval_base(ctx):
            indexed_qas = list(enumerate(qa_pairs))
            pd = preparator.prepare_base(ctx, td)
            models = [algo.train_base(ctx, pd) for algo in algorithms]
            supplemented = [(qx, serving.supplement_base(q))
                            for qx, (q, _a) in indexed_qas]
            # per-algorithm predictions keyed by query index
            predictions: Dict[int, Dict[int, Any]] = {}
            for ax, (algo, model) in enumerate(zip(algorithms, models)):
                for qx, p in algo.batch_predict_base(ctx, model,
                                                     supplemented):
                    predictions.setdefault(qx, {})[ax] = p
            qpa: List[Tuple[Any, Any, Any]] = []
            for qx, (q, a) in indexed_qas:
                ps_by_ax = predictions.get(qx, {})
                if len(ps_by_ax) != len(algorithms):
                    raise RuntimeError(
                        f"query {qx}: got predictions from "
                        f"{sorted(ps_by_ax)} but expected all "
                        f"{len(algorithms)} algorithms")
                ps = [ps_by_ax[ax] for ax in range(len(algorithms))]
                qpa.append((q, serving.serve_base(q, ps), a))
            out.append((eval_info, qpa))
        return out


__all__ = ["Engine", "EngineConfigError", "EngineParams", "eval_pipeline",
           "expand_engine_params", "params_from_dict", "params_to_dict",
           "train_pipeline"]
