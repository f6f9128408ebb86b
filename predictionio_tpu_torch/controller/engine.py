"""Engine and EngineParams, the subset that builds a deployment.

The port's copy of ``predictionio_tpu/controller/engine.py`` for
serving: name -> class maps for the algorithms and the serving, typed
params from engine.json blocks, and the variant -> ``EngineParams``
step. The data-source and preparator stages (and so the ``datasource``
and ``preparator`` sections of a variant) come with the slices that
port storage and training; a variant's other sections are not read
here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping, Optional, Sequence, Tuple

from predictionio_tpu_torch.core.base import (
    BaseAlgorithm,
    Doer,
    EmptyParams,
    Params,
)


class EngineConfigError(ValueError):
    """Bad engine wiring or variant params."""


def _snake_name(name: str) -> str:
    return "".join("_" + c.lower() if c.isupper() else c for c in name)


@dataclasses.dataclass
class EngineParams:
    """The serving half of one engine parameterization: (name, params)
    per algorithm, and the serving's (name, params)."""

    algorithm_params_list: Sequence[Tuple[str, Params]] = (("", EmptyParams()),)
    serving_params: Tuple[str, Params] = ("", EmptyParams())


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


def _named_block(block: Any, where: str) -> Tuple[str, Mapping[str, Any]]:
    """``{"name": ..., "params": {...}}`` or bare ``{...}`` params for
    the default ("") controller."""
    if not isinstance(block, Mapping):
        raise EngineConfigError(f"{where}: expected an object, got {block!r}")
    if "name" in block or "params" in block:
        return block.get("name", ""), block.get("params", {})
    return "", block


class Engine:
    """Name -> class maps for the algorithms and the serving."""

    def __init__(self, algorithm_class_map: Mapping[str, type],
                 serving_class_map: Mapping[str, type]):
        self.algorithm_class_map = dict(algorithm_class_map)
        self.serving_class_map = dict(serving_class_map)

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

    def engine_params_from_variant(
            self, variant: Mapping[str, Any]) -> EngineParams:
        """The ``algorithms`` and ``serving`` sections of an engine.json
        variant as EngineParams; an absent section means the default
        ("") controller with EmptyParams."""
        serving: Tuple[str, Params] = ("", EmptyParams())
        if variant.get("serving") is not None:
            name, data = _named_block(variant["serving"], "serving")
            if name not in self.serving_class_map:
                raise EngineConfigError(
                    f"serving: controller named {name!r} not registered; "
                    f"known: {sorted(self.serving_class_map)}")
            serving = (name, params_from_dict(
                getattr(self.serving_class_map[name], "params_class", None),
                data, where=f"serving[{name!r}]"))
        algo_blocks = variant.get("algorithms")
        if algo_blocks is None:
            algos: List[Tuple[str, Params]] = [("", EmptyParams())]
        else:
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
        return EngineParams(algorithm_params_list=algos,
                            serving_params=serving)


__all__ = ["Engine", "EngineConfigError", "EngineParams", "params_from_dict"]
