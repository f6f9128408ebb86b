"""PersistentModel: models that save and load themselves.

The port's copy of ``predictionio_tpu/controller/persistent.py``. A
model that cannot be pickled implements ``save``; the stored manifest
names its class as ``module:Class``, and :func:`load_persistent_model`
calls that class's ``load`` at deploy. A manifest naming a module of
the JAX package is refused: the port never imports it.
"""

from __future__ import annotations

import abc
import importlib
from typing import Any, Optional

from predictionio_tpu_torch.core.base import Params, PersistentModelManifest


class PersistentModel(abc.ABC):
    """Implement both methods; ``save`` returning False means "do not
    persist, retrain at deploy"."""

    @abc.abstractmethod
    def save(self, model_id: str, params: Params,
             ctx: Optional[Any] = None) -> bool: ...

    @classmethod
    @abc.abstractmethod
    def load(cls, model_id: str, params: Params,
             ctx: Optional[Any] = None) -> "PersistentModel": ...


def class_path(obj: Any) -> str:
    cls = obj if isinstance(obj, type) else type(obj)
    return f"{cls.__module__}:{cls.__qualname__}"


def manifest_for(model: PersistentModel) -> PersistentModelManifest:
    return PersistentModelManifest(class_path=class_path(model))


def is_jax_package_module(module: str) -> bool:
    """A module of the JAX package (``predictionio_tpu`` and below), which
    the port must not import."""
    return module == "predictionio_tpu" or module.startswith(
        "predictionio_tpu.")


def load_persistent_model(manifest: PersistentModelManifest, model_id: str,
                          params: Params, ctx: Optional[Any] = None) -> Any:
    """Resolve the manifest's class and ``load`` the model."""
    mod_name, _, cls_name = manifest.class_path.partition(":")
    if is_jax_package_module(mod_name):
        raise TypeError(
            f"{manifest.class_path} belongs to the JAX package; the port "
            "loads only its own model classes")
    cls: Any = importlib.import_module(mod_name)
    for part in cls_name.split("."):
        cls = getattr(cls, part)
    if not (isinstance(cls, type) and issubclass(cls, PersistentModel)):
        raise TypeError(
            f"{manifest.class_path} is not a PersistentModel subclass")
    return cls.load(model_id, params, ctx)
