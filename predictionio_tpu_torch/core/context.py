"""Where a training or serving run computes.

The port's copy of ``predictionio_tpu/core/context.py``: the ``ctx``
handed to ``Engine.train`` and to the controllers names the device they
run on (``device``, None = cuda) and, for the code that shards work,
a logical mesh laid over ``devices`` (``mesh_shape`` / ``axis_names``;
``mesh`` builds a :class:`~predictionio_tpu_torch.parallel.mesh.Mesh`
once). ``mode`` tags the workflow: "train" | "eval" | "serving".
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch

from predictionio_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ComputeContext:
    """Devices and mesh handle passed to every DASE stage. Without
    explicit ``_devices`` the plane is ``device`` alone when one is
    named, else every visible card."""

    device: DeviceLike = None
    mode: str = "train"
    batch: str = ""
    mesh_shape: Optional[Tuple[int, ...]] = None
    axis_names: Tuple[str, ...] = ("data",)
    _devices: Optional[Sequence[Any]] = None
    _mesh: Any = dataclasses.field(default=None, init=False, compare=False,
                                   repr=False)

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        if self._devices is not None:
            return tuple(torch.device(d) for d in self._devices)
        if self.device is not None:
            return (resolve_device(self.device),)
        from predictionio_tpu_torch.parallel.mesh import default_devices

        devs = tuple(default_devices())
        if not devs:
            resolve_device(None)  # raises: no CUDA
        return devs

    @property
    def device_count(self) -> int:
        return len(self.devices)

    @property
    def mesh(self):
        """The :class:`~predictionio_tpu_torch.parallel.mesh.Mesh` of
        this context, built on first use and kept."""
        if self._mesh is None:
            import numpy as np

            from predictionio_tpu_torch.parallel.mesh import Mesh

            devs = np.empty(len(self.devices), dtype=object)
            devs[:] = self.devices
            shape = self.mesh_shape or (len(devs),)
            names = self.axis_names
            if len(shape) != len(names):
                names = tuple(f"axis{i}" for i in range(len(shape)))
            object.__setattr__(self, "_mesh",
                               Mesh(devs.reshape(shape), names))
        return self._mesh

    @property
    def serving_plane(self):
        """The mesh a deployment's served stores span
        (``PIO_SERVE_SHARDS`` shards over its devices) when this context
        was given its devices, else None: a store then spans every
        visible card, or its one CPU device."""
        return self.mesh if self._devices is not None else None

    def replace(self, **kw) -> "ComputeContext":
        return dataclasses.replace(self, **kw)

    def stop(self) -> None:
        """Drop the mesh handle (the devices are process-global: nothing
        else to free)."""
        object.__setattr__(self, "_mesh", None)


def workflow_context(mode: str = "train", batch: str = "",
                     mesh_shape: Optional[Tuple[int, ...]] = None,
                     axis_names: Tuple[str, ...] = ("data",),
                     devices: Optional[Sequence[Any]] = None,
                     device: DeviceLike = None) -> ComputeContext:
    """A :class:`ComputeContext` for one workflow (the reference's
    ``WorkflowContext.apply``)."""
    return ComputeContext(device=device, mode=mode, batch=batch,
                          mesh_shape=mesh_shape, axis_names=axis_names,
                          _devices=devices)
