"""Mesh construction helpers and work-partition index math.

The port's copy of ``predictionio_tpu/parallel/mesh.py``. A JAX mesh is
an array of devices with named axes, and XLA lays collectives over it;
here :class:`Mesh` is the same bookkeeping over ``torch.device``s (a
numpy object array plus axis names), and the code that shards work over
it launches per device itself. Axis convention: ``data`` shards rows,
``model`` shards factor dimensions.

A device list may name one device several times: a mesh of four logical
shards on one card (``[cuda:0] * 4``) or on the CPU (``["cpu"] * 4``)
runs each shard's work as its own launch on that device. It is the
port's counterpart of the JAX package's forced host device count.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """``devices``: a numpy object array of ``torch.device``s, one axis
    per name in ``axis_names``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(devices), dtype=object)
        for ix, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            arr[ix] = torch.device(d)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-D devices for axes "
                             f"{tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_list(self) -> List[torch.device]:
        """The devices in row-major order."""
        return list(self.devices.flat)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.device_list()})"


def default_devices() -> List[torch.device]:
    """The device plane when none is given: every visible card,
    ``cuda:0`` .. ``cuda:{count-1}`` (none without CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _device_list(devices: Optional[Sequence]) -> List[torch.device]:
    return [torch.device(d) for d in devices] if devices is not None \
        else default_devices()


def shard_spans(n: int, parts: int) -> List[Tuple[int, int]]:
    """Split ``range(n)`` into at most ``parts`` balanced contiguous
    ``(start, stop)`` spans, never an empty one. ``pio batchpredict``'s
    ``--query-partitions`` chunker uses it."""
    if n <= 0:
        return []
    parts = max(1, min(int(parts), n))
    base, rem = divmod(n, parts)
    spans: List[Tuple[int, int]] = []
    start = 0
    for i in range(parts):
        stop = start + base + (1 if i < rem else 0)
        spans.append((start, stop))
        start = stop
    return spans


def data_parallel_mesh(n_devices: Optional[int] = None,
                       devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices, axis name 'data'."""
    devs = _device_list(devices)
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs, dtype=object), ("data",))


def mesh_2d(data: int, model: int,
            devices: Optional[Sequence] = None) -> Mesh:
    """2-D (data x model) mesh for model-parallel factor sharding."""
    devs = _device_list(devices)
    need = data * model
    if len(devs) < need:
        raise ValueError(f"need {need} devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:need], dtype=object).reshape(data, model),
                ("data", "model"))
