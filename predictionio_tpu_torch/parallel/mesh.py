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

A JAX array carries its sharding; here :class:`ShardedTensor` is the
same bookkeeping over torch tensors: the block each device of a mesh
holds, by a :class:`PartitionSpec` (JAX's, entry for entry: per
dimension an axis name, a tuple of names, or None for replicated).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

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


class PartitionSpec(tuple):
    """How an array's dimensions split over a mesh's axes (JAX's
    ``PartitionSpec``): per dimension an axis name, a tuple of names (the
    axes' devices taken in row-major order), or None (replicated)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


P = PartitionSpec


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes one entry of a spec splits over."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def row_part(mesh: Mesh, spec: Sequence, k: int) -> Tuple[int, int]:
    """``(part, n_parts)``: which of the equal row blocks of an array laid
    out by ``spec`` the ``k``-th device of ``mesh.device_list()`` holds
    (dimension 0 only; the others are never split here)."""
    axes = spec_axes(spec[0] if len(spec) else None)
    coords = np.unravel_index(k, mesh.devices.shape)
    shape = mesh.shape
    part, n_parts = 0, 1
    for name in axes:
        ax = mesh.axis_names.index(name)
        part = part * shape[name] + int(coords[ax])
        n_parts *= shape[name]
    return part, n_parts


class ShardedTensor:
    """A ``[rows, ...]`` array laid out over ``mesh`` by ``spec``:
    ``blocks[k]`` is the block the ``k``-th device of
    ``mesh.device_list()`` holds, on that device. Shards of one device
    that hold the same rows share one tensor (logical shards of one card
    hold no second copy). Rows split in equal blocks over the axes of
    ``spec[0]``. ``shape`` is the whole array's; with a process group, a
    spec over ``data`` spans the processes and this process holds rows
    ``[row_offset, row_offset + local_rows)`` (its
    :func:`~predictionio_tpu_torch.parallel.distributed.process_row_block`),
    every other spec the whole array. The counterpart of a JAX array
    sharded by a ``NamedSharding``."""

    def __init__(self, blocks: List[torch.Tensor], mesh: Mesh, spec,
                 shape: Tuple[int, ...], row_offset: int = 0,
                 local_rows: Optional[int] = None):
        self.blocks = list(blocks)
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)
        self.shape = tuple(int(d) for d in shape)
        self.row_offset = int(row_offset)
        self.local_rows = self.shape[0] if local_rows is None \
            else int(local_rows)

    @property
    def device(self) -> torch.device:
        """The first device of the mesh: where gathers land."""
        return self.blocks[0].device

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    def span(self, k: int) -> Tuple[int, int]:
        """The local rows ``[start, stop)`` device ``k`` holds."""
        part, n_parts = row_part(self.mesh, self.spec, k)
        rows = self.local_rows // n_parts
        return part * rows, (part + 1) * rows

    def block_bytes(self) -> List[int]:
        """Bytes each device's block holds, in device-list order."""
        return [b.numel() * b.element_size() for b in self.blocks]

    def gathered(self, k: int = 0) -> torch.Tensor:
        """This process's rows whole on device ``k``'s device: its own
        block when it holds them all, else the blocks of the devices that
        share its coordinates on the axes the rows do not split over
        (its ``model`` group, say), joined in row order. A transient
        copy, the all-gather a JAX program inserts before a gather by
        index."""
        part, n_parts = row_part(self.mesh, self.spec, k)
        if n_parts == 1:
            return self.blocks[k]
        dev = self.mesh.device_list()[k]
        split = set(spec_axes(self.spec[0]))
        coords = np.unravel_index(k, self.mesh.devices.shape)
        mine = {i: int(c) for i, (name, c) in enumerate(
            zip(self.mesh.axis_names, coords)) if name not in split}
        parts: Dict[int, torch.Tensor] = {}
        for j in range(self.mesh.size):
            cj = np.unravel_index(j, self.mesh.devices.shape)
            if all(int(cj[i]) == c for i, c in mine.items()):
                parts.setdefault(row_part(self.mesh, self.spec, j)[0],
                                 self.blocks[j])
        return torch.cat([parts[p].to(dev) for p in range(n_parts)])

    def all_finite(self) -> bool:
        """Every block finite: one device reduction a distinct block,
        one scalar to the host."""
        seen: Dict[int, Any] = {}
        for b in self.blocks:
            seen.setdefault(id(b), b)
        home = self.device
        ok = torch.stack([torch.isfinite(b).all().to(home)
                          for b in seen.values()]).all()
        return bool(ok.item())

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={self.shape}, spec={self.spec}, "
                f"dtype={self.dtype}, {self.mesh})")
