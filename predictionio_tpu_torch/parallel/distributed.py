"""Multi-host runtime: the process group.

The port's copy of ``predictionio_tpu/parallel/distributed.py`` on
``torch.distributed``. Every host runs the same ``pio train ...
--num-hosts K --coordinator HOST:PORT --process-id i`` command;
:func:`initialize` joins them into one process group, with the
coordinator as its ``tcp://`` rendezvous, NCCL when this process has a
card and gloo otherwise. One process is the
degenerate case: with ``num_hosts <= 1`` and no coordinator,
:func:`initialize` does nothing and every helper below answers for a
world of one.

Each host reads only its own contiguous block of training rows
(:func:`process_row_block`). A torch process holds its local devices:
:func:`host_aware_mesh` lays this process's devices out, and a
collective between processes goes through the process group.
:func:`make_global_array` places this host's block over its mesh as a
:class:`~predictionio_tpu_torch.parallel.mesh.ShardedTensor`, and
:func:`process_allgather` joins every host's rows (the JAX package's
``multihost_utils.process_allgather``); :func:`all_gather_rows` and
:func:`all_reduce_sum` are the two merges the sharded trainers run
through the group.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import numpy as np

_INITIALIZED = False


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    """Topology flags (CLI ``--coordinator/--num-hosts/--process-id`` or
    the ``PIO_COORDINATOR/PIO_NUM_HOSTS/PIO_PROCESS_ID`` env)."""

    coordinator: Optional[str] = None     # "host:port"
    num_hosts: int = 1
    process_id: Optional[int] = None
    local_device_ids: Optional[Tuple[int, ...]] = None

    @classmethod
    def from_env(cls) -> "DistributedConfig":
        ids = os.environ.get("PIO_LOCAL_DEVICE_IDS")
        return cls(
            coordinator=os.environ.get("PIO_COORDINATOR") or None,
            num_hosts=int(os.environ.get("PIO_NUM_HOSTS", "1")),
            process_id=(int(os.environ["PIO_PROCESS_ID"])
                        if "PIO_PROCESS_ID" in os.environ else None),
            local_device_ids=(tuple(int(x) for x in ids.split(","))
                              if ids else None),
        )

    @classmethod
    def from_args(cls, args) -> "DistributedConfig":
        """Build from argparse flags, falling back to the env scheme."""
        env = cls.from_env()
        return cls(
            coordinator=getattr(args, "coordinator", None) or env.coordinator,
            num_hosts=(getattr(args, "num_hosts", None) or env.num_hosts),
            process_id=(getattr(args, "process_id", None)
                        if getattr(args, "process_id", None) is not None
                        else env.process_id),
            local_device_ids=env.local_device_ids,
        )

    @property
    def is_multi_host(self) -> bool:
        return self.num_hosts > 1 or self.coordinator is not None


def initialize(config: Optional[DistributedConfig] = None) -> bool:
    """Join this process to the process group.

    One process (``num_hosts <= 1``, no coordinator): nothing to do,
    returns False. Otherwise ``torch.distributed.init_process_group``
    (once per process) with ``init_method="tcp://<coordinator>"``,
    ``world_size=num_hosts`` and ``rank=process_id``; returns True. With
    NCCL, the process's card is ``local_device_ids[0]`` when given."""
    global _INITIALIZED
    config = config or DistributedConfig.from_env()
    if not config.is_multi_host:
        return False
    if _INITIALIZED:
        return True
    if not config.coordinator:
        raise ValueError("--coordinator HOST:PORT is required when "
                         "--num-hosts > 1")
    if config.process_id is None:
        raise ValueError("--process-id is required when --num-hosts > 1 "
                         "(0..num_hosts-1, unique per host)")

    import torch
    import torch.distributed as dist

    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device((config.local_device_ids or (0,))[0])
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{config.coordinator}",
        world_size=int(config.num_hosts), rank=int(config.process_id))
    _INITIALIZED = True
    return True


def shutdown() -> None:
    """Leave the process group (tests, clean exit)."""
    global _INITIALIZED
    if _INITIALIZED:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        _INITIALIZED = False


def group_initialized() -> bool:
    """Whether a process group exists, this module's or one set up
    outside it. Imports nothing new in the plain one-process case."""
    import sys

    dist = sys.modules.get("torch.distributed")
    return bool(dist is not None and dist.is_available()
                and dist.is_initialized())


def is_primary_host() -> bool:
    """True on the host that owns metadata and model persistence (rank
    0, the reference's coordinating Spark process), and in one
    process."""
    return process_index() == 0


def process_count() -> int:
    if not group_initialized():
        return 1
    import torch.distributed as dist

    return dist.get_world_size()


def process_index() -> int:
    if not group_initialized():
        return 0
    import torch.distributed as dist

    return dist.get_rank()


def host_aware_mesh(model: int = 1, devices: Optional[Sequence] = None):
    """A (data x model) mesh of this process's devices (None = every
    visible card), whose ``model`` groups never cross a host: with one
    device plane per process they cannot. With ``model == 1`` it is the
    1-D ``data`` mesh."""
    import torch

    from predictionio_tpu_torch.parallel.mesh import Mesh, default_devices

    devs = [torch.device(d) for d in devices] if devices is not None \
        else default_devices()
    if model <= 0 or len(devs) % model:
        raise ValueError(
            f"model axis {model} must divide device count {len(devs)}")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    arr = arr.reshape(len(devs) // model, model)
    if model == 1:
        return Mesh(arr[:, 0], ("data",))
    return Mesh(arr, ("data", "model"))


def process_row_block(n_rows: int,
                      index: Optional[int] = None,
                      count: Optional[int] = None) -> Tuple[int, int]:
    """The contiguous ``[start, stop)`` block of rows this host ingests.
    Blocks are balanced to within one row; every row belongs to exactly
    one host."""
    if index is None:
        index = process_index()
    if count is None:
        count = process_count()
    if not 0 <= index < count:
        raise ValueError(f"process index {index} not in [0, {count})")
    base, extra = divmod(n_rows, count)
    start = index * base + min(index, extra)
    stop = start + base + (1 if index < extra else 0)
    return start, stop


def make_global_array(mesh, spec, local_block):
    """One array over ``mesh`` by ``spec`` from this host's block (the
    JAX package's ``make_array_from_process_local_data``): a
    :class:`~predictionio_tpu_torch.parallel.mesh.ShardedTensor` whose
    device ``k`` holds its rows of ``local_block`` (numpy or a tensor on
    any device; a tensor moves device to device, never through host
    numpy). With a process group of several processes and a spec whose
    rows split over ``data``, ``local_block`` is this host's
    :func:`process_row_block` of an array of ``count`` equal blocks;
    every other spec takes the whole array on each host. Devices that
    hold the same rows share one copy."""
    import torch

    from predictionio_tpu_torch.parallel.mesh import (
        ShardedTensor,
        row_part,
        spec_axes,
    )

    t = local_block if isinstance(local_block, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(local_block))
    n_local = int(t.shape[0])
    count = process_count() if "data" in spec_axes(spec[0]) else 1
    blocks, placed = [], {}
    for k, dev in enumerate(mesh.device_list()):
        part, n_parts = row_part(mesh, spec, k)
        if n_local % n_parts:
            raise ValueError(f"{n_local} rows do not split in {n_parts} "
                             f"equal blocks over {spec}")
        rows = n_local // n_parts
        key = (dev, part)
        if key not in placed:
            block = t[part * rows:(part + 1) * rows]
            placed[key] = block.to(dev).contiguous()
        blocks.append(placed[key])
    return ShardedTensor(blocks, mesh, spec,
                         (n_local * count,) + tuple(t.shape[1:]),
                         row_offset=process_index() * n_local
                         if count > 1 else 0,
                         local_rows=n_local)


def process_allgather(x):
    """Every host's rows of ``x`` (a :class:`~predictionio_tpu_torch.
    parallel.mesh.ShardedTensor`) as one tensor on ``x``'s first device:
    this host's rows joined there, then, when they are only this host's
    block, the blocks of every host through the process group. The JAX
    package's ``multihost_utils.process_allgather(x, tiled=True)``,
    which lands on the host; the port's stays on the device."""
    local = x.gathered(0)
    if x.local_rows == x.shape[0]:
        return local
    return all_gather_rows(local)


def all_gather_rows(t):
    """Every process's equal ``[rows, ...]`` block of ``t`` joined in rank
    order, on ``t``'s device: ``all_gather_into_tensor``, or on gloo
    ``all_gather`` into views of the result."""
    import torch.distributed as dist

    count = dist.get_world_size()
    src = t.contiguous()
    out = src.new_empty((count * src.shape[0],) + tuple(src.shape[1:]))
    if dist.get_backend() == "gloo":
        dist.all_gather(list(out.chunk(count)), src)
    else:
        dist.all_gather_into_tensor(out, src)
    return out


def all_reduce_sum(t):
    """``t`` summed over every process (``all_reduce(SUM)``), in place on
    ``t``'s device, and returned."""
    import torch.distributed as dist

    dist.all_reduce(t)
    return t
