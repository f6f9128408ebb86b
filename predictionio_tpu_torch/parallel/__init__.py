"""Distributed execution: the mesh, the process group, the sharded
trainers and the sequence-parallel attention (the port's copy of
``predictionio_tpu/parallel``). A
:class:`~predictionio_tpu_torch.parallel.mesh.Mesh` names the devices,
and the code that shards work over it launches on each device itself;
collectives between processes go through ``torch.distributed``."""

from predictionio_tpu_torch.parallel.mesh import (
    Mesh,
    P,
    PartitionSpec,
    ShardedTensor,
    data_parallel_mesh,
    mesh_2d,
)
from predictionio_tpu_torch.parallel.als_sharding import (
    ItemShardLayout,
    contiguous_item_layout,
    density_aware_item_layout,
    sharded_train_step,
    train_als_auto,
    train_als_bucketed_sharded,
    train_als_device,
    train_als_sharded,
    train_als_sharded_2d,
)
from predictionio_tpu_torch.parallel import distributed  # the process group
from predictionio_tpu_torch.parallel.distributed import (
    DistributedConfig,
    host_aware_mesh,
)
from predictionio_tpu_torch.ops.attention import (  # sequence parallel
    ring_attention,
    ulysses_attention,
)

__all__ = ["Mesh", "P", "PartitionSpec", "ShardedTensor",
           "data_parallel_mesh", "mesh_2d", "train_als_sharded",
           "train_als_sharded_2d", "train_als_bucketed_sharded",
           "ring_attention", "ulysses_attention",
           "train_als_device", "train_als_auto", "sharded_train_step",
           "distributed", "DistributedConfig", "host_aware_mesh",
           "ItemShardLayout", "density_aware_item_layout",
           "contiguous_item_layout"]
