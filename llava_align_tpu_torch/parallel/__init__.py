"""Parallelism over torch.distributed (torch twin of llava_align_tpu/parallel):
one process per rank, a ('data', 'model') DeviceMesh, Megatron column/row
tensor parallelism with explicit collectives, and data parallelism by
question or group."""

from llava_align_tpu_torch.parallel.mesh import make_mesh, single_device_mesh  # noqa: F401
from llava_align_tpu_torch.parallel.sharding import (  # noqa: F401
    cache_shardings,
    llava_param_shardings,
    shard_params,
)
