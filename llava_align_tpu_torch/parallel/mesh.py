"""Device-mesh construction (torch twin of llava_align_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over a ('data', 'model') mesh and
GSPMD inserts the collectives. The port runs one process per rank over a
torch DeviceMesh with the same axis names: tensor parallelism shards
weights over 'model' (explicit Megatron collectives, models/llama and
models/clip_vit), data parallelism splits questions or batch rows over
'data'. Rank r sits at mesh coordinate (r // model, r % model), so the
ranks of one 'model' group are consecutive.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("data", "model")


def make_mesh(model: Optional[int] = None, data: int = 1) -> DeviceMesh:
    """Mesh with axes ('data', 'model') over the ranks of the default
    process group (one device per rank). Defaults to every rank on
    'model'. The mesh's device type is the transport's: 'cuda' under NCCL,
    'cpu' under gloo (parallel/dist's rule), whatever device the tensors
    lie on."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if model is None:
        model = n // data
    if data * model != n:
        raise ValueError(f"data({data}) * model({model}) != n_devices({n})")
    if not dist.is_initialized():
        # one process: a world of one, so a mesh exists as in JAX
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, model), mesh_dim_names=AXES)


def single_device_mesh() -> DeviceMesh:
    return make_mesh(model=1, data=1)


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    """The mesh's size along `axis` (1 without a mesh)."""
    return 1 if mesh is None else int(mesh.shape[AXES.index(axis)])


def axis_rank(mesh: Optional[DeviceMesh], axis: str) -> int:
    """This rank's coordinate along `axis` (0 without a mesh)."""
    return 0 if mesh is None else int(mesh.get_local_rank(axis))


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of this rank's `axis` slice."""
    return mesh.get_group(axis)
