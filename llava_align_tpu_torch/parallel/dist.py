"""Multi-process runtime helpers (torch twin of llava_align_tpu/parallel/dist.py).

Capability parity: reference lavis/common/dist_utils.py —
init_distributed_mode (:57-92, env-rank init), get_world_size / get_rank /
is_main_process (:41-55), the main_process decorator (:107). The ranks are
started by torchrun (or spawned) and read torch's launcher environment:
RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT.

The backend follows one rule, logged at init (`choose_backend`):
    NCCL  when each rank of the host has a GPU of its own;
    gloo  on the CPU;
    gloo  when ranks share a GPU (NCCL refuses two ranks on one device:
          "Duplicate GPU detected").
Under gloo, tensors on the GPU stay there: gloo takes CUDA tensors for
all_reduce and broadcast only, so parallel/comm builds every other
collective of the port from those two. That is a transport rule, not a
device fallback; a collective that fails raises.
"""

from __future__ import annotations

import functools
import logging
import os
from typing import Callable, Optional

import torch
import torch.distributed as dist

logger = logging.getLogger("llava_align_tpu_torch.dist")


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def local_rank() -> int:
    """This process's rank on its host (LOCAL_RANK, else RANK, else 0)."""
    for name in ("LOCAL_RANK", "RANK"):
        v = _env_int(name)
        if v is not None:
            return v
    return 0


def local_world_size() -> int:
    """Ranks on this host (LOCAL_WORLD_SIZE, else WORLD_SIZE, else 1)."""
    for name in ("LOCAL_WORLD_SIZE", "WORLD_SIZE"):
        v = _env_int(name)
        if v is not None:
            return v
    return 1


def _device_type(device: Optional[str]) -> str:
    """'cpu' when asked, else 'cuda' (the default), which needs a GPU."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on the CPU")
    return kind


def choose_backend(device: Optional[str] = None) -> str:
    """The transport rule of this module's docstring. device: 'cpu' or
    'cuda' (default: the GPU, which raises without one)."""
    if _device_type(device) == "cpu":
        return "gloo"
    return "nccl" if local_world_size() <= torch.cuda.device_count() else "gloo"


def rank_device(device: Optional[str] = None) -> torch.device:
    """The device this rank computes on: the CPU when asked, else its own
    GPU (LOCAL_RANK), or the GPU it shares when ranks outnumber the GPUs
    (raises without a GPU)."""
    if _device_type(device) == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def init_distributed_mode(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    device: Optional[str] = None,
    backend: Optional[str] = None,
) -> bool:
    """Initialize the default process group from the arguments or torch's
    launcher environment (RANK, WORLD_SIZE, MASTER_ADDR / MASTER_PORT).
    Returns True if a multi-process runtime is active.

    As in the JAX package, a real init failure RAISES; only the case where
    the group is already initialized is absorbed. Without a launcher
    environment (and no arguments) nothing is initialized and this returns
    False."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if world_size is None or rank is None:
        return False
    backend = backend or choose_backend(device)
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    logger.info("init_process_group: backend=%s rank=%d/%d (local %d of %d, %d GPUs)",
                backend, rank, world_size, local_rank(), local_world_size(),
                torch.cuda.device_count() if torch.cuda.is_available() else 0)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return world_size > 1


def get_world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def is_dist_avail_and_initialized() -> bool:
    return is_initialized() and dist.get_world_size() > 1


def is_main_process() -> bool:
    return get_rank() == 0


def main_process(func: Callable) -> Callable:
    """Run only on process 0 (reference dist_utils.py:107-115)."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if is_main_process():
            return func(*args, **kwargs)
        return None

    return wrapper


def barrier() -> None:
    """All ranks meet (a no-op in one process)."""
    if is_dist_avail_and_initialized():
        dist.barrier()


def shard_questions(questions, num_chunks: Optional[int] = None, chunk_idx: Optional[int] = None):
    """Shard an eval set across processes (replaces the reference's
    --num-chunks / CUDA_VISIBLE_DEVICES fan-out, eval/sampling/run.sh:17-25)."""
    from llava_align_tpu_torch.runners.common import get_chunk

    n = num_chunks if num_chunks is not None else get_world_size()
    k = chunk_idx if chunk_idx is not None else get_rank()
    # rank-derived indices: a rank past the ceil-chunk count legitimately
    # holds an empty shard (it still writes its part file for the merge)
    return list(get_chunk(questions, n, k, allow_out_of_range=True)) if n > 1 else list(questions)
