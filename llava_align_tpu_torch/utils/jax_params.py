"""Carry a JAX param tree (as numpy) over to the port's tensors.

Both packages keep the same tree: LLaMA linears are [out, in] in both, and
CLIP/projector kernels stay [in, out] (used as y @ kernel) — nothing is
transposed. int8 dicts {'q', 's'} become int8 and fp32 tensors, int4 dicts
{'q4', 'gs'} packed int8 and fp32 tensors (the same layout in both
packages, so the carry-over is a copy). Takes numpy
leaves (jax.device_get of a param tree), so this module imports no jax.

The default device is the GPU, as for load_model and
build_random_llava_params: without one, the carry-over raises unless
device="cpu" is asked for.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from llava_align_tpu_torch.utils.synthetic import resolve_device


def _to_tensor(x, device, dtype: Optional[torch.dtype], is_scale: bool) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.kind in "iub":  # int8 weights, token ids, masks keep their type
        return torch.from_numpy(np.array(a)).to(device)
    if is_scale:
        target = torch.float32
    elif dtype is not None:
        target = dtype
    elif a.dtype.name == "bfloat16":  # ml_dtypes bf16 has no torch.from_numpy
        target = torch.bfloat16
    else:
        target = torch.from_numpy(np.zeros(0, a.dtype)).dtype
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=device, dtype=target)


def from_jax_params(tree: Any, device=None, dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dicts/lists of numpy arrays → the same structure of tensors on
    `device` (the GPU unless another is named). Float leaves take `dtype`
    when given (else their own); the scales of int8 ('s') and int4 ('gs')
    dicts stay fp32."""
    device = resolve_device(device)

    def scale_key(node: dict) -> Optional[str]:
        if "q" in node and "s" in node:
            return "s"
        if "q4" in node and "gs" in node:
            return "gs"
        return None

    def walk(node, is_scale=False):
        if isinstance(node, dict):
            sk = scale_key(node)
            return {k: walk(v, k == sk) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return _to_tensor(node, device, dtype, is_scale)

    return walk(tree)
