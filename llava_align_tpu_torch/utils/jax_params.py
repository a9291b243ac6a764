"""Carry a JAX param tree (as numpy) over to the port's tensors.

Both packages keep the same tree: LLaMA linears are [out, in] in both, and
CLIP/projector kernels stay [in, out] (used as y @ kernel) — nothing is
transposed. int8 dicts {'q', 's'} become int8 and fp32 tensors. Takes numpy
leaves (jax.device_get of a param tree), so this module imports no jax.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


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
    `device`. Float leaves take `dtype` when given (else their own); the
    scales of int8 dicts stay fp32."""

    def walk(node, is_scale=False):
        if isinstance(node, dict):
            quant = "q" in node and "s" in node
            return {k: walk(v, quant and k == "s") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return _to_tensor(node, device, dtype, is_scale)

    return walk(tree)
