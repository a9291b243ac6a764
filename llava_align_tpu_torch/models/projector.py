"""Vision→language projector (torch twin of llava_align_tpu/models/projector.py).

'linear' | 'mlp{N}x_gelu' | 'identity' (llava-v1.5 ships mlp2x_gelu); GELU is
the exact erf form. Param tree: {"layers": [{"kernel": [in,out],
"bias": [out]}, ...]} — an empty list for 'identity'.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import torch

from llava_align_tpu_torch.ops.layers import gelu_exact

Params = Dict[str, Any]


def num_layers(projector_type: str) -> int:
    if projector_type == "identity":
        return 0
    if projector_type == "linear":
        return 1
    m = re.match(r"^mlp(\d+)x_gelu$", projector_type)
    if m:
        return int(m.group(1))
    raise ValueError(f"Unknown projector type: {projector_type}")


def forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    for i, lp in enumerate(params["layers"]):
        if i > 0:
            x = gelu_exact(x)
        x = x @ lp["kernel"] + lp["bias"]
    return x
