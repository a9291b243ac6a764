"""torch.save / torch.load of converted model params (torch twin of
llava_align_tpu/utils/checkpoint_io.py, which uses orbax).

The params go to one file at `path` (the JAX package writes an orbax
directory there) and the optional metadata to the same `path +
".meta.json"` sidecar. Loading takes weights only (tensors in nested
dicts and lists), never pickled code.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch


def save_params(path: str, params: Dict[str, Any], meta: Optional[dict] = None) -> str:
    path = os.path.abspath(os.path.expanduser(path))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(params, path)
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)
    return path


def load_params(
    path: str, target: Optional[Dict[str, Any]] = None, device=None
) -> Tuple[Dict[str, Any], Optional[dict]]:
    """target: an optional tree of tensors whose device and dtype each
    loaded leaf takes (the JAX package's restore-into-target); else the
    leaves land on `device` (the CPU when None)."""
    path = os.path.abspath(os.path.expanduser(path))
    params = torch.load(path, map_location=device or "cpu", weights_only=True)
    if target is not None:
        params = _like(params, target)
    meta = None
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return params, meta


def _like(tree, target):
    if isinstance(tree, dict):
        return {k: _like(v, target[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_like(v, t) for v, t in zip(tree, target))
    return tree.to(device=target.device, dtype=target.dtype)
