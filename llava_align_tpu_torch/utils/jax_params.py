"""Carry a JAX param tree (as numpy) over to the port's tensors.

Both packages keep the same tree: LLaMA, Qwen, OPT, MPT, T5, BLIP,
TimeSformer / ALPRO and GPT-2 linears are [out, in] in both (the Qwen ViT's nested {w, b} dicts too;
T5's layer lists and relative-bias tables [NB, H] as they are), and CLIP/projector kernels
stay [in, out] (used as y @ kernel) — nothing is transposed. The LAVIS
composites nest these: PnP-VQA and Img2Prompt {itm, cap: BLIP; qa / qg: T5},
BLIP-Diffusion {visual: the CLIP ViT, qformer, query_tokens, text: CLIP,
proj: ProjLayer's {w, b} linears}. int8 dicts {'q', 's'} become int8 and fp32 tensors, int4 dicts
{'q4', 'gs'} packed int8 and fp32 tensors (the same layout in both
packages, so the carry-over is a copy). Takes numpy
leaves (jax.device_get of a param tree), so this module imports no jax.

from_jax_opt_state carries an optax optimizer state the same way into the
state of framework/optims.AdamW, so a resume can be held against JAX.

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
    dicts and BLIP-2 stage 1's 0-d 'temp' stay fp32, and None leaves stay
    None."""
    device = resolve_device(device)

    def scale_key(node: dict) -> Optional[str]:
        if "q" in node and "s" in node:
            return "s"
        if "q4" in node and "gs" in node:
            return "gs"
        return None

    def walk(node, is_scale=False):
        if node is None:  # e.g. a tied T5's lm_head
            return None
        if isinstance(node, dict):
            sk = scale_key(node)
            return {k: walk(v, k in (sk, "temp")) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return _to_tensor(node, device, dtype, is_scale)

    return walk(tree)


def _fields(node) -> tuple:
    return getattr(node, "_fields", ()) if isinstance(node, tuple) else ()


def _find_adam(node):
    """The ScaleByAdamState (count, mu, nu) inside an optax chain state."""
    if {"count", "mu", "nu"} <= set(_fields(node)):
        return node
    if isinstance(node, (tuple, list)):
        for v in node:
            found = _find_adam(v)
            if found is not None:
                return found
    return None


def from_jax_opt_state(state: Any, device=None) -> dict:
    """An optax state of the JAX package's optimizers as numpy
    (jax.device_get): chain(clip_by_global_norm, adamw), optionally wrapped
    in MultiSteps → the AdamW state {count, mu, nu[, acc, mini_step]} on
    `device`, each moment in its own dtype (optax keeps mu and nu in the
    param's dtype). Namedtuples are read by their field names, so no optax
    import is needed."""
    multi = state if "acc_grads" in _fields(state) else None
    adam = _find_adam(multi.inner_opt_state if multi is not None else state)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the optimizer state")
    out = {"count": int(np.asarray(adam.count)),
           "mu": from_jax_params(adam.mu, device), "nu": from_jax_params(adam.nu, device)}
    if multi is not None:
        out["acc"] = from_jax_params(multi.acc_grads, device)
        out["mini_step"] = int(np.asarray(multi.mini_step))
    return out
