"""Checkpoint tooling: LoRA merge, projector-only load, delta weights
(torch twin of llava_align_tpu/utils/checkpoint_tools.py).

Capability parity:
  * LoRA/PEFT merge — reference llava/model/builder.py:46-79 (base + adapter →
    merged weights; including `non_lora_trainables` extra tensors).
  * projector-only load — builder.py:80-96 (mm_projector.bin over a base LM).
  * delta weights — llava/model/make_delta.py (delta = target - base) and
    consolidate.py / apply_delta (base + delta = target).

The state-dict tools are copies: they operate on flat state dicts of numpy
arrays (torch tensors are read as fp32 numpy), before the conversion to the
port's trees. resize_token_embeddings works on the port's LLaMA tree.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

Array = np.ndarray
StateDict = Dict[str, Array]


def _np(x) -> Array:
    if isinstance(x, np.ndarray):
        return x
    return x.float().cpu().numpy()


def resize_token_embeddings(
    llama_params: Dict[str, "object"], new_vocab_size: int
) -> Dict[str, "object"]:
    """Grow embed/lm_head to a larger vocab, initializing new rows with the
    mean of the existing ones (reference llava_arch.initialize_vision_tokenizer
    :206-226: add <im_patch>/<im_start>/<im_end>, resize, mean-init); the
    mean in fp32, the new rows in the table's dtype."""
    out = dict(llama_params)
    for key in ("embed", "lm_head"):
        w = llama_params[key]
        if isinstance(w, dict):  # quantized — resize before quantization
            raise ValueError("resize before quantizing the embeddings/lm_head")
        old_v = w.shape[0]
        if new_vocab_size < old_v:
            raise ValueError(f"cannot shrink vocab {old_v} -> {new_vocab_size}")
        if new_vocab_size == old_v:
            continue
        mean_row = w.float().mean(dim=0, keepdim=True)
        new_rows = mean_row.expand(new_vocab_size - old_v, w.shape[1])
        out[key] = torch.cat([w, new_rows.to(w.dtype)], dim=0)
    return out


def merge_lora(
    base_sd: Mapping[str, Array],
    lora_sd: Mapping[str, Array],
    scaling: Optional[float] = None,
    lora_alpha: float = 16.0,
) -> StateDict:
    """Merge LoRA adapters into base weights: W' = W + scaling * B @ A.

    lora_sd keys follow PEFT convention:
        base_model.model.<module_path>.lora_A.weight   [r, in]
        base_model.model.<module_path>.lora_B.weight   [out, r]
    scaling defaults to lora_alpha / r.
    """
    out: StateDict = {k: _np(v).copy() for k, v in base_sd.items()}
    a_keys = [k for k in lora_sd if k.endswith("lora_A.weight")]
    for a_key in a_keys:
        b_key = a_key.replace("lora_A.weight", "lora_B.weight")
        module = (
            a_key.replace("base_model.model.", "")
            .replace(".lora_A.weight", "")
        )
        target = module + ".weight"
        if target not in out:
            raise KeyError(f"LoRA target {target} not in base weights")
        A = _np(lora_sd[a_key])
        B = _np(lora_sd[b_key])
        r = A.shape[0]
        s = scaling if scaling is not None else lora_alpha / r
        out[target] = out[target] + s * (B @ A)
    # extra trained tensors saved alongside the adapter (builder.py:60-70)
    for k, v in lora_sd.items():
        if "lora_A" in k or "lora_B" in k:
            continue
        clean = k.replace("base_model.model.", "")
        out[clean] = _np(v)
    return out


def apply_projector_only(
    base_sd: Mapping[str, Array], projector_sd: Mapping[str, Array]
) -> StateDict:
    """Overlay mm_projector.bin tensors onto a base LM state dict
    (reference builder.py:80-96)."""
    out: StateDict = {k: _np(v) for k, v in base_sd.items()}
    for k, v in projector_sd.items():
        out[k] = _np(v)
    return out


def make_delta(
    base_sd: Mapping[str, Array], target_sd: Mapping[str, Array]
) -> StateDict:
    """delta = target - base; tensors unique to target pass through
    (reference llava/model/make_delta.py semantics)."""
    delta: StateDict = {}
    for k, v in target_sd.items():
        v = _np(v)
        if k in base_sd:
            b = _np(base_sd[k])
            if b.shape == v.shape:
                delta[k] = v - b
            else:  # resized embeddings: store target, mark by shape mismatch
                delta[k] = v
        else:
            delta[k] = v
    return delta


def apply_delta(
    base_sd: Mapping[str, Array], delta_sd: Mapping[str, Array]
) -> StateDict:
    """base + delta = target (reference llava/model/consolidate.py /
    apply_delta semantics, incl. resized-embedding passthrough)."""
    out: StateDict = {}
    for k, v in delta_sd.items():
        v = _np(v)
        if k in base_sd:
            b = _np(base_sd[k])
            out[k] = v + b if b.shape == v.shape else v
        else:
            out[k] = v
    return out
