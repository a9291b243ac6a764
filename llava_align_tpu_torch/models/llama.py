"""LLaMA decoder (torch twin of llava_align_tpu/models/llama.py).

Param tree — the JAX layout, linear weights [out, in], stacked on a leading
layer axis:
    embed:      [V, D]
    layers/attn_norm  [L, D]
    layers/{q,k,v}    [L, H*Dh, D] / [L, K*Dh, D] x2   (or fused 'qkv')
    layers/o          [L, D, H*Dh]
    layers/mlp_norm   [L, D]
    layers/{gate,up}  [L, F, D]                         (or fused 'gateup')
    layers/down       [L, D, F]
    final_norm: [D]
    lm_head:    [V, D]
An int8-quantized linear is a {'q': int8 [L, O, D], 's': fp32 [L, O]} dict
(ops/quant.quantize_llama_params); the stack stays whole and the kernel
takes the layer index.

The KV cache is one {'k', 'v'} pair of [L, B, Smax, K, Dh] tensors holding
every decode branch on the batch axis. Unlike the JAX version, which is
functional and returns a new cache, `forward` UPDATES THE CACHE IN PLACE
(and also returns it, so call sites read the same in both packages).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from llava_align_tpu_torch.config import LlamaConfig
from llava_align_tpu_torch.ops.attention import causal_attention, decode_attention
from llava_align_tpu_torch.ops.layers import apply_rope, rms_norm, rope_cos_sin, silu
from llava_align_tpu_torch.ops.quant import (
    int8_matmul,
    int8_matmul_stacked_dispatch,
    is_quantized,
)

Params = Dict[str, Any]
KVCache = Dict[str, torch.Tensor]


def init_cache(
    cfg: LlamaConfig, batch: int, max_len: int, dtype: Optional[torch.dtype] = None,
    kv_quant: bool = False, device=None,
) -> KVCache:
    if kv_quant:
        raise NotImplementedError("int8 KV cache (kv_quant) is not ported yet")
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    dtype = dtype or cfg.dtype
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def embed_tokens(params: Params, token_ids: torch.Tensor) -> torch.Tensor:
    """token_ids [...] int → embeddings [..., D]. Ids are clipped to the
    vocab, as JAX clamps its gathers: the sentinel IMAGE_TOKEN_INDEX=-200
    would otherwise wrap (CPU) or fault (CUDA); the caller overwrites those
    positions with image features."""
    V = params["embed"].shape[0]
    return params["embed"][token_ids.clamp(0, V - 1)]


def _write_cache(
    cache_full: torch.Tensor, new: torch.Tensor, li: int, offsets: torch.Tensor,
    is_decode: bool, row_offset: int,
) -> None:
    """Write new [B, S, K, Dh] into cache_full [L, Btot, Smax, K, Dh] at layer
    li, in place. Prefill starts at position 0; decode (S == 1) writes row b
    at position offsets[b]."""
    B, S = new.shape[0], new.shape[1]
    if is_decode:
        rows = torch.arange(row_offset, row_offset + B, device=new.device)
        cache_full[li, rows, offsets] = new[:, 0]
    else:
        cache_full[li, row_offset : row_offset + B, :S] = new


def forward(
    params: Params,
    cfg: LlamaConfig,
    embeds: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[KVCache] = None,
    cache_offset: Optional[torch.Tensor] = None,
    *,
    cache_row_offset: int = 0,
    tp_mesh=None,
    shared_kv: Optional[KVCache] = None,
    act_quant: bool = False,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder stack.

    embeds       [B, S, D]   token or spliced multimodal embeddings
    positions    [B, S]      absolute RoPE positions
    cache        optional KV cache, written in place
    cache_offset [B] int     where this block starts in the cache. Prefill
                 requires offset == 0 (fresh rows, causal within the block);
                 decode uses S == 1 at the per-row current length.
    cache_row_offset: first cache row of this batch (split-bucket prefill
                 writes the text rows after the image rows).

    Returns (hidden [B, S, D] after the final norm, cache).
    Not ported yet: shared_kv, tp_mesh, act_quant and the int8 KV cache.
    """
    if shared_kv is not None or tp_mesh is not None or act_quant:
        raise NotImplementedError("shared_kv / tp_mesh / act_quant are not ported yet")
    if cache is not None and "ks" in cache:
        raise NotImplementedError("int8 KV cache (kv_quant) is not ported yet")
    B, S, _ = embeds.shape
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    if cache_offset is None:
        cache_offset = torch.zeros((B,), dtype=torch.long, device=embeds.device)
    cache_offset = cache_offset.long()
    is_decode = cache is not None and S == 1

    layers = params["layers"]
    QD, KD = cfg.q_dim, cfg.kv_dim
    Hn, Kn, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def lin(h, name, li):  # h [B, S, in] → [B, S, out]
        w = layers[name]
        if is_quantized(w):
            return int8_matmul_stacked_dispatch(h, w, li)
        return h @ w[li].t()

    x = embeds
    for li in range(cfg.num_layers):
        h = rms_norm(x, layers["attn_norm"][li], cfg.rms_norm_eps)
        if "qkv" in layers:
            qkv = lin(h, "qkv", li)  # one launch streams q|k|v
            q = qkv[..., :QD].reshape(B, S, Hn, Dh)
            k = qkv[..., QD : QD + KD].reshape(B, S, Kn, Dh)
            v = qkv[..., QD + KD : QD + 2 * KD].reshape(B, S, Kn, Dh)
        else:
            q = lin(h, "q", li).reshape(B, S, Hn, Dh)
            k = lin(h, "k", li).reshape(B, S, Kn, Dh)
            v = lin(h, "v", li).reshape(B, S, Kn, Dh)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        v = v.contiguous()

        if cache is not None:
            _write_cache(cache["k"], k, li, cache_offset, is_decode, cache_row_offset)
            _write_cache(cache["v"], v, li, cache_offset, is_decode, cache_row_offset)

        if is_decode:
            rows = slice(cache_row_offset, cache_row_offset + B)
            attn = decode_attention(q, cache["k"][li, rows], cache["v"][li, rows], cache_offset)
        else:
            attn = causal_attention(q, k, v)

        x = x + lin(attn.reshape(B, S, QD), "o", li)

        h = rms_norm(x, layers["mlp_norm"][li], cfg.rms_norm_eps)
        if "gateup" in layers:
            gu = lin(h, "gateup", li)  # one launch streams gate|up
            # split at the stack's own half-width, not cfg.intermediate_size
            # (the JAX package may pad each half for tensor parallelism)
            Fh = gu.shape[-1] // 2
            act = silu(gu[..., :Fh]) * gu[..., Fh:]
        else:
            act = silu(lin(h, "gate", li)) * lin(h, "up", li)
        x = x + lin(act, "down", li)

    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps), cache


def logits_from_hidden(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """lm_head → fp32 logits [..., V]. The int8 lm_head returns h's dtype
    from the kernel and is then widened, as in the JAX package."""
    w = params["lm_head"]
    if is_quantized(w):
        return int8_matmul(hidden, w).float()
    return hidden.to(w.dtype).float() @ w.float().t()


def last_token_logits(
    params: Params, hidden: torch.Tensor, last_index: torch.Tensor
) -> torch.Tensor:
    """Hidden at each row's last valid position, then one [B,D]x[D,V] matmul."""
    B = hidden.shape[0]
    gathered = hidden[torch.arange(B, device=hidden.device), last_index.long()]
    return logits_from_hidden(params, gathered)
