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
An int8-quantized linear is a {'q': int8 [L, O, D], 's': fp32 [L, O]} dict,
an int4 one a {'q4': int8 [L, D/2, O], 'gs': fp32 [L, D/128, O]} dict
(ops/quant.quantize_llama_params); the stack stays whole and the kernel
takes the layer index.

The KV cache is one {'k', 'v'} pair of [L, B, Smax, K, Dh] tensors holding
every decode branch on the batch axis; the int8 cache (init_cache
kv_quant=True) holds int8 'k'/'v' and fp32 'ks'/'vs' scale planes [L, B,
Smax, K, 1] (ops/quant.kv_quantize_block per position and head). Unlike
the JAX version, which is functional and returns a new cache, `forward`
UPDATES THE CACHE IN PLACE (and also returns it, so call sites read the
same in both packages).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from llava_align_tpu_torch.config import LlamaConfig
from llava_align_tpu_torch.ops.attention import (
    causal_attention,
    chunk_attention_shared,
    chunk_attention_shared_grouped,
    decode_attention,
    decode_attention_shared,
    decode_attention_shared_grouped,
)
from llava_align_tpu_torch.ops.layers import apply_rope, rms_norm, rope_cos_sin, silu
from llava_align_tpu_torch.ops.quant import (
    int4_matmul_stacked_dispatch,
    int8_matmul,
    int8_matmul_stacked_dispatch,
    is_quantized,
    is_quantized_int4,
    kv_quantize_block,
)

Params = Dict[str, Any]
KVCache = Dict[str, torch.Tensor]


def init_cache(
    cfg: LlamaConfig, batch: int, max_len: int, dtype: Optional[torch.dtype] = None,
    kv_quant: bool = False, device=None,
) -> KVCache:
    """{'k', 'v'}: [L, batch, max_len, K, Dh] zeros on `device`; with
    kv_quant int8 values plus fp32 'ks'/'vs' scale planes [L, batch,
    max_len, K, 1] (the trailing singleton as in the JAX package)."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    if kv_quant:
        return quantized_cache(shape, device)
    dtype = dtype or cfg.dtype
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def quantized_cache(shape, device=None) -> KVCache:
    """The int8 cache of value shape [L, B, Smax, K, Dh]: int8 'k'/'v', fp32
    'ks'/'vs' [L, B, Smax, K, 1], all zeros (a zero scale keeps an unwritten
    slot inert)."""
    sshape = tuple(shape[:-1]) + (1,)
    return {
        "k": torch.zeros(shape, dtype=torch.int8, device=device),
        "ks": torch.zeros(sshape, dtype=torch.float32, device=device),
        "v": torch.zeros(shape, dtype=torch.int8, device=device),
        "vs": torch.zeros(sshape, dtype=torch.float32, device=device),
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


def layer_views(layers: Params) -> Params:
    """The layer tree as `forward` reads it: under autograd, each stacked
    [L, ...] leaf that requires grad becomes a tuple of its L layer views
    by one unbind, whose backward is one stack of the layers' gradients
    (indexing w[li] instead costs a zero tensor of the whole stack per
    layer in the backward: ~L full stacks written per leaf). The numbers
    are the same either way; outside autograd the tree is returned as is."""
    if not torch.is_grad_enabled():
        return layers
    return {k: v.unbind(0) if isinstance(v, torch.Tensor) and v.requires_grad else v
            for k, v in layers.items()}


def linear(h: torch.Tensor, w: Any, li: int, act_quant: bool = False) -> torch.Tensor:
    """h [B, S, in] x layer li of a stacked linear [L, out, in] (or the
    tuple of its layers, layer_views) → [B, S, out]: int4 stacks through
    K4's dispatch, int8 ones through K1's (with act_quant, W8A8 from
    W8A8_MIN_ROWS rows on), float ones through torch.matmul."""
    if is_quantized_int4(w):
        return int4_matmul_stacked_dispatch(h, w, li)
    if is_quantized(w):
        return int8_matmul_stacked_dispatch(h, w, li, act_quant=act_quant)
    return h @ w[li].t()


def _write_kv(cache: KVCache, k: torch.Tensor, v: torch.Tensor, li: int, offsets: torch.Tensor,
              is_decode: bool, row_offset: int) -> None:
    """Write k and v [B, S, K, Dh] into the cache at layer li; an int8 cache
    stores their kv_quantize_block codes and scales."""
    if "ks" in cache:
        (k, ks), (v, vs) = kv_quantize_block(k), kv_quantize_block(v)
        _write_cache(cache["ks"], ks, li, offsets, is_decode, row_offset)
        _write_cache(cache["vs"], vs, li, offsets, is_decode, row_offset)
    _write_cache(cache["k"], k, li, offsets, is_decode, row_offset)
    _write_cache(cache["v"], v, li, offsets, is_decode, row_offset)


def _read_kv(cache: KVCache, li: int, rows: slice):
    """Layer li's rows of the cache: (k, v), each an int8 (values, scales)
    tuple for an int8 cache (the attention ops fold the scales)."""
    if "ks" in cache:
        return ((cache["k"][li, rows], cache["ks"][li, rows]),
                (cache["v"][li, rows], cache["vs"][li, rows]))
    return cache["k"][li, rows], cache["v"][li, rows]


def _read_shared(shared_kv: KVCache, li: int, name: str, scales: str):
    """Layer li of a shared segment table, with its scale plane when the
    segment is int8."""
    if scales in shared_kv:
        return shared_kv[name][li], shared_kv[scales][li]
    return shared_kv[name][li]


def attend(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, li: int, cache: Optional[KVCache],
    cache_offset: torch.Tensor, is_decode: bool, cache_row_offset: int, attn_impl: str,
    shared_kv: Optional[KVCache] = None, shared_len: Optional[torch.Tensor] = None,
    shared_rows_per_prefix: Optional[int] = None, shared_rows_per_prefix2: int = 0,
) -> torch.Tensor:
    """One layer's attention, as `forward` (which see for the arguments)
    runs it: k and v [B, S, K, Dh] are written into the cache first (if
    any); then a decode step attends over the cache rows, a prefill
    causally within its block (K3 or mha by attn_impl), and either one
    against the shared prefix segment too when shared_kv is given."""
    B = q.shape[0]
    if cache is not None:
        _write_kv(cache, k, v, li, cache_offset, is_decode, cache_row_offset)
    rows = slice(cache_row_offset, cache_row_offset + B)
    if shared_kv is None:
        if is_decode:
            return decode_attention(q, *_read_kv(cache, li, rows), cache_offset)
        return causal_attention(q, k, v, impl=attn_impl)
    k_sh, v_sh = _read_shared(shared_kv, li, "k", "ks"), _read_shared(shared_kv, li, "v", "vs")
    grouped = shared_kv["k"].dim() == 5  # [L, G, P, K, Dh]: one prefix per row group
    two = {}
    if "k2" in shared_kv:  # second (text-branch) segment table
        two = dict(k_sh2=_read_shared(shared_kv, li, "k2", "k2s"),
                   v_sh2=_read_shared(shared_kv, li, "v2", "v2s"),
                   rows_per_prefix2=shared_rows_per_prefix2)
    if is_decode:
        kc, vc = _read_kv(cache, li, rows)
        if grouped:
            return decode_attention_shared_grouped(
                q, kc, vc, cache_offset, k_sh, v_sh, shared_len, shared_rows_per_prefix, **two
            )
        return decode_attention_shared(q, kc, vc, cache_offset, k_sh, v_sh, shared_len)
    if grouped:
        return chunk_attention_shared_grouped(
            q, k, v, k_sh, v_sh, shared_len, shared_rows_per_prefix, **two
        )
    return chunk_attention_shared(q, k, v, k_sh, v_sh, shared_len)


def forward(
    params: Params,
    cfg: LlamaConfig,
    embeds: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[KVCache] = None,
    cache_offset: Optional[torch.Tensor] = None,
    *,
    attn_impl: str = "auto",
    cache_row_offset: int = 0,
    tp_mesh=None,
    shared_kv: Optional[KVCache] = None,
    shared_len: Optional[torch.Tensor] = None,
    shared_rows_per_prefix: Optional[int] = None,
    shared_rows_per_prefix2: int = 0,
    act_quant: bool = False,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder stack.

    embeds       [B, S, D]   token or spliced multimodal embeddings
    positions    [B, S]      absolute RoPE positions
    cache        optional KV cache, written in place
    cache_offset [B] int     where this block starts in the cache. Prefill
                 requires offset == 0 (fresh rows, causal within the block);
                 decode uses S == 1 at the per-row current length.
    attn_impl    the causal prefill's route: 'auto' | 'pallas' (K3) | 'xla'
                 (mha); see ops.attention.causal_attention.
    cache_row_offset: first cache row of this batch (split-bucket prefill
                 writes the text rows after the image rows).
    shared_kv    optional read-only prefix KV segment {'k', 'v': [L, P, K,
                 Dh]} shared by all rows, or grouped [L, G, P, K, Dh] with
                 rows blocked by shared_rows_per_prefix; a grouped segment
                 may carry a second table {'k2', 'v2': [L, G2, P2, K, Dh]}
                 (rows blocked by shared_rows_per_prefix2) for the rows right
                 after the first table's span. shared_len [B]: each row's
                 valid prefix length (0 = none). With a segment, `positions`
                 are absolute (shared_len[b] + local index) while
                 `cache_offset` stays LOCAL; prefill blocks are the first
                 local content. An int8 cache (init_cache kv_quant) stores
                 each written block quantized; int8 segments carry their
                 scale planes ('ks'/'vs', 'k2s'/'v2s').
    act_quant    opt-in W8A8: int8 stacks take the W8A8 product at
                 W8A8_MIN_ROWS rows and more (prefills); decode rows keep
                 K1. Not bit-exact with the weight-only path, by design.

    Returns (hidden [B, S, D] after the final norm, cache).
    Not ported yet: tp_mesh.
    """
    if tp_mesh is not None:
        raise NotImplementedError("tp_mesh is not ported yet")
    B, S, _ = embeds.shape
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    if cache_offset is None:
        cache_offset = torch.zeros((B,), dtype=torch.long, device=embeds.device)
    cache_offset = cache_offset.long()
    is_decode = cache is not None and S == 1

    layers = layer_views(params["layers"])
    QD, KD = cfg.q_dim, cfg.kv_dim
    Hn, Kn, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def lin(h, name, li):
        return linear(h, layers[name], li, act_quant)

    def attn_fn(q, k, v, li):
        return attend(q, k, v, li, cache, cache_offset, is_decode, cache_row_offset, attn_impl,
                      shared_kv, shared_len, shared_rows_per_prefix, shared_rows_per_prefix2)

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
        attn = attn_fn(q, k, v.contiguous(), li)
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
