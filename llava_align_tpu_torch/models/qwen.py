"""Qwen(-VL) decoder (torch twin of llava_align_tpu/models/qwen.py).

Capability parity: reference experiments/Qwen_VL/modeling_qwen.py —
packed c_attn with a bias, bias-free projections, MLP w1 * silu(w2),
pre-RMSNorm residuals, rotary embeddings with a dynamic-NTK base, log-n
query scaling beyond the trained context, RMSNorm eps 1e-6.

Param tree — the JAX layout, linear weights [out, in] stacked over layers:
    wte:       [V, D]
    layers/ln_1        [L, D]
    layers/c_attn_w    [L, 3*H*Dh, D]   (q | k | v)
    layers/c_attn_b    [L, 3*H*Dh]      (added after the matmul; stays dense)
    layers/attn_proj   [L, D, H*Dh]
    layers/ln_2        [L, D]
    layers/{w1,w2}     [L, F/2, D] x2   (or fused 'w12' = w1 | w2)
    layers/mlp_proj    [L, D, F/2]
    ln_f:      [D]
    lm_head:   [V, D]
An int8 linear is {'q', 's'} (ops/quant.quantize_qwen_params). The KV
cache and the shared-prefix segments are those of models/llama (MHA: as
many kv heads as heads), and `forward` updates the cache in place, as
llama.forward does. Under a 'model' mesh (parallel/sharding.
qwen_param_shardings) the forward carries llama.forward's collectives.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from llava_align_tpu_torch.models import llama
from llava_align_tpu_torch.ops.layers import apply_rope, rms_norm, rope_cos_sin, silu
from llava_align_tpu_torch.ops.quant import int8_tp_mode
from llava_align_tpu_torch.parallel import comm
from llava_align_tpu_torch.parallel.mesh import axis_group, axis_size

Params = Dict[str, Any]
KVCache = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class QwenConfig:
    vocab_size: int = 151936
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    head_dim: int = 128  # kv_channels
    intermediate_size: int = 22016  # w1/w2 each output intermediate_size // 2
    layer_norm_eps: float = 1e-6
    rotary_emb_base: float = 10000.0
    seq_length: int = 2048  # trained context: NTK and log-n act beyond it
    use_dynamic_ntk: bool = True
    use_logn_attn: bool = True
    dtype: torch.dtype = torch.bfloat16

    @property
    def ff_dim(self) -> int:
        return self.intermediate_size // 2

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @staticmethod
    def qwen_vl_7b() -> "QwenConfig":
        return QwenConfig()

    @staticmethod
    def tiny(vocab_size: int = 256) -> "QwenConfig":
        return QwenConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            head_dim=16,
            intermediate_size=256,
            seq_length=128,
            dtype=torch.float32,
        )


def init_cache(
    cfg: QwenConfig, batch: int, max_len: int, kv_quant: bool = False, device=None,
    num_heads: Optional[int] = None,
) -> KVCache:
    """{'k', 'v'}: [L, batch, max_len, H, Dh] zeros on `device` ('meta'
    sizes a cache without allocating it); with kv_quant the int8 cache
    (llama.quantized_cache: int8 values, fp32 'ks'/'vs' scale planes).
    num_heads: a tensor-parallel rank's local heads (default: all)."""
    shape = (cfg.num_layers, batch, max_len, num_heads or cfg.num_heads, cfg.head_dim)
    if kv_quant:
        return llama.quantized_cache(shape, device)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
    }


def embed_tokens(params: Params, token_ids: torch.Tensor, tp_group=None) -> torch.Tensor:
    """Ids clipped to the vocab, as JAX clamps its gathers (the image
    sentinel's slots are overwritten by the splice). tp_group: the 'model'
    group of a wte split on hidden; the shards are gathered."""
    V = params["wte"].shape[0]
    return comm.gather_last(params["wte"][token_ids.clamp(0, V - 1)], tp_group)


def ntk_alpha_for_len(cfg: QwenConfig, kv_seq_len: int) -> float:
    """Dynamic-NTK alpha (reference modeling_qwen.py:645-659), from the
    static max sequence length of the call on the host."""
    if not cfg.use_dynamic_ntk or kv_seq_len <= cfg.seq_length:
        return 1.0
    context_value = math.log(kv_seq_len / cfg.seq_length, 2) + 1
    return max(2 ** math.ceil(context_value) - 1, 1.0)


def _logn_scale(cfg: QwenConfig, positions: torch.Tensor) -> torch.Tensor:
    """log-n query scale per absolute position (reference :140-144:
    log_{seq_length}(i) for 1-based i > seq_length, else 1), fp32."""
    i = positions.float() + 1.0
    factor = torch.log(i) / math.log(float(cfg.seq_length))
    return torch.where(i > cfg.seq_length, factor, torch.ones_like(i))


def forward(
    params: Params,
    cfg: QwenConfig,
    embeds: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[KVCache] = None,
    cache_offset: Optional[torch.Tensor] = None,
    *,
    ntk_alpha: float = 1.0,
    attn_impl: str = "auto",
    cache_row_offset: int = 0,
    shared_kv: Optional[KVCache] = None,
    shared_len: Optional[torch.Tensor] = None,
    shared_rows_per_prefix: Optional[int] = None,
    shared_rows_per_prefix2: int = 0,
    act_quant: bool = False,
    tp_mesh=None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder stack; the arguments are llama.forward's (positions
    absolute, cache_offset local, the same shared-segment contract), plus
    ntk_alpha (ntk_alpha_for_len of the call's cache length), which scales
    the rotary base. act_quant and the int8 cache as in llama.forward.
    tp_mesh: the 'model' axis the layer stacks are split over
    (qwen_param_shardings; int8 stacks through ops/quant.
    int8_matmul_stacked_tp on the local shard): c_attn and w1/w2 (or w12)
    column-parallel, attn_proj and mlp_proj row-parallel with one
    all_reduce each; attention on the local heads, whose cache holds
    them. Dynamic NTK and log-n read positions, not heads.
    Returns (hidden after ln_f, cache)."""
    B, S, _ = embeds.shape
    H, Dh, QD = cfg.num_heads, cfg.head_dim, cfg.q_dim
    group = None
    if tp_mesh is not None and axis_size(tp_mesh, "model") > 1:
        n = axis_size(tp_mesh, "model")
        group, H, QD = axis_group(tp_mesh, "model"), H // n, QD // n
    base = cfg.rotary_emb_base * ntk_alpha ** (Dh / (Dh - 2))
    cos, sin = rope_cos_sin(positions, Dh, base)
    if cache_offset is None:
        cache_offset = torch.zeros((B,), dtype=torch.long, device=embeds.device)
    cache_offset = cache_offset.long()
    is_decode = cache is not None and S == 1
    logn = _logn_scale(cfg, positions)[..., None, None] if cfg.use_logn_attn else None  # [B,S,1,1]

    layers = params["layers"]

    def lin(h, name, li):
        return llama.linear(h, layers[name], li, act_quant, tp_group=group, tp_mode=int8_tp_mode(name))

    x = embeds
    for li in range(cfg.num_layers):
        h = comm.copy_to(rms_norm(x, layers["ln_1"][li], cfg.layer_norm_eps), group)
        qkv = lin(h, "c_attn_w", li) + layers["c_attn_b"][li]
        q, k, v = qkv.split(QD, dim=-1)
        q = apply_rope(q.reshape(B, S, H, Dh), cos, sin)
        k = apply_rope(k.reshape(B, S, H, Dh), cos, sin)
        if logn is not None:
            q = (q.float() * logn).to(q.dtype)
        attn = llama.attend(q, k, v.reshape(B, S, H, Dh).contiguous(), li, cache, cache_offset,
                            is_decode, cache_row_offset, attn_impl, shared_kv, shared_len,
                            shared_rows_per_prefix, shared_rows_per_prefix2)
        x = x + lin(attn.reshape(B, S, QD), "attn_proj", li)

        h = comm.copy_to(rms_norm(x, layers["ln_2"][li], cfg.layer_norm_eps), group)
        if "w12" in layers:
            w12 = lin(h, "w12", li)  # one launch streams w1 | w2
            half = w12.shape[-1] // 2
            act = w12[..., :half] * silu(w12[..., half:])
        else:
            act = lin(h, "w1", li) * silu(lin(h, "w2", li))
        x = x + lin(act, "mlp_proj", li)

    return rms_norm(x, params["ln_f"], cfg.layer_norm_eps), cache


def logits_from_hidden(params: Params, hidden: torch.Tensor, tp_group=None,
                       vocab: Optional[int] = None) -> torch.Tensor:
    """lm_head → fp32 logits [..., V]; an int8 lm_head through K2's
    dispatch (llama.logits_from_hidden: the same leaf name and math, and
    its vocab-parallel gather under tp_group)."""
    return llama.logits_from_hidden(params, hidden, tp_group, vocab)
