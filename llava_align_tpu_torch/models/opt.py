"""OPT decoder, BLIP-2's OPT backend (torch twin of
llava_align_tpu/models/opt.py).

Capability parity: reference experiments/lavis/models/blip2_models/
modeling_opt.py (vendored HF OPT): learned position embeddings with the +2
offset, pre-LN decoder layers (do_layer_norm_before=True, the config every
BLIP-2 OPT uses), ReLU MLP, biased linears, final_layer_norm, tied lm head.

Param tree (linears {w [L, out, in], b [L, out]}, stacked over layers):
    embed_tokens [V, D], embed_positions [P + 2, D]
    layers/{attn_ln, ffn_ln}: {scale, bias} [L, D]
    layers/{q, k, v, out, fc1, fc2}
    final_ln {scale, bias} [D]

The KV cache is a {'k', 'v'} pair of [L, B, Smax, H, Dh] tensors, written
in place by `forward` (as models/llama's). Head dim 80 at opt-2.7b: the
causal prefill goes to `mha` (K3 takes Dh 64/128 only), as JAX sends it to
XLA.

Under a 'model' mesh (parallel/sharding.opt_param_shardings) q/k/v and
fc1 are column-parallel, each whole bias sliced to the rank's columns;
out and fc2 row-parallel, their bias added once after the all_reduce;
attention runs on the local heads, whose cache holds them; embed_tokens
and the tied head are split on vocab, the learned positions whole.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from llava_align_tpu_torch.models.llama import _write_cache
from llava_align_tpu_torch.ops.attention import causal_attention, decode_attention
from llava_align_tpu_torch.ops.layers import layer_norm
from llava_align_tpu_torch.parallel import comm
from llava_align_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size

Params = Dict[str, Any]
KVCache = Dict[str, torch.Tensor]

POS_OFFSET = 2  # OPT's learned-position quirk


@dataclasses.dataclass(frozen=True)
class OptConfig:
    vocab_size: int = 50272
    hidden_size: int = 2560  # opt-2.7b
    num_layers: int = 32
    num_heads: int = 32
    ffn_dim: int = 10240
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def opt_2_7b() -> "OptConfig":
        return OptConfig()

    @staticmethod
    def tiny(vocab_size: int = 256) -> "OptConfig":
        return OptConfig(
            vocab_size=vocab_size, hidden_size=64, num_layers=2, num_heads=4,
            ffn_dim=128, max_position_embeddings=128, dtype=torch.float32,
        )


def init_cache(cfg: OptConfig, batch: int, max_len: int, device=None,
               num_heads: Optional[int] = None) -> KVCache:
    """num_heads: a tensor-parallel rank's local heads (default: all)."""
    shape = (cfg.num_layers, batch, max_len, num_heads or cfg.num_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def embed_tokens(params: Params, ids: torch.Tensor, tp_group=None, vocab: Optional[int] = None) -> torch.Tensor:
    """Ids clipped to the vocab, as the JAX version clips them. tp_group:
    the 'model' group of a table split on its `vocab` rows
    (comm.vocab_parallel_embed)."""
    table = params["embed_tokens"]
    return comm.vocab_parallel_embed(table, ids, vocab or table.shape[0], tp_group)


def gather_rows(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """table[index] with a JAX gather's index handling: a negative index
    counts from the end once, then every index is clamped into the table.
    (torch would fault on CUDA and raise on the CPU.)"""
    n = table.shape[0]
    index = index.long()
    return table[torch.where(index < 0, index + n, index).clamp(0, n - 1)]


def forward(
    params: Params,
    cfg: OptConfig,
    embeds: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[KVCache] = None,
    cache_offset: Optional[torch.Tensor] = None,
    *,
    attn_impl: str = "auto",
    cache_row_offset: int = 0,
    tp_mesh=None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """embeds [B, S, D], positions [B, S] (the learned table is read at
    positions + 2; bucket pads past the table clamp, as in JAX). Prefill
    (offset 0) attends causally within the block; decode (S == 1, a cache)
    attends over the cache up to cache_offset[b]. tp_mesh: the 'model'
    axis the layer stacks are split over (the module docstring's layout).
    Returns (hidden after final_ln, cache)."""
    B, S, D = embeds.shape
    H, Dh, eps = cfg.num_heads, cfg.head_dim, cfg.layer_norm_eps
    group, r = None, 0
    if tp_mesh is not None and axis_size(tp_mesh, "model") > 1:
        n = axis_size(tp_mesh, "model")
        group, r, H = axis_group(tp_mesh, "model"), axis_rank(tp_mesh, "model"), H // n
    if cache_offset is None:
        cache_offset = torch.zeros((B,), dtype=torch.long, device=embeds.device)
    cache_offset = cache_offset.long()
    is_decode = cache is not None and S == 1
    rows = slice(cache_row_offset, cache_row_offset + B)
    lp = params["layers"]

    def lin(h, name, li):
        """A column-parallel linear (or any linear without a mesh): the
        whole bias is every rank's leaf, sliced to its columns (under
        autograd the slices' gradients sum over the group)."""
        w, b = lp[name]["w"][li], comm.copy_to(lp[name]["b"][li], group)
        return h @ w.t() + b.narrow(-1, r * w.shape[0], w.shape[0])

    def row(h, name, li):
        """A row-parallel linear: h is this rank's slice; the bias is added
        once, after the sum."""
        return comm.reduce_from(h @ lp[name]["w"][li].t(), group) + lp[name]["b"][li]

    def ln(h, name, li):
        return layer_norm(h, lp[name]["scale"][li], lp[name]["bias"][li], eps)

    x = embeds + gather_rows(params["embed_positions"], positions + POS_OFFSET)
    for li in range(cfg.num_layers):
        h = comm.copy_to(ln(x, "attn_ln", li), group)
        q = lin(h, "q", li).reshape(B, S, H, Dh)
        k = lin(h, "k", li).reshape(B, S, H, Dh)
        v = lin(h, "v", li).reshape(B, S, H, Dh)
        if cache is not None:
            _write_cache(cache["k"], k, li, cache_offset, is_decode, cache_row_offset)
            _write_cache(cache["v"], v, li, cache_offset, is_decode, cache_row_offset)
        if is_decode:
            attn = decode_attention(q, cache["k"][li, rows], cache["v"][li, rows], cache_offset)
        else:
            attn = causal_attention(q, k, v, impl=attn_impl)
        x = x + row(attn.reshape(B, S, H * Dh), "out", li)
        h = torch.relu(lin(comm.copy_to(ln(x, "ffn_ln", li), group), "fc1", li))
        x = x + row(h, "fc2", li)
    return layer_norm(x, params["final_ln"]["scale"], params["final_ln"]["bias"], eps), cache


def logits_from_hidden(params: Params, hidden: torch.Tensor, tp_group=None,
                       vocab: Optional[int] = None) -> torch.Tensor:
    """Tied lm head (OPT ties it to embed_tokens) → fp32 logits. tp_group:
    the table split on its `vocab` rows; the ranks' logits are gathered."""
    w = params["embed_tokens"]
    out = comm.copy_to(hidden, tp_group).to(w.dtype).float() @ w.float().t()
    return comm.gather_last(out, tp_group, vocab)
