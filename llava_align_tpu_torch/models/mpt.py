"""MPT decoder with alibi attention, the alternative LLaVA language
backbone (torch twin of llava_align_tpu/models/mpt.py).

Capability parity: reference experiments/llava/model/language_model/mpt/ —
modeling_mpt.py (alibi position bias, tied lm weights), attention.py
(packed Wqkv, MHA or multi-query attention, optional qk_ln and clip_qkv,
alibi slopes per head), blocks.py (pre-LN, expansion_ratio FFN with exact
GELU).

Alibi is the key-position-linear bias slope_h * j over the key index of
the cache, equal to the canonical -slope * (i - j) up to a per-row
constant that the softmax cancels; the engine's positions are taken and
ignored. Under a prefix mask (prefix-LM) the prefill uses the full
symmetric -slope * |i - j|. Logits, softmax and PV run in fp32 (the
JAX version's HIGHEST-precision einsums); no kernel takes an alibi bias,
so this is plain torch.

Param tree (linears [L, out, in], no biases):
    wte [V, D]
    layers/{norm_1, norm_2}: {scale, bias} [L, D]
    layers/wqkv [L, D + 2 * KV, D], out_proj [L, D, D],
    layers/up_proj [L, F, D], down_proj [L, D, F]
    layers/q_ln {scale, bias} [L, D], k_ln [L, KV]   (qk_ln only)
    norm_f {scale, bias} [D]
with KV = kv_heads * head_dim. The KV cache is a {'k', 'v'} pair of
[L, B, Smax, kv_heads, Dh] tensors, written in place by `forward`.

Under a 'model' mesh (parallel/sharding.mpt_param_shardings, the JAX
package's MQA-safe choice) wqkv is row-parallel: each rank multiplies its
slice of the input, one all_reduce gives every rank the whole q|k|v, and
the alibi attention and the cache stay whole on every rank; out_proj
(on the rank's slice of the attention output) and down_proj are
row-parallel, up_proj column-parallel; wte and the tied head are split
on vocab.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from llava_align_tpu_torch.models.llama import _write_cache
from llava_align_tpu_torch.ops.attention import NEG_INF
from llava_align_tpu_torch.ops.layers import gelu_exact, layer_norm
from llava_align_tpu_torch.parallel import comm
from llava_align_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size

Params = Dict[str, Any]
KVCache = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MptConfig:
    vocab_size: int = 50432
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    expansion_ratio: int = 4
    max_seq_len: int = 2048
    multiquery: bool = False  # MQA: 1 kv head
    qk_ln: bool = False
    clip_qkv: Optional[float] = None
    alibi_bias_max: float = 8.0
    no_bias: bool = True
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return 1 if self.multiquery else self.n_heads

    @property
    def ffn_dim(self) -> int:
        return self.expansion_ratio * self.d_model

    @property
    def hidden_size(self) -> int:
        """d_model under the name the decode engine reads."""
        return self.d_model

    @staticmethod
    def mpt_7b() -> "MptConfig":
        return MptConfig()

    @staticmethod
    def tiny(vocab_size: int = 256, multiquery: bool = False) -> "MptConfig":
        return MptConfig(
            vocab_size=vocab_size, d_model=64, n_layers=2, n_heads=4,
            max_seq_len=128, multiquery=multiquery, dtype=torch.float32,
        )


def alibi_slopes(n_heads: int, alibi_bias_max: float = 8.0) -> np.ndarray:
    """Per-head alibi slopes (reference mpt/attention.py gen_slopes)."""
    p2 = 2 ** math.ceil(math.log2(n_heads))
    m = np.arange(1, p2 + 1, dtype=np.float64) * alibi_bias_max / p2
    slopes = 1.0 / np.power(2.0, m)
    if p2 != n_heads:
        slopes = np.concatenate([slopes[1::2], slopes[0::2]])[:n_heads]
    return slopes.astype(np.float32)


def init_cache(cfg: MptConfig, batch: int, max_len: int, device=None) -> KVCache:
    shape = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def embed_tokens(params: Params, ids: torch.Tensor, tp_group=None, vocab: Optional[int] = None) -> torch.Tensor:
    """Ids clipped to the vocab. tp_group: the 'model' group of a wte
    split on its `vocab` rows (comm.vocab_parallel_embed)."""
    return comm.vocab_parallel_embed(params["wte"], ids, vocab or params["wte"].shape[0], tp_group)


def _alibi_attention(q, k, v, slopes: torch.Tensor, key_positions: torch.Tensor, mask: torch.Tensor,
                     query_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, Sq, H, Dh]; k/v [B, Sk, K, Dh]; slopes [H] fp32; key_positions
    [Sk]; mask [B, Sq, Sk] bool (True = attend). query_positions None: the
    causal key-linear bias slope * j; [Sq]: the symmetric -slope * |i - j|.
    fp32 logits and softmax, probabilities rounded to v's dtype before PV."""
    B, Sq, H, Dh = q.shape
    K = k.shape[2]
    group = H // K
    qr = q.reshape(B, Sq, K, group, Dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qr.float(), k.float()) * (1.0 / Dh**0.5)
    slopes_r = slopes.reshape(K, group)[None, :, :, None, None]
    if query_positions is None:
        bias = slopes_r * key_positions.float()[None, None, None, None, :]
    else:
        dist = (key_positions[None, :] - query_positions[:, None]).abs().float()
        bias = -slopes_r * dist[None, None, None]
    logits = (logits + bias).masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def forward(
    params: Params,
    cfg: MptConfig,
    embeds: torch.Tensor,
    positions: torch.Tensor,  # taken for the engine's interface; alibi reads key indices
    cache: Optional[KVCache] = None,
    cache_offset: Optional[torch.Tensor] = None,
    *,
    attn_impl: str = "auto",
    cache_row_offset: int = 0,
    prefix_mask: Optional[torch.Tensor] = None,
    tp_mesh=None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """prefix_mask [B, S] bool: prefix-LM — position i attends j if j <= i
    or prefix_mask[b, j] (reference modeling_mpt.py _apply_prefix_mask);
    None = causal. Decode steps (S == 1 with a cache) attend the cache up
    to cache_offset[b], causally in both modes. attn_impl is taken and
    ignored: the alibi attention is plain torch whatever the route.
    tp_mesh: the 'model' axis the layer stacks are split over (the module
    docstring's layout). Returns (hidden after norm_f, cache)."""
    B, S, D = embeds.shape
    H, Dh, KV, eps = cfg.n_heads, cfg.head_dim, cfg.kv_heads, cfg.layer_norm_eps
    dev = embeds.device
    if cache_offset is None:
        cache_offset = torch.zeros((B,), dtype=torch.long, device=dev)
    cache_offset = cache_offset.long()
    is_decode = cache is not None and S == 1
    rows = slice(cache_row_offset, cache_row_offset + B)
    slopes = torch.from_numpy(alibi_slopes(H, cfg.alibi_bias_max)).to(dev)
    lp = params["layers"]

    def ln(h, name, li):
        return layer_norm(h, lp[name]["scale"][li], lp[name]["bias"][li], eps)

    group, r, n = None, 0, 1
    if tp_mesh is not None and axis_size(tp_mesh, "model") > 1:
        n = axis_size(tp_mesh, "model")
        group, r = axis_group(tp_mesh, "model"), axis_rank(tp_mesh, "model")

    def row(y, name, li):
        """y [..., in] whole on every rank x a row-parallel [L, out, in/n]
        stack: this rank's slice of y, summed over the group."""
        w = lp[name][li]
        y = comm.copy_to(y, group).narrow(-1, r * w.shape[-1], w.shape[-1])
        return comm.reduce_from(y @ w.t(), group)

    qp = None
    if is_decode:
        kp = torch.arange(cache["k"].shape[2], device=dev)
        mask = kp[None, None, :] <= cache_offset[:, None, None]
    else:
        kp = torch.arange(S, device=dev)
        mask = torch.ones((S, S), dtype=torch.bool, device=dev).tril().expand(B, S, S)
        if prefix_mask is not None:
            mask = mask | prefix_mask.bool()[:, None, :]
            qp = kp  # bidirectional rows need the full |i - j| alibi

    x = embeds
    for li in range(cfg.n_layers):
        qkv = row(ln(x, "norm_1", li), "wqkv", li)
        if cfg.clip_qkv:
            qkv = qkv.clamp(-cfg.clip_qkv, cfg.clip_qkv)
        q_flat, k_flat = qkv[..., :D], qkv[..., D : D + KV * Dh]
        if cfg.qk_ln:
            q_flat, k_flat = ln(q_flat, "q_ln", li), ln(k_flat, "k_ln", li)
        q = q_flat.reshape(B, S, H, Dh)
        k = k_flat.reshape(B, S, KV, Dh)
        v = qkv[..., D + KV * Dh :].reshape(B, S, KV, Dh)
        if cache is not None:
            _write_cache(cache["k"], k, li, cache_offset, is_decode, cache_row_offset)
            _write_cache(cache["v"], v, li, cache_offset, is_decode, cache_row_offset)
        if is_decode:
            k, v = cache["k"][li, rows], cache["v"][li, rows]
        attn = _alibi_attention(q, k, v, slopes, kp, mask, qp)
        x = x + row(attn.reshape(B, S, D), "out_proj", li)
        h = gelu_exact(comm.copy_to(ln(x, "norm_2", li), group) @ lp["up_proj"][li].t())
        x = x + comm.reduce_from(h @ lp["down_proj"][li].t(), group)
    return layer_norm(x, params["norm_f"]["scale"], params["norm_f"]["bias"], eps), cache


def logits_from_hidden(params: Params, hidden: torch.Tensor, tp_group=None,
                       vocab: Optional[int] = None) -> torch.Tensor:
    """Tied output head: fp32 logits = hidden @ wte^T. tp_group: wte split
    on its `vocab` rows; the ranks' logits are gathered."""
    w = params["wte"]
    out = comm.copy_to(hidden, tp_group).to(w.dtype).float() @ w.float().t()
    return comm.gather_last(out, tp_group, vocab)
