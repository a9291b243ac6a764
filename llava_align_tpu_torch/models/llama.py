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
    int8_matmul_stacked_tp,
    int8_tp_mode,
    is_quantized,
    is_quantized_int4,
    kv_quantize_block,
)
from llava_align_tpu_torch.parallel import comm
from llava_align_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size

Params = Dict[str, Any]
KVCache = Dict[str, torch.Tensor]


def init_cache(
    cfg: LlamaConfig, batch: int, max_len: int, dtype: Optional[torch.dtype] = None,
    kv_quant: bool = False, device=None, num_kv_heads: Optional[int] = None,
) -> KVCache:
    """{'k', 'v'}: [L, batch, max_len, K, Dh] zeros on `device`; with
    kv_quant int8 values plus fp32 'ks'/'vs' scale planes [L, batch,
    max_len, K, 1] (the trailing singleton as in the JAX package).
    num_kv_heads: K, when not cfg's (a tensor-parallel rank's local kv
    heads)."""
    shape = (cfg.num_layers, batch, max_len, num_kv_heads or cfg.num_kv_heads, cfg.head_dim)
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


def embed_tokens(params: Params, token_ids: torch.Tensor, tp_group=None) -> torch.Tensor:
    """token_ids [...] int → embeddings [..., D]. Ids are clipped to the
    vocab, as JAX clamps its gathers: the sentinel IMAGE_TOKEN_INDEX=-200
    would otherwise wrap (CPU) or fault (CUDA); the caller overwrites those
    positions with image features. tp_group: the 'model' group of an embed
    split on its hidden dim ([V, D/n], parallel/sharding); the hidden
    shards are gathered, so every rank gets the whole [..., D]."""
    V = params["embed"].shape[0]
    return comm.gather_last(params["embed"][token_ids.clamp(0, V - 1)], tp_group)


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


def linear(h: torch.Tensor, w: Any, li: int, act_quant: bool = False, *,
           tp_group=None, tp_mode: str = "column") -> torch.Tensor:
    """h [B, S, in] x layer li of a stacked linear [L, out, in] (or the
    tuple of its layers, layer_views) → [B, S, out]: int4 stacks through
    K4's dispatch, int8 ones through K1's (with act_quant, W8A8 from
    W8A8_MIN_ROWS rows on), float ones through torch.matmul.

    tp_group: this rank's shard of a tensor-parallel stack over the 'model'
    group. column: h is whole, the output is this rank's columns; row: h is
    this rank's slice of the contraction and the partial products are
    summed over the group (int8: ops/quant.int8_matmul_stacked_tp, which
    applies the scales after the sum)."""
    if tp_group is not None and is_quantized(w):
        return int8_matmul_stacked_tp(h, w, li, tp_group, tp_mode, act_quant=act_quant)
    if is_quantized_int4(w):
        out = int4_matmul_stacked_dispatch(h, w, li)
    elif is_quantized(w):
        out = int8_matmul_stacked_dispatch(h, w, li, act_quant=act_quant)
    else:
        out = h @ w[li].t()
    return comm.reduce_from(out, tp_group) if tp_mode == "row" else out


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


def _take_heads(x, heads: Optional[torch.Tensor]):
    """x [..., K, Dh] (or an int8 (values, scales) pair) at the kv heads
    `heads` (None: all, as they are)."""
    if heads is None:
        return x
    if isinstance(x, tuple):
        return tuple(t.index_select(-2, heads) for t in x)
    return x.index_select(-2, heads)


def attend(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, li: int, cache: Optional[KVCache],
    cache_offset: torch.Tensor, is_decode: bool, cache_row_offset: int, attn_impl: str,
    shared_kv: Optional[KVCache] = None, shared_len: Optional[torch.Tensor] = None,
    shared_rows_per_prefix: Optional[int] = None, shared_rows_per_prefix2: int = 0,
    kv_heads: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One layer's attention, as `forward` (which see for the arguments)
    runs it: k and v [B, S, K, Dh] are written into the cache first (if
    any); then a decode step attends over the cache rows, a prefill
    causally within its block (K3 or mha by attn_impl), and either one
    against the shared prefix segment too when shared_kv is given.
    kv_heads: each query head's kv head, where the kv heads stay whole on a
    tensor-parallel rank that holds only some query heads (forward); every
    key and value read is taken at those heads."""
    B = q.shape[0]
    if cache is not None:
        _write_kv(cache, k, v, li, cache_offset, is_decode, cache_row_offset)
    k, v = _take_heads(k, kv_heads), _take_heads(v, kv_heads)
    rows = slice(cache_row_offset, cache_row_offset + B)
    if shared_kv is None:
        if is_decode:
            kc, vc = _read_kv(cache, li, rows)
            return decode_attention(q, _take_heads(kc, kv_heads), _take_heads(vc, kv_heads), cache_offset)
        return causal_attention(q, k, v, impl=attn_impl)
    k_sh = _take_heads(_read_shared(shared_kv, li, "k", "ks"), kv_heads)
    v_sh = _take_heads(_read_shared(shared_kv, li, "v", "vs"), kv_heads)
    grouped = shared_kv["k"].dim() == 5  # [L, G, P, K, Dh]: one prefix per row group
    two = {}
    if "k2" in shared_kv:  # second (text-branch) segment table
        two = dict(k_sh2=_take_heads(_read_shared(shared_kv, li, "k2", "k2s"), kv_heads),
                   v_sh2=_take_heads(_read_shared(shared_kv, li, "v2", "v2s"), kv_heads),
                   rows_per_prefix2=shared_rows_per_prefix2)
    if is_decode:
        kc, vc = (_take_heads(x, kv_heads) for x in _read_kv(cache, li, rows))
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
    tp_mesh      optional ('data', 'model') DeviceMesh whose 'model' axis
                 this rank's tree is sharded over (parallel/sharding):
                 column-parallel q/k/v/gate/up (fused stacks split block by
                 block), row-parallel o/down, each followed by one
                 all_reduce over 'model' (Megatron; int8 stacks through
                 ops/quant.int8_matmul_stacked_tp). Attention runs on the
                 local heads (H/n, and K/n kv heads in the cache; where K
                 does not split n ways, k/v and the cache stay whole and
                 each query head reads its kv head). The caller passes it
                 only for a tree whose layer stacks are split (not for
                 int4 stacks, or int8 stacks the engine could not align:
                 those run whole, with no collective). embeds are whole on
                 every rank, and so is the returned hidden.

    Returns (hidden [B, S, D] after the final norm, cache).
    """
    B, S, _ = embeds.shape
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    if cache_offset is None:
        cache_offset = torch.zeros((B,), dtype=torch.long, device=embeds.device)
    cache_offset = cache_offset.long()
    is_decode = cache is not None and S == 1

    layers = layer_views(params["layers"])
    QD, KD = cfg.q_dim, cfg.kv_dim
    Hn, Kn, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    group, kv_heads = None, None
    if tp_mesh is not None and axis_size(tp_mesh, "model") > 1:
        n = axis_size(tp_mesh, "model")
        group = axis_group(tp_mesh, "model")
        QD, Hn = QD // n, Hn // n
        if Kn % n == 0:  # parallel/sharding's rule for k and v
            KD, Kn = KD // n, Kn // n
        else:
            # kv heads that do not split over 'model' stay whole (and so
            # does the cache): this rank's query heads read theirs
            r = axis_rank(tp_mesh, "model")
            g = cfg.num_heads // cfg.num_kv_heads
            kv_heads = torch.tensor([(r * Hn + j) // g for j in range(Hn)], device=embeds.device)

    def lin(h, name, li):
        return linear(h, layers[name], li, act_quant, tp_group=group, tp_mode=int8_tp_mode(name))

    def attn_fn(q, k, v, li):
        return attend(q, k, v, li, cache, cache_offset, is_decode, cache_row_offset, attn_impl,
                      shared_kv, shared_len, shared_rows_per_prefix, shared_rows_per_prefix2, kv_heads)

    x = embeds
    for li in range(cfg.num_layers):
        h = rms_norm(x, layers["attn_norm"][li], cfg.rms_norm_eps)
        hq = comm.copy_to(h, group)
        if "qkv" in layers:
            qkv = lin(hq, "qkv", li)  # one launch streams q|k|v
            q = qkv[..., :QD].reshape(B, S, Hn, Dh)
            k = qkv[..., QD : QD + KD].reshape(B, S, Kn, Dh)
            v = qkv[..., QD + KD : QD + 2 * KD].reshape(B, S, Kn, Dh)
        elif kv_heads is None:
            q = lin(hq, "q", li).reshape(B, S, Hn, Dh)
            k = lin(hq, "k", li).reshape(B, S, Kn, Dh)
            v = lin(hq, "v", li).reshape(B, S, Kn, Dh)
        else:
            # whole k and v on every rank; under autograd each rank's share
            # of their gradient (its query heads') is summed over the group
            q = lin(hq, "q", li).reshape(B, S, Hn, Dh)
            k = comm.copy_to(linear(h, layers["k"], li, act_quant), group).reshape(B, S, Kn, Dh)
            v = comm.copy_to(linear(h, layers["v"], li, act_quant), group).reshape(B, S, Kn, Dh)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn = attn_fn(q, k, v.contiguous(), li)
        x = x + lin(attn.reshape(B, S, QD), "o", li)

        h = comm.copy_to(rms_norm(x, layers["mlp_norm"][li], cfg.rms_norm_eps), group)
        if "gateup" in layers:
            gu = lin(h, "gateup", li)  # one launch streams gate|up
            # split at the stack's own half-width, not cfg.intermediate_size:
            # TP lane padding may have widened each half (ops/quant.
            # pad_llama_quantized_for_tp), and a rank holds [gate_r | up_r]
            Fh = gu.shape[-1] // 2
            act = silu(gu[..., :Fh]) * gu[..., Fh:]
        else:
            act = silu(lin(h, "gate", li)) * lin(h, "up", li)
        x = x + lin(act, "down", li)

    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps), cache


def logits_from_hidden(params: Params, hidden: torch.Tensor, tp_group=None,
                       vocab: Optional[int] = None) -> torch.Tensor:
    """lm_head → fp32 logits [..., V]. The int8 lm_head returns h's dtype
    from the kernel and is then widened, as in the JAX package.
    tp_group: the 'model' group of a vocab-parallel lm_head (this rank's
    comm.shard_range rows of the `vocab`, int8 through K2 on them); the
    ranks' logits are gathered, so every rank gets the whole vocab."""
    w = params["lm_head"]
    hidden = comm.copy_to(hidden, tp_group)
    if is_quantized(w):
        out = int8_matmul(hidden, w).float()
    else:
        out = hidden.to(w.dtype).float() @ w.float().t()
    return comm.gather_last(out, tp_group, vocab)


def last_token_logits(
    params: Params, hidden: torch.Tensor, last_index: torch.Tensor, tp_group=None,
    vocab: Optional[int] = None,
) -> torch.Tensor:
    """Hidden at each row's last valid position, then one [B,D]x[D,V] matmul."""
    B = hidden.shape[0]
    gathered = hidden[torch.arange(B, device=hidden.device), last_index.long()]
    return logits_from_hidden(params, gathered, tp_group, vocab)


def param_count(params: Params) -> int:
    """The number of elements in the tree's tensors (an int8 leaf counts
    its codes and its scales, as the JAX package counts its arrays)."""
    n = 0
    stack = [params]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, torch.Tensor):
            n += x.numel()
    return n
