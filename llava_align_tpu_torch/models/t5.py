"""T5 / Flan-T5 encoder-decoder, BLIP-2's third LLM backend (torch twin of
llava_align_tpu/models/t5.py).

Capability parity: reference experiments/lavis/models/blip2_models/
modeling_t5.py (vendored HF T5): T5LayerNorm (RMS, no bias), UNSCALED
attention (no 1/sqrt(d)), a bucketed relative position bias held by layer
0 and shared, a causal decoder with cross-attention, a gated-GELU FFN
(flan, the tanh form) or ReLU (t5 v1.0), optional tied-embedding output
scaling.

The relative-position buckets are integers computed ON THE HOST (numpy,
the JAX function's float32 ops in its order) for each call's query and key
positions, then gathered on the device: the bucket of a distance whose
real log ratio is an exact integer (16, 32 and 64 at 32 buckets, max
distance 128) depends on the last bit of a float32 log, which a CUDA log
need not share with XLA's.

Param tree (linears [out, in]; encoder/decoder layers are lists):
    shared [V, D], lm_head [V, D] (None when tie_word_embeddings)
    encoder/{rel_bias [NB, H], final_ln [D]},
    encoder/layers[i]/{ln1, attn {q, k, v, o}, ln2, ffn}
    decoder/{rel_bias, final_ln},
    decoder/layers[i]/{ln1, attn, ln_x, xattn, ln2, ffn}
    ffn: {wi_0, wi_1, wo} (gated) or {wi, wo}
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from llava_align_tpu_torch.ops.layers import rms_norm

Params = Dict[str, Any]
NEG = -1e30


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 2048       # flan-t5-xl
    d_kv: int = 64
    num_heads: int = 32
    d_ff: int = 5120
    num_layers: int = 24       # encoder layers
    num_decoder_layers: int = 24
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    gated_act: bool = True     # flan: gated-gelu; t5 v1.0: relu
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.d_kv

    @staticmethod
    def flan_t5_xl() -> "T5Config":
        return T5Config()

    @staticmethod
    def tiny(vocab_size: int = 128) -> "T5Config":
        return T5Config(
            vocab_size=vocab_size, d_model=32, d_kv=8, num_heads=4, d_ff=64,
            num_layers=2, num_decoder_layers=2, dtype=torch.float32,
        )


def relative_position_bucket(
    relative_position: np.ndarray, bidirectional: bool, num_buckets: int, max_distance: int,
) -> np.ndarray:
    """T5 bucketing of key_pos - query_pos, on the host: int32 buckets by
    the JAX function's float32 ops, in its order."""
    n = np.asarray(relative_position, np.int32)
    ret = np.zeros_like(n)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n > 0).astype(np.int32) * num_buckets
        n = np.abs(n)
    else:
        n = -np.minimum(n, 0)
    max_exact = num_buckets // 2
    ratio = n.astype(np.float32) / np.float32(max_exact) + np.float32(1e-9)
    scaled = (np.log(ratio) / np.float32(math.log(max_distance / max_exact))
              * np.float32(num_buckets - max_exact))
    val_large = np.minimum(max_exact + scaled.astype(np.int32), num_buckets - 1)
    return ret + np.where(n < max_exact, n, val_large)


def _rel_bias(side: Params, cfg: T5Config, q_pos: np.ndarray, k_pos: np.ndarray,
              bidirectional: bool) -> torch.Tensor:
    """[H, Sq, Sk] fp32 from the side's shared table [NB, H]; the buckets
    are computed on the host for these positions."""
    buckets = relative_position_bucket(
        np.asarray(k_pos)[None, :] - np.asarray(q_pos)[:, None], bidirectional,
        cfg.relative_attention_num_buckets, cfg.relative_attention_max_distance,
    )
    table = side["rel_bias"]
    return table[torch.from_numpy(buckets).to(table.device).long()].permute(2, 0, 1).float()


def _lin(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return h @ w.t()


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=True), term for term (T5's gelu_new)."""
    return x * (0.5 * (1.0 + torch.tanh(math.sqrt(2 / math.pi) * (x + 0.044715 * x**3))))


def _softmax_pv(scores: torch.Tensor, v: torch.Tensor, out_dtype) -> torch.Tensor:
    """fp32 softmax over the last axis, probabilities rounded to v's dtype,
    PV in fp32 → [B, Sq, H, Dk] in out_dtype."""
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float()).to(out_dtype)


def _attention(ap: Params, cfg: T5Config, q_in, k_in, v_in, bias, mask) -> torch.Tensor:
    """UNSCALED T5 attention; bias [H, Sq, Sk] or None; mask [B, Sq, Sk]
    bool or None."""
    B, Sq, _ = q_in.shape
    Sk = k_in.shape[1]
    H, Dk = cfg.num_heads, cfg.d_kv
    q = _lin(q_in, ap["q"]).reshape(B, Sq, H, Dk)
    k = _lin(k_in, ap["k"]).reshape(B, Sk, H, Dk)
    v = _lin(v_in, ap["v"]).reshape(B, Sk, H, Dk)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if bias is not None:
        scores = scores + bias[None]
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None], NEG)
    out = _softmax_pv(scores, v, q_in.dtype)
    return _lin(out.reshape(B, Sq, cfg.inner_dim), ap["o"])


def _ffn(fp: Params, cfg: T5Config, h: torch.Tensor) -> torch.Tensor:
    if cfg.gated_act:
        return _lin(_gelu_tanh(_lin(h, fp["wi_0"])) * _lin(h, fp["wi_1"]), fp["wo"])
    return _lin(torch.relu(_lin(h, fp["wi"])), fp["wo"])


def encode(params: Params, cfg: T5Config, inputs_embeds: torch.Tensor,
           attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """inputs_embeds [B, S, D] (the caller embeds tokens / the image prefix)
    → encoder states [B, S, D]."""
    B, S, _ = inputs_embeds.shape
    enc = params["encoder"]
    pos = np.arange(S)
    bias = _rel_bias(enc, cfg, pos, pos, bidirectional=True)
    mask = None
    if attention_mask is not None:
        mask = attention_mask[:, None, :].bool().expand(B, S, S)
    x = inputs_embeds
    for lp in enc["layers"]:
        h = rms_norm(x, lp["ln1"], cfg.layer_norm_eps)
        x = x + _attention(lp["attn"], cfg, h, h, h, bias, mask)
        x = x + _ffn(lp["ffn"], cfg, rms_norm(x, lp["ln2"], cfg.layer_norm_eps))
    return rms_norm(x, enc["final_ln"], cfg.layer_norm_eps)


def embed_tokens(params: Params, ids: torch.Tensor) -> torch.Tensor:
    V = params["shared"].shape[0]
    return params["shared"][ids.long().clamp(0, V - 1)]


def _head_logits(params: Params, cfg: T5Config, x: torch.Tensor) -> torch.Tensor:
    """Decoder states after final_ln → fp32 logits (the tied head scales
    by d_model^-0.5 first)."""
    if cfg.tie_word_embeddings:
        x = x * (cfg.d_model**-0.5)
        head = params["shared"]
    else:
        head = params["lm_head"]
    return x.to(head.dtype).float() @ head.float().t()


def decode(params: Params, cfg: T5Config, decoder_ids: torch.Tensor, encoder_hidden: torch.Tensor,
           encoder_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole (non-incremental) decoder pass: ids [B, T] → fp32 logits
    [B, T, V]."""
    B, T = decoder_ids.shape
    S = encoder_hidden.shape[1]
    dec = params["decoder"]
    x = embed_tokens(params, decoder_ids)
    pos = np.arange(T)
    bias = _rel_bias(dec, cfg, pos, pos, bidirectional=False)
    causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril().expand(B, T, T)
    xmask = None
    if encoder_mask is not None:
        xmask = encoder_mask[:, None, :].bool().expand(B, T, S)
    eps = cfg.layer_norm_eps
    for lp in dec["layers"]:
        h = rms_norm(x, lp["ln1"], eps)
        x = x + _attention(lp["attn"], cfg, h, h, h, bias, causal)
        h = rms_norm(x, lp["ln_x"], eps)
        x = x + _attention(lp["xattn"], cfg, h, encoder_hidden, encoder_hidden, None, xmask)
        x = x + _ffn(lp["ffn"], cfg, rms_norm(x, lp["ln2"], eps))
    return _head_logits(params, cfg, rms_norm(x, dec["final_ln"], eps))


# ---------------------------------------------------------------------------
# incremental decoding: one stacked self-attention cache [L, B, Smax, H, Dk]
# written in place, and the cross-attention K/V computed once per prompt
# ---------------------------------------------------------------------------


def init_self_cache(cfg: T5Config, batch: int, max_len: int, dtype: Optional[torch.dtype] = None,
                    device=None) -> Dict[str, torch.Tensor]:
    shape = (cfg.num_decoder_layers, batch, max_len, cfg.num_heads, cfg.d_kv)
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def precompute_cross_kv(params: Params, cfg: T5Config, encoder_hidden: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Cross-attention K/V of every decoder layer: [L, B, S, H, Dk] pairs."""
    B, S, _ = encoder_hidden.shape
    H, Dk = cfg.num_heads, cfg.d_kv
    layers = params["decoder"]["layers"]
    return {
        "k": torch.stack([_lin(encoder_hidden, lp["xattn"]["k"]).reshape(B, S, H, Dk) for lp in layers]),
        "v": torch.stack([_lin(encoder_hidden, lp["xattn"]["v"]).reshape(B, S, H, Dk) for lp in layers]),
    }


def decode_step(params: Params, cfg: T5Config, token_ids: torch.Tensor, t: int,
                cache: Dict[str, torch.Tensor], cross_kv: Dict[str, torch.Tensor],
                encoder_mask: Optional[torch.Tensor] = None):
    """One decoder step: token_ids [B] at position t (an int) → (fp32 logits
    [B, V], the cache, updated in place)."""
    B = token_ids.shape[0]
    H, Dk, eps = cfg.num_heads, cfg.d_kv, cfg.layer_norm_eps
    dec = params["decoder"]
    Smax = cache["k"].shape[2]
    x = embed_tokens(params, token_ids[:, None])  # [B, 1, D]
    bias = _rel_bias(dec, cfg, np.array([t]), np.arange(Smax), bidirectional=False)  # [H, 1, Smax]
    self_mask = (torch.arange(Smax, device=x.device) <= t)[None, None, None, :]
    xmask = None
    if encoder_mask is not None:
        xmask = encoder_mask[:, None, None, :].bool()
    kc, vc = cache["k"], cache["v"]
    for li, lp in enumerate(dec["layers"]):
        h = rms_norm(x, lp["ln1"], eps)
        q = _lin(h, lp["attn"]["q"]).reshape(B, 1, H, Dk)
        kc[li, :, t] = _lin(h, lp["attn"]["k"]).reshape(B, H, Dk)
        vc[li, :, t] = _lin(h, lp["attn"]["v"]).reshape(B, H, Dk)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kc[li].float()) + bias[None]
        attn = _softmax_pv(scores.masked_fill(~self_mask, NEG), vc[li], x.dtype)
        x = x + _lin(attn.reshape(B, 1, cfg.inner_dim), lp["attn"]["o"])

        h = rms_norm(x, lp["ln_x"], eps)
        q = _lin(h, lp["xattn"]["q"]).reshape(B, 1, H, Dk)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), cross_kv["k"][li].float())
        if xmask is not None:
            scores = scores.masked_fill(~xmask, NEG)
        attn = _softmax_pv(scores, cross_kv["v"][li], x.dtype)
        x = x + _lin(attn.reshape(B, 1, cfg.inner_dim), lp["xattn"]["o"])
        x = x + _ffn(lp["ffn"], cfg, rms_norm(x, lp["ln2"], eps))
    return _head_logits(params, cfg, rms_norm(x, dec["final_ln"], eps))[:, 0], cache


@torch.inference_mode()
def generate_greedy(params: Params, cfg: T5Config, encoder_hidden: torch.Tensor,
                    encoder_mask: Optional[torch.Tensor] = None, *, max_new_tokens: int = 32,
                    decoder_start_token_id: int = 0, eos_token_id: int = 1) -> List[List[int]]:
    """Greedy decode over the incremental cache, one host read a step;
    each row stops at its eos (excluded). Returns List[List[int]]."""
    B = encoder_hidden.shape[0]
    dev = encoder_hidden.device
    cache = init_self_cache(cfg, B, max_new_tokens, device=dev)
    cross_kv = precompute_cross_kv(params, cfg, encoder_hidden)
    token = np.full((B,), decoder_start_token_id, np.int64)
    done = np.zeros((B,), bool)
    rows = []
    for t in range(max_new_tokens):
        logits, cache = decode_step(params, cfg, torch.from_numpy(token).to(dev), t, cache, cross_kv,
                                    encoder_mask)
        nxt = logits.argmax(-1).cpu().numpy()
        nxt = np.where(done, eos_token_id, nxt)
        rows.append(nxt)
        done |= nxt == eos_token_id
        token = nxt
        if done.all():
            break
    ids = np.stack(rows, axis=1) if rows else np.zeros((B, 0), np.int64)
    out = []
    for b in range(B):
        row = ids[b].tolist()
        if eos_token_id in row:
            row = row[: row.index(eos_token_id)]
        out.append(row)
    return out
