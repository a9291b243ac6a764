"""Attention ops (torch twin of llava_align_tpu/ops/attention.py).

Layouts:
    q        [B, S, H, Dh]
    k, v     [B, S, K, Dh]          (K = num kv heads; GQA via H % K == 0)
    cache    [B, Smax, K, Dh], or an int8 (values [B, Smax, K, Dh], fp32
             scales [B, Smax, K, 1]) tuple (ops/quant.kv_quantize_block)

All softmax math is float32; inputs may be bf16. `mha`, `decode_attention`
and the shared-prefix (grouped) variants are plain torch, as their JAX
counterparts are XLA einsums; causal prefill goes through the flash kernel
K3 (csrc/flash_attn.cu) on the card where K3 takes the shape, and through
mha where it does not (causal_attention_impl).
"""

from __future__ import annotations

from typing import Optional

import torch

from llava_align_tpu_torch.ops import _kernels

NEG_INF = -1e30


def _causal_mask(sq: int, sk: int, device) -> torch.Tensor:
    """[Sq, Sk] bool, True where key col <= query row."""
    return torch.ones((sq, sk), dtype=torch.bool, device=device).tril()


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain attention (twin of mha_xla). q [B,Sq,H,Dh], k/v [B,Sk,K,Dh] →
    [B,Sq,H,Dh]. Logits and softmax in fp32; the probabilities are rounded to
    v's dtype before PV, as mha_xla does. bias: added to the fp32 logits
    [B, K, H/K, Sq, Sk] (after the causal mask, before the softmax), or
    anything that broadcasts to them."""
    B, Sq, H, Dh = q.shape
    K = k.shape[2]
    scale = 1.0 / (Dh**0.5)
    qr = q.reshape(B, Sq, K, H // K, Dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qr.float(), k.float()) * scale
    if causal:
        logits = logits.masked_fill(~_causal_mask(Sq, k.shape[1], q.device), NEG_INF)
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def _kv_parts(x):
    """Cache and segment operands are either a plain tensor or an int8
    (values, scales) tuple (ops/quant.kv_quantize_block's layout: the scales
    carry a trailing singleton over Dh). Quantized operands are consumed
    scale-folded, as in the JAX package: the per-(position, head) scale
    multiplies the [.., S] logits or probabilities, never the [.., S, K, Dh]
    operand. Here the int8 values are widened to fp32 for the einsum (the
    JAX package does the same, fused by XLA)."""
    if isinstance(x, tuple):
        return x
    return x, None


def _fold_rows(scales: torch.Tensor) -> torch.Tensor:
    """[B, S, K, 1] scale plane → [B, K, 1, S] logits/probs multiplier."""
    return scales[..., 0].permute(0, 2, 1)[:, :, None, :]


def _slice_kv(x, sl):
    """Row-slice a cache operand that may be a (values, scales) tuple."""
    vals, scales = _kv_parts(x)
    return vals[sl] if scales is None else (vals[sl], scales[sl])


def decode_attention(q: torch.Tensor, k_cache, v_cache, lengths: torch.Tensor) -> torch.Tensor:
    """Single-step decode attention over a KV cache.

    q        [B, 1, H, Dh]   (query token already written to cache at lengths[b])
    k/v      [B, Smax, K, Dh], or int8 (values, scales) tuples (_kv_parts)
    lengths  [B] int — index of the current token; keys j <= lengths[b] attend.

    Per-row lengths make the packed VDD branch axis honest: the 'none' row is
    genuinely shorter, and masking reproduces its physical removal.
    """
    k_cache, k_s = _kv_parts(k_cache)
    v_cache, v_s = _kv_parts(v_cache)
    B, _, H, Dh = q.shape
    Smax, K = k_cache.shape[1], k_cache.shape[2]
    scale = 1.0 / (Dh**0.5)
    if k_s is None:
        qr = q.to(k_cache.dtype).reshape(B, K, H // K, Dh)
        logits = torch.einsum("bkgd,bskd->bkgs", qr.float(), k_cache.float()) * scale
    else:
        qr = q.float().reshape(B, K, H // K, Dh)
        logits = torch.einsum("bkgd,bskd->bkgs", qr, k_cache.float()) * (scale * _fold_rows(k_s))
    pos = torch.arange(Smax, device=q.device)
    mask = pos[None, :] <= lengths.to(q.device)[:, None]  # [B, Smax]
    logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if v_s is None:
        out = torch.einsum("bkgs,bskd->bkgd", probs.to(v_cache.dtype).float(), v_cache.float())
    else:
        out = torch.einsum("bkgs,bskd->bkgd", probs * _fold_rows(v_s), v_cache.float())
    return out.reshape(B, 1, H, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Shared-prefix (two-segment) attention, plain torch as the JAX package's
# XLA einsums. One [system + image] prefix is prefilled once into a
# read-only KV segment; per-row caches hold only the suffix and the
# generated tokens. Queries attend [shared | local] with one joint softmax,
# prefix keys first, so the math is that of an unshared prefill.
#
# k_sh/v_sh: [P, K, Dh] (one prefix, broadcast over rows) or, grouped,
# [G, P, K, Dh] with rows statically blocked by rows_per_prefix; sh_len [B]:
# valid prefix keys per row (0 = no shared segment). An optional second
# table (k_sh2/v_sh2, its own bucket) covers the rows right after the first
# table's span: rows are [table-1 span | table-2 span | plain rows]. Every
# cache and segment operand may be an int8 (values, scales) tuple.
# ---------------------------------------------------------------------------


def _fold_seg(scales: torch.Tensor) -> torch.Tensor:
    """[P, K, 1] segment scale plane → [1, K, 1, P] (callers broadcast over
    the leading B and any S axis)."""
    return scales[..., 0].permute(1, 0)[None, :, None, :]


def _fold_gseg(scales: torch.Tensor) -> torch.Tensor:
    """[G, P, K, 1] grouped segment scale plane → [G, 1, K, 1, P]."""
    return scales[..., 0].permute(0, 2, 1)[:, None, :, None, :]


def _shared_logits(q4: torch.Tensor, k_sh, sh_len: torch.Tensor, scale: float):
    """q4 [B,K,g,S,Dh] x k_sh [P,K,Dh] (or an int8 tuple) → masked fp32
    logits [B,K,g,S,P]."""
    k_sh, k_s = _kv_parts(k_sh)
    P = k_sh.shape[0]
    if k_s is None:
        logits = torch.einsum("bkgsd,pkd->bkgsp", q4.float(), k_sh.to(q4.dtype).float()) * scale
    else:
        logits = torch.einsum("bkgsd,pkd->bkgsp", q4.float(), k_sh.float()) * (
            scale * _fold_seg(k_s)[:, :, None])
    col = torch.arange(P, device=q4.device)
    valid = col < sh_len.to(q4.device)[:, None, None, None, None]
    return logits.masked_fill(~valid, NEG_INF)


def _seg_value_einsum(subs: str, probs: torch.Tensor, v_sh, compute_dtype, fold_shape):
    """probs x segment values summed in fp32: both rounded to compute_dtype,
    or, for an int8 segment, its scales folded into probs."""
    v_sh, v_s = _kv_parts(v_sh)
    if v_s is None:
        return torch.einsum(subs, probs.to(compute_dtype).float(), v_sh.to(compute_dtype).float())
    return torch.einsum(subs, probs * _fold_seg(v_s).reshape(fold_shape), v_sh.float())


def chunk_attention_shared(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_sh, v_sh, sh_len: torch.Tensor,
) -> torch.Tensor:
    """Suffix prefill: causal within the local block [B,S] + full attention to
    the shared prefix. The block is the first local cache content (local
    offset 0); absolute positions are sh_len[b] + i (RoPE applied by the
    caller). k_sh/v_sh may be int8 (values, scales) tuples."""
    B, S, H, Dh = q.shape
    K = k.shape[2]
    scale = 1.0 / (Dh**0.5)
    qr = q.to(k.dtype).reshape(B, S, K, H // K, Dh).permute(0, 2, 3, 1, 4)
    sh = _shared_logits(qr, k_sh, sh_len, scale)  # [B,K,g,S,P]
    loc = torch.einsum("bkgsd,btkd->bkgst", qr.float(), k.float()) * scale
    loc = loc.masked_fill(~_causal_mask(S, S, q.device), NEG_INF)
    probs = torch.nan_to_num(torch.softmax(torch.cat([sh, loc], dim=-1), dim=-1))
    P = _kv_parts(k_sh)[0].shape[0]
    out = _seg_value_einsum("bkgsp,pkd->bkgsd", probs[..., :P], v_sh, v.dtype,
                            (1, K, 1, 1, P)) + torch.einsum(
        "bkgst,btkd->bkgsd", probs[..., P:].to(v.dtype).float(), v.float()
    )
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, Dh).to(q.dtype)


def decode_attention_shared(
    q: torch.Tensor, k_cache, v_cache, lengths: torch.Tensor, k_sh, v_sh, sh_len: torch.Tensor,
) -> torch.Tensor:
    """decode_attention over [shared prefix | local cache]. lengths indexes
    the LOCAL cache (current token already written at lengths[b]). The cache
    and segment operands may be int8 (values, scales) tuples."""
    k_cache, k_s = _kv_parts(k_cache)
    v_cache, v_s = _kv_parts(v_cache)
    B, _, H, Dh = q.shape
    Smax, K = k_cache.shape[1], k_cache.shape[2]
    scale = 1.0 / (Dh**0.5)
    qr = q.to(torch.float32 if k_s is not None else k_cache.dtype).reshape(B, K, H // K, 1, Dh)
    sh = _shared_logits(qr, k_sh, sh_len, scale)[:, :, :, 0]  # [B,K,g,P]
    loc = torch.einsum("bkgd,bskd->bkgs", qr[:, :, :, 0].float(), k_cache.float())
    loc = loc * (scale if k_s is None else scale * _fold_rows(k_s))
    pos = torch.arange(Smax, device=q.device)
    loc = loc.masked_fill(~(pos[None, :] <= lengths.to(q.device)[:, None])[:, None, None, :], NEG_INF)
    probs = torch.softmax(torch.cat([sh, loc], dim=-1), dim=-1)
    P = _kv_parts(k_sh)[0].shape[0]
    vdt = torch.float32 if v_s is not None else v_cache.dtype
    out = _seg_value_einsum("bkgp,pkd->bkgd", probs[..., :P], v_sh, vdt, (1, K, 1, P))
    if v_s is None:
        out = out + torch.einsum("bkgs,bskd->bkgd", probs[..., P:].to(v_cache.dtype).float(),
                                 v_cache.float())
    else:
        out = out + torch.einsum("bkgs,bskd->bkgd", probs[..., P:] * _fold_rows(v_s), v_cache.float())
    return out.reshape(B, 1, H, Dh).to(q.dtype)


def _chunk_span_shared(
    qr: torch.Tensor,  # [Bs, K, g, S, Dh] rows of this span
    k: torch.Tensor,   # [Bs, S, K, Dh] local keys
    v: torch.Tensor,
    k_sh,              # [G, P, K, Dh], or an int8 (values, scales) tuple
    v_sh,
    sh_len: torch.Tensor,  # [Bs]
    R: int,
    scale: float,
) -> torch.Tensor:
    """One-table grouped chunk attention over a contiguous row span →
    [Bs, K, g, S, Dh] fp32."""
    k_sh, k_s = _kv_parts(k_sh)
    v_sh, v_s = _kv_parts(v_sh)
    Bs, K, g, S, Dh = qr.shape
    G, P = k_sh.shape[0], k_sh.shape[1]
    qg = qr.reshape(G, R, K, g, S, Dh)
    if k_s is None:
        sh = torch.einsum("Grkgsd,Gpkd->Grkgsp", qg.float(), k_sh.to(qr.dtype).float()) * scale
    else:
        sh = torch.einsum("Grkgsd,Gpkd->Grkgsp", qg.float(), k_sh.float()) * (
            scale * _fold_gseg(k_s)[:, :, :, :, None])
    col = torch.arange(P, device=qr.device)
    valid = col < sh_len.to(qr.device).reshape(G, R, 1, 1, 1, 1)
    sh = sh.masked_fill(~valid, NEG_INF).reshape(Bs, K, g, S, P)
    loc = torch.einsum("bkgsd,btkd->bkgst", qr.float(), k.float()) * scale
    loc = loc.masked_fill(~_causal_mask(S, S, qr.device), NEG_INF)
    probs = torch.nan_to_num(torch.softmax(torch.cat([sh, loc], dim=-1), dim=-1))
    p_sh = probs[..., :P].reshape(G, R, K, g, S, P)
    if v_s is None:
        out_sh = torch.einsum("Grkgsp,Gpkd->Grkgsd", p_sh.to(v.dtype).float(), v_sh.to(v.dtype).float())
    else:
        out_sh = torch.einsum("Grkgsp,Gpkd->Grkgsd", p_sh * _fold_gseg(v_s)[:, :, :, :, None],
                              v_sh.float())
    return out_sh.reshape(Bs, K, g, S, Dh) + torch.einsum(
        "bkgst,btkd->bkgsd", probs[..., P:].to(v.dtype).float(), v.float())


def chunk_attention_shared_grouped(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    k_sh, v_sh, sh_len: torch.Tensor, rows_per_prefix: int,
    k_sh2=None, v_sh2=None, rows_per_prefix2: int = 0,
) -> torch.Tensor:
    """Suffix prefill with one shared prefix per static row group. Rows are
    [table-1 span | table-2 span (optional)]; each span's rows block by its
    own rows_per_prefix. Segment tables may be int8 (values, scales)
    tuples."""
    B, S, H, Dh = q.shape
    K = k.shape[2]
    scale = 1.0 / (Dh**0.5)
    M1 = _kv_parts(k_sh)[0].shape[0] * rows_per_prefix
    qr = q.to(k.dtype).reshape(B, S, K, H // K, Dh).permute(0, 2, 3, 1, 4)
    out = _chunk_span_shared(qr[:M1], k[:M1], v[:M1], k_sh, v_sh, sh_len[:M1], rows_per_prefix, scale)
    if k_sh2 is not None:
        out2 = _chunk_span_shared(
            qr[M1:], k[M1:], v[M1:], k_sh2, v_sh2, sh_len[M1:], rows_per_prefix2, scale
        )
        out = torch.cat([out, out2], dim=0)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, Dh).to(q.dtype)


def _decode_span_shared(
    qr: torch.Tensor,  # [Ms, K, g, Dh]
    k_cache,           # [Ms, Smax, K, Dh], or an int8 (values, scales) tuple
    v_cache,
    lengths: torch.Tensor,  # [Ms]
    k_sh,              # [G, P, K, Dh], or an int8 tuple
    v_sh,
    sh_len: torch.Tensor,  # [Ms]
    R: int,
    scale: float,
) -> torch.Tensor:
    """One-table grouped decode attention over a row span → [Ms, K, g, Dh]
    fp32."""
    k_cache, k_s = _kv_parts(k_cache)
    v_cache, v_s = _kv_parts(v_cache)
    k_sh, ksh_s = _kv_parts(k_sh)
    v_sh, vsh_s = _kv_parts(v_sh)
    Ms, K, g, Dh = qr.shape
    G, P = k_sh.shape[0], k_sh.shape[1]
    Smax = k_cache.shape[1]
    qg = qr.reshape(G, R, K, g, Dh)
    if ksh_s is None:
        sh = torch.einsum("Grkgd,Gpkd->Grkgp", qg.float(), k_sh.to(qr.dtype).float()) * scale
    else:
        sh = torch.einsum("Grkgd,Gpkd->Grkgp", qg.float(), k_sh.float()) * (scale * _fold_gseg(ksh_s))
    col = torch.arange(P, device=qr.device)
    valid = col < sh_len.to(qr.device).reshape(G, R, 1, 1, 1)
    sh = sh.masked_fill(~valid, NEG_INF).reshape(Ms, K, g, P)
    loc = torch.einsum("bkgd,bskd->bkgs", qr.float(), k_cache.float())
    loc = loc * (scale if k_s is None else scale * _fold_rows(k_s))
    pos = torch.arange(Smax, device=qr.device)
    loc = loc.masked_fill(~(pos[None, :] <= lengths.to(qr.device)[:, None])[:, None, None, :], NEG_INF)
    probs = torch.softmax(torch.cat([sh, loc], dim=-1), dim=-1)
    p_sh = probs[..., :P].reshape(G, R, K, g, P)
    vdt = v_cache.dtype if v_s is None else torch.float32
    if vsh_s is None:
        out_sh = torch.einsum("Grkgp,Gpkd->Grkgd", p_sh.to(vdt).float(), v_sh.to(vdt).float())
    else:
        out_sh = torch.einsum("Grkgp,Gpkd->Grkgd", p_sh * _fold_gseg(vsh_s), v_sh.float())
    if v_s is None:
        out_loc = torch.einsum("bkgs,bskd->bkgd", probs[..., P:].to(vdt).float(), v_cache.float())
    else:
        out_loc = torch.einsum("bkgs,bskd->bkgd", probs[..., P:] * _fold_rows(v_s), v_cache.float())
    return out_sh.reshape(Ms, K, g, Dh) + out_loc


def decode_attention_shared_grouped(
    q: torch.Tensor, k_cache, v_cache, lengths: torch.Tensor,
    k_sh, v_sh, sh_len: torch.Tensor, rows_per_prefix: int,
    k_sh2=None, v_sh2=None, rows_per_prefix2: int = 0,
) -> torch.Tensor:
    """Decode over [the row group's shared prefix | local cache]. Row layout:
    [table-1 span | table-2 span (optional) | plain rows]; plain rows (text
    branches with no shared segment) attend their local cache only. Every
    cache and segment operand may be an int8 (values, scales) tuple."""
    k_vals, k_s = _kv_parts(k_cache)
    B, _, H, Dh = q.shape
    K = k_vals.shape[2]
    scale = 1.0 / (Dh**0.5)
    M1 = _kv_parts(k_sh)[0].shape[0] * rows_per_prefix
    M2 = _kv_parts(k_sh2)[0].shape[0] * rows_per_prefix2 if k_sh2 is not None else 0
    M = M1 + M2
    qr = q[:M].to(torch.float32 if k_s is not None else k_vals.dtype).reshape(M, K, H // K, Dh)
    outs = [_decode_span_shared(qr[:M1], _slice_kv(k_cache, slice(None, M1)),
                                _slice_kv(v_cache, slice(None, M1)), lengths[:M1],
                                k_sh, v_sh, sh_len[:M1], rows_per_prefix, scale)]
    if M2:
        outs.append(_decode_span_shared(qr[M1:M], _slice_kv(k_cache, slice(M1, M)),
                                        _slice_kv(v_cache, slice(M1, M)), lengths[M1:M],
                                        k_sh2, v_sh2, sh_len[M1:M], rows_per_prefix2, scale))
    out_m = torch.cat(outs, dim=0).reshape(M, 1, H, Dh).to(q.dtype)
    if M == B:
        return out_m
    out_r = decode_attention(q[M:], _slice_kv(k_cache, slice(M, None)),
                             _slice_kv(v_cache, slice(M, None)), lengths[M:])
    return torch.cat([out_m, out_r], dim=0)


# ---------------------------------------------------------------------------
# K3: causal flash attention (csrc/flash_attn.cu)
# ---------------------------------------------------------------------------


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel's math: fp32 causal softmax attention,
    output in q's dtype. q [B,S,H,Dh], k/v [B,S,K,Dh] → [B,S,H,Dh]."""
    B, S, H, Dh = q.shape
    K = k.shape[2]
    qr = q.float().reshape(B, S, K, H // K, Dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qr, k.float()) * (1.0 / (Dh**0.5))
    logits = logits.masked_fill(~_causal_mask(S, S, q.device), NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(B, S, H, Dh).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K3 wrapper (twin of flash_attention_tpu, TPU kernel _flash_kernel):
    causal attention, q [B,S,H,Dh], k/v [B,S,K,Dh] → [B,S,H,Dh]. Any S;
    Dh in {64, 128}; bf16 runs on the tensor cores (P rounded to bf16 before
    PV), fp32 on the CUDA cores. CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    _kernels.refuse_grad("flash_attention", q, k, v)
    B, S, H, Dh = q.shape
    if not (k.device == v.device == q.device and q.is_cuda):
        raise ValueError("q, k and v must lie on one CUDA device")
    if q.dtype not in _kernels.DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need one of bf16/fp32")
    if k.shape != v.shape or k.shape[:2] != (B, S) or k.shape[3] != Dh:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    K = k.shape[2]
    if Dh not in (64, 128) or H % K:
        raise ValueError(f"kernel takes Dh in (64, 128) and H % K == 0, got {Dh}, {H}/{K}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("kernel operands must be 16-byte aligned")
    o = torch.empty_like(q)
    err = _kernels.lib().flash_attn_causal(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, S, H, K, Dh, _kernels.DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _kernels.check(err, "flash_attn_causal")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0


def causal_attention_impl(Dh: int, H: int, K: int, dtype: torch.dtype, needs_grad: bool = False) -> str:
    """The dispatch rule of causal_attention(impl="auto"): 'pallas' (K3)
    where K3 takes the shape (Dh in {64, 128}, H % K == 0, bf16 or fp32),
    'xla' (mha, the twin of mha_xla) for every other shape, and always
    'xla' when a gradient is needed (K3 has no backward; the JAX package's
    flash kernel has no VJP either, and its 'auto' takes mha_xla off the
    TPU). The JAX package's 1536-token cut-over was measured on a TPU and
    does not carry over."""
    if needs_grad:
        return "xla"
    return "pallas" if Dh in (64, 128) and H % K == 0 and dtype in _kernels.DTYPE_CODE else "xla"


def causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, impl: str = "auto"
) -> torch.Tensor:
    """Causal self-attention for prefill (twin of causal_attention): 'pallas'
    runs K3 (CPU tensors: its plain version), 'xla' runs mha; 'auto' picks by
    causal_attention_impl (mha whenever autograd needs a backward)."""
    if impl == "auto":
        needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
        impl = causal_attention_impl(q.shape[3], q.shape[2], k.shape[2], q.dtype, needs_grad)
    if impl == "pallas":
        return flash_attention(q, k, v)
    if impl == "xla":
        return mha(q, k, v, causal=True)
    raise ValueError(f"impl must be 'auto', 'pallas' or 'xla', got {impl!r}")
