"""Attention ops (torch twin of llava_align_tpu/ops/attention.py).

Layouts:
    q        [B, S, H, Dh]
    k, v     [B, S, K, Dh]          (K = num kv heads; GQA via H % K == 0)
    cache    [B, Smax, K, Dh]

All softmax math is float32; inputs may be bf16. `mha` and
`decode_attention` are plain torch, as their JAX counterparts are XLA
einsums; causal prefill goes through the flash kernel K3
(csrc/flash_attn.cu) on the card.
"""

from __future__ import annotations

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
) -> torch.Tensor:
    """Plain attention (twin of mha_xla). q [B,Sq,H,Dh], k/v [B,Sk,K,Dh] →
    [B,Sq,H,Dh]. Logits and softmax in fp32; the probabilities are rounded to
    v's dtype before PV, as mha_xla does."""
    B, Sq, H, Dh = q.shape
    K = k.shape[2]
    scale = 1.0 / (Dh**0.5)
    qr = q.reshape(B, Sq, K, H // K, Dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qr.float(), k.float()) * scale
    if causal:
        logits = logits.masked_fill(~_causal_mask(Sq, k.shape[1], q.device), NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def decode_attention(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """Single-step decode attention over a KV cache.

    q        [B, 1, H, Dh]   (query token already written to cache at lengths[b])
    k/v      [B, Smax, K, Dh]
    lengths  [B] int — index of the current token; keys j <= lengths[b] attend.

    Per-row lengths make the packed VDD branch axis honest: the 'none' row is
    genuinely shorter, and masking reproduces its physical removal.
    """
    if isinstance(k_cache, tuple) or isinstance(v_cache, tuple):
        raise NotImplementedError("int8 KV cache (kv_quant) is not ported yet")
    B, _, H, Dh = q.shape
    Smax, K = k_cache.shape[1], k_cache.shape[2]
    scale = 1.0 / (Dh**0.5)
    qr = q.to(k_cache.dtype).reshape(B, K, H // K, Dh)
    logits = torch.einsum("bkgd,bskd->bkgs", qr.float(), k_cache.float()) * scale
    pos = torch.arange(Smax, device=q.device)
    mask = pos[None, :] <= lengths.to(q.device)[:, None]  # [B, Smax]
    logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(B, 1, H, Dh).to(q.dtype)


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
    Dh in {64, 128}; bf16 or fp32. CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
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


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal self-attention for prefill. Every CUDA prefill goes to K3 (the
    JAX package's 1536-token XLA/Pallas cut-over was measured on a TPU and
    does not carry over); CPU tensors take K3's plain version."""
    return flash_attention(q, k, v)
