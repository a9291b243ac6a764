"""Weight-only int8 quantization for serving (torch twin of
llava_align_tpu/ops/quant.py, int8 part).

Weights are stored int8 with per-output-channel absmax scales. Two matmul
paths, which round differently:

* the kernel path (csrc/int8_mm.cu, K1/K2 below): weights widened in
  registers, fp32 accumulation, the scale applied once after the reduction
  over D — the math of the TPU kernels _int8_mm_stacked_kernel and
  _int8_mm_kernel;
* the dequant path (int8_matmul_dequant, twin of int8_matmul_xla): q*s
  rounded to the activation dtype first, then torch.matmul.

Dispatch: row counts up to DECODE_MAX_ROWS (decode) take the kernel, larger
ones (prefill) the dequant path — as the JAX package sends large row counts
to XLA outside Pallas.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from llava_align_tpu_torch.ops import _kernels

# Provisional: rows up to here take the weight-streaming kernel, above it the
# dequant + torch.matmul path. To be set by measuring on the H100.
DECODE_MAX_ROWS = 64


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[..., O, D] float → {'q': int8 [..., O, D], 's': fp32 [..., O]}."""
    wf = w.float()
    absmax = wf.abs().amax(dim=-1)
    s = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 127.0)
    q = torch.clamp(torch.round(wf / s[..., None]), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def dequantize(wq: Dict[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    return (wq["q"].float() * wq["s"][..., None]).to(dtype)


def int8_matmul_dequant(h: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """h [..., D] x int8 [O, D] (scales [O]) → [..., O] in h.dtype. Twin of
    int8_matmul_xla: dequantize to the activation dtype, then matmul."""
    w = (q.float() * s[:, None]).to(h.dtype)
    return torch.matmul(h, w.t())


# ---------------------------------------------------------------------------
# K1 / K2: the int8 weight-streaming kernel (csrc/int8_mm.cu)
# ---------------------------------------------------------------------------


def int8_matmul_plain(h: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernels' math: fp32 reduction, scale after it,
    cast to h's dtype. h [B, D], q int8 [O, D], s [O] → [B, O]."""
    return ((h.float() @ q.float().t()) * s).to(h.dtype)


def _check_kernel_args(h: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> None:
    """What the CUDA kernel takes; anything else raises."""
    if not (q.is_cuda and s.is_cuda and q.device == h.device == s.device):
        raise ValueError("h, q and s must lie on one CUDA device")
    if h.dtype not in _kernels.DTYPE_CODE:
        raise TypeError(f"activation dtype {h.dtype} not supported (bf16/fp32)")
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"weights must be int8 with fp32 scales, got {q.dtype}/{s.dtype}")
    if h.dim() != 2 or not (h.is_contiguous() and q.is_contiguous() and s.is_contiguous()):
        raise ValueError("h must be a contiguous [B, D] matrix; q and s contiguous")
    B, D = h.shape
    if not 1 <= B <= DECODE_MAX_ROWS:
        raise ValueError(f"kernel takes 1..{DECODE_MAX_ROWS} rows, got {B}")
    if D % 16 or q.shape[-1] != D:
        raise ValueError(f"D={D} must be a multiple of 16 and match q {tuple(q.shape)}")
    if any(t.data_ptr() % 16 for t in (h, q, s)):
        raise ValueError("kernel operands must be 16-byte aligned")


def int8_matmul_stacked_plain(
    h: torch.Tensor, q: torch.Tensor, s: torch.Tensor, layer_idx: int
) -> torch.Tensor:
    return int8_matmul_plain(h, q[layer_idx], s[layer_idx])


def int8_matmul_stacked(
    h: torch.Tensor, q: torch.Tensor, s: torch.Tensor, layer_idx: int
) -> torch.Tensor:
    """K1 wrapper (twin of int8_matmul_stacked, TPU kernel
    _int8_mm_stacked_kernel): h [B, D] x q int8 [L, O, D] at layer
    `layer_idx`, scales s [L, O] → [B, O] in h's dtype. The layer is a
    pointer offset into the whole stack. CPU tensors take the plain version."""
    if h.device.type == "cpu":
        return int8_matmul_stacked_plain(h, q, s, layer_idx)
    _check_kernel_args(h, q, s)
    L, O, D = q.shape
    if s.shape != (L, O) or not 0 <= layer_idx < L:
        raise ValueError(f"bad scales {tuple(s.shape)} or layer {layer_idx} for q {tuple(q.shape)}")
    y = torch.empty((h.shape[0], O), dtype=h.dtype, device=h.device)
    err = _kernels.lib().int8_mm_stacked(
        h.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
        h.shape[0], O, D, int(layer_idx), _kernels.DTYPE_CODE[h.dtype],
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    _kernels.check(err, "int8_mm_stacked")
    int8_matmul_stacked.launches += 1
    return y


int8_matmul_stacked.launches = 0


def int8_matmul_cuda(h: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """K2 wrapper (twin of int8_matmul_tpu, TPU kernel _int8_mm_kernel):
    h [B, D] x q int8 [O, D], s [O] → [B, O] in h's dtype; the int8 lm_head.
    CPU tensors take the plain version."""
    if h.device.type == "cpu":
        return int8_matmul_plain(h, q, s)
    _check_kernel_args(h, q, s)
    O, D = q.shape
    if s.shape != (O,):
        raise ValueError(f"bad scales {tuple(s.shape)} for q {tuple(q.shape)}")
    y = torch.empty((h.shape[0], O), dtype=h.dtype, device=h.device)
    err = _kernels.lib().int8_mm(
        h.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
        h.shape[0], O, D, _kernels.DTYPE_CODE[h.dtype],
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    _kernels.check(err, "int8_mm")
    int8_matmul_cuda.launches += 1
    return y


int8_matmul_cuda.launches = 0


def _rows(h: torch.Tensor) -> int:
    n = 1
    for d in h.shape[:-1]:
        n *= int(d)
    return n


def int8_matmul_stacked_dispatch(
    h: torch.Tensor, wq: Dict[str, torch.Tensor], layer_idx: int, *,
    act_quant: bool = False,
) -> torch.Tensor:
    """h [..., D] x stacked quantized [L, O, D] at layer_idx → [..., O].
    Decode row counts (<= DECODE_MAX_ROWS) take K1; prefill rows the dequant
    path. act_quant (W8A8) is not ported yet."""
    if act_quant:
        raise NotImplementedError("W8A8 (act_quant) is not ported yet")
    q, s = wq["q"], wq["s"]
    lead = h.shape[:-1]
    if _rows(h) <= DECODE_MAX_ROWS:
        out = int8_matmul_stacked(h.reshape(-1, h.shape[-1]).contiguous(), q, s, layer_idx)
        return out.reshape(*lead, q.shape[1])
    return int8_matmul_dequant(h, q[layer_idx], s[layer_idx])


def int8_matmul(h: torch.Tensor, wq: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Dispatcher: h [..., D] x quantized [O, D] → [..., O]. Decode row
    counts take K2; prefill rows the dequant path."""
    q, s = wq["q"], wq["s"]
    lead = h.shape[:-1]
    if _rows(h) <= DECODE_MAX_ROWS:
        out = int8_matmul_cuda(h.reshape(-1, h.shape[-1]).contiguous(), q, s)
        return out.reshape(*lead, q.shape[0])
    return int8_matmul_dequant(h, q, s)


# ---------------------------------------------------------------------------
# llama param-tree quantization
# ---------------------------------------------------------------------------

_LLAMA_QUANT_KEYS = ("q", "k", "v", "o", "gate", "up", "down")


def quantize_llama_params(
    params: Dict[str, Any], fuse: bool = True, bits: int = 8,
) -> Dict[str, Any]:
    """Quantize the llama linears (stacked [L, O, D]) and the lm_head; the
    embedding table stays as it is. fuse=True packs q|k|v into one 'qkv'
    stack and gate|up into one 'gateup' stack (per-output-channel scales make
    that bit-identical to quantizing the parts). bits=4 is not ported yet."""
    if bits != 8:
        raise NotImplementedError(f"bits={bits}: only int8 is ported")
    out = dict(params)
    layers = dict(params["layers"])
    if fuse:
        layers["qkv"] = quantize_weight(
            torch.cat([layers.pop("q"), layers.pop("k"), layers.pop("v")], dim=1)
        )
        layers["gateup"] = quantize_weight(
            torch.cat([layers.pop("gate"), layers.pop("up")], dim=1)
        )
        layers["o"] = quantize_weight(layers["o"])
        layers["down"] = quantize_weight(layers["down"])
    else:
        for k in _LLAMA_QUANT_KEYS:
            layers[k] = quantize_weight(params["layers"][k])
    out["layers"] = layers
    out["lm_head"] = quantize_weight(params["lm_head"])
    return out
