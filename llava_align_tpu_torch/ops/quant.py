"""Weight-only int8 and int4 quantization for serving (torch twin of
llava_align_tpu/ops/quant.py: the int8 part and the group-wise int4 part).

int8 weights are stored with per-output-channel absmax scales. Two matmul
paths, which round differently:

* the kernel path (csrc/int8_mm.cu, K1/K2 below): weights widened in
  registers, fp32 accumulation, the scale applied once after the reduction
  over D — the math of the TPU kernels _int8_mm_stacked_kernel and
  _int8_mm_kernel. Its regimes (stream_regime): bf16 at 1..64 rows on the
  tensor cores (csrc/stream_mma.cuh), fp32 at 1..64 rows on the CUDA cores,
  bf16 at 65..640 rows on the wgmma main loop;
* the dequant path (int8_matmul_dequant, twin of int8_matmul_xla): q*s
  rounded to the activation dtype first, then torch.matmul.

int8 dispatch, the JAX package's rule (_stream_rows_ok): every matrix
takes the kernel at row counts up to DECODE_MAX_ROWS (decode); output-major
ones (O >= D: the fused qkv, o and gate|up stacks, the lm_head) also up to
STREAM_MAX_ROWS, as the TPU sends them to its Pallas kernels up to 640 rows;
everything else (the down stack's prefill, rows past 640) takes the dequant
path. Above 64 rows the kernel runs its tiled regime (the wgmma main loop
of csrc/wq_gemm.cuh, shared with K4), which takes bf16 only.

int4 (group 128) keeps the JAX package's layout, so quantize_weight_int4 is
bit-identical to it and a JAX tree carries over as a copy: packed int8
[..., D/2, O] with O contiguous, split-half (low nibble = row d, high nibble
= row D/2 + d), fp32 group scales [..., D/group, O]. int4 dispatch: every
CUDA row count goes to the kernel K4 (csrc/int4_mm.cu; from
INT4_WGMMA_MIN_ROWS rows on the wgmma main loop it shares with K1/K2), as
the TPU package sends every row count to its Pallas kernel; CPU tensors
take its plain version.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from llava_align_tpu_torch.ops import _kernels

# Rows up to here run the int8 kernel's weight-streaming regimes (any dtype);
# up to STREAM_MAX_ROWS its tiled tensor-core regime (bf16 only).
DECODE_MAX_ROWS = 64
STREAM_MAX_ROWS = 640

def stream_regime(dtype: torch.dtype, rows: int) -> str:
    """Which body of K1/K2 runs a call, the rule compiled into
    csrc/int8_mm.cu: "mma" (bf16, 1..DECODE_MAX_ROWS rows: the tensor-core
    streaming kernel), "cuda_cores" (fp32, 1..DECODE_MAX_ROWS: fp32 FMAs, as
    bf16 MMAs would round fp32 activations) or "tiled" (bf16, up to
    STREAM_MAX_ROWS: the wgmma main loop). Every D the wrapper takes runs in
    the regime its dtype and rows pick."""
    if not 1 <= rows <= STREAM_MAX_ROWS:
        raise ValueError(f"kernel takes 1..{STREAM_MAX_ROWS} rows, got {rows}")
    if rows > DECODE_MAX_ROWS:
        if dtype != torch.bfloat16:
            raise TypeError(f"the tiled regime ({rows} rows > {DECODE_MAX_ROWS}) takes bf16 only")
        return "tiled"
    return "mma" if dtype == torch.bfloat16 else "cuda_cores"


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
    if D % 16 or q.shape[-1] != D:
        raise ValueError(f"D={D} must be a multiple of 16 and match q {tuple(q.shape)}")
    if stream_regime(h.dtype, B) == "tiled" and D % 64:
        raise TypeError(f"the tiled regime ({B} rows > {DECODE_MAX_ROWS}) takes D % 64 == 0, got D={D}")
    if any(t.data_ptr() % 16 for t in (h, q, s)):
        raise ValueError("kernel operands must be 16-byte aligned")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _int8_workspace(h: torch.Tensor, O: int, D: int) -> Optional[torch.Tensor]:
    """The fp32 split-K workspace of a tiled-regime call that splits D,
    else None (the streaming regimes need none: the tensor-core kernel
    reduces its splits inside a cluster; at a few rows a query and an
    allocation would cost as much as the kernel)."""
    if h.shape[0] <= DECODE_MAX_ROWS:
        return None
    n = _kernels.lib().int8_mm_workspace(h.shape[0], O, D)
    return torch.empty((n,), dtype=torch.float32, device=h.device) if n else None


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
    pointer offset into the whole stack. Up to DECODE_MAX_ROWS rows the
    kernel streams the weights (bf16 on the tensor cores, fp32 on the CUDA
    cores: stream_regime); up to STREAM_MAX_ROWS it runs its tiled regime,
    which takes bf16 only and raises on fp32. CPU tensors take the plain
    version."""
    if h.device.type == "cpu":
        return int8_matmul_stacked_plain(h, q, s, layer_idx)
    _check_kernel_args(h, q, s)
    L, O, D = q.shape
    if s.shape != (L, O) or not 0 <= layer_idx < L:
        raise ValueError(f"bad scales {tuple(s.shape)} or layer {layer_idx} for q {tuple(q.shape)}")
    y = torch.empty((h.shape[0], O), dtype=h.dtype, device=h.device)
    work = _int8_workspace(h, O, D)
    err = _kernels.lib().int8_mm_stacked(
        h.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(), _ptr(work),
        h.shape[0], O, D, int(layer_idx), _kernels.DTYPE_CODE[h.dtype], _kernels.stream_of(h),
    )
    _kernels.check(err, "int8_mm_stacked")
    int8_matmul_stacked.launches += 1
    return y


int8_matmul_stacked.launches = 0


def int8_matmul_cuda(h: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """K2 wrapper (twin of int8_matmul_tpu, TPU kernel _int8_mm_kernel):
    h [B, D] x q int8 [O, D], s [O] → [B, O] in h's dtype; the int8 lm_head.
    Rows and dtypes as int8_matmul_stacked. CPU tensors take the plain
    version."""
    if h.device.type == "cpu":
        return int8_matmul_plain(h, q, s)
    _check_kernel_args(h, q, s)
    O, D = q.shape
    if s.shape != (O,):
        raise ValueError(f"bad scales {tuple(s.shape)} for q {tuple(q.shape)}")
    y = torch.empty((h.shape[0], O), dtype=h.dtype, device=h.device)
    work = _int8_workspace(h, O, D)
    err = _kernels.lib().int8_mm(
        h.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(), _ptr(work),
        h.shape[0], O, D, _kernels.DTYPE_CODE[h.dtype], _kernels.stream_of(h),
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


def _stream_rows_ok(n_rows: int, O: int, D: int) -> bool:
    """The JAX package's dispatch rule: every matrix takes the kernel at
    decode rows, output-major (O >= D) ones up to STREAM_MAX_ROWS."""
    return n_rows <= DECODE_MAX_ROWS or (n_rows <= STREAM_MAX_ROWS and O >= D)


def int8_matmul_stacked_dispatch(
    h: torch.Tensor, wq: Dict[str, torch.Tensor], layer_idx: int, *,
    act_quant: bool = False,
) -> torch.Tensor:
    """h [..., D] x stacked quantized [L, O, D] at layer_idx → [..., O].
    Row counts the JAX package streams (_stream_rows_ok: every stack up to
    DECODE_MAX_ROWS, output-major ones up to STREAM_MAX_ROWS) take K1; the
    rest the dequant path. act_quant (W8A8) is not ported yet."""
    if act_quant:
        raise NotImplementedError("W8A8 (act_quant) is not ported yet")
    q, s = wq["q"], wq["s"]
    lead = h.shape[:-1]
    if _stream_rows_ok(_rows(h), q.shape[1], q.shape[2]):
        out = int8_matmul_stacked(h.reshape(-1, h.shape[-1]).contiguous(), q, s, layer_idx)
        return out.reshape(*lead, q.shape[1])
    return int8_matmul_dequant(h, q[layer_idx], s[layer_idx])


def int8_matmul(h: torch.Tensor, wq: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Dispatcher: h [..., D] x quantized [O, D] → [..., O]. Row counts the
    JAX package streams (_stream_rows_ok: the lm_head up to STREAM_MAX_ROWS)
    take K2; larger ones the dequant path."""
    q, s = wq["q"], wq["s"]
    lead = h.shape[:-1]
    if _stream_rows_ok(_rows(h), q.shape[0], q.shape[1]):
        out = int8_matmul_cuda(h.reshape(-1, h.shape[-1]).contiguous(), q, s)
        return out.reshape(*lead, q.shape[0])
    return int8_matmul_dequant(h, q, s)


# ---------------------------------------------------------------------------
# int4 weight-only, group-wise (twin of the JAX package's int4 part)
# ---------------------------------------------------------------------------

INT4_GROUP = 128

# K4 takes row counts up to here in its skinny (weight-streaming, CUDA-core)
# regime and larger ones in its tensor-core regimes. Set from the crossover
# measured on the H100 at the 13B stacks (PERF.md): the tensor cores are
# faster from 3 rows up. The same constant, kSkinnyMaxRows, is compiled
# into csrc/int4_mm.cu.
INT4_SKINNY_MAX_ROWS = 2
# K4's mma.sync tiles take rows above INT4_SKINNY_MAX_ROWS up to here (their
# tile height, TileSmall::BM in csrc/int4_mm.cu); the wgmma regime (the
# main loop of csrc/wq_gemm.cuh, shared with K1/K2's tiled regime) the rows
# from INT4_WGMMA_MIN_ROWS on (kWgmmaMinRows there). Measured on an NVIDIA
# H100 80GB HBM3 at 700 W (PERF.md; the k4 format of
# runners/time_stream_rows.py times it): below 33 rows the wgmma regime's
# 128-row tiles are up to 10% slower at the 13B stacks and up to 28% slower
# at the 7B ones; at 72 rows 40-49% faster.
INT4_MMA_SYNC_MAX_ROWS = 32
INT4_WGMMA_MIN_ROWS = INT4_MMA_SYNC_MAX_ROWS + 1


def int4_auto_group(dims) -> int:
    """Largest power-of-two group <= INT4_GROUP packing every contraction dim
    in `dims` (tiny test configs have D < 256; real llama dims give 128, the
    only group K4 takes)."""
    g = INT4_GROUP
    while g > 1 and any(int(d) % (2 * g) for d in dims):
        g //= 2
    return g


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int4 codes [..., O, D] (values in [-8, 7], any integer dtype) →
    split-half packed int8 [..., O, D/2]: the low nibble of byte d holds
    code d, the high nibble code D/2 + d."""
    q32 = q.to(torch.int32)
    half = q.shape[-1] // 2
    packed = (q32[..., :half] & 0xF) | ((q32[..., half:] & 0xF) << 4)
    return packed.to(torch.uint8).view(torch.int8)


def quantize_weight_int4(w: torch.Tensor, group: int = INT4_GROUP) -> Dict[str, torch.Tensor]:
    """[..., O, D] float → {'q4': int8 [..., D/2, O] packed, split-half,
    'gs': fp32 [..., D/group, O]}: group absmax/7 scales, codes in [-8, 7]."""
    wf = w.float()
    O, D = wf.shape[-2], wf.shape[-1]
    if D % (2 * group):
        raise ValueError(f"D={D} not divisible by 2*group={2 * group}")
    lead = wf.shape[:-2]
    gr = wf.reshape(*lead, O, D // group, group)
    absmax = gr.abs().amax(dim=-1)
    s = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 7.0)
    q = torch.clamp(torch.round(gr / s[..., None]), -8, 7).to(torch.int32).reshape(*lead, O, D)
    return {
        "q4": pack_int4(q).transpose(-1, -2).contiguous(),
        "gs": s.transpose(-1, -2).contiguous(),
    }


def is_quantized_int4(w: Any) -> bool:
    return isinstance(w, dict) and "q4" in w and "gs" in w


def _unpack_int4(q4: torch.Tensor):
    """packed int8 → (lo, hi) int32 nibble values in [-8, 7]."""
    q32 = q4.to(torch.int32)
    return ((q32 & 15) ^ 8) - 8, q32 >> 4


def dequantize_int4(wq: Dict[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    """→ dense [..., O, D] (the quantizer's input layout)."""
    q4, gs = wq["q4"], wq["gs"]
    group = 2 * q4.shape[-2] // gs.shape[-2]
    lo, hi = _unpack_int4(q4)
    q = torch.cat([lo, hi], dim=-2).float()
    w = (q * gs.repeat_interleave(group, dim=-2)).to(dtype)  # [..., D, O]
    return w.transpose(-1, -2)


def int4_matmul_stacked_plain(
    h: torch.Tensor, q4: torch.Tensor, gs: torch.Tensor, layer_idx: int
) -> torch.Tensor:
    """Plain version of K4: the math of int4_matmul_xla in fp32. Each packed
    half dequantizes with its own group scales, the two half-dots reduce in
    fp32, the sum is cast to h's dtype. h [B, D], q4 [L, D/2, O], gs
    [L, D/g, O] → [B, O]."""
    Dp = q4.shape[1]
    group = 2 * Dp // gs.shape[1]
    nGh = Dp // group
    lo, hi = _unpack_int4(q4[layer_idx])
    w_lo = lo.float() * gs[layer_idx, :nGh].repeat_interleave(group, dim=0)
    w_hi = hi.float() * gs[layer_idx, nGh:].repeat_interleave(group, dim=0)
    hf = h.float()
    return (hf[..., :Dp] @ w_lo + hf[..., Dp:] @ w_hi).to(h.dtype)


def _check_int4_args(h: torch.Tensor, q4: torch.Tensor, gs: torch.Tensor, layer_idx: int) -> None:
    """What K4 takes; anything else raises."""
    if not (q4.is_cuda and gs.is_cuda and q4.device == h.device == gs.device):
        raise ValueError("h, q4 and gs must lie on one CUDA device")
    if h.dtype not in _kernels.DTYPE_CODE:
        raise TypeError(f"activation dtype {h.dtype} not supported (bf16/fp32)")
    if q4.dtype != torch.int8 or gs.dtype != torch.float32 or q4.dim() != 3 or gs.dim() != 3:
        raise TypeError(f"need int8 [L, D/2, O] weights and fp32 [L, D/128, O] scales, "
                        f"got {q4.dtype}{tuple(q4.shape)} / {gs.dtype}{tuple(gs.shape)}")
    if h.dim() != 2 or not (h.is_contiguous() and q4.is_contiguous() and gs.is_contiguous()):
        raise ValueError("h must be a contiguous [B, D] matrix; q4 and gs contiguous")
    B, D = h.shape
    L, Dp, O = q4.shape
    if B < 1 or D != 2 * Dp or D % (2 * INT4_GROUP):
        raise ValueError(f"h {tuple(h.shape)} does not fit q4 {tuple(q4.shape)} (D % 256 == 0)")
    if tuple(gs.shape) != (L, D // INT4_GROUP, O):
        raise ValueError(f"K4 takes group {INT4_GROUP} only: scales {tuple(gs.shape)} "
                         f"for D={D}, O={O}")
    if O % 16 or not 0 <= layer_idx < L:
        raise ValueError(f"O={O} must be a multiple of 16; layer {layer_idx} of {L}")
    if B > INT4_SKINNY_MAX_ROWS and h.dtype != torch.bfloat16:
        raise TypeError(f"K4's tensor-core regimes ({B} rows > {INT4_SKINNY_MAX_ROWS}) take bf16 only")
    if any(t.data_ptr() % 16 for t in (h, q4, gs)):
        raise ValueError("kernel operands must be 16-byte aligned")


def int4_matmul_stacked(
    h: torch.Tensor, q4: torch.Tensor, gs: torch.Tensor, layer_idx: int
) -> torch.Tensor:
    """K4 wrapper (twin of int4_matmul_stacked, TPU kernel
    _make_int4_stacked_kernel): h [B, D] x packed int4 q4 [L, D/2, O] at layer
    `layer_idx` with group-128 scales gs [L, D/128, O] → [B, O] in h's dtype.
    The layer is a pointer offset into the whole stack.

    Rows up to INT4_SKINNY_MAX_ROWS run the skinny regime, which takes
    bf16 or fp32 activations; rows up to INT4_MMA_SYNC_MAX_ROWS the
    mma.sync tiles, larger row counts the wgmma regime; both tensor-core
    regimes take bf16 only and raise on fp32. Split-K partial sums go to an
    fp32 workspace this wrapper allocates. CPU tensors take the plain
    version."""
    if h.device.type == "cpu":
        return int4_matmul_stacked_plain(h, q4, gs, layer_idx)
    _check_int4_args(h, q4, gs, layer_idx)
    B, D = h.shape
    O = q4.shape[2]
    lib = _kernels.lib()
    n_work = lib.int4_mm_workspace(B, O, D)
    work = torch.empty((max(n_work, 1),), dtype=torch.float32, device=h.device)
    y = torch.empty((B, O), dtype=h.dtype, device=h.device)
    err = lib.int4_mm_stacked(
        h.data_ptr(), q4.data_ptr(), gs.data_ptr(), y.data_ptr(), work.data_ptr(),
        B, O, D, int(layer_idx), _kernels.DTYPE_CODE[h.dtype],
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    _kernels.check(err, "int4_mm_stacked")
    int4_matmul_stacked.launches += 1
    return y


int4_matmul_stacked.launches = 0


def int4_matmul_stacked_dispatch(
    h: torch.Tensor, wq: Dict[str, torch.Tensor], layer_idx: int
) -> torch.Tensor:
    """h [..., D] x stacked packed int4 [L, D/2, O] at layer_idx → [..., O].
    Every row count goes to K4 (CPU tensors: its plain version); nothing on
    the card dequantizes to a dense weight."""
    q4, gs = wq["q4"], wq["gs"]
    lead = h.shape[:-1]
    out = int4_matmul_stacked(h.reshape(-1, h.shape[-1]).contiguous(), q4, gs, layer_idx)
    return out.reshape(*lead, q4.shape[2])


# ---------------------------------------------------------------------------
# llama param-tree quantization
# ---------------------------------------------------------------------------

_LLAMA_QUANT_KEYS = ("q", "k", "v", "o", "gate", "up", "down")


def quantize_llama_params(
    params: Dict[str, Any], fuse: bool = True, bits: int = 8,
    group: Optional[int] = None,
) -> Dict[str, Any]:
    """Quantize the llama linears (stacked [L, O, D]) and the lm_head; the
    embedding table stays as it is. fuse=True packs q|k|v into one 'qkv'
    stack and gate|up into one 'gateup' stack (per-output-channel int8
    scales and int4 group scales along the contraction make that
    bit-identical to quantizing the parts). bits=4 uses the group-wise int4
    scheme for the layer stacks (group: the largest that packs every
    contraction dim, unless given); the lm_head stays int8 either way."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if bits == 4:
        if group is None:
            group = int4_auto_group(params["layers"][k].shape[-1] for k in _LLAMA_QUANT_KEYS)

        def qw(w):
            return quantize_weight_int4(w, group)
    else:
        qw = quantize_weight
    out = dict(params)
    layers = dict(params["layers"])
    if fuse:
        layers["qkv"] = qw(torch.cat([layers.pop("q"), layers.pop("k"), layers.pop("v")], dim=1))
        layers["gateup"] = qw(torch.cat([layers.pop("gate"), layers.pop("up")], dim=1))
        layers["o"] = qw(layers["o"])
        layers["down"] = qw(layers["down"])
    else:
        for k in _LLAMA_QUANT_KEYS:
            layers[k] = qw(params["layers"][k])
    out["layers"] = layers
    out["lm_head"] = quantize_weight(params["lm_head"])
    return out
