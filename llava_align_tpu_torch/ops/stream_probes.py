"""The kernels of the TPU microbenchmark scripts that no decoder kernel
computes: row-major int4 (per-channel or group-128 scales), bf16 weight
streaming, and the index-mapping copy the int4 scale broadcasts are built
from. The two matmuls are formats of K1's tensor-core streaming kernel
(csrc/stream_mma.cuh, entries in csrc/int8_mm.cu); the copy is
csrc/repeat2d.cu. Each has a wrapper with a
`launches` counter, which launches the kernel on CUDA tensors (or raises on
what the kernel does not take), and a plain PyTorch version of the same
math, which the wrapper takes for CPU tensors.

Row-major int4 packs [L, O, D/2] int8, D contiguous per output row,
split-half: the low nibble of p[o, d] is W[o, d], the high nibble
W[o, D/2 + d]; codes in [-8, 7]. The per-channel mode applies s [L, O]
after the fp32 sum (the math of K1, ops/quant.py); the group mode takes
s [L, O, D/128], the low half's groups first, and its plain version keeps
the TPU script's rounding: each weight scaled in fp32 and rounded to h's
dtype before the dot.

The TPU scripts these replace, and the twins that run them, are listed in
llava_align_tpu_torch/scripts/__init__.py.
"""

from __future__ import annotations

from typing import Tuple

import torch

from llava_align_tpu_torch.ops import _kernels
from llava_align_tpu_torch.ops.quant import _unpack_int4

INT4_GROUP = 128
MAX_ROWS = 64  # the streaming kernels take 1..MAX_ROWS rows of h


def unpack_int4_rowmajor(p: torch.Tensor) -> torch.Tensor:
    """packed int8 [..., O, D/2] (ops/quant.pack_int4) → int32 codes
    [..., O, D], both nibbles of any byte sign-extended."""
    return torch.cat(_unpack_int4(p), dim=-1)


def _check_stream_args(h: torch.Tensor, tensors, what: str) -> None:
    _kernels.refuse_grad(what, h, *tensors)
    if not all(t.is_cuda and t.device == h.device for t in tensors):
        raise ValueError(f"{what}: every operand must lie on h's CUDA device")
    if h.dtype != torch.bfloat16:
        raise TypeError(f"{what}: activations must be bf16, got {h.dtype}")
    if h.dim() != 2 or not all(t.is_contiguous() for t in (h, *tensors)):
        raise ValueError(f"{what}: h must be a contiguous [B, D] matrix; weights contiguous")
    if not 1 <= h.shape[0] <= MAX_ROWS:
        raise ValueError(f"{what}: the kernel takes 1..{MAX_ROWS} rows, got {h.shape[0]}")
    if any(t.data_ptr() % 16 for t in (h, *tensors)):
        raise ValueError(f"{what}: kernel operands must be 16-byte aligned")


# ---------------------------------------------------------------------------
# row-major int4 (csrc/int8_mm.cu, entry int4_rowmajor_mm_stacked)
# ---------------------------------------------------------------------------


def int4_rowmajor_matmul_stacked_plain(
    h: torch.Tensor, p: torch.Tensor, s: torch.Tensor, layer_idx: int
) -> torch.Tensor:
    """h [B, D] x packed int4 p [L, O, D/2] at layer `layer_idx` → [B, O]
    in h's dtype. s [L, O]: per-channel, applied after the fp32 sum; s
    [L, O, D/g]: group scales (low half first), each weight scaled in fp32
    and rounded to h's dtype, then an fp32 dot."""
    q = unpack_int4_rowmajor(p[layer_idx]).float()  # [O, D]
    hf = h.float()
    if s.dim() == 2:
        return ((hf @ q.t()) * s[layer_idx]).to(h.dtype)
    group = q.shape[-1] // s.shape[-1]
    w = (q * s[layer_idx].repeat_interleave(group, dim=-1)).to(h.dtype)
    return (hf @ w.float().t()).to(h.dtype)


def int4_rowmajor_matmul_stacked(
    h: torch.Tensor, p: torch.Tensor, s: torch.Tensor, layer_idx: int
) -> torch.Tensor:
    """Row-major int4 wrapper (twin of the int4_mm of scripts/bench_int4_probe*.py):
    h [B, D] bf16 x p int8 [L, O, D/2] with s fp32 [L, O] (per-channel) or
    [L, O, D/128] (group 128) → [B, O] bf16. CPU tensors take the plain
    version."""
    if h.device.type == "cpu":
        return int4_rowmajor_matmul_stacked_plain(h, p, s, layer_idx)
    _check_stream_args(h, (p, s), "int4_rowmajor_matmul_stacked")
    B, D = h.shape
    if p.dtype != torch.int8 or s.dtype != torch.float32 or p.dim() != 3:
        raise TypeError(f"need int8 [L, O, D/2] weights and fp32 scales, "
                        f"got {p.dtype}{tuple(p.shape)} / {s.dtype}{tuple(s.shape)}")
    L, O, Dp = p.shape
    if D != 2 * Dp or D % 32:
        raise ValueError(f"h {tuple(h.shape)} does not fit p {tuple(p.shape)} (D % 32 == 0)")
    if tuple(s.shape) == (L, O):
        mode = 0
    elif tuple(s.shape) == (L, O, D // INT4_GROUP) and D % (2 * INT4_GROUP) == 0:
        mode = 1
    else:
        raise ValueError(f"scales {tuple(s.shape)} are neither per-channel [L, O] nor group "
                         f"{INT4_GROUP} [L, O, D/{INT4_GROUP}] (D % 256 == 0) for p {tuple(p.shape)}")
    if not 0 <= layer_idx < L:
        raise ValueError(f"layer {layer_idx} of {L}")
    y = torch.empty((B, O), dtype=h.dtype, device=h.device)
    err = _kernels.lib().int4_rowmajor_mm_stacked(
        h.data_ptr(), p.data_ptr(), s.data_ptr(), y.data_ptr(), B, O, D, int(layer_idx), mode,
        _kernels.stream_of(h),
    )
    _kernels.check(err, "int4_rowmajor_mm_stacked")
    int4_rowmajor_matmul_stacked.launches += 1
    return y


int4_rowmajor_matmul_stacked.launches = 0


# ---------------------------------------------------------------------------
# bf16 weight streaming (csrc/int8_mm.cu, entry bf16_mm_stacked)
# ---------------------------------------------------------------------------


def bf16_matmul_stacked_plain(h: torch.Tensor, w: torch.Tensor, layer_idx: int) -> torch.Tensor:
    """h [B, D] x w [L, O, D] at layer `layer_idx` → [B, O] in h's dtype;
    fp32 sum, no scale."""
    return (h.float() @ w[layer_idx].float().t()).to(h.dtype)


def bf16_matmul_stacked(h: torch.Tensor, w: torch.Tensor, layer_idx: int) -> torch.Tensor:
    """bf16 streaming wrapper (twin of stream_mm, scripts/bench_bf16_stream.py):
    h [B, D] bf16 x w bf16 [L, O, D] → [B, O] bf16. CPU tensors take the
    plain version."""
    if h.device.type == "cpu":
        return bf16_matmul_stacked_plain(h, w, layer_idx)
    _check_stream_args(h, (w,), "bf16_matmul_stacked")
    B, D = h.shape
    if w.dtype != torch.bfloat16 or w.dim() != 3 or w.shape[2] != D or D % 8:
        raise ValueError(f"need bf16 [L, O, {D}] weights (D % 8 == 0), got {w.dtype}{tuple(w.shape)}")
    L, O, _ = w.shape
    if not 0 <= layer_idx < L:
        raise ValueError(f"layer {layer_idx} of {L}")
    y = torch.empty((B, O), dtype=h.dtype, device=h.device)
    err = _kernels.lib().bf16_mm_stacked(
        h.data_ptr(), w.data_ptr(), y.data_ptr(), B, O, D, int(layer_idx), _kernels.stream_of(h),
    )
    _kernels.check(err, "bf16_mm_stacked")
    bf16_matmul_stacked.launches += 1
    return y


bf16_matmul_stacked.launches = 0


# ---------------------------------------------------------------------------
# repeat2d (csrc/repeat2d.cu)
# ---------------------------------------------------------------------------

MODES = {"tile": 0, "repeat": 1}
Axis = Tuple[str, int]  # ("tile", n): i % n; ("repeat", n): i // n


def _source_index(n_out: int, start: int, axis: Axis, device) -> torch.Tensor:
    mode, n = axis
    i = torch.arange(n_out, device=device)
    return start + (i % n if mode == "tile" else i // n)


def _check_repeat2d_args(x: torch.Tensor, shape, rows: Axis, cols: Axis, offset) -> None:
    if x.dim() != 2 or len(shape) != 2 or min(shape) < 1:
        raise ValueError(f"need a 2-D source and a 2-D output shape, got {tuple(x.shape)} -> {shape}")
    for (mode, n), n_out, start, size in zip((rows, cols), shape, offset, x.shape):
        if mode not in MODES or n < 1 or start < 0:
            raise ValueError(f"bad axis map {(mode, n)} at offset {start}")
        last = start + (min(n, n_out) - 1 if mode == "tile" else (n_out - 1) // n)
        if last >= size:
            raise ValueError(f"axis map {(mode, n)} at offset {start} reads index {last} of {size}")


def repeat2d_plain(
    x: torch.Tensor, shape, rows: Axis, cols: Axis, offset=(0, 0), scale: float = 1.0
) -> torch.Tensor:
    """out[i, j] = scale * x[offset[0] + map_r(i), offset[1] + map_c(j)] for
    an output of `shape`; each map is ("tile", n): i % n or ("repeat", n):
    i // n."""
    _check_repeat2d_args(x, shape, rows, cols, offset)
    ri = _source_index(shape[0], offset[0], rows, x.device)
    ci = _source_index(shape[1], offset[1], cols, x.device)
    return scale * x[ri[:, None], ci[None, :]]


def repeat2d(
    x: torch.Tensor, shape, rows: Axis, cols: Axis, offset=(0, 0), scale: float = 1.0
) -> torch.Tensor:
    """repeat2d wrapper (the copies of scripts/probe_mosaic_ops.py): fp32
    x, any row stride, contiguous rows → a new contiguous fp32 tensor of
    `shape`. CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return repeat2d_plain(x, shape, rows, cols, offset, scale)
    _kernels.refuse_grad("repeat2d", x)
    _check_repeat2d_args(x, shape, rows, cols, offset)
    if x.dtype != torch.float32 or x.stride(1) != 1:
        raise TypeError(f"repeat2d takes fp32 with contiguous rows, got {x.dtype}, strides {x.stride()}")
    y = torch.empty(tuple(shape), dtype=torch.float32, device=x.device)
    err = _kernels.lib().repeat2d(
        x.data_ptr(), y.data_ptr(), x.stride(0), shape[0], shape[1], offset[0], offset[1],
        MODES[rows[0]], rows[1], MODES[cols[0]], cols[1], float(scale),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _kernels.check(err, "repeat2d")
    repeat2d.launches += 1
    return y


repeat2d.launches = 0
