"""int8 and int4 quantization for serving (torch twin of
llava_align_tpu/ops/quant.py: the int8 weight-only part, the opt-in W8A8
product, the group-wise int4 part and the int8 KV-cache blocks).

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
CUDA row count goes to the kernel K4 (csrc/int4_mm.cu; its regimes:
int4_regime), as the TPU package sends every row count to its Pallas
kernel; CPU tensors take its plain version.
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
    s = torch.where(absmax == 0, torch.ones_like(absmax), _div127(absmax))
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
    _kernels.refuse_grad("int8_matmul_stacked", h, s)
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
    _kernels.refuse_grad("int8_matmul_cuda", h, s)
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
    rest the dequant path. act_quant=True first sends row counts of
    W8A8_MIN_ROWS and more to the W8A8 product (int8_matmul_w8a8), as the
    JAX dispatch does; decode rows keep K1."""
    q, s = wq["q"], wq["s"]
    lead = h.shape[:-1]
    if act_quant and _rows(h) >= W8A8_MIN_ROWS:
        return int8_matmul_w8a8(h, q[layer_idx], s[layer_idx])
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
# W8A8: dynamic per-row activation quantization, int8 x int8 → int32, the
# JAX package's opt-in throughput mode (act_quant; engine and runner
# `--quant w8a8`). Activations quantize per row (absmax over D), weights
# keep their per-output-channel scales, the accumulation is exact int32 and
# the scale epilogue fp32. Not bit-exact with the weight-only paths, by
# design. The JAX package computes the product with XLA's int8 dot_general,
# outside Pallas, so the port takes torch._int_mm (cuBLASLt on the card;
# int8 x int8 → int32 on the CPU too): no TPU kernel stands behind it.
# The quantization and the epilogue are plain torch, op for op the JAX
# package's (division by the row scale, round half to even, then
# (acc * a_scale) * s), so the codes are equal. W8A8_MIN_ROWS is the JAX
# package's crossover, measured on a TPU and kept as its rule; the card's
# own crossover is timed by chip_smoke.py.
# ---------------------------------------------------------------------------

W8A8_MIN_ROWS = 256


def _div127(x: torch.Tensor) -> torch.Tensor:
    """x / 127, correctly rounded on every device: PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal instead, which rounds
    differently from the JAX package's division (and the CPU's)."""
    return x / torch.full_like(x, 127.0)


def w8a8_row_scale(amax: torch.Tensor) -> torch.Tensor:
    """Per-row activation scale from the rows' absmax [..., 1] (fp32)."""
    return _div127(torch.clamp(amax, min=1e-30))


def w8a8_quantize(hf: torch.Tensor, a_scale: torch.Tensor) -> torch.Tensor:
    """fp32 rows over their scales → int8 codes (round half to even)."""
    return torch.clamp(torch.round(hf / a_scale), -127.0, 127.0).to(torch.int8)


def int8_matmul_w8a8(h: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """h [..., D] x int8 q [O, D] (scales s [O]) → [..., O] in h's dtype:
    per-row dynamic activation quantization, int32 accumulation
    (torch._int_mm: on the card more than 16 rows, D and O multiples of 8),
    fp32 epilogue a_scale[row] * s[col]."""
    lead, D = h.shape[:-1], h.shape[-1]
    hf = h.reshape(-1, D).float()
    a_scale = w8a8_row_scale(hf.abs().amax(dim=-1, keepdim=True))
    acc = torch._int_mm(w8a8_quantize(hf, a_scale), q.t())
    int8_matmul_w8a8.launches += 1
    return (acc.float() * a_scale * s).to(h.dtype).reshape(*lead, q.shape[0])


int8_matmul_w8a8.launches = 0


# ---------------------------------------------------------------------------
# Tensor-parallel int8 (the JAX package's int8_matmul_stacked_tp and its
# lane padding). Column-parallel stacks (qkv/gateup/q/k/v/gate/up) hold
# their output channels' slice [L, O/n, D] and return this rank's output
# columns; row-parallel stacks (o/down) hold a contraction slice
# [L, O, D/n], run the kernel with unit scales, all_reduce the partial
# products and apply the per-output-channel scales after the sum. Each
# rank runs the same dispatch as one device, on its shard's own (O, D).
# ---------------------------------------------------------------------------

_ROW_PARALLEL_NAMES = ("o", "down", "attn_proj", "mlp_proj", "out", "fc2", "down_proj")


def int8_tp_mode(name: str) -> str:
    return "row" if name in _ROW_PARALLEL_NAMES else "column"


def int8_tp_aligned(wq: Dict[str, Any], mode: str, n_shards: int) -> bool:
    """Per-shard dims must stay lane-aligned (multiples of 128): the JAX
    package's rule, kept as it is."""
    O, D = int(wq["q"].shape[1]), int(wq["q"].shape[2])
    dim = O if mode == "column" else D
    return dim % n_shards == 0 and (dim // n_shards) % 128 == 0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pad_quantized_stack(wq: Dict[str, torch.Tensor], mode: str, n_shards: int, halves: int = 1):
    """Lane-align an int8 [L, O, D] stack for n-way TP by bit-inert padding.
    column: each of the `halves` equal O-parts (fused gateup has two) gains
    zero rows with unit scales, so the padded output channels are exact
    zeros; row: the contraction dim gains zero columns. Returns (stack,
    changed)."""
    q, s = wq["q"], wq["s"]
    L, O, D = (int(d) for d in q.shape)
    u = 128 * n_shards
    if mode == "column":
        part = O // halves
        pad = _round_up(part, u) - part
        if pad == 0:
            return wq, False
        qs, ss = [], []
        for h in range(halves):
            qs.append(torch.nn.functional.pad(q[:, h * part : (h + 1) * part], (0, 0, 0, pad)))
            ss.append(torch.nn.functional.pad(s[:, h * part : (h + 1) * part], (0, pad), value=1.0))
        return {"q": torch.cat(qs, dim=1), "s": torch.cat(ss, dim=1)}, True
    pad = _round_up(D, u) - D
    if pad == 0:
        return wq, False
    return {"q": torch.nn.functional.pad(q, (0, pad)), "s": s}, True


def pad_llama_quantized_for_tp(layers: Dict[str, Any], n_shards: int,
                               columns=(("gateup", 2), ("gate", 1), ("up", 1)), row: str = "down"):
    """Pad the MLP int8 stacks (gateup/gate/up column, down row) to the
    same F_pad, so 7B-style intermediate sizes shard at any power-of-two TP
    degree; the head-structured attention stacks stay as they are. Returns
    (layers, changed). `columns` ((name, halves), ...) and `row` name
    another family's MLP stacks (Qwen: w12/w1/w2 and mlp_proj)."""
    out = dict(layers)
    changed = False
    for name, halves in columns:
        if name in out and is_quantized(out[name]):
            out[name], ch = pad_quantized_stack(out[name], "column", n_shards, halves)
            changed |= ch
    if row in out and is_quantized(out[row]):
        out[row], ch = pad_quantized_stack(out[row], "row", n_shards)
        changed |= ch
    return out, changed


_UNIT_SCALES: Dict[tuple, torch.Tensor] = {}


def _unit_scales(L: int, O: int, device) -> torch.Tensor:
    key = (L, O, str(device))
    if key not in _UNIT_SCALES:
        _UNIT_SCALES[key] = torch.ones((L, O), dtype=torch.float32, device=device)
    return _UNIT_SCALES[key]


def int8_matmul_stacked_tp(
    h: torch.Tensor, wq: Dict[str, torch.Tensor], layer_idx: int, group, mode: str, *,
    act_quant: bool = False,
) -> torch.Tensor:
    """h [..., D] (column: the whole rows; row: this rank's D slice) x this
    rank's shard of a stacked int8 [L, O, D] at layer_idx over the process
    group `group`. column → this rank's output columns [..., O/n]; row →
    the whole [..., O] on every rank. The body picks as one device does on
    the shard's own (O, D) (_stream_rows_ok: K1 at decode rows, the dequant
    product otherwise). act_quant routes >= W8A8_MIN_ROWS rows through
    W8A8, bit-identical to one device: column shards see the full D, row
    shards take the global row absmax (MAX all_reduce), sum the int32
    partial products exactly and apply the same fp32 epilogue."""
    import torch.distributed as dist

    q, s = wq["q"], wq["s"]
    lead = h.shape[:-1]
    h2 = h.reshape(-1, h.shape[-1]).contiguous()
    n_rows = h2.shape[0]
    w8a8 = act_quant and n_rows >= W8A8_MIN_ROWS
    decode_rows = _stream_rows_ok(n_rows, q.shape[1], q.shape[2])
    if mode == "column":
        if w8a8:
            out = int8_matmul_w8a8(h2, q[layer_idx], s[layer_idx])
        elif decode_rows:
            out = int8_matmul_stacked(h2, q, s, layer_idx)
        else:
            out = int8_matmul_dequant(h2, q[layer_idx], s[layer_idx])
    elif w8a8:
        hf = h2.float()
        amax = hf.abs().amax(dim=-1, keepdim=True)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)  # the global row absmax
        a_scale = w8a8_row_scale(amax)
        acc = torch._int_mm(w8a8_quantize(hf, a_scale), q[layer_idx].t())
        int8_matmul_w8a8.launches += 1
        dist.all_reduce(acc, group=group)  # exact: int32 partials
        out = (acc.float() * a_scale * s[layer_idx]).to(h.dtype)
    else:
        ones = _unit_scales(q.shape[0], q.shape[1], q.device)
        if decode_rows:
            part = int8_matmul_stacked(h2, q, ones, layer_idx)
        else:
            part = int8_matmul_dequant(h2, q[layer_idx], ones[layer_idx])
        dist.all_reduce(part, group=group)
        out = part * s[layer_idx][None, :].to(h.dtype)
    return out.reshape(*lead, out.shape[-1])


# ---------------------------------------------------------------------------
# int8 KV cache blocks (the JAX package's kv_quantize_block layout): int8
# values with one fp32 absmax scale per (row, position, head), a trailing
# singleton over Dh. Exact zeros stay exact; a zero vector quantizes to
# zeros with scale 0, so padded cache slots stay inert.
# ---------------------------------------------------------------------------


def kv_quantize_block(x: torch.Tensor):
    """[..., Dh] float → (int8 [..., Dh], fp32 scale [..., 1])."""
    xf = x.float()
    scale = _div127(xf.abs().amax(dim=-1, keepdim=True))
    pos = scale > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, scale, torch.ones_like(scale)), torch.zeros_like(scale))
    q = torch.clamp(torch.round(xf * inv), -127, 127).to(torch.int8)
    return q, scale


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """(int8 [..., Dh], fp32 [..., 1]) → [..., Dh] in `dtype`."""
    return (q.float() * scale).to(dtype)


# ---------------------------------------------------------------------------
# int4 weight-only, group-wise (twin of the JAX package's int4 part)
# ---------------------------------------------------------------------------

INT4_GROUP = 128

# K4's regime rule (int4_regime; compiled into csrc/int4_mm.cu as
# kSkinnyMaxRows and kStreamMaxRows): fp32 activations take the skinny
# regime (CUDA-core weight streaming) up to INT4_SKINNY_MAX_ROWS rows and no
# other; bf16 takes the streaming kernel (weight streaming on the tensor
# cores, one launch) up to INT4_STREAM_MAX_ROWS and the wgmma regime (the
# main loop of csrc/wq_gemm.cuh, shared with K1/K2's tiled regime) from
# INT4_WGMMA_MIN_ROWS on. Measured on an NVIDIA H100 80GB HBM3 at 700 W,
# parent and change alternated (PERF.md; runners/time_stream_rows.py, k4
# format): the streaming kernel beats the skinny regime at 1-2 rows and
# the mma.sync tiles it replaced at 3-32, and loses to the wgmma regime
# from 80 rows on.
INT4_SKINNY_MAX_ROWS = 2
INT4_STREAM_MAX_ROWS = 72
INT4_WGMMA_MIN_ROWS = INT4_STREAM_MAX_ROWS + 1


def int4_regime(dtype: torch.dtype, rows: int) -> str:
    """Which body of K4 runs a call, the rule compiled into csrc/int4_mm.cu
    (int4_mm_regime reports it on the card): "skinny" (fp32, up to
    INT4_SKINNY_MAX_ROWS rows), "stream" (bf16 up to INT4_STREAM_MAX_ROWS:
    the tensor-core streaming kernel) or "wgmma" (bf16 above). fp32 above
    the skinny rows raises."""
    if rows < 1:
        raise ValueError(f"K4 takes at least one row, got {rows}")
    if dtype == torch.float32:
        if rows > INT4_SKINNY_MAX_ROWS:
            raise TypeError(f"K4's tensor-core regimes ({rows} rows > {INT4_SKINNY_MAX_ROWS}) take bf16 only")
        return "skinny"
    if dtype != torch.bfloat16:
        raise TypeError(f"activation dtype {dtype} not supported (bf16/fp32)")
    return "stream" if rows <= INT4_STREAM_MAX_ROWS else "wgmma"


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
    int4_regime(h.dtype, B)  # raises on fp32 above the skinny rows
    if any(t.data_ptr() % 16 for t in (h, q4, gs)):
        raise ValueError("kernel operands must be 16-byte aligned")


def int4_matmul_stacked(
    h: torch.Tensor, q4: torch.Tensor, gs: torch.Tensor, layer_idx: int
) -> torch.Tensor:
    """K4 wrapper (twin of int4_matmul_stacked, TPU kernel
    _make_int4_stacked_kernel): h [B, D] x packed int4 q4 [L, D/2, O] at layer
    `layer_idx` with group-128 scales gs [L, D/128, O] → [B, O] in h's dtype.
    The layer is a pointer offset into the whole stack.

    The regime follows int4_regime: fp32 activations run the skinny regime
    (up to INT4_SKINNY_MAX_ROWS rows, and raise above), bf16 the streaming
    kernel at decode rows (one launch, no workspace) and the wgmma regime
    above INT4_STREAM_MAX_ROWS. Where a regime splits D over a workspace
    (the skinny and wgmma regimes), this wrapper allocates it. CPU tensors
    take the plain version."""
    if h.device.type == "cpu":
        return int4_matmul_stacked_plain(h, q4, gs, layer_idx)
    _kernels.refuse_grad("int4_matmul_stacked", h, gs)
    _check_int4_args(h, q4, gs, layer_idx)
    B, D = h.shape
    O = q4.shape[2]
    lib = _kernels.lib()
    code = _kernels.DTYPE_CODE[h.dtype]
    work = None
    if int4_regime(h.dtype, B) != "stream":
        n_work = lib.int4_mm_workspace(B, O, D, code)
        work = torch.empty((n_work,), dtype=torch.float32, device=h.device) if n_work else None
    y = torch.empty((B, O), dtype=h.dtype, device=h.device)
    err = lib.int4_mm_stacked(
        h.data_ptr(), q4.data_ptr(), gs.data_ptr(), y.data_ptr(), _ptr(work),
        B, O, D, int(layer_idx), code, _kernels.stream_of(h),
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


def quantize_qwen_params(params: Dict[str, Any], fuse: bool = True) -> Dict[str, Any]:
    """int8 weight-only for the Qwen decoder (models/qwen layout), the JAX
    package's quantize_qwen_params: c_attn_w is already the packed q|k|v
    stack; fuse=True also packs w1|w2 into one 'w12' stack along the output
    axis (per-output-channel scales make that bit-identical to the parts);
    c_attn_b stays dense (added after the matmul); the lm_head int8, the
    embedding table as it is. Each stack is quantized one layer at a time
    (the same result: scales are per channel), so the peak beyond the
    float tree is the int8 copy and one layer in fp32."""
    out = dict(params)
    layers = dict(params["layers"])
    names = ["c_attn_w", "attn_proj", "mlp_proj"]
    if fuse:
        layers["w12"] = _quantize_stacks([layers.pop("w1"), layers.pop("w2")])
    else:
        names += ["w1", "w2"]
    for name in names:
        layers[name] = _quantize_stacks([layers[name]])
    out["layers"] = layers
    out["lm_head"] = quantize_weight(params["lm_head"])
    return out


def _quantize_stacks(parts) -> Dict[str, torch.Tensor]:
    """quantize_weight of the [L, O_i, D] stacks concatenated along O, built
    layer by layer into int8 [L, sum O_i, D] and fp32 [L, sum O_i]."""
    L, D = parts[0].shape[0], parts[0].shape[2]
    O = sum(p.shape[1] for p in parts)
    dev = parts[0].device
    wq = {"q": torch.empty((L, O, D), dtype=torch.int8, device=dev),
          "s": torch.empty((L, O), dtype=torch.float32, device=dev)}
    for li in range(L):
        layer = quantize_weight(torch.cat([p[li] for p in parts]))
        wq["q"][li], wq["s"][li] = layer["q"], layer["s"]
    return wq
