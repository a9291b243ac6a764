#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (llava_align_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):
  1. device: the card's name and power limit (nvidia-smi), CUDA must exist;
  2. build: compile the package's CUDA kernels from csrc/ with nvcc (one
     process per source, in parallel); ptxas must report no spill for K3's
     tensor-core kernel, for the wgmma main loop of K1/K2 and K4 nor for the
     tensor-core streaming kernel (K1/K2 at 1-64 rows, S1-S3, S5, S6), and
     must not serialize the wgmma main loop (C7515);
  3. kernels: K1-K4 against their plain PyTorch versions on the card, in
     bf16, at their main paths' shapes (K1 at 3, 16, 18 and 64 rows, each
     timed under by_rows, and at the 7B text-branch prefill's rows on the
     O >= D stacks; K2 at the 7B and the 13B lm_head, each regime, every
     row count timed under by_path's by_rows; K3 at each prefill shape of both model paths; K4 in each
     of its regimes, at the grouped path's decode and prefill rows), with
     the tolerance stated; by CUDA events the
     kernel's, the plain version's and a library call's times (torch.matmul
     on a weight dequantized beforehand, or scaled_dot_product_attention: a
     yardstick only, the port never calls it; K3 and SDPA also as launches
     captured in a CUDA graph, their device time without the host's); K3
     is held row by row, and that rule must pass a control (K3's algorithm
     in PyTorch with P rounded to bf16) and catch three planted faults;
  4. microbenchmark path: each twin of a TPU script
     (llava_align_tpu_torch/scripts) runs its main() once at the script's
     shapes; each must launch the kernels of its TPU script (S1-S7), and
     each kernel's record from that run (its error against the plain
     version, held here at the same tolerance, S7's copies exact; kernel,
     plain and library times, the library being torch.matmul on a weight
     dequantized beforehand or Tensor.repeat / repeat_interleave) is the
     S entry's;
  5. 7B path: LLaVA-v1.5-7B at full width and depth with random int8
     weights, several POPE-style requests through DecodeEngine.generate with
     dual-branch VDD (use_dd + use_dd_unk, cd_alpha=1, cd_beta=0.1, greedy,
     8 new tokens, EOS out of range); K1, K2 and K3 must launch, and no call
     the JAX dispatch rule streams may take the dequant path;
  6. 7B reference: the same model cut to 2 decoder / 2 vision layers at full
     width, its prefill and decode logits on the card against the same
     params run in fp32 on the CPU (the kernels' plain versions);
  7. 13B grouped path: LLaVA-v1.5-13B at full width and depth with random
     int4 (group 128) weights, the same decoding, POPE's 6 questions per
     image: one generate_batch_prefix call, one generate_batch_groups call
     at G = 4 groups (the POPE runner's cap), then a submit_batch_groups /
     collect_batch_groups loop at G = 4, sequential (the port's submit runs
     the whole call); K4, K2 and K3 must launch in the G = 1 call and in the
     G = 4 calls on their own;
  8. 13B grouped reference: that model cut to 2 decoder / 2 vision layers at
     full width; the grouped path's first-step fused scores on the card
     against the same params in fp32 on the CPU, and against `generate` on
     the card for the same question.

Prints a JSON line with each kernel's record (launches: both main paths'
counts, per path under launches_by_path; K1's and K4's prefill-row times
under prefill, K1's per decode row count under by_rows, K2's times per path
under by_path (each row count under its by_rows), K3's per shape under by_shape,
with its CUDA-graph times as graph_ms / graph_library_ms and its row
errors);
S1-S7: launches, errors and times from the run of the twin that runs
each), the card's name and power limit, then as the last line
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# bf16 results of two fp32 reductions in different orders (and K4's tiled
# regime rounding each dequantized weight to bf16, as the TPU kernel does)
# may land one bf16 ulp apart (<= 2^-7 of the largest output); allow twice.
KERNEL_TOL = 2.0**-6
# bf16 model on the card against the fp32 CPU model, 2 decoder layers:
# bf16 rounding of activations and weights compounds to ~1e-2 of the
# logits' range.
REFERENCE_TOL = 5e-2
NEW_TOKENS = 8
N_REQUESTS = 4  # the first one also warms cuBLAS and the allocator
QUESTIONS = (
    "Is there a dog in the image?",
    "Is there a person in the image?",
    "Is there a dining table in the image?",
    "Is there a car in the image?",
)
GROUPS = 4          # image groups per grouped call: the POPE runner's cap
GROUP_CALLS = 3     # G = 4 calls: one generate_batch_groups (warm-up), then submit/collect
LM_HEAD_7B = (32000, 4096)
LM_HEAD_13B = (32000, 5120)
STACKS_13B = {"qkv": (15360, 5120), "o": (5120, 5120), "gateup": (27648, 5120), "down": (5120, 13824)}
L_13B = 40
# the card's published peaks (H100 SXM data sheet), for the bounds
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn(i) over `iters` calls, by CUDA events."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Mean device time of fn() over `iters` calls captured in one CUDA
    graph, by CUDA events over `replays` replays: no host launch overhead
    between the calls, for kernels shorter than their Python wrapper."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def compare(kernel_out: torch.Tensor, plain_out: torch.Tensor, what: str) -> float:
    err = (kernel_out.float() - plain_out.float()).abs().max().item()
    tol = KERNEL_TOL * plain_out.float().abs().max().item()
    ok = np.isfinite(err) and err <= tol
    log(f"  {what}: max_abs_err={err:.6g} tol={tol:.6g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain version")
    return err


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the bf16 tensor-core rate, whichever is larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> tuple:
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is False — this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}, count {torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    # fp32 references in full fp32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, smi


def phase_build() -> None:
    from llava_align_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    path = _kernels.library_path()
    _kernels.lib()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({'nvcc ' + format(_kernels.build_seconds, '.2f') + ' s' if _kernels.build_seconds else 'cached'}) -> {path}")
    text = (path.parent / "build.log").read_text()
    for line in text.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log("  ptxas: " + line.strip())
    # K3's tensor-core kernel holds Q fragments, S and O in registers, the
    # wgmma main loop of K1/K2/K4 its 128 accumulators, the streaming
    # kernel its widened weights and accumulators: a spill would put them
    # in local memory
    spills = ptxas_spill_stores(text)
    for what, key, n_inst in (("K3 tensor-core kernel", "flash_fwd_mma_kernel", 2),
                              ("wgmma main loop (K1/K2 int8, K4 int4)", "wq_gemm_kernel", 2),
                              # 4 formats x 4 row bounds (8, 16, 32, 64)
                              ("tensor-core streaming kernel (K1/K2, S1-S3, S5, S6)", "stream_mma_kernel", 16)):
        inst = {fn: n for fn, n in spills.items() if key in fn}
        log(f"  {what}, spill-store bytes per instance: {inst}")
        if len(inst) != n_inst or any(inst.values()):
            raise AssertionError(f"{what}: expected {n_inst} instances without spills, got {inst}")
    # ptxas C7515: wgmma serialized (each MMA waited for), which undoes the
    # main loop's overlap of widening and MMAs
    serial = [line.strip() for line in text.splitlines() if "C7515" in line and "wq_gemm_kernel" in line]
    if serial:
        raise AssertionError(f"the wgmma main loop is serialized by ptxas: {serial}")


def ptxas_spill_stores(build_log: str) -> dict:
    """{function: spill-store bytes} from nvcc's -Xptxas -v output."""
    spills, fn = {}, None
    for line in build_log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            spills[fn] = int(m.group(1))
    return spills


K1_ROWS = (3, 16, 18, 64)  # the 7B decode step, the twins' rows, the grouped decode step, DECODE_MAX_ROWS


def phase_kernels_int8(grouped_decode_rows, prefill_rows: int) -> dict:
    """K1 and K2 against their plain versions at the 7B path's shapes (K1
    at K1_ROWS, each timed per layer under by_rows, and at its text-branch
    prefill's `prefill_rows` on the O >= D stacks; K2 at the 13B lm_head's
    grouped rows too, every row count timed under by_path's by_rows)."""
    from llava_align_tpu_torch.ops import quant
    from llava_align_tpu_torch.scripts._common import SHAPES_7B, matmul_work

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(0)
    rec = {}

    log("kernels: K1 int8_matmul_stacked (decoder linears) vs plain, bf16; tensor-core streaming up to "
        f"{quant.DECODE_MAX_ROWS} rows, tiled above (the O >= D stacks' {prefill_rows}-row "
        "text-branch prefill)")
    k1_err = 0.0
    by_rows = {B: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, flops=0.0) for B in K1_ROWS}
    pre = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, flops=0.0)
    for name, (O, D) in SHAPES_7B.items():
        L = 32
        q = torch.randint(-127, 128, (L, O, D), dtype=torch.int8, device=dev, generator=g)
        s = (torch.rand((L, O), device=dev, generator=g) + 0.5) / (127.0 * D**0.5)
        w_bf16 = [quant.dequantize({"q": q[i], "s": s[i]}, torch.bfloat16) for i in range(2)]
        # the text-branch prefill's rows reach K1 only on the O >= D stacks (the JAX rule)
        prefill = (prefill_rows,) if quant._stream_rows_ok(prefill_rows, O, D) else ()
        for B in K1_ROWS + prefill:
            h = torch.randn((B, D), device=dev, generator=g).to(torch.bfloat16)
            for li in (0, L - 1):
                k1_err = max(k1_err, compare(
                    quant.int8_matmul_stacked(h, q, s, li),
                    quant.int8_matmul_stacked_plain(h, q, s, li),
                    f"{name} [{L},{O},{D}] B={B} li={li}",
                ))
            # rotate layers so each call streams weights L2 does not hold
            ms = cuda_ms(lambda i: quant.int8_matmul_stacked(h, q, s, i % L), 64)
            plain_ms = cuda_ms(lambda i: quant.int8_matmul_stacked_plain(h, q, s, i % L), 16)
            lib_ms = cuda_ms(lambda i: torch.matmul(h, w_bf16[i % 2].t()), 32)
            gbs = O * D / (ms * 1e-3) / 1e9
            log(f"  {name} B={B}: kernel {ms:.4f} ms ({gbs:.0f} GB/s of int8 weights), "
                f"plain {plain_ms:.4f} ms, library (torch.matmul, bf16 weight) {lib_ms:.4f} ms, "
                f"bound {bound(*matmul_work(B, O, D, O * D, 4 * O))['bound_ms']:.4f} ms")
            nb, fl = matmul_work(B, O, D, O * D, 4 * O)
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                             ("bytes", nb), ("flops", fl)):
                if B in by_rows:
                    by_rows[B][key] += val
                if B == prefill_rows:
                    pre[key] += val
        del q, s, w_bf16
    for B, r in by_rows.items():
        r.update(bound(r.pop("bytes"), r.pop("flops")))
        log(f"  one 7B layer's four linears at B={B}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    # top-level numbers: the 7B decode step (3 rows: dual-branch VDD)
    rec["K1"] = dict(by_rows[3], max_abs_err=k1_err, by_rows={str(B): r for B, r in by_rows.items()})
    b = bound(pre.pop("bytes"), pre.pop("flops"))
    rec["K1"]["prefill"] = dict(pre, rows=prefill_rows, stacks=["qkv", "o", "gateup"], **b)
    log(f"  one 7B layer's qkv, o and gate|up at B={prefill_rows} (text-branch prefill): kernel "
        f"{pre['ms']:.4f} ms, plain {pre['plain_ms']:.4f} ms, library {pre['library_ms']:.4f} ms, "
        f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")

    log("kernels: K2 int8_matmul_cuda (lm_head) vs plain, bf16; streaming up to "
        f"{quant.DECODE_MAX_ROWS} rows, tiled above")
    # per path: (lm_head shape, the path's decode rows, the rows its record times)
    k2_paths = {
        "7b_int8_generate": (LM_HEAD_7B, (1, 2, 3, 18), 3),
        "13b_int4_grouped": (LM_HEAD_13B, tuple(grouped_decode_rows) + (65, quant.STREAM_MAX_ROWS),
                             grouped_decode_rows[-1]),
    }
    k2_err, k2_by_path = 0.0, {}
    for path, ((O, D), rows_list, head_rows) in k2_paths.items():
        per_rows = {}
        q = torch.randint(-127, 128, (O, D), dtype=torch.int8, device=dev, generator=g)
        s = (torch.rand((O,), device=dev, generator=g) + 0.5) / (127.0 * D**0.5)
        w_bf16 = quant.dequantize({"q": q, "s": s}, torch.bfloat16)
        for B in rows_list:
            h = torch.randn((B, D), device=dev, generator=g).to(torch.bfloat16)
            k2_err = max(k2_err, compare(
                quant.int8_matmul_cuda(h, q, s), quant.int8_matmul_plain(h, q, s),
                f"lm_head [{O},{D}] B={B}",
            ))
            ms = cuda_ms(lambda i: quant.int8_matmul_cuda(h, q, s), 32)
            plain_ms = cuda_ms(lambda i: quant.int8_matmul_plain(h, q, s), 16)
            lib_ms = cuda_ms(lambda i: torch.matmul(h, w_bf16.t()), 32)
            b = bound(*matmul_work(B, O, D, O * D, 4 * O))
            log(f"  lm_head [{O},{D}] B={B}: kernel {ms:.4f} ms ({O * D / (ms * 1e-3) / 1e9:.0f} GB/s of "
                f"int8 weights), plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
                f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
            per_rows[str(B)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **b)
        k2_by_path[path] = dict(shape=[O, D], rows=head_rows, **per_rows[str(head_rows)], by_rows=per_rows)
        del q, s, w_bf16
    # top-level numbers: the 7B path's decode step, as in the K1 record
    top = {k: v for k, v in k2_by_path["7b_int8_generate"].items() if k not in ("shape", "rows", "by_rows")}
    rec["K2"] = dict(top, max_abs_err=k2_err, by_path=k2_by_path)
    return rec


K3_TILE = 64  # keys per tile of K3's tensor-core kernel
K3_FAULTS = ("skip_tile", "no_rescale", "mask_off_by_one")


def row_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """K3's measure: the worst over the output rows (b, s, h) of max|got -
    want| over the row, over max|want| over the row. One bound for the
    whole tensor would be set by the first rows, which attend to one key
    and are the largest outputs (|v| up to ~4, against ~0.1 for a row over
    300 keys): a fault in a late key tile would pass under it."""
    diff = (got.float() - want.float()).abs().amax(-1)
    ref = want.float().abs().amax(-1)
    return (diff / ref.clamp_min(torch.finfo(torch.float32).tiny)).max().item()


def flash_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, fault: str | None = None) -> torch.Tensor:
    """K3's bf16 algorithm in PyTorch, fp32: 64-key tiles, the online max
    and sum, P rounded to bf16 before PV, the output to bf16. Unfaulted,
    it is the control of K3's row tolerance (what the design's own rounding
    costs). `fault` plants one bug in the rows of the last query block (the
    longest rows, whose outputs are the smallest) that the tolerance must
    catch: "skip_tile" (they skip the middle key tile), "no_rescale" (their
    acc is not rescaled when the running max grows), "mask_off_by_one"
    (they also see the key after them)."""
    B, S, H, Dh = q.shape
    K = k.shape[2]
    qf = q.float().reshape(B, S, K, H // K, Dh).permute(0, 2, 3, 1, 4)  # [B, K, G, S, Dh]
    kf, vf = (x.float().permute(0, 2, 1, 3) for x in (k, v))            # [B, K, S, Dh]
    rows = torch.arange(S, device=q.device)[:, None]
    last = (S - 1) // K3_TILE
    late = rows // K3_TILE == last if fault else torch.zeros_like(rows, dtype=torch.bool)
    m = torch.full(qf.shape[:-1] + (1,), -1e30, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, S, K3_TILE):
        keys = torch.arange(k0, min(k0 + K3_TILE, S), device=q.device)[None, :]
        sc = torch.einsum("bkgqd,bksd->bkgqs", qf, kf[:, :, k0:k0 + K3_TILE]) * Dh**-0.5
        masked = keys > rows + (late & (fault == "mask_off_by_one")).int()
        if fault == "skip_tile" and k0 // K3_TILE == last // 2:
            masked = masked | late
        sc = sc.masked_fill(masked, -1e30)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = torch.where(late, acc, acc * corr) if fault == "no_rescale" else acc * corr
        acc = acc + torch.einsum("bkgqs,bksd->bkgqd", p.to(torch.bfloat16).float(), vf[:, :, k0:k0 + K3_TILE])
        m = m_new
    out = acc / torch.where(l == 0, torch.ones_like(l), l)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, Dh).to(q.dtype)


def phase_kernel_flash(attn_shapes) -> dict:
    """K3 against its plain version and SDPA at the prefill shapes of both
    model paths, row by row (row_err) at KERNEL_TOL; the rule is shown to
    sit between the control (flash_tiled) and each planted fault. The
    record is the first shape's, with every shape under by_shape."""
    from llava_align_tpu_torch.ops import attention

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(3)
    log(f"kernels: K3 flash_attention (causal prefill, tensor cores) vs plain, bf16, each output row "
        f"within {KERNEL_TOL:g} of its largest |plain|; kernel and SDPA timed eager (CUDA events), "
        "and as 20 launches in one CUDA graph (device time without the host's)")
    k3_err = k3_row = 0.0
    by_shape = []
    for B, S, H, Dh in attn_shapes:
        what = f"[{B},{S},{H},{Dh}]"
        qkv = [torch.randn((B, S, H, Dh), device=dev, generator=g).to(torch.bfloat16)
               for _ in range(3)]
        got, want = attention.flash_attention(*qkv), attention.flash_attention_plain(*qkv)
        err = (got.float() - want.float()).abs().max().item()
        row = row_err(got, want)
        control = row_err(flash_tiled(*qkv), want)
        planted = {f: flash_tiled(*qkv, fault=f) for f in K3_FAULTS}
        faults = {f: row_err(x, want) for f, x in planted.items()}
        # the same faults under one bound for the whole tensor, for the record
        whole = {f: ((x.float() - want.float()).abs().max() / want.float().abs().max()).item()
                 for f, x in planted.items()}
        ok = np.isfinite(row) and row <= KERNEL_TOL and control <= KERNEL_TOL
        caught = all(r > KERNEL_TOL for r in faults.values())
        log(f"  {what}: max_abs_err={err:.6g}, worst row {row:.6g} (control, bf16 P: {control:.6g}; "
            f"planted faults: " + ", ".join(f"{f} {r:.6g}" for f, r in faults.items())
            + f") tol={KERNEL_TOL:g} {'ok' if ok and caught else 'FAIL'}; under one bound for the "
            "whole tensor the faults read " + ", ".join(f"{f} {r:.6g}" for f, r in whole.items()))
        if not ok:
            raise AssertionError(f"K3 {what}: kernel disagrees with its plain version")
        if not caught:
            raise AssertionError(f"K3 {what}: the row tolerance lets a planted fault through")
        k3_err, k3_row = max(k3_err, err), max(k3_row, row)
        qt, kt, vt = (x.transpose(1, 2) for x in qkv)  # [B, H, S, Dh], as SDPA takes it
        kernel = lambda *_: attention.flash_attention(*qkv)  # noqa: E731
        sdpa = lambda *_: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)  # noqa: E731
        ms, lib_ms = cuda_ms(kernel, 20), cuda_ms(sdpa, 20)
        g_ms, g_lib_ms = graph_ms(kernel, 20), graph_ms(sdpa, 20)
        plain_ms = cuda_ms(lambda _: attention.flash_attention_plain(*qkv), 5)
        nbytes = 4 * B * S * H * Dh * 2
        flops = 4.0 * Dh * H * B * S * (S + 1) / 2  # QK and PV over the causal pairs
        b = bound(nbytes, flops)
        log(f"  {what}: kernel {ms:.4f} ms eager, {g_ms:.4f} ms in a graph ({flops / (g_ms * 1e-3) / 1e12:.1f} "
            f"TFLOP/s); library (SDPA) {lib_ms:.4f} ms eager, {g_lib_ms:.4f} ms in a graph; kernel/SDPA "
            f"{ms / lib_ms:.2f}x eager, {g_ms / g_lib_ms:.2f}x in a graph; plain {plain_ms:.4f} ms; bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
        by_shape.append(dict(shape=[B, S, H, Dh], ms=ms, library_ms=lib_ms, graph_ms=g_ms,
                             graph_library_ms=g_lib_ms, plain_ms=plain_ms, max_abs_err=err,
                             row_err=row, control_row_err=control, fault_row_err=faults,
                             fault_whole_err=whole, **b))
        del qkv, got, want, planted, qt, kt, vt
    top = {k: v for k, v in by_shape[0].items()
           if k in ("ms", "library_ms", "graph_ms", "graph_library_ms", "plain_ms", "bound_ms", "bound_by")}
    torch.cuda.synchronize()
    return dict(top, max_abs_err=k3_err, max_row_err=k3_row, by_shape=by_shape)


def random_int4_stack(L: int, O: int, D: int, g) -> tuple:
    dev = torch.device("cuda:0")
    q4 = torch.randint(-128, 128, (L, D // 2, O), dtype=torch.int8, device=dev, generator=g)
    gs = (torch.rand((L, D // 128, O), device=dev, generator=g) + 0.5) / (7.0 * D**0.5)
    return q4, gs


def phase_kernels_int4(decode_rows, prefill_rows) -> dict:
    """K4 at each 13B stack, layers 0 and 39, at the grouped path's row
    counts (decode, then the prefills), timed; at the rows on both sides of
    INT4_SKINNY_MAX_ROWS (the skinny regime's 1 and 2 rows, the mma.sync
    tiles' 3) and of INT4_WGMMA_MIN_ROWS (32 and 33), checked."""
    from llava_align_tpu_torch.ops import quant
    from llava_align_tpu_torch.scripts._common import matmul_work

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(4)
    thr = quant.INT4_SKINNY_MAX_ROWS
    log(f"kernels: K4 int4_matmul_stacked (13B int4 decoder linears) vs plain, bf16; "
        f"skinny regime up to {thr} rows, mma.sync tiles up to {quant.INT4_MMA_SYNC_MAX_ROWS}, wgmma above")
    stacks = {name: random_int4_stack(L_13B, O, D, g) for name, (O, D) in STACKS_13B.items()}
    rows_all = list(decode_rows) + list(prefill_rows)
    per_rows = {B: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, flops=0.0) for B in rows_all}
    err = 0.0
    for name, (q4, gs) in stacks.items():
        Dp, O = q4.shape[1], q4.shape[2]
        D = 2 * Dp
        w_bf16 = [quant.dequantize_int4({"q4": q4[i], "gs": gs[i]}, torch.bfloat16) for i in range(2)]
        for B in rows_all:
            h = torch.randn((B, D), device=dev, generator=g).to(torch.bfloat16)
            for li in (0, L_13B - 1):
                err = max(err, compare(
                    quant.int4_matmul_stacked(h, q4, gs, li),
                    quant.int4_matmul_stacked_plain(h, q4, gs, li),
                    f"{name} [{L_13B},{Dp},{O}] B={B} li={li}",
                ))
            if B == decode_rows[0]:
                # both sides of each regime threshold
                wg = quant.INT4_WGMMA_MIN_ROWS
                hs_all = torch.randn((wg, D), device=dev, generator=g).to(torch.bfloat16)
                for Bs in (*range(1, thr + 2), wg - 1, wg):
                    hs = hs_all[:Bs].contiguous()
                    regime = "skinny regime" if Bs <= thr else "mma.sync tiles" if Bs < wg else "wgmma regime"
                    for li in (0, L_13B - 1):
                        err = max(err, compare(
                            quant.int4_matmul_stacked(hs, q4, gs, li),
                            quant.int4_matmul_stacked_plain(hs, q4, gs, li),
                            f"{name} [{L_13B},{Dp},{O}] B={Bs} li={li} {regime}",
                        ))
            big = B > 512
            ms = cuda_ms(lambda i: quant.int4_matmul_stacked(h, q4, gs, i % L_13B), 10 if big else 40)
            plain_ms = cuda_ms(lambda i: quant.int4_matmul_stacked_plain(h, q4, gs, i % L_13B), 2, warmup=1)
            lib_ms = cuda_ms(lambda i: torch.matmul(h, w_bf16[i % 2].t()), 10 if big else 40)
            nb, fl = matmul_work(B, O, D, Dp * O, 4.0 * (D // 128) * O)
            r = per_rows[B]
            r["ms"] += ms
            r["plain_ms"] += plain_ms
            r["library_ms"] += lib_ms
            r["bytes"] += nb
            r["flops"] += fl
            log(f"  {name} B={B}: kernel {ms:.4f} ms ({Dp * O / (ms * 1e-3) / 1e9:.0f} GB/s of packed "
                f"weights, {fl / (ms * 1e-3) / 1e12:.1f} TFLOP/s), plain {plain_ms:.4f} ms, library "
                f"(torch.matmul, bf16 weight) {lib_ms:.4f} ms, bound {bound(nb, fl)['bound_ms']:.4f} ms")
        del w_bf16
    for B, r in per_rows.items():
        r.update(bound(r.pop("bytes"), r.pop("flops")))
        log(f"  one 13B layer's four linears at B={B}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    del stacks
    torch.cuda.empty_cache()
    head = per_rows[decode_rows[-1]]  # the G = 4 decode step, the grouped path's headline
    prefill = [dict(rows=B, **per_rows[B]) for B in prefill_rows]
    return dict(head, max_abs_err=err, prefill=prefill)


# kernels-line entries of the microbenchmark path: TPU kernel -> (the twin
# that runs it, the key of the kernel's record in the twin's main() result,
# the port's wrapper, its source, the TPU kernel's file:line)
PROBE_KERNELS = {
    "S1a": ("bench_int4_probe", "int4_mm", "int4_rowmajor_matmul_stacked",
            "llava_align_tpu_torch/csrc/stream_mma.cuh", "scripts/bench_int4_probe.py:58"),
    "S1b": ("bench_int4_probe", "int4_native_mm", "int8_matmul_stacked",
            "llava_align_tpu_torch/csrc/int8_mm.cu", "scripts/bench_int4_probe.py:115"),
    "S2a": ("bench_int4_probe2", "int4_mm", "int4_rowmajor_matmul_stacked",
            "llava_align_tpu_torch/csrc/stream_mma.cuh", "scripts/bench_int4_probe2.py:55"),
    "S2b": ("bench_int4_probe2", "int4_native_mm", "int8_matmul_stacked",
            "llava_align_tpu_torch/csrc/int8_mm.cu", "scripts/bench_int4_probe2.py:182"),
    "S3": ("bench_int4_probe3", "int4_mm", "int4_rowmajor_matmul_stacked",
           "llava_align_tpu_torch/csrc/stream_mma.cuh", "scripts/bench_int4_probe3.py:46"),
    "S4": ("bench_int4_transposed", "int4t_mm", "int4_matmul_stacked",
           "llava_align_tpu_torch/csrc/int4_mm.cu", "scripts/bench_int4_transposed.py:43"),
    "S5": ("bench_bf16_stream", "stream_mm", "bf16_matmul_stacked",
           "llava_align_tpu_torch/csrc/stream_mma.cuh", "scripts/bench_bf16_stream.py:37"),
    "S6": ("probe_int4_kernel_bisect", "kern", "int4_rowmajor_matmul_stacked",
           "llava_align_tpu_torch/csrc/stream_mma.cuh", "scripts/probe_int4_kernel_bisect.py:24"),
    "S7": ("probe_mosaic_ops", "tryk", "repeat2d", "llava_align_tpu_torch/csrc/repeat2d.cu",
           "scripts/probe_mosaic_ops.py:9"),
}


def phase_probes() -> dict:
    """The microbenchmark path: each twin's main() once, at its TPU
    script's shapes, on the card; every count is reset before a twin and
    read after it. Each twin must launch the kernels of its TPU script. A
    twin's main() returns its kernels' records (error against the plain
    version at the twin's shapes; kernel, plain and library ms; the timed
    work's bytes and operations): each error is held here at KERNEL_TOL
    (S7 exact) and each record becomes the S entry's numbers."""
    import importlib

    from llava_align_tpu_torch.scripts import TWINS

    counts, results = {}, {}
    for twin in TWINS:
        mod = importlib.import_module(f"llava_align_tpu_torch.scripts.{twin}")
        log(f"microbenchmark twin {twin}:")
        reset_launches()
        t0 = time.perf_counter()
        results[twin] = mod.main([])
        torch.cuda.synchronize()
        counts[twin] = read_launches()
        torch.cuda.empty_cache()
        log(f"  {twin}: {time.perf_counter() - t0:.2f} s, launches "
            f"{ {k: v for k, v in counts[twin].items() if v} }")
    dead = [(sid, twin, w) for sid, (twin, _, w, _, _) in PROBE_KERNELS.items() if counts[twin][w] <= 0]
    if dead:
        raise AssertionError(f"kernels not launched by their twins: {dead}")
    entries = {}
    for sid, (twin, key, w, _, _) in PROBE_KERNELS.items():
        r = results[twin][key]
        tol = 0.0 if sid == "S7" else KERNEL_TOL * r["ref_max"]
        ok = np.isfinite(r["max_abs_err"]) and r["max_abs_err"] <= tol
        b = bound(r["bytes"], r["flops"])
        log(f"  {sid} ({twin}.{key}): max_abs_err={r['max_abs_err']:.6g} tol={tol:.6g} "
            f"{'ok' if ok else 'FAIL'}; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}); launches {counts[twin][w]}")
        if not ok:
            raise AssertionError(f"{sid}: the kernel disagrees with its plain version in {twin}")
        entries[sid] = dict(launches=counts[twin][w], max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], library_ms=r["library_ms"], **b)
    return entries


def pope_requests(tokenizer, image_size: int):
    """POPE-style requests: llava_v1 prompts and seeded uint8 images."""
    from llava_align_tpu_torch.runners.common import build_prompt
    from llava_align_tpu_torch.tokenization import tokenizer_image_token

    rng = np.random.default_rng(0)
    return [
        (tokenizer_image_token(build_prompt(q, "llava_v1")[0], tokenizer),
         rng.integers(0, 256, (3, image_size, image_size), dtype=np.uint8))
        for q in QUESTIONS[:N_REQUESTS]
    ]


def grouped_shapes(num_image_tokens: int, bucket: int = 128) -> dict:
    """The 13B grouped path's row counts, from the MockTokenizer prompts."""
    from llava_align_tpu_torch.runners.common import MockTokenizer, pope_groups

    prefix, suffixes, _ = pope_groups(MockTokenizer(), 336, 1)[0]
    pad = lambda n, m: -(-max(n, m) // m) * m  # noqa: E731
    pad_prefix = pad(len(prefix) - 1 + num_image_tokens, bucket)
    pad_txt = pad(len(prefix), bucket)  # 'unk' keeps the sentinel's slot; 'none' is 1 shorter
    pad_suf = pad(max(len(s) for s in suffixes), 32)
    rows_q = 6 * 3  # questions x VDD branches
    # the prefills' rows: image prefixes, text-branch prefixes (unk, none),
    # suffixes
    prefill_rows = (GROUPS * pad_prefix, GROUPS * 2 * pad_txt, GROUPS * rows_q * pad_suf)
    return dict(pad_prefix=pad_prefix, pad_txt=pad_txt, pad_suf=pad_suf,
                decode_rows=(rows_q, GROUPS * rows_q), prefill_rows=prefill_rows)


def dual_vdd_config():
    from llava_align_tpu_torch.config import GenerationConfig

    return GenerationConfig(
        max_new_tokens=NEW_TOKENS, do_sample=False, use_dd=True, use_dd_unk=True,
        cd_alpha=1.0, cd_beta=0.1, eos_token_id=10**9,  # EOS out of range: full length
    )


def check_output(out, V: int, what: str) -> None:
    probs = out.first_scores_top_probs
    if out.num_generated != NEW_TOKENS or len(out.token_ids) != NEW_TOKENS:
        raise AssertionError(f"{what}: {out.num_generated} tokens, expected {NEW_TOKENS}")
    if not all(0 <= t < V for t in out.token_ids):
        raise AssertionError(f"{what}: token ids out of the vocab: {out.token_ids}")
    if not (np.all(np.isfinite(probs)) and np.all(np.diff(probs) <= 0) and probs.sum() <= 1 + 1e-5):
        raise AssertionError(f"{what}: bad first-step scores {probs[:8]}")


def wrappers():
    from llava_align_tpu_torch.ops import attention, quant
    from llava_align_tpu_torch.ops import stream_probes as sp

    return {
        "int8_matmul_stacked": quant.int8_matmul_stacked,
        "int8_matmul_cuda": quant.int8_matmul_cuda,
        "flash_attention": attention.flash_attention,
        "int4_matmul_stacked": quant.int4_matmul_stacked,
        "int4_rowmajor_matmul_stacked": sp.int4_rowmajor_matmul_stacked,
        "bf16_matmul_stacked": sp.bf16_matmul_stacked,
        "repeat2d": sp.repeat2d,
    }


def reset_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


def phase_main_path(dev) -> dict:
    """LLaVA-v1.5-7B int8, dual-branch VDD, through DecodeEngine.generate."""
    from llava_align_tpu_torch.decoding.engine import DecodeEngine
    from llava_align_tpu_torch.ops import quant
    from llava_align_tpu_torch.runners.common import load_model

    t0 = time.perf_counter()
    lm = load_model("random:7b", quant="int8", device=dev, seed=0)
    torch.cuda.synchronize()
    log(f"7B path: built random LLaVA-v1.5-7B int8 on {dev} in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    engine = DecodeEngine(lm.params, lm.cfg, dual_vdd_config())
    requests = pope_requests(lm.tokenizer, lm.cfg.vision.image_size)
    V = lm.cfg.text.vocab_size

    # every call that takes the dequant path, as (rows, O, D): none may be
    # one the JAX rule streams (an O >= D stack at 65..640 rows)
    dequant_calls = collections.Counter()
    dequant = quant.int8_matmul_dequant

    def counted_dequant(h, q, s):
        dequant_calls[(h.numel() // h.shape[-1], q.shape[0], q.shape[1])] += 1
        return dequant(h, q, s)

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    stats = []
    quant.int8_matmul_dequant = counted_dequant
    try:
        for i, (ids, image) in enumerate(requests):
            out = engine.generate(ids, image)
            torch.cuda.synchronize()
            check_output(out, V, f"request {i}")
            decode_s = out.seconds_total - out.seconds_to_first_token
            tps = (out.num_generated - 1) / decode_s
            stats.append((out.seconds_total, out.seconds_to_first_token, tps))
            log(f"  request {i}{' (warm-up)' if i == 0 else ''}: prompt {len(ids)} ids -> spliced "
                f"{out.prompt_length}, tokens {out.token_ids}, total {out.seconds_total:.4f} s, "
                f"prefill+first token {out.seconds_to_first_token:.4f} s, decode {tps:.2f} tok/s")
    finally:
        quant.int8_matmul_dequant = dequant
    launches = read_launches()
    log(f"  dequant-path calls (rows, O, D): {dict(dequant_calls)}")
    streamable = [c for c in dequant_calls if quant._stream_rows_ok(*c)]
    if streamable:
        raise AssertionError(f"calls the JAX rule streams took the dequant path: {streamable}")
    peak = torch.cuda.max_memory_allocated()
    steady = stats[1:]
    log(f"  launches during the 7B path: {launches}")
    log(f"  steady requests (1..{len(stats) - 1}): mean total {np.mean([s[0] for s in steady]):.4f} s, "
        f"mean prefill+first token {np.mean([s[1] for s in steady]):.4f} s, "
        f"mean decode {np.mean([s[2] for s in steady]):.2f} tok/s; "
        f"peak memory {peak / 2**30:.2f} GiB")
    dead = [n for n in ("int8_matmul_stacked", "int8_matmul_cuda", "flash_attention") if launches[n] <= 0]
    if dead:
        raise AssertionError(f"kernels not launched on the 7B path: {dead}")
    del engine, lm
    torch.cuda.empty_cache()
    return launches


def to_cpu32(node):
    if isinstance(node, dict):
        return {k: to_cpu32(v) for k, v in node.items()}
    if isinstance(node, list):
        return [to_cpu32(v) for v in node]
    return node.cpu().float() if node.is_floating_point() else node.cpu()


def cut_config(full, dtype=None):
    """full width, 2 decoder layers, 3 vision layers (select_layer -2 runs 2)."""
    cfg = dataclasses.replace(
        full, text=dataclasses.replace(full.text, num_layers=2),
        vision=dataclasses.replace(full.vision, num_layers=3),
    )
    if dtype is not None:
        cfg = dataclasses.replace(
            cfg, text=dataclasses.replace(cfg.text, dtype=dtype),
            vision=dataclasses.replace(cfg.vision, dtype=dtype),
        )
    return cfg


def phase_reference(dev) -> None:
    """Full-width 7B model cut to 2 decoder / 2 vision layers: prefill and
    decode logits on the card (kernels) against fp32 on the CPU (plain)."""
    from llava_align_tpu_torch.config import LlavaConfig
    from llava_align_tpu_torch.models import llama, llava
    from llava_align_tpu_torch.ops.image import normalize_device
    from llava_align_tpu_torch.runners.common import MockTokenizer
    from llava_align_tpu_torch.utils.synthetic import build_random_llava_params

    cfg = cut_config(LlavaConfig.llava_v15_7b())
    cfg32 = cut_config(LlavaConfig.llava_v15_7b(), torch.float32)
    params = build_random_llava_params(cfg, quant="int8", device=dev, seed=1)
    params_cpu = to_cpu32(params)
    ids, image = pope_requests(MockTokenizer(), cfg.vision.image_size)[0]
    plan = llava.plan_splice(ids, cfg.num_image_tokens, -(-(len(ids) - 1 + cfg.num_image_tokens) // 128) * 128)
    steps = (29871, 3869)  # fixed next tokens, so both sides decode the same sequence

    @torch.inference_mode()
    def run(p, c, device):
        pixels = normalize_device(torch.from_numpy(image)[None].to(device), c.vision.dtype)
        feats = llava.encode_images(p, c, pixels)
        t = {k: torch.from_numpy(np.asarray(getattr(plan, k)))[None].to(device)
             for k in ("tokens", "tok_gather", "img_gather", "is_image")}
        embeds = llava.splice_embeds(p, c, t["tokens"], t["tok_gather"], t["img_gather"], t["is_image"], feats)
        S = embeds.shape[1]
        cache = llama.init_cache(c.text, 1, S + len(steps), device=device)
        zero = torch.zeros((1,), dtype=torch.long, device=device)
        hidden, _ = llama.forward(p["llama"], c.text, embeds, torch.arange(S, device=device)[None], cache, zero)
        out = [llama.last_token_logits(p["llama"], hidden, zero + plan.length - 1)]
        for i, tok in enumerate(steps):
            pos = zero + plan.length + i
            emb = llama.embed_tokens(p["llama"], torch.full((1, 1), tok, device=device))
            hidden, _ = llama.forward(p["llama"], c.text, emb, pos[:, None], cache, pos)
            out.append(llama.logits_from_hidden(p["llama"], hidden[:, 0]))
        return [o.float().cpu() for o in out]

    got, ref = run(params, cfg, dev), run(params_cpu, cfg32, torch.device("cpu"))
    for name, g, r in zip(("prefill", "decode 1", "decode 2"), got, ref):
        rel_check(g, r, f"7B reference {name}: max|card - cpu fp32| / max|cpu|")
    del params, params_cpu
    torch.cuda.empty_cache()


def rel_check(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    err = (got - want).abs().max().item() / want.abs().max().item()
    ok = np.isfinite(err) and err <= REFERENCE_TOL
    log(f"{what} = {err:.4g} (tol {REFERENCE_TOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: out of tolerance")
    return err


def phase_grouped(dev, shapes) -> dict:
    """LLaVA-v1.5-13B int4, dual-branch VDD, through the grouped entry points."""
    from llava_align_tpu_torch.decoding.engine import DecodeEngine
    from llava_align_tpu_torch.runners.common import load_model
    from llava_align_tpu_torch.runners.common import pope_groups

    t0 = time.perf_counter()
    lm = load_model("random:13b", quant="int4", device=dev, seed=0)
    torch.cuda.synchronize()
    log(f"13B grouped path: built random LLaVA-v1.5-13B int4 (group 128) on {dev} in "
        f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    engine = DecodeEngine(lm.params, lm.cfg, dual_vdd_config())
    V = lm.cfg.text.vocab_size
    calls = [pope_groups(lm.tokenizer, lm.cfg.vision.image_size, GROUPS, seed=1 + c)
             for c in range(GROUP_CALLS)]
    prefix, suffixes, _ = calls[0][0]
    log(f"  POPE split: prefix {len(prefix)} ids (bucket {shapes['pad_prefix']} with the image), "
        f"suffixes {[len(s) for s in suffixes]} ids (bucket {shapes['pad_suf']}), text prefixes "
        f"bucket {shapes['pad_txt']}")

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    outs = engine.generate_batch_prefix(*calls[0][0])
    torch.cuda.synchronize()
    one = time.perf_counter() - t1
    for q, out in enumerate(outs):
        check_output(out, V, f"generate_batch_prefix question {q}")
    at_g1 = read_launches()
    log(f"  generate_batch_prefix (1 image x 6 questions, includes warm-up): {one:.4f} s, "
        f"{6 / one:.2f} questions/s, first tokens {[o.token_ids[:3] for o in outs[:2]]}; "
        f"launches {at_g1}")

    # the first G = 4 call through generate_batch_groups (it warms up), the
    # rest through submit_batch_groups / collect_batch_groups in the POPE
    # runner's order (submit g+1 before collecting g); the port's submit
    # runs the whole call, so the loop is sequential
    t1 = time.perf_counter()
    outs = engine.generate_batch_groups(calls[0])
    per_call, n_q = [outs[0].seconds_total], len(outs)
    for q, out in enumerate(outs):
        check_output(out, V, f"generate_batch_groups question {q}")
    log(f"  grouped call 0, generate_batch_groups (warm-up, G={GROUPS} x 6 questions): "
        f"prefill+first token {outs[0].seconds_to_first_token:.4f} s, call {outs[0].seconds_total:.4f} s")
    handle = engine.submit_batch_groups(calls[1])
    for c in range(2, GROUP_CALLS + 1):
        nxt = engine.submit_batch_groups(calls[c]) if c < GROUP_CALLS else None
        outs = engine.collect_batch_groups(handle)
        for q, out in enumerate(outs):
            check_output(out, V, f"grouped call {c - 1} question {q}")
        n_q += len(outs)
        per_call.append(outs[0].seconds_total)
        log(f"  grouped call {c - 1}, submit/collect (G={GROUPS} x 6 questions): "
            f"prefill+first token {outs[0].seconds_to_first_token:.4f} s, call {outs[0].seconds_total:.4f} s")
        handle = nxt
    torch.cuda.synchronize()
    loop = time.perf_counter() - t1
    launches = read_launches()
    at_g4 = {n: launches[n] - at_g1[n] for n in launches}
    peak = torch.cuda.max_memory_allocated()
    steady = float(np.mean(per_call[1:]))
    log(f"  launches during the 13B grouped path: {launches} (the G = 4 calls alone: {at_g4})")
    log(f"  G={GROUPS} calls: {GROUP_CALLS}, {n_q} questions in {loop:.4f} s "
        f"({n_q / loop:.2f} questions/s with the warm-up call); steady calls (1..{GROUP_CALLS - 1}) "
        f"{steady:.4f} s per call, {GROUPS * 6 / steady:.2f} questions/s; peak memory "
        f"{peak / 2**30:.2f} GiB")
    for what, counts in (("G = 1 call", at_g1), ("G = 4 calls", at_g4)):
        dead = [n for n in ("int4_matmul_stacked", "int8_matmul_cuda", "flash_attention") if counts[n] <= 0]
        if dead:
            raise AssertionError(f"kernels not launched in the 13B grouped path's {what}: {dead}")
    del engine, lm
    torch.cuda.empty_cache()
    return launches


def phase_grouped_reference(dev) -> None:
    """13B int4 at full width cut to 2 decoder / 2 vision layers: the
    grouped path's first-step fused scores on the card against the fp32 CPU
    run of the same params (plain versions), and against `generate` on the
    card for the same question. Scores are compared where both are finite
    (the plausibility cutoff may differ for tokens right at it)."""
    from llava_align_tpu_torch.config import LlavaConfig
    from llava_align_tpu_torch.decoding.engine import DecodeEngine
    from llava_align_tpu_torch.runners.common import MockTokenizer, pope_groups
    from llava_align_tpu_torch.utils.synthetic import build_random_llava_params

    cfg = cut_config(LlavaConfig.llava_v15_13b())
    cfg32 = cut_config(LlavaConfig.llava_v15_13b(), torch.float32)
    params = build_random_llava_params(cfg, quant="int4", device=dev, seed=2)
    params_cpu = to_cpu32(params)
    prefix, suffixes, image = pope_groups(MockTokenizer(), cfg.vision.image_size, 1, seed=7)[0]
    group = [(prefix, suffixes[:2], image)]
    gen = dataclasses.replace(dual_vdd_config(), max_new_tokens=1)

    with torch.inference_mode():
        card = DecodeEngine(params, cfg, gen)
        got = card.submit_batch_groups(group)["first_scores"].float().cpu()
        single = card.submit_generate(prefix + suffixes[0], image)["first_scores"].float().cpu()
        want = DecodeEngine(params_cpu, cfg32, gen).submit_batch_groups(group)["first_scores"]

    def finite_check(a, b, what):
        both = torch.isfinite(a) & torch.isfinite(b)
        differ = (torch.isfinite(a) != torch.isfinite(b)).float().mean().item()
        log(f"  {what}: {int(both.sum())} scores finite in both, cutoff disagrees on {differ:.4%}")
        if differ > 0.01:
            raise AssertionError(f"{what}: the plausibility cutoffs disagree on {differ:.2%} of the vocab")
        return rel_check(a[both], b[both], f"13B grouped reference {what}: max|diff| / max|ref|")

    finite_check(got, want, "grouped card vs cpu fp32, first-step fused scores")
    finite_check(got[0], single, "grouped vs generate on the card, question 0")
    del params, params_cpu
    torch.cuda.empty_cache()


def main() -> int:
    name, smi = phase_device()
    dev = torch.device("cuda:0")
    phase_build()
    from llava_align_tpu_torch.runners.common import MockTokenizer

    # the 7B path's prefill lengths: image row and text rows at 128-buckets
    ids = pope_requests(MockTokenizer(), 336)[0][0]
    main_lens = (-(-(len(ids) - 1 + 576) // 128) * 128, -(-len(ids) // 128) * 128)
    shapes = grouped_shapes(576)
    log(f"13B grouped path shapes: {shapes}")
    attn_shapes = [(1, 640, 32, 128), (2, 128, 32, 128), (1, main_lens[0], 32, 128),
                   (2, main_lens[1], 32, 128), (GROUPS, shapes["pad_prefix"], 40, 128),
                   (2 * GROUPS, shapes["pad_txt"], 40, 128)]
    # the text-branch rows (unk, none) prefill together at their bucket
    rec = phase_kernels_int8(shapes["decode_rows"], 2 * main_lens[1])
    rec["K3"] = phase_kernel_flash(attn_shapes)
    rec["K4"] = phase_kernels_int4(shapes["decode_rows"], shapes["prefill_rows"])
    torch.cuda.synchronize()
    probes = phase_probes()
    by_path = {"7b_int8_generate": phase_main_path(dev)}
    torch.cuda.synchronize()
    phase_reference(dev)
    torch.cuda.synchronize()
    by_path["13b_int4_grouped"] = phase_grouped(dev, shapes)
    torch.cuda.synchronize()
    phase_grouped_reference(dev)
    torch.cuda.synchronize()

    sources = {
        "int8_matmul_stacked": ("K1", "llava_align_tpu_torch/csrc/int8_mm.cu", "llava_align_tpu/ops/quant.py:242"),
        "int8_matmul_cuda": ("K2", "llava_align_tpu_torch/csrc/int8_mm.cu", "llava_align_tpu/ops/quant.py:177"),
        "flash_attention": ("K3", "llava_align_tpu_torch/csrc/flash_attn.cu", "llava_align_tpu/ops/attention.py:611"),
        "int4_matmul_stacked": ("K4", "llava_align_tpu_torch/csrc/int4_mm.cu", "llava_align_tpu/ops/quant.py:541"),
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("by_rows", "by_path", "prefill", "graph_ms", "graph_library_ms", "max_row_err", "by_shape")
    kernels = [
        dict(name=n, route="cuda", source=src, replaces=rep,
             launches=sum(p[n] for p in by_path.values()),
             launches_by_path={path: p[n] for path, p in by_path.items()},
             **{k: rec[kid][k] for k in keys},
             **{k: rec[kid][k] for k in extra if k in rec[kid]})
        for n, (kid, src, rep) in sources.items()
    ] + [
        # the microbenchmark path: launches, errors and times from the twin's run
        dict(name=f"{sid} {w}", route="cuda", source=src, replaces=rep, twin=twin,
             launches=probes[sid]["launches"], **{k: probes[sid][k] for k in keys})
        for sid, (twin, _, w, src, rep) in PROBE_KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
