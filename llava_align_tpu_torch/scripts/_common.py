"""Shared pieces of the microbenchmark twins: the 7B decode shapes, the
command line, seeded inputs made on the device, timing, and the record each
twin returns for its kernel.

Every twin takes `--device` (the GPU unless `--device cpu` is given; without
a GPU it raises) and `--tiny` (the four stacks at 1/16 of the 7B widths, for
a rehearsal on the CPU). Times on the GPU are CUDA events over whole steps;
on the CPU they are the host clock and say so.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from llava_align_tpu_torch.utils.synthetic import resolve_device

# LLaVA-v1.5-7B's decoder stacks, [O, D]: fused q|k|v, o, fused gate|up, down
SHAPES_7B: Dict[str, Tuple[int, int]] = {
    "qkv": (3 * 4096, 4096), "o": (4096, 4096), "gateup": (2 * 11008, 4096), "down": (4096, 11008),
}
# the same four stacks at rehearsal size (every D a multiple of 256)
SHAPES_TINY: Dict[str, Tuple[int, int]] = {
    "qkv": (768, 256), "o": (256, 256), "gateup": (1024, 256), "down": (256, 512),
}
B = 16  # the scripts' decode rows
SLOPE_LAYERS = (4, 12)  # the two stack depths the slope scripts time
ITERS = 10  # timed steps (or calls) per number


def parse(argv: Optional[Sequence[str]], doc: str, extra: Callable = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true", help="1/16 widths, for a CPU rehearsal")
    if extra is not None:
        extra(ap)
    return ap.parse_args(list(argv) if argv is not None else None)


def setup(args) -> Tuple[torch.device, Dict[str, Tuple[int, int]]]:
    """The device and the stacks' shapes; on the GPU, fp32 matmuls in full
    fp32 (the references)."""
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev, dict(SHAPES_TINY if args.tiny else SHAPES_7B)


def make(shape, dtype=torch.bfloat16, seed: int = 0, device="cpu", std: float = 0.02) -> torch.Tensor:
    """std * N(0, 1) from a seeded generator on `device`, cast to dtype."""
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=device) * std).to(dtype)


def codes(shape, seed: int, device, low: int = -8, high: int = 8) -> torch.Tensor:
    """int8 integers in [low, high) from a seeded generator on `device`."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(low, high, shape, generator=g, device=device, dtype=torch.int8)


def max_abs(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.float() - want.float()).abs().max().item()


def clock(device: torch.device) -> str:
    return "CUDA events" if device.type == "cuda" else "host clock, CPU"


def time_ms(fn: Callable[[], object], device: torch.device, iters: int = ITERS, warmup: int = 2) -> float:
    """Mean time of fn() in ms over `iters` calls after `warmup` calls: CUDA
    events on the GPU, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def graph_ms(fn: Callable[[], object], device: torch.device, iters: int = ITERS,
             replays: int = 5) -> Optional[float]:
    """Mean device time of fn() in ms over `iters` calls captured in one
    CUDA graph, by CUDA events over `replays` replays: the kernels' time
    without the host's launch cost between them. None on the CPU, which
    has no graphs."""
    if device.type != "cuda":
        return None
    for _ in range(2):
        fn()
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize(device)
    del graph
    return start.elapsed_time(end) / (iters * replays)


def layer_ms(call: Callable[[int, str], object], names: Sequence[str], L: int,
             device: torch.device, iters: int = ITERS, warmup: int = 2) -> float:
    """Time of one layer: a step calls call(li, name) for every layer li and
    stack name (the layers rotate, so each call reads weights the previous
    ones did not), timed over `iters` steps and divided by L."""

    def step():
        for li in range(L):
            for name in names:
                call(li, name)

    return time_ms(step, device, iters, warmup) / L


def matmul_work(B: int, O: int, D: int, weight_bytes: float, scale_bytes: float, act_bytes: int = 2):
    """(bytes, operations) of y[B,O] = h[B,D] W: weights and scales read
    once, h read once, y written once; one multiply-add is two operations."""
    return weight_bytes + scale_bytes + act_bytes * B * (D + O), 2.0 * B * O * D


def stack_record(kernel: Callable, plain: Callable, dense: Callable, shapes: Dict[str, Tuple[int, int]],
                 hs: Dict[str, torch.Tensor], L: int, device: torch.device,
                 work_bytes: Callable[[int, int], Tuple[float, float]]) -> dict:
    """The record of one stacked-matmul kernel over the stacks `shapes`, per
    layer: kernel(h, name, li) against plain(h, name, li) at layers 0 and
    L-1 of every stack (max_abs_err, and ref_max = max|plain|); the
    kernel's, the plain version's and the library's times (torch.matmul on
    dense(name, li), the layer's weight in bf16, built beforehand for two
    layers used in turn); and the bytes and operations of one layer, with
    work_bytes(O, D) -> (weight bytes, scale bytes) of one stack."""
    err = ref = 0.0
    for k in shapes:
        for li in (0, L - 1):
            want = plain(hs[k], k, li)
            err = max(err, max_abs(kernel(hs[k], k, li), want))
            ref = max(ref, want.float().abs().max().item())
    ms = layer_ms(lambda li, k: kernel(hs[k], k, li), shapes, L, device)
    plain_ms = layer_ms(lambda li, k: plain(hs[k], k, li), shapes, L, device, iters=1, warmup=1)
    two = {k: [dense(k, li) for li in (0, L - 1)] for k in shapes}
    library_ms = layer_ms(lambda li, k: torch.matmul(hs[k], two[k][li % 2].t()), shapes, L, device)
    del two
    nbytes = flops = 0.0
    for k, (O, D) in shapes.items():
        b, f = matmul_work(hs[k].shape[0], O, D, *work_bytes(O, D))
        nbytes, flops = nbytes + b, flops + f
    return dict(max_abs_err=err, ref_max=ref, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bytes=nbytes, flops=flops)


def record_line(label: str, rec: dict, weight_bytes: float, note: str = "") -> str:
    """One printed line of a record: error, and kernel / plain / library ms
    with the kernel's rate over `weight_bytes` (per layer or call), `note`
    after the rate."""
    return (f"{label}: max|kernel - plain| {rec['max_abs_err']:.2e} (max|plain| {rec['ref_max']:.3g}); "
            f"kernel {rec['ms']:.4f} ms -> {gbs(weight_bytes, rec['ms']):.0f} GB/s{note}, plain "
            f"{rec['plain_ms']:.4f} ms, library (torch.matmul, bf16 weight) {rec['library_ms']:.4f} ms")


def gbs(nbytes: float, ms: float) -> float:
    return nbytes / (ms * 1e-3) / 1e9


def slope_line(t_small: float, t_big: float, nbytes: int) -> str:
    """Per-layer times at both SLOPE_LAYERS depths and the rate of their
    slope, (t_big * 12 - t_small * 4) / 8 per layer, for `nbytes` a layer."""
    lo, hi = SLOPE_LAYERS
    slope = (t_big * hi - t_small * lo) / (hi - lo)
    return (f"t{lo}={t_small:.4f} ms/layer t{hi}={t_big:.4f} ms/layer slope {slope:.4f} ms/layer "
            f"-> {gbs(nbytes, slope):.0f} GB/s")
