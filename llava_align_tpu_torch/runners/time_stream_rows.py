"""The decode-row kernels' time at 1-72 rows, per layer of a model's
stacks, in each weight format, on one GPU.

    python3 -m llava_align_tpu_torch.runners.time_stream_rows [--model 7b|13b] [--rows 1 2 3 ...]
        [--formats int8 int4 int4_g128 bf16 k4 library] [--iters 100]

Builds random stacks of LLaVA-v1.5-7B's (or 13B's) four decoder linears
(fused qkv, o, fused gate|up, down; 4 layers, so that no weight stays in
L2) in each format: int8 with per-channel scales (K1,
int8_matmul_stacked), row-major split-half int4 with per-channel or
group-128 scales (int4_rowmajor_matmul_stacked) and bf16
(bf16_matmul_stacked), all on the weight-streaming kernel up to 64 rows,
and K4's transposed int4 group-128 layout (int4_matmul_stacked, its own
regimes). Times each on bf16 activations at each row count by CUDA
events, --iters calls per linear walking the layers, beside one library
call on the same shapes (torch.matmul on a bf16 weight built beforehand,
two layers used in turn). int8 and K4 also run past 64 rows, where their
wrappers take a wgmma regime. Each call is timed eager (back to back
from Python, the host's launch cost included) and as --iters calls
captured in one CUDA graph (the device's time alone). Prints one JSON
line: {"card": ..., "model": ..., "ms": {format: {rows: {"layer": ms of
one layer's four linears, "<stack>": ms of that stack, "layer_graph",
"<stack>_graph": the same in a graph}}}}. Uses only the wrappers' public
signatures, so it times any tree of the port (PYTHONPATH=<tree>): run on
two trees in one call, it gives the crossover of two kernels.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from llava_align_tpu_torch.ops import quant
from llava_align_tpu_torch.ops import stream_probes as sp

STACKS = {
    "7b": {"qkv": (12288, 4096), "o": (4096, 4096), "gateup": (22016, 4096), "down": (4096, 11008)},
    "13b": {"qkv": (15360, 5120), "o": (5120, 5120), "gateup": (27648, 5120), "down": (5120, 13824)},
}
L = 4
FORMATS = ("int8", "int4", "int4_g128", "bf16", "k4", "library")
PAST_DECODE_ROWS = ("int8", "k4", "library")  # the formats whose wrappers take rows past 64
ROWS = (1, 2, 3, 4, 8, 9, 16, 17, 18, 24, 32, 33, 48, 64, 65, 72)


def per_call_ms(call, iters: int) -> float:
    """Mean time of call(li) over `iters` calls walking the layers."""
    for i in range(3):
        call(i % L)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        call(i % L)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_call_ms(call, iters: int, replays: int = 3) -> float:
    """Mean device time of call(li) over `iters` calls walking the layers,
    captured in one CUDA graph and replayed `replays` times."""
    for i in range(3):
        call(i % L)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            call(i % L)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def stack(fmt: str, O: int, D: int, g: torch.Generator):
    """(weights, the call on h and a layer) of one stack in `fmt`."""
    dev = g.device
    if fmt == "int8":
        q = torch.randint(-127, 128, (L, O, D), dtype=torch.int8, device=dev, generator=g)
        s = (torch.rand((L, O), device=dev, generator=g) + 0.5) / (127.0 * D**0.5)
        return (q, s), lambda h, li: quant.int8_matmul_stacked(h, q, s, li)
    if fmt in ("int4", "int4_g128"):
        p = torch.randint(-128, 128, (L, O, D // 2), dtype=torch.int8, device=dev, generator=g)
        shape = (L, O, D // 128) if fmt == "int4_g128" else (L, O)
        s = (torch.rand(shape, device=dev, generator=g) + 0.5) / (7.0 * D**0.5)
        return (p, s), lambda h, li: sp.int4_rowmajor_matmul_stacked(h, p, s, li)
    if fmt == "k4":
        q4 = torch.randint(-128, 128, (L, D // 2, O), dtype=torch.int8, device=dev, generator=g)
        gs = (torch.rand((L, D // 128, O), device=dev, generator=g) + 0.5) / (7.0 * D**0.5)
        return (q4, gs), lambda h, li: quant.int4_matmul_stacked(h, q4, gs, li)
    w = (torch.randn((L if fmt == "bf16" else 2, O, D), device=dev, generator=g) * 0.02).to(torch.bfloat16)
    if fmt == "bf16":
        return (w,), lambda h, li: sp.bf16_matmul_stacked(h, w, li)
    return (w,), lambda h, li: torch.matmul(h, w[li % 2].t())  # the library: a yardstick only


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="+", default=list(ROWS))
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--formats", nargs="+", default=list(FORMATS), choices=FORMATS)
    ap.add_argument("--model", choices=sorted(STACKS), default="7b")
    args = ap.parse_args(argv)
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for fmt in args.formats:
        rows = [B for B in args.rows if B <= quant.DECODE_MAX_ROWS or fmt in PAST_DECODE_ROWS]
        per = {B: {"layer": 0.0, "layer_graph": 0.0} for B in rows}
        for name, (O, D) in STACKS[args.model].items():
            weights, call = stack(fmt, O, D, g)
            for B in rows:
                h = torch.randn((B, D), device=dev, generator=g).to(torch.bfloat16)
                for key, timer in (("", per_call_ms), ("_graph", graph_call_ms)):
                    ms = timer(lambda li: call(h, li), args.iters)
                    per[B]["layer" + key] += ms
                    per[B][name + key] = ms
            del weights, call
            torch.cuda.empty_cache()
        out[fmt] = per
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    rec = {"card": card, "model": args.model, "ms": out}
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
