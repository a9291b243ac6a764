"""K4's time at decode row counts, per layer of a stack, on one GPU.

    python3 -m llava_align_tpu_torch.runners.time_int4_rows [--rows 3 8 16 18 32 72] [--iters 200]

Builds random packed int4 (group 128) stacks of one model's four decoder
linears (the 13B ones, 40 layers; the 7B ones at the S4 twin's depth, 12
layers) and times int4_matmul_stacked, as the dispatch picks its regime, on
bf16 activations at each row count: --iters calls per linear, walking the
layers so that no weight stays in L2, by CUDA events. Prints one JSON line:
{"card": ..., "ms": {model: {rows: ms of one layer's four linears}}}.
Uses only the wrapper's public signature, so it times any tree of the port
(PYTHONPATH=<tree>) for a comparison of two trees in one call.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from llava_align_tpu_torch.ops import quant

MODELS = {
    "13b": (40, {"qkv": (15360, 5120), "o": (5120, 5120), "gateup": (27648, 5120), "down": (5120, 13824)}),
    "7b": (12, {"qkv": (12288, 4096), "o": (4096, 4096), "gateup": (22016, 4096), "down": (4096, 11008)}),
}


def layer_ms(h: torch.Tensor, q4: torch.Tensor, gs: torch.Tensor, iters: int) -> float:
    L = q4.shape[0]
    for i in range(3):
        quant.int4_matmul_stacked(h, q4, gs, i % L)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        quant.int4_matmul_stacked(h, q4, gs, i % L)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[3, 8, 16, 18, 32, 72])
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for model, (L, stacks) in MODELS.items():
        per = {B: 0.0 for B in args.rows}
        for O, D in stacks.values():
            q4 = torch.randint(-128, 128, (L, D // 2, O), dtype=torch.int8, device=dev, generator=g)
            gs = (torch.rand((L, D // 128, O), device=dev, generator=g) + 0.5) / (7.0 * D**0.5)
            for B in args.rows:
                h = torch.randn((B, D), device=dev, generator=g).to(torch.bfloat16)
                per[B] += layer_ms(h, q4, gs, args.iters)
            del q4, gs
        out[model] = per
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    rec = {"card": card, "ms": out}
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
