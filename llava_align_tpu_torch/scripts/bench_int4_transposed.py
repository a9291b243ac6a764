"""Twin of scripts/bench_int4_transposed.py: the transposed int4 layout —
packed [L, D/2, O] (O contiguous), group scales [L, D/128, O] — at the 7B
stacks (B = 16 rows, the down stack's D = 11008 included), on the H100.

This layout and its math are the int4 decoder kernel's: int4t_mm runs K4
(ops/quant.int4_matmul_stacked, csrc/int4_mm.cu). The TPU's two unpack
flavours (UNPACK=i32 or bf16) are both exact, so they are one function.

L = 4 and L = 12 layers, timed by CUDA events, per layer, and the slope. At
L = 12, K4 is checked against its plain version and timed beside the plain
version and the library (torch.matmul on a bf16 weight dequantized
beforehand); main() returns that record as int4t_mm.

    python3 -m llava_align_tpu_torch.scripts.bench_int4_transposed [--device cpu] [--tiny]
"""

from __future__ import annotations

import sys

import torch

from llava_align_tpu_torch.ops.quant import dequantize_int4, int4_matmul_stacked, int4_matmul_stacked_plain, pack_int4
from llava_align_tpu_torch.scripts._common import (
    B, SLOPE_LAYERS, clock, codes, layer_ms, make, parse, record_line, setup, slope_line, stack_record,
)

G = 128


def mk(L: int, shapes, device):
    w4t = {}
    for i, (k, (O, D)) in enumerate(shapes.items()):
        q = codes((L, O, D), 10 + i, device)
        # transposed packing: packed[l, r, o] = (q[l, o, r] & 0xF) | (q[l, o, Dp + r] << 4)
        w4t[k] = {
            "q4t": pack_int4(q).transpose(1, 2).contiguous(),  # [L, Dp, O]
            "gst": make((L, D // G, O), torch.float32, seed=40 + i, device=device, std=0.05).abs() + 0.01,
        }
        del q
    return w4t


def int4t_mm(h, p, s, li):
    """h [B, D] x packed [L, D/2, O] with scales [L, D/128, O]: K4."""
    return int4_matmul_stacked(h, p, s, li)


def ref_mm(h, p, s, li):
    """int4t_mm's plain version (K4's)."""
    return int4_matmul_stacked_plain(h, p, s, li)


def main(argv=None) -> dict:
    args = parse(argv, __doc__)
    dev, shapes = setup(args)
    hs = {k: make((B, D), seed=20 + i, device=dev, std=0.05) for i, (k, (O, D)) in enumerate(shapes.items())}
    bytes4 = sum(O * D // 2 for O, D in shapes.values())  # per layer
    print(f"[{clock(dev)}] B={B}, L={SLOPE_LAYERS}, stacks {shapes}, {bytes4 / 1e6:.1f} MB of int4 per layer")
    weights = {L: mk(L, shapes, dev) for L in SLOPE_LAYERS}
    lo, hi = SLOPE_LAYERS
    w = weights[hi]

    t_lo = layer_ms(lambda li, k: int4t_mm(hs[k], weights[lo][k]["q4t"], weights[lo][k]["gst"], li),
                    shapes, lo, dev)
    rec = stack_record(
        lambda h, k, li: int4t_mm(h, w[k]["q4t"], w[k]["gst"], li),
        lambda h, k, li: ref_mm(h, w[k]["q4t"], w[k]["gst"], li),
        lambda k, li: dequantize_int4({"q4": w[k]["q4t"][li], "gs": w[k]["gst"][li]}, torch.bfloat16),
        shapes, hs, hi, dev, lambda O, D: (O * D / 2, 4 * O * (D // G)))
    print(f"int4t (K4): relerr={rec['max_abs_err'] / rec['ref_max']:.2e} {slope_line(t_lo, rec['ms'], bytes4)} raw")
    print("  " + record_line(f"L={hi}, per layer", rec, bytes4))
    return {"int4t_mm": rec}


if __name__ == "__main__":
    main(sys.argv[1:])
