"""Twin of scripts/bench_int4_probe3.py: row-major int4 with group-wise
(g = 128) scales applied in the kernel, at the 7B stacks (B = 16 rows), on
the H100.

  g128rep: row-major split-half packed int4 [L, O, D/2], group scales
     [L, O, D/128] (the low half's groups first): the row-major int4 kernel
     in its group mode (each chunk's partial dot scaled in fp32; the TPU
     kernel scaled each weight, rounded it to bf16, then took the dot — the
     two differ by rounding only).
  int8: K1 on the same codes stored as int8 [L, O, D], per-channel scales.

L = 4 and L = 12 layers, timed by CUDA events, per layer, and the slope.
At L = 12 the group kernel is checked against its plain version and timed
beside the plain version and the library (torch.matmul on a bf16 weight
dequantized beforehand); main() returns that record as int4_mm.

    python3 -m llava_align_tpu_torch.scripts.bench_int4_probe3 [--device cpu] [--tiny]
"""

from __future__ import annotations

import sys

import torch

from llava_align_tpu_torch.ops.quant import int8_matmul_stacked, pack_int4
from llava_align_tpu_torch.ops.stream_probes import (
    int4_rowmajor_matmul_stacked, int4_rowmajor_matmul_stacked_plain, unpack_int4_rowmajor,
)
from llava_align_tpu_torch.scripts._common import (
    B, SLOPE_LAYERS, clock, codes, gbs, layer_ms, make, parse, record_line, setup, slope_line, stack_record,
)

G = 128  # scale group size along D


def pack(q4: torch.Tensor) -> torch.Tensor:  # [L, O, D] codes -> [L, O, D/2]
    return pack_int4(q4)


def mk_weights(L: int, shapes, device):
    ws4, ss, ws8 = {}, {}, {}
    for i, (k, (O, D)) in enumerate(shapes.items()):
        q4 = codes((L, O, D), 100 + i, device)
        ws4[k] = pack(q4)
        # group scales [L, O, D/G], positive
        ss[k] = make((L, O, D // G), torch.float32, seed=200 + i, device=device).abs() + 0.01
        ws8[k] = {"q": q4, "s": make((L, O), torch.float32, seed=300 + i, device=device)}
    return ws4, ss, ws8


def int4_mm(h, p, s, li):
    """Row-major int4 with group-128 scales s [L, O, D/128]."""
    return int4_rowmajor_matmul_stacked(h, p, s, li)


def ref_mm(h, p, s, li):
    """int4_mm's plain version: each weight scaled in fp32 and rounded to
    h's dtype, then an fp32 dot (the TPU kernel's rounding)."""
    return int4_rowmajor_matmul_stacked_plain(h, p, s, li)


def main(argv=None) -> dict:
    args = parse(argv, __doc__)
    dev, shapes = setup(args)
    hs = {k: make((B, D), seed=20 + i, device=dev) for i, (k, (O, D)) in enumerate(shapes.items())}
    bytes4 = sum(O * D // 2 for O, D in shapes.values())  # per layer
    print(f"[{clock(dev)}] B={B}, L={SLOPE_LAYERS}, stacks {shapes}, {bytes4 / 1e6:.1f} MB of int4 per layer")
    weights = {L: mk_weights(L, shapes, dev) for L in SLOPE_LAYERS}
    lo, hi = SLOPE_LAYERS
    w4, s4, _ = weights[hi]

    t_lo = layer_ms(lambda li, k: int4_mm(hs[k], weights[lo][0][k], weights[lo][1][k], li), shapes, lo, dev)
    rec = stack_record(
        lambda h, k, li: int4_mm(h, w4[k], s4[k], li), lambda h, k, li: ref_mm(h, w4[k], s4[k], li),
        lambda k, li: (unpack_int4_rowmajor(w4[k][li]).float()
                       * s4[k][li].repeat_interleave(G, dim=-1)).to(torch.bfloat16),
        shapes, hs, hi, dev, lambda O, D: (O * D / 2, 4 * O * (D // G)))
    print(f"g128rep: relerr={rec['max_abs_err'] / rec['ref_max']:.1e} {slope_line(t_lo, rec['ms'], bytes4)} raw "
          f"(int8-equiv {gbs(2 * bytes4, rec['ms']):.0f} GB/s at L={hi})")
    print("  " + record_line(f"L={hi}, per layer", rec, bytes4))

    t = [layer_ms(lambda li, k: int8_matmul_stacked(hs[k], ws8[k]["q"], ws8[k]["s"], li), shapes, L, dev)
         for L, (_, _, ws8) in weights.items()]
    print(f"int8: {slope_line(*t, 2 * bytes4)}")
    return {"int4_mm": rec}


if __name__ == "__main__":
    main(sys.argv[1:])
