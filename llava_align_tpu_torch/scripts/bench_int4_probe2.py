"""Twin of scripts/bench_int4_probe2.py: row-major int4 against int8
streaming and "native int4" at the 7B stacks (B = 16 rows), on the H100.

The TPU script timed L = 4 and L = 12 layers and took the slope, which
cancelled the fixed dispatch cost of a remote runtime. Here both sizes are
timed by CUDA events and reported per layer, beside the slope.

  int4: row-major split-half packed int4 [L, O, D/2] with per-channel
     scales, the row-major int4 kernel. It stands for the TPU's i32, i16
     and bf16 unpack flavours: each is exact, so on the H100 they are one
     function.
  int8: K1 on the same codes stored as int8 [L, O, D].
  native: the TPU's jnp.int4 operand at qkv [4, 12288, 4096], one call at
     a time; torch has no int4 tensor a kernel can read, so the codes are
     stored as int8 and run through K1. Its bytes count int4 storage, half
     of what K1 reads.

The int4 (at L = 12) and native lines check the kernel against its plain
version and time the plain version and the library beside it (torch.matmul
on a bf16 weight dequantized beforehand); main() returns their records as
int4_mm and int4_native_mm.

    python3 -m llava_align_tpu_torch.scripts.bench_int4_probe2 [--device cpu] [--tiny]
"""

from __future__ import annotations

import sys

import torch

from llava_align_tpu_torch.ops.quant import dequantize, int8_matmul_stacked, int8_matmul_stacked_plain, pack_int4
from llava_align_tpu_torch.ops.stream_probes import (
    int4_rowmajor_matmul_stacked, int4_rowmajor_matmul_stacked_plain, unpack_int4_rowmajor,
)
from llava_align_tpu_torch.scripts._common import (
    B, SLOPE_LAYERS, clock, codes, gbs, layer_ms, make, parse, record_line, setup, slope_line, stack_record,
)


def pack(q4: torch.Tensor) -> torch.Tensor:  # [L, O, D] codes -> [L, O, D/2]
    return pack_int4(q4)


def mk_weights(L: int, shapes, device):
    ws4, ss, ws8 = {}, {}, {}
    for i, (k, (O, D)) in enumerate(shapes.items()):
        q4 = codes((L, O, D), 100 + i, device)
        ws4[k] = pack(q4)
        ss[k] = make((L, O), torch.float32, seed=200 + i, device=device)
        ws8[k] = q4
    return ws4, ss, ws8


def int4_mm(h, p, s, li):
    """Row-major int4, per-channel scales s [L, O]."""
    return int4_rowmajor_matmul_stacked(h, p, s, li)


def int4_native_mm(h, q, s, li):
    """int4 codes stored as int8 [L, O, D]: K1."""
    return int8_matmul_stacked(h, q, s, li)


def ref_mm(h, p, s, li):
    """int4_mm's plain version: fp32 sum, then the scale."""
    return int4_rowmajor_matmul_stacked_plain(h, p, s, li)


def main(argv=None) -> dict:
    args = parse(argv, __doc__)
    dev, shapes = setup(args)
    hs = {k: make((B, D), seed=20 + i, device=dev) for i, (k, (O, D)) in enumerate(shapes.items())}
    bytes4 = sum(O * D // 2 for O, D in shapes.values())  # per layer
    int4_bytes = lambda O, D: (O * D / 2, 4 * O)  # noqa: E731
    print(f"[{clock(dev)}] B={B}, L={SLOPE_LAYERS}, stacks {shapes}, {bytes4 / 1e6:.1f} MB of int4 per layer")
    weights = {L: mk_weights(L, shapes, dev) for L in SLOPE_LAYERS}
    lo, hi = SLOPE_LAYERS
    w4, s4, _ = weights[hi]

    t_lo = layer_ms(lambda li, k: int4_mm(hs[k], weights[lo][0][k], weights[lo][1][k], li), shapes, lo, dev)
    rec4 = stack_record(
        lambda h, k, li: int4_mm(h, w4[k], s4[k], li), lambda h, k, li: ref_mm(h, w4[k], s4[k], li),
        lambda k, li: (unpack_int4_rowmajor(w4[k][li]).float() * s4[k][li][:, None]).to(torch.bfloat16),
        shapes, hs, hi, dev, int4_bytes)
    print(f"int4 (the TPU's i32, i16 and bf16 unpack): {slope_line(t_lo, rec4['ms'], bytes4)} raw "
          f"(int8-equiv {gbs(2 * bytes4, rec4['ms']):.0f} GB/s at L={hi})")
    print("  " + record_line(f"L={hi}, per layer", rec4, bytes4))

    t = [layer_ms(lambda li, k: int8_matmul_stacked(hs[k], ws8[k], ss[k], li), shapes, L, dev)
         for L, (_, ss, ws8) in weights.items()]
    print(f"int8: {slope_line(*t, 2 * bytes4)}")
    del weights, w4, s4

    O, D = shapes["qkv"]
    q4n = codes((4, O, D), 7, dev)
    s8 = make((4, O), torch.float32, seed=200, device=dev)
    # one call at a time, rotating the 4 layers
    recn = stack_record(
        lambda h, k, li: int4_native_mm(h, q4n, s8, li),
        lambda h, k, li: int8_matmul_stacked_plain(h, q4n, s8, li),
        lambda k, li: dequantize({"q": q4n[li], "s": s8[li]}, torch.bfloat16),
        {"qkv": (O, D)}, hs, 4, dev, int4_bytes)
    print(record_line("native int4 (codes stored as int8, K1), per call", recn, O * D,
                      f" of int8 ({gbs(O * D // 2, recn['ms']):.0f} int4-equiv)"))
    return {"int4_mm": rec4, "int4_native_mm": recn}


if __name__ == "__main__":
    main(sys.argv[1:])
