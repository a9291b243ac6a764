"""Twin of scripts/bench_int4_probe.py: int4 weight-streaming decode matmul
options at the 7B stacks (B = 16 rows, L = 8 layers), on the H100.

  B) row-major split-half packed int4 [L, O, D/2] (low nibble = columns
     [0, D/2), high nibble = [D/2, D)), per-channel scales: the row-major
     int4 kernel. It stands for both TPU unpack flavours (i8, i32): each is
     exact, so on the H100 they are one function.
  C) the int8 kernel K1 on the same codes stored as int8 [L, O, D].
  A) "native int4": torch has no int4 tensor a kernel can read, so the
     codes stay in int8 storage and line C's K1 run is this line too. Its
     bytes count int4 storage, half of what K1 reads.

Each line checks its kernel against the plain version at layers 0 and L-1
of every stack, and times kernel, plain version and library (torch.matmul
on a bf16 weight dequantized beforehand) per layer, by CUDA events over
whole steps (every layer, every stack). main() returns the records of
int4_mm and int4_native_mm.

    python3 -m llava_align_tpu_torch.scripts.bench_int4_probe [--device cpu] [--tiny]
"""

from __future__ import annotations

import sys

import torch

from llava_align_tpu_torch.ops.quant import dequantize, int8_matmul_stacked, int8_matmul_stacked_plain, pack_int4
from llava_align_tpu_torch.ops.stream_probes import (
    int4_rowmajor_matmul_stacked, int4_rowmajor_matmul_stacked_plain, unpack_int4_rowmajor,
)
from llava_align_tpu_torch.scripts._common import (
    B, clock, codes, gbs, make, parse, record_line, setup, stack_record,
)

L = 8


def pack_nibbles(q4: torch.Tensor) -> torch.Tensor:  # [L, O, D] codes -> [L, O, D/2]
    return pack_int4(q4)


def int4_mm(h, p, s, li):
    """Row-major int4, per-channel scales s [L, O]."""
    return int4_rowmajor_matmul_stacked(h, p, s, li)


def int4_native_mm(h, q, s, li):
    """int4 codes stored as int8 [L, O, D]: K1."""
    return int8_matmul_stacked(h, q, s, li)


def ref_mm(h, q4_packed, s, li):
    """int4_mm's plain version: fp32 sum, then the scale."""
    return int4_rowmajor_matmul_stacked_plain(h, q4_packed, s, li)


def main(argv=None) -> dict:
    args = parse(argv, __doc__)
    dev, shapes = setup(args)
    ws4, ss, ws8 = {}, {}, {}
    for i, (k, (O, D)) in enumerate(shapes.items()):
        ws8[k] = codes((L, O, D), 100 + i, dev)
        ws4[k] = pack_nibbles(ws8[k])
        ss[k] = make((L, O), torch.float32, seed=200 + i, device=dev)
    hs = {k: make((B, D), seed=20 + i, device=dev) for i, (k, (O, D)) in enumerate(shapes.items())}
    bytes4 = sum(O * D // 2 for O, D in shapes.values())  # per layer
    int4_bytes = lambda O, D: (O * D / 2, 4 * O)  # noqa: E731
    print(f"[{clock(dev)}] B={B}, L={L}, stacks {shapes}, {bytes4 / 1e6:.1f} MB of int4 per layer")

    rec4 = stack_record(
        lambda h, k, li: int4_mm(h, ws4[k], ss[k], li), lambda h, k, li: ref_mm(h, ws4[k], ss[k], li),
        lambda k, li: (unpack_int4_rowmajor(ws4[k][li]).float() * ss[k][li][:, None]).to(torch.bfloat16),
        shapes, hs, L, dev, int4_bytes)
    print(record_line("B) packed int4 (the TPU's i8 and i32 unpack), per layer", rec4, bytes4,
                      f" (int8-equiv {gbs(2 * bytes4, rec4['ms']):.0f})"))
    del ws4

    rec8 = stack_record(
        lambda h, k, li: int4_native_mm(h, ws8[k], ss[k], li),
        lambda h, k, li: int8_matmul_stacked_plain(h, ws8[k], ss[k], li),
        lambda k, li: dequantize({"q": ws8[k][li], "s": ss[k][li]}, torch.bfloat16),
        shapes, hs, L, dev, int4_bytes)
    print(record_line("C) int8 kernel (K1), per layer", rec8, 2 * bytes4))
    print(f"A) native int4 = line C (codes stored as int8, K1): {gbs(bytes4, rec8['ms']):.0f} GB/s int4-equiv")
    return {"int4_mm": rec4, "int4_native_mm": rec8}


if __name__ == "__main__":
    main(sys.argv[1:])
