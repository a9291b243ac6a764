"""Twin of scripts/bench_bf16_stream.py: a bf16 decode matmul over the 7B
stacks (B = 16 rows, L = 8 layers) by the bf16 weight-streaming kernel
(K1's streaming kernel with bf16 weights, csrc/int8_mm.cu) against the
library, on the H100.

  kernel: stream_mm, the bf16 streaming kernel (fp32 sum, no scale);
  library: torch.matmul on each layer's bf16 weight (the TPU script's XLA
     loop; a yardstick, the port never calls it).

The kernel is checked against its plain version at layers 0 and L-1 of
every stack; kernel, plain version and library are timed per layer by CUDA
events over whole steps. main() returns the record as stream_mm.

    python3 -m llava_align_tpu_torch.scripts.bench_bf16_stream [--device cpu] [--tiny]
"""

from __future__ import annotations

import sys

from llava_align_tpu_torch.ops.stream_probes import bf16_matmul_stacked, bf16_matmul_stacked_plain
from llava_align_tpu_torch.scripts._common import B, clock, make, parse, record_line, setup, stack_record

L = 8


def stream_mm(h, w, li):
    """h [B, D] bf16 x w [L, O, D] bf16 at layer li → [B, O] bf16."""
    return bf16_matmul_stacked(h, w, li)


def main(argv=None) -> dict:
    args = parse(argv, __doc__)
    dev, shapes = setup(args)
    ws = {k: make((L, O, D), seed=i, device=dev) for i, (k, (O, D)) in enumerate(shapes.items())}
    hs = {k: make((B, D), seed=20 + i, device=dev) for i, (k, (O, D)) in enumerate(shapes.items())}
    per_layer = sum(O * D * 2 for O, D in shapes.values())
    print(f"[{clock(dev)}] B={B}, L={L}, stacks {shapes}")
    print(f"weight bytes/step: {per_layer * L / 1e9:.2f} GB ({per_layer / 1e6:.1f} MB per layer)")
    rec = stack_record(
        lambda h, k, li: stream_mm(h, ws[k], li), lambda h, k, li: bf16_matmul_stacked_plain(h, ws[k], li),
        lambda k, li: ws[k][li], shapes, hs, L, dev, lambda O, D: (2 * O * D, 0))
    print(record_line("stream_mm, per layer", rec, per_layer))
    return {"stream_mm": rec}


if __name__ == "__main__":
    main(sys.argv[1:])
