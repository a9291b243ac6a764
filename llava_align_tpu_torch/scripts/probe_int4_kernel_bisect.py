"""Twin of scripts/probe_int4_kernel_bisect.py: the variants of the row-major
int4 g128 kernel the TPU script bisected, at its qkv decode shape (one
layer: packed [12288, 2048] from the whole int8 range, group scales
[12288, 32], B = 16 bf16 rows), on the H100.

Every variant is the row-major int4 kernel (K1's streaming kernel in the
int4 group format, csrc/int8_mm.cu); the TPU variants differ in how they
build the scales, which here is done on the host (effective_scales), or in
bf16 rounding:

  full, noslice, wherechain, bcast: the group scales as they are;
  bcast16, mxubcast: the same scales (the TPU kernel rounded the scaled
     weight in bf16: a rounding difference only);
  norep: all ones;
  perchan: each D step's first group (the TPU block walked D/2 in steps of
     bDp = 1024 packed columns, bG = 8 groups);
  nods: groups 0..bG-1 (low half) and bG..2bG-1 (high half) at every step.

Every variant runs and is checked against the plain version. Only the
values of the scales differ between them, so the kernel is timed once, with
the "full" scales, over 4 independent draws of the layer in turn (one 25 MB
layer would sit in L2), beside the plain version and the library
(torch.matmul on a bf16 weight dequantized beforehand). main() returns that
record as kern, its error the largest over the variants.

    python3 -m llava_align_tpu_torch.scripts.probe_int4_kernel_bisect [--device cpu] [--tiny]
"""

from __future__ import annotations

import sys

import torch

from llava_align_tpu_torch.ops.stream_probes import (
    int4_rowmajor_matmul_stacked, int4_rowmajor_matmul_stacked_plain, unpack_int4_rowmajor,
)
from llava_align_tpu_torch.scripts._common import (
    B, clock, codes, make, max_abs, parse, record_line, setup, stack_record,
)

G = 128
SHAPE = (12288, 4096)  # [O, D]: the 7B qkv stack
TINY = (256, 1024)  # --tiny: two D steps of two groups each
bDp = 1024  # the TPU block's packed columns per D step (nkh = 2 steps at D = 4096)
VARIANTS = ("full", "nods", "norep", "noslice", "perchan", "wherechain", "bcast", "bcast16", "mxubcast")
DRAWS = 4  # independent layers timed in turn


def effective_scales(gs: torch.Tensor, variant: str, block_packed: int = bDp) -> torch.Tensor:
    """The group scales [.., O, D/G] each TPU variant applied, as one
    [.., O, D/G] tensor (low half's groups first)."""
    nG = gs.shape[-1]
    nGh = nG // 2
    bG = block_packed // G
    if variant in ("full", "noslice", "wherechain", "bcast", "bcast16", "mxubcast"):
        return gs
    if variant == "norep":
        return torch.ones_like(gs)
    g = torch.arange(nGh, device=gs.device)
    if variant == "perchan":
        lo = (g // bG) * bG
    elif variant == "nods":
        lo = g % bG
    else:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    hi = nGh + lo if variant == "perchan" else bG + lo
    return gs[..., torch.cat([lo, hi])]


def kern(h, p, s, li=0):
    """h [B, D] x packed [L, O, D/2] with (effective) group scales [L, O, D/G]."""
    return int4_rowmajor_matmul_stacked(h, p, s, li)


def main(argv=None) -> dict:
    args = parse(argv, __doc__)
    dev, _ = setup(args)
    O, D = TINY if args.tiny else SHAPE
    Dp = D // 2
    block = min(bDp, Dp // 2)  # two D steps, as the TPU script forced
    q4 = codes((DRAWS, O, Dp), 0, dev, low=-128, high=128)
    gs = make((DRAWS, O, D // G), torch.float32, seed=1, device=dev, std=1.0).abs() + 0.01
    h = make((B, D), seed=2, device=dev, std=0.1)
    print(f"[{clock(dev)}] O={O}, D={D}, B={B}, D step {block} packed columns, {DRAWS} draws")
    err = ref = 0.0
    for variant in VARIANTS:
        s = effective_scales(gs, variant, block)
        got, want = kern(h, q4, s, 0), int4_rowmajor_matmul_stacked_plain(h, q4, s, 0)
        err, ref = max(err, max_abs(got, want)), max(ref, want.float().abs().max().item())
        print(f"{variant}: ran, out[0,:3]={[round(v, 4) for v in got[0, :3].float().tolist()]} "
              f"max|kernel - plain| {max_abs(got, want):.2e}")
    rec = stack_record(
        lambda h_, k, li: kern(h_, q4, gs, li),
        lambda h_, k, li: int4_rowmajor_matmul_stacked_plain(h_, q4, gs, li),
        lambda k, li: (unpack_int4_rowmajor(q4[li]).float() * gs[li].repeat_interleave(G, dim=-1)).to(torch.bfloat16),
        {"qkv": (O, D)}, {"qkv": h}, DRAWS, dev, lambda O_, D_: (O_ * D_ / 2, 4 * O_ * (D_ // G)))
    rec["max_abs_err"], rec["ref_max"] = max(err, rec["max_abs_err"]), max(ref, rec["ref_max"])
    print(record_line("every variant (the same kernel; timed with the full scales), per call", rec, O * Dp))
    return {"kern": rec}


if __name__ == "__main__":
    main(sys.argv[1:])
