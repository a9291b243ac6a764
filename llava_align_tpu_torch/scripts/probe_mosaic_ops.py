"""Twin of scripts/probe_mosaic_ops.py: the scale-broadcast copies the TPU
script probed Mosaic for, as index-mapping copies on the H100 (repeat2d,
csrc/repeat2d.cu), each checked exactly against its plain version and one
PyTorch call of the same function, and timed beside both.

pltpu.repeat tiles (repeat([[0, 1, 2]], 2, 1) is [[0, 1, 2, 0, 1, 2]]);
jnp.repeat and the broadcast_in_dim + reshape of k_bcast repeat each
element. The static and dynamic slices are a window offset.

main() returns each copy's record and, as tryk, their sums.

    python3 -m llava_align_tpu_torch.scripts.probe_mosaic_ops [--device cpu]
"""

from __future__ import annotations

import sys

import torch

from llava_align_tpu_torch.ops.stream_probes import repeat2d, repeat2d_plain
from llava_align_tpu_torch.scripts._common import clock, parse, setup, time_ms

# TPU kernel -> (the TPU script's label, source, output shape, row map,
# column map, window offset, scale); a map is ("tile", n): i % n or
# ("repeat", n): i // n
OPS = {
    "k_rep": ("repeat_lanes_16x128", "x", (512, 2048), ("repeat", 1), ("tile", 16), (0, 0), 1.0),
    "k_slice_rep": ("static_slice16_repeat", "big", (512, 2048), ("repeat", 1), ("tile", 16), (0, 0), 1.0),
    "k_dyn": ("dyn_lane_slice16", "big", (512, 16), ("repeat", 1), ("tile", 16), (0, 16), 2.0),
    "k_jrep": ("jnp_repeat_lanes", "x", (512, 2048), ("repeat", 1), ("repeat", 128), (0, 0), 1.0),
    "k_rep0": ("repeat_sublanes_8x", "xt", (128, 512), ("tile", 16), ("repeat", 1), (0, 0), 1.0),
    "k_bcast": ("bcast_reshape_sublane", "xt", (128, 512), ("repeat", 8), ("repeat", 1), (0, 0), 1.0),
}

# one PyTorch call computing the same function: a yardstick, never called by the port
LIBRARY = {
    "k_rep": lambda x: x.repeat(1, 128),
    "k_slice_rep": lambda big: big[:, :16].repeat(1, 128),
    "k_dyn": lambda big: big[:, 16:32] * 2.0,
    "k_jrep": lambda x: x.repeat_interleave(128, dim=1),
    "k_rep0": lambda xt: xt.repeat(8, 1),
    "k_bcast": lambda xt: xt.repeat_interleave(8, dim=0),
}
ITERS = 100  # the copies take microseconds


def sources(device) -> dict:
    """The TPU script's inputs: arange * 0.01 in fp32."""
    def ar(r, c):
        return torch.arange(r * c, dtype=torch.float32, device=device).reshape(r, c) * 0.01

    return {"x": ar(512, 16), "big": ar(512, 128), "xt": ar(16, 512)}


def run(name: str, src: dict, plain: bool = False) -> torch.Tensor:
    """One TPU kernel's copy, by the kernel (or its plain version)."""
    _, key, shape, rows, cols, offset, scale = OPS[name]
    fn = repeat2d_plain if plain else repeat2d
    return fn(src[key], shape, rows, cols, offset, scale)


def copy_bytes(name: str) -> int:
    """The source elements the copy reads, once each, and the output it
    writes, in bytes."""
    _, _, shape, rows, cols, _, _ = OPS[name]
    n_src = 1
    for (mode, n), n_out in zip((rows, cols), shape):
        n_src *= min(n, n_out) if mode == "tile" else -(-n_out // n)
    return 4 * (n_src + shape[0] * shape[1])


def tryk(name: str, src: dict, device) -> dict:
    """Run, check exactly against the plain version and the library call,
    time all three, and print one line."""
    label, key = OPS[name][:2]
    got = run(name, src)
    plain = run(name, src, plain=True)
    lib = LIBRARY[name](src[key])
    ok = torch.equal(got, plain) and torch.equal(got, lib)
    rec = dict(max_abs_err=(got - plain).abs().max().item(), ref_max=plain.abs().max().item(),
               ms=time_ms(lambda: run(name, src), device, ITERS),
               plain_ms=time_ms(lambda: run(name, src, plain=True), device, ITERS),
               library_ms=time_ms(lambda: LIBRARY[name](src[key]), device, ITERS),
               bytes=copy_bytes(name), flops=0)
    print(f"{label} ({name}): {'OK' if ok else 'FAIL'} {[round(v, 4) for v in got.ravel()[:4].tolist()]} "
          f"{rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms)")
    if not ok:
        raise AssertionError(f"{name}: the kernel disagrees with its plain version or the library")
    return rec


def main(argv=None) -> dict:
    args = parse(argv, __doc__)
    dev, _ = setup(args)
    src = sources(dev)
    print(f"[{clock(dev)}] fp32 sources {[tuple(v.shape) for v in src.values()]}")
    out = {name: tryk(name, src, dev) for name in OPS}
    total = {k: sum(r[k] for r in out.values()) for k in ("ms", "plain_ms", "library_ms", "bytes", "flops")}
    total.update(max_abs_err=max(r["max_abs_err"] for r in out.values()),
                 ref_max=max(r["ref_max"] for r in out.values()))
    return dict(out, tryk=total)


if __name__ == "__main__":
    main(sys.argv[1:])
