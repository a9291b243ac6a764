"""Twins of the TPU microbenchmark scripts in scripts/, on the H100.

Each twin has the TPU script's file name and function names, builds its
inputs from seeds on the device, prints the quantities the TPU script
prints at the same shapes (error, ms, GB/s raw and int8-equivalent; times
by CUDA events, per layer), and runs nothing at import. Its main() returns,
keyed by the TPU function's name, the record of the kernel it runs: the
largest error against the plain version, kernel, plain and library ms, and
the bytes and operations of the timed work (_common.stack_record).

    python3 -m llava_align_tpu_torch.scripts.<name> [--device cpu] [--tiny]

| twin                       | TPU kernel (scripts/...)              | kernel here |
|----------------------------|---------------------------------------|-------------|
| bench_int4_probe           | S1a _make_kern4 (int4_mm)             | row-major int4, per-channel (K1's streaming kernel, csrc/int8_mm.cu) |
|                            | S1b _kern_n4 (int4_native_mm)         | K1 on int4 codes stored as int8 |
| bench_int4_probe2          | S2a _make_kern4 (int4_mm)             | row-major int4, per-channel |
|                            | S2b _kern_n                           | K1 on int4 codes stored as int8 |
| bench_int4_probe3          | S3 _kern_rep (int4_mm)                | row-major int4, group 128 |
| bench_int4_transposed      | S4 _mk_kern (int4t_mm)                | K4 (csrc/int4_mm.cu) |
| bench_bf16_stream          | S5 _kern (stream_mm)                  | bf16 streaming (csrc/int8_mm.cu) |
| probe_int4_kernel_bisect   | S6 kern                               | row-major int4, group 128 |
| probe_mosaic_ops           | S7 the six kernels of tryk            | repeat2d (csrc/repeat2d.cu) |

The int8 lines of S1-S3 run K1 (ops/quant.int8_matmul_stacked).
"""

TWINS = (
    "bench_int4_probe", "bench_int4_probe2", "bench_int4_probe3", "bench_int4_transposed",
    "bench_bf16_stream", "probe_int4_kernel_bisect", "probe_mosaic_ops",
)
