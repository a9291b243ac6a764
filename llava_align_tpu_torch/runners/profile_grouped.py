"""Where the time goes in the 13B int4 grouped POPE path, on one GPU.

    python3 -m llava_align_tpu_torch.runners.profile_grouped [--groups 4] [--new-tokens 8]

Builds random LLaVA-v1.5-13B int4 (group 128) at full width and depth, then
for a prefill-only call (1 new token) and a full call (--new-tokens) of
generate_batch_groups at --groups image groups x POPE's 6 questions, with
dual-branch VDD (use_dd + use_dd_unk, cd_alpha=1, cd_beta=0.1, greedy, EOS
out of range): one warm-up call, one timed call, then the same call under
torch.profiler. Prints the wall time, the kernel time summed over the
profiled call, the device-busy share of the unprofiled wall, the port's
kernel launch counts in the call, and the kernels by device time.
Needs a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from llava_align_tpu_torch.config import GenerationConfig
from llava_align_tpu_torch.decoding.engine import DecodeEngine
from llava_align_tpu_torch.ops import attention, quant
from llava_align_tpu_torch.runners.common import load_model, pope_groups

WRAPPERS = {
    "K4 int4_matmul_stacked": quant.int4_matmul_stacked,
    "K2 int8_matmul_cuda": quant.int8_matmul_cuda,
    "K3 flash_attention": attention.flash_attention,
}


def profile_call(engine: DecodeEngine, groups, top: int) -> None:
    engine.generate_batch_groups(groups)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.generate_batch_groups(groups)  # the same call without the profiler
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    for fn in WRAPPERS.values():
        fn.launches = 0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        outs = engine.generate_batch_groups(groups)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernels only: an operator's own row would count its kernels twice
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in events)
    print(f"  wall {wall_plain * 1e3:.1f} ms ({wall * 1e3:.1f} ms under the profiler), kernel time "
          f"{device_us / 1e3:.1f} ms: device busy {device_us / 1e6 / wall_plain:.3f} of the "
          f"unprofiled wall, {len(outs)} questions, {outs[0].num_generated} tokens each")
    print("  launches: " + ", ".join(f"{k} {fn.launches}" for k, fn in WRAPPERS.items()))
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.self_device_time_total / device_us:6.1%} "
              f"x{e.count:<6d} {e.key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    dev = torch.device("cuda:0")
    lm = load_model("random:13b", quant="int4", device=dev, seed=0)
    groups = pope_groups(lm.tokenizer, lm.cfg.vision.image_size, args.groups)
    gen = GenerationConfig(max_new_tokens=args.new_tokens, do_sample=False, use_dd=True,
                           use_dd_unk=True, cd_alpha=1.0, cd_beta=0.1, eos_token_id=10**9)
    print(f"{torch.cuda.get_device_name(0)}: 13B int4 grouped, G={args.groups} x 6 questions")
    for tokens in (1, args.new_tokens):
        print(f"{tokens} new token(s):")
        engine = DecodeEngine(lm.params, lm.cfg, dataclasses.replace(gen, max_new_tokens=tokens))
        profile_call(engine, groups, args.top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
