#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (llava_align_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):
  1. device: the card's name and power limit (nvidia-smi), CUDA must exist;
  2. build: compile the package's CUDA kernels from csrc/ with nvcc;
  3. kernels: each kernel against its plain PyTorch version on the card, in
     bf16, at the LLaVA-v1.5-7B main path's shapes, with the tolerance
     stated, and both times;
  4. main path: LLaVA-v1.5-7B at full width with random int8 weights,
     several POPE-style requests through DecodeEngine.generate with
     dual-branch VDD (use_dd + use_dd_unk, cd_alpha=1, cd_beta=0.1, greedy,
     8 new tokens, EOS out of range); every kernel's launch counter must
     rise during this phase;
  5. reference: the same model cut to 2 decoder / 2 vision layers at full
     width, its prefill and decode logits on the card against the same
     params run in fp32 on the CPU (the kernels' plain versions).

Prints a JSON line with each kernel's record, then as the last line
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

# bf16 results of two fp32 reductions in different orders may round one bf16
# ulp apart (<= 2^-7 of the largest output); allow twice that.
KERNEL_TOL = 2.0**-6
# bf16 model on the card against the fp32 CPU model, 2 decoder layers:
# bf16 rounding of activations and weights compounds to ~1e-2 of the
# logits' range.
REFERENCE_TOL = 5e-2
NEW_TOKENS = 8
N_REQUESTS = 4  # the first one also warms cuBLAS and the allocator
QUESTIONS = (
    "Is there a dog in the image?",
    "Is there a person in the image?",
    "Is there a dining table in the image?",
    "Is there a car in the image?",
)
STACKS_7B = {"qkv": (12288, 4096), "o": (4096, 4096), "gateup": (22016, 4096), "down": (4096, 11008)}
LM_HEAD_7B = (32000, 4096)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn(i) over `iters` calls, by CUDA events."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(kernel_out: torch.Tensor, plain_out: torch.Tensor, what: str) -> float:
    err = (kernel_out.float() - plain_out.float()).abs().max().item()
    tol = KERNEL_TOL * plain_out.float().abs().max().item()
    ok = np.isfinite(err) and err <= tol
    log(f"  {what}: max_abs_err={err:.6g} tol={tol:.6g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain version")
    return err


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is False — this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi.splitlines()[0])
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}, count {torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    # fp32 references in full fp32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def phase_build() -> None:
    from llava_align_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    path = _kernels.library_path()
    _kernels.lib()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({'nvcc ' + format(_kernels.build_seconds, '.2f') + ' s' if _kernels.build_seconds else 'cached'}) -> {path}")
    for line in (path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log("  ptxas: " + line.strip())


def phase_kernels(main_lens) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    from llava_align_tpu_torch.ops import attention, quant

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(0)
    rec = {}

    log("kernels: K1 int8_matmul_stacked (decoder linears) vs plain, bf16")
    k1_err, k1_ms, k1_plain_ms = 0.0, 0.0, 0.0
    for name, (O, D) in STACKS_7B.items():
        L = 32
        q = torch.randint(-127, 128, (L, O, D), dtype=torch.int8, device=dev, generator=g)
        s = (torch.rand((L, O), device=dev, generator=g) + 0.5) / (127.0 * D**0.5)
        for B in (3, 16, 64):
            h = torch.randn((B, D), device=dev, generator=g).to(torch.bfloat16)
            for li in (0, L - 1):
                k1_err = max(k1_err, compare(
                    quant.int8_matmul_stacked(h, q, s, li),
                    quant.int8_matmul_stacked_plain(h, q, s, li),
                    f"{name} [{L},{O},{D}] B={B} li={li}",
                ))
            # rotate layers so each call streams weights L2 does not hold
            ms = cuda_ms(lambda i: quant.int8_matmul_stacked(h, q, s, i % L), 64)
            plain_ms = cuda_ms(lambda i: quant.int8_matmul_stacked_plain(h, q, s, i % L), 16)
            gbs = O * D / (ms * 1e-3) / 1e9
            log(f"  {name} B={B}: kernel {ms:.4f} ms ({gbs:.0f} GB/s of int8 weights), "
                f"plain {plain_ms:.4f} ms")
            if B == 3:  # the decode row count of dual-branch VDD
                k1_ms += ms
                k1_plain_ms += plain_ms
        del q, s
    rec["K1"] = dict(max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain_ms)
    log(f"  one decode layer's four linears at B=3: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms")

    log("kernels: K2 int8_matmul_cuda (lm_head) vs plain, bf16")
    O, D = LM_HEAD_7B
    q = torch.randint(-127, 128, (O, D), dtype=torch.int8, device=dev, generator=g)
    s = (torch.rand((O,), device=dev, generator=g) + 0.5) / (127.0 * D**0.5)
    k2_err = 0.0
    for B in (1, 2, 3):
        h = torch.randn((B, D), device=dev, generator=g).to(torch.bfloat16)
        k2_err = max(k2_err, compare(
            quant.int8_matmul_cuda(h, q, s), quant.int8_matmul_plain(h, q, s),
            f"lm_head [{O},{D}] B={B}",
        ))
        ms = cuda_ms(lambda i: quant.int8_matmul_cuda(h, q, s), 32)
        plain_ms = cuda_ms(lambda i: quant.int8_matmul_plain(h, q, s), 16)
        log(f"  lm_head B={B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if B == 3:
            rec["K2"] = dict(max_abs_err=k2_err, ms=ms, plain_ms=plain_ms)
    rec["K2"]["max_abs_err"] = k2_err
    del q, s

    log("kernels: K3 flash_attention (causal prefill) vs plain, bf16")
    shapes = [(1, 640, 32, 128), (2, 128, 32, 128)]
    shapes += [(1, main_lens[0], 32, 128), (2, main_lens[1], 32, 128)]
    k3_err = 0.0
    for i, (B, S, H, Dh) in enumerate(shapes):
        qkv = [torch.randn((B, S, H, Dh), device=dev, generator=g).to(torch.bfloat16)
               for _ in range(3)]
        k3_err = max(k3_err, compare(
            attention.flash_attention(*qkv), attention.flash_attention_plain(*qkv),
            f"[{B},{S},{H},{Dh}]",
        ))
        ms = cuda_ms(lambda _: attention.flash_attention(*qkv), 20)
        plain_ms = cuda_ms(lambda _: attention.flash_attention_plain(*qkv), 10)
        log(f"  [{B},{S},{H},{Dh}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if i == 0:
            rec["K3"] = dict(ms=ms, plain_ms=plain_ms)
    rec["K3"]["max_abs_err"] = k3_err
    torch.cuda.synchronize()
    return rec


def pope_requests(tokenizer, image_size: int):
    """POPE-style requests: llava_v1 prompts and seeded uint8 images."""
    from llava_align_tpu_torch.runners.common import build_prompt
    from llava_align_tpu_torch.tokenization import tokenizer_image_token

    rng = np.random.default_rng(0)
    return [
        (tokenizer_image_token(build_prompt(q, "llava_v1")[0], tokenizer),
         rng.integers(0, 256, (3, image_size, image_size), dtype=np.uint8))
        for q in QUESTIONS[:N_REQUESTS]
    ]


def phase_main_path(dev) -> dict:
    """LLaVA-v1.5-7B int8, dual-branch VDD, through DecodeEngine.generate."""
    from llava_align_tpu_torch.config import GenerationConfig
    from llava_align_tpu_torch.decoding.engine import DecodeEngine
    from llava_align_tpu_torch.ops import attention, quant
    from llava_align_tpu_torch.runners.common import load_model

    t0 = time.perf_counter()
    lm = load_model("random:7b", quant="int8", device=dev, seed=0)
    torch.cuda.synchronize()
    log(f"main path: built random LLaVA-v1.5-7B int8 on {dev} in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    gen = GenerationConfig(
        max_new_tokens=NEW_TOKENS, do_sample=False, use_dd=True, use_dd_unk=True,
        cd_alpha=1.0, cd_beta=0.1, eos_token_id=10**9,  # EOS out of range: full length
    )
    engine = DecodeEngine(lm.params, lm.cfg, gen)
    requests = pope_requests(lm.tokenizer, lm.cfg.vision.image_size)
    V = lm.cfg.text.vocab_size

    wrappers = {
        "int8_matmul_stacked": quant.int8_matmul_stacked,
        "int8_matmul_cuda": quant.int8_matmul_cuda,
        "flash_attention": attention.flash_attention,
    }
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    stats = []
    for i, (ids, image) in enumerate(requests):
        out = engine.generate(ids, image)
        torch.cuda.synchronize()
        probs = out.first_scores_top_probs
        if out.num_generated != NEW_TOKENS or len(out.token_ids) != NEW_TOKENS:
            raise AssertionError(f"request {i}: {out.num_generated} tokens, expected {NEW_TOKENS}")
        if not all(0 <= t < V for t in out.token_ids):
            raise AssertionError(f"request {i}: token ids out of the vocab: {out.token_ids}")
        if not (np.all(np.isfinite(probs)) and np.all(np.diff(probs) <= 0) and probs.sum() <= 1 + 1e-5):
            raise AssertionError(f"request {i}: bad first-step scores {probs[:8]}")
        decode_s = out.seconds_total - out.seconds_to_first_token
        tps = (out.num_generated - 1) / decode_s
        stats.append((out.seconds_total, out.seconds_to_first_token, tps))
        log(f"  request {i}{' (warm-up)' if i == 0 else ''}: prompt {len(ids)} ids -> spliced "
            f"{out.prompt_length}, tokens {out.token_ids}, total {out.seconds_total:.4f} s, "
            f"prefill+first token {out.seconds_to_first_token:.4f} s, decode {tps:.2f} tok/s")
    launches = {name: fn.launches for name, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    steady = stats[1:]
    log(f"  launches during the main path: {launches}")
    log(f"  steady requests (1..{len(stats) - 1}): mean total {np.mean([s[0] for s in steady]):.4f} s, "
        f"mean prefill+first token {np.mean([s[1] for s in steady]):.4f} s, "
        f"mean decode {np.mean([s[2] for s in steady]):.2f} tok/s; "
        f"peak memory {peak / 2**30:.2f} GiB")
    dead = [name for name, n in launches.items() if n <= 0]
    if dead:
        raise AssertionError(f"kernels not launched on the main path: {dead}")
    del engine, lm
    torch.cuda.empty_cache()
    return launches


def phase_reference(dev) -> None:
    """Full-width model cut to 2 decoder / 2 vision layers: prefill and
    decode logits on the card (kernels) against fp32 on the CPU (plain)."""
    from llava_align_tpu_torch.config import LlavaConfig
    from llava_align_tpu_torch.models import llama, llava
    from llava_align_tpu_torch.ops.image import normalize_device
    from llava_align_tpu_torch.runners.common import MockTokenizer
    from llava_align_tpu_torch.utils.synthetic import build_random_llava_params

    full = LlavaConfig.llava_v15_7b()
    cfg = dataclasses.replace(
        full, text=dataclasses.replace(full.text, num_layers=2),
        vision=dataclasses.replace(full.vision, num_layers=3),  # select_layer -2 runs 2
    )
    cfg32 = dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, dtype=torch.float32),
        vision=dataclasses.replace(cfg.vision, dtype=torch.float32),
    )
    params = build_random_llava_params(cfg, quant="int8", device=dev, seed=1)

    def to_cpu32(node):
        if isinstance(node, dict):
            return {k: to_cpu32(v) for k, v in node.items()}
        if isinstance(node, list):
            return [to_cpu32(v) for v in node]
        return node.cpu().float() if node.is_floating_point() else node.cpu()

    params_cpu = to_cpu32(params)
    ids, image = pope_requests(MockTokenizer(), cfg.vision.image_size)[0]
    plan = llava.plan_splice(ids, cfg.num_image_tokens, -(-(len(ids) - 1 + cfg.num_image_tokens) // 128) * 128)
    steps = (29871, 3869)  # fixed next tokens, so both sides decode the same sequence

    @torch.inference_mode()
    def run(p, c, device):
        pixels = normalize_device(torch.from_numpy(image)[None].to(device), c.vision.dtype)
        feats = llava.encode_images(p, c, pixels)
        t = {k: torch.from_numpy(np.asarray(getattr(plan, k)))[None].to(device)
             for k in ("tokens", "tok_gather", "img_gather", "is_image")}
        embeds = llava.splice_embeds(p, c, t["tokens"], t["tok_gather"], t["img_gather"], t["is_image"], feats)
        S = embeds.shape[1]
        cache = llama.init_cache(c.text, 1, S + len(steps), device=device)
        zero = torch.zeros((1,), dtype=torch.long, device=device)
        hidden, _ = llama.forward(p["llama"], c.text, embeds, torch.arange(S, device=device)[None], cache, zero)
        out = [llama.last_token_logits(p["llama"], hidden, zero + plan.length - 1)]
        for i, tok in enumerate(steps):
            pos = zero + plan.length + i
            emb = llama.embed_tokens(p["llama"], torch.full((1, 1), tok, device=device))
            hidden, _ = llama.forward(p["llama"], c.text, emb, pos[:, None], cache, pos)
            out.append(llama.logits_from_hidden(p["llama"], hidden[:, 0]))
        return [o.float().cpu() for o in out]

    got, ref = run(params, cfg, dev), run(params_cpu, cfg32, torch.device("cpu"))
    for name, g, r in zip(("prefill", "decode 1", "decode 2"), got, ref):
        err = (g - r).abs().max().item() / r.abs().max().item()
        ok = np.isfinite(err) and err <= REFERENCE_TOL
        log(f"reference {name}: max|card - cpu fp32| / max|cpu| = {err:.4g} "
            f"(tol {REFERENCE_TOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"reference {name}: card disagrees with the fp32 CPU model")


def main() -> int:
    name = phase_device()
    dev = torch.device("cuda:0")
    phase_build()
    from llava_align_tpu_torch.runners.common import MockTokenizer

    # the main path's prefill lengths: image row and text rows at 128-buckets
    ids = pope_requests(MockTokenizer(), 336)[0][0]
    main_lens = (-(-(len(ids) - 1 + 576) // 128) * 128, -(-len(ids) // 128) * 128)
    rec = phase_kernels(main_lens)
    torch.cuda.synchronize()
    launches = phase_main_path(dev)
    torch.cuda.synchronize()
    phase_reference(dev)
    torch.cuda.synchronize()

    sources = {
        "int8_matmul_stacked": ("K1", "llava_align_tpu_torch/csrc/int8_mm.cu", "llava_align_tpu/ops/quant.py:242"),
        "int8_matmul_cuda": ("K2", "llava_align_tpu_torch/csrc/int8_mm.cu", "llava_align_tpu/ops/quant.py:177"),
        "flash_attention": ("K3", "llava_align_tpu_torch/csrc/flash_attn.cu", "llava_align_tpu/ops/attention.py:611"),
    }
    kernels = [
        dict(name=n, route="cuda", source=src, replaces=rep, launches=launches[n], **rec[k])
        for n, (k, src, rep) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
