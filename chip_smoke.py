#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (llava_align_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):
  1. device: the card's name and power limit (nvidia-smi), CUDA must exist;
  2. build: compile the package's CUDA kernels from csrc/ with nvcc (one
     process per source, in parallel); ptxas must report no spill for K3's
     tensor-core kernel, for the wgmma main loop of K1/K2 and K4, for the
     tensor-core streaming kernel (K1/K2 at 1-64 rows, S1-S3, S5, S6) nor
     for K4's streaming kernel (its decode rows), and must not serialize the
     wgmma main loop (C7515);
  3. kernels: K1-K4 against their plain PyTorch versions on the card, in
     bf16, at their main paths' shapes (K1 at 3, 12, 16, 18, 24, 36 and 64
     rows, each timed under by_rows, and at the 7B text-branch prefill's
     rows on the O >= D stacks; K2 at the 7B and the 13B lm_head, each
     regime, every row count timed under by_path's by_rows, the POPE
     runner's rows (VDD and VCD) included; K3 at each prefill shape of the model paths, the POPE
     runner's batch-6 shapes included; K4 in each
     of its regimes, at the grouped path's decode rows (each timed under
     by_rows) and prefill rows, and on both sides of each regime threshold), with
     the tolerance stated; by CUDA events the
     kernel's, the plain version's and a library call's times (torch.matmul
     on a weight dequantized beforehand, or scaled_dot_product_attention: a
     yardstick only, the port never calls it; K3 and SDPA also as launches
     captured in a CUDA graph, their device time without the host's); K3
     is held row by row, and that rule must pass a control (K3's algorithm
     in PyTorch with P rounded to bf16) and catch three planted faults;
  4. microbenchmark path: each twin of a TPU script
     (llava_align_tpu_torch/scripts) runs its main() once at the script's
     shapes; each must launch the kernels of its TPU script (S1-S7), and
     each kernel's record from that run (its error against the plain
     version, held here at the same tolerance, S7's copies exact; kernel,
     plain and library times, the library being torch.matmul on a weight
     dequantized beforehand or Tensor.repeat / repeat_interleave; S7's
     kernel and library also as launches captured in a CUDA graph) is the
     S entry's;
  5. 7B path: LLaVA-v1.5-7B at full width and depth with random int8
     weights, several POPE-style requests through DecodeEngine.generate with
     dual-branch VDD (use_dd + use_dd_unk, cd_alpha=1, cd_beta=0.1, greedy,
     8 new tokens, EOS out of range); K1, K2 and K3 must launch, and no call
     the JAX dispatch rule streams may take the dequant path;
  6. POPE runner: llava_align_tpu_torch.runners.pope.run on that 7B int8
     model (full width and depth), on a question file written here (2
     images x POPE's 6 questions, image files absent: --synthetic-images),
     dual VDD (cd_alpha=1, cd_beta=0.1), greedy, 8 new tokens, EOS out of
     range, --calibrate, twice: --batch-size 6 ungrouped (generate_batch on
     both engines) and --group-by-image (submit_batch_groups + the scoring
     engine's submit_batch); each run must answer every question with its
     naive/none/unk dumps and launch K1, K2 and K3, and the port's POPE
     scorer (evals.pope) must score each answers file, calibrated report
     included; every shape K3 takes in these runs that phase 3 did not
     check is then checked and timed as phase 3 does; then
     utils.profiling.trace around one 7B int8 `generate` (a torch.profiler
     trace kept gzipped under build/trace_7b_decode/, which must name
     K1's and K3's kernels; its kernel time beside the call's PhaseTimer
     wall) and framework.data.JsonlDataset on the question file, which
     must take the native line index;
  6b. the same runner with VCD (--use_cd, noise step 500, cd_alpha=1,
     cd_beta=0.1) in the same two layouts on the same file, each with its
     questions/s beside dual VDD's of the same run; then the MME runner
     (runners/mme.run, 2 categories x 2 images x 2 questions written here,
     dual VDD, grouped; category files and score printed; K1, K2, K3 must
     launch) on that model, and the MMMU runner's command line
     (runners/mmmu.main, 4 samples written here, multiple choice and open,
     --calibrate, scored with none_unk and its table printed) on random:7b
     in bf16 as the runner loads it (K3 must launch); every shape K3 takes
     in phases 6 and 6b that phase 3 did not check is then checked and
     timed as phase 3 does;
  7. 7B reference (timed by utils.profiling.PhaseTimer): the same model
     cut to 2 decoder / 2 vision layers at full
     width, its prefill and decode logits on the card against the same
     params run in fp32 on the CPU (the kernels' plain versions); then a VCD
     `generate` on that cut, its first-step fused scores on the card
     against fp32 on the CPU, both given one eps for the noised image;
  7b. checkpoint: a llava-v1.5-7b-shaped checkpoint dir (2 decoder layers,
     the whole vision tower, bf16 weights from a seed in two .bin shards
     under HF key names) written to a temporary dir and loaded onto the card
     by utils.hf_convert.load_llava_checkpoint (seconds and GB/s printed),
     every leaf held exactly against its source tensor; then quantized int8
     and one dual-VDD `generate`, which must launch K1, K2 and K3; then
     the port's parity CLI (python -m llava_align_tpu_torch.utils.
     parity_check --image --tol 1e-3) on that dir (a wordpiece vocab and a
     seeded PNG added), fp32, against transformers' LlamaForCausalLM and
     CLIPVisionModel on the card; it must exit 0;
  8. 13B grouped path: LLaVA-v1.5-13B at full width and depth with random
     int4 (group 128) weights, the same decoding, POPE's 6 questions per
     image: one generate_batch_prefix call, one generate_batch_groups call
     at G = 4 groups (the POPE runner's cap), then a submit_batch_groups /
     collect_batch_groups loop at G = 4, sequential (the port's submit runs
     the whole call); K4, K2 and K3 must launch in the G = 1 call and in the
     G = 4 calls on their own;
  9. 13B grouped reference: that model cut to 2 decoder / 2 vision layers at
     full width; the grouped path's first-step fused scores on the card
     against the same params in fp32 on the CPU, and against `generate` on
     the card for the same question;
 10. Qwen-VL runners: Qwen-VL-7B at full width and depth (the 32-layer
     decoder, the 48-layer ViT-bigG at 448 px, the 256-query Resampler), a
     random bf16 tree from a seed, handed to runners/qwen_pope.run as its
     load_qwen_model would, which quantizes the decoder int8
     (quantize_qwen_params) itself: the POPE question file (2 images x 6
     questions, --synthetic-images), dual VDD ('unk' = 'None {q} Answer:'),
     greedy, 8 new tokens, EOS out of range, --calibrate, grouped by image
     and --no-group-by-image --batch-size 6, each scored by evals.pope,
     questions/s printed with and without the quantization (timed apart);
     then MME and the MMMU command line with --model-family qwen --quant
     int8 on the same tree and files as the LLaVA phases, through the same
     phase functions as LLaVA's; K1, K2 and K3 must launch in each run;
 11. Qwen-VL reference: the model cut to 2 decoder / 2 vision layers at full
     width, int8, a nonzero c_attn_b: an image prompt's prefill and decode
     logits, and a 2100-token text prompt's (its cache past seq_length
     2048: dynamic NTK and log-n active), on the card against the same
     params in fp32 on the CPU;
 12. InstructBLIP runners: InstructBLIP-Vicuna-7B at full width and depth
     (EVA-ViT-g, 39 layers at 224 px; the 12-layer Q-Former, 32 queries;
     the 32-layer Vicuna-7B), a random bf16 tree built by instructblip.init
     on the card and handed to the BLIP runners as their load_blip_model
     would (the mock tokenizer on both sides, EOS 2): runners/blip_pope.run
     on the POPE question file with --use_cd (noise step 500, cd_alpha 1,
     cd_beta 0.1), --calibrate, greedy, 8 new tokens, every record with its
     naive/none/noise dumps, scored by evals.pope (the calibrated
     none/noise settings included); then runners/caption.run at its
     defaults (5 beams, max_len 30, min_len 8) on 4 synthetic images, one
     non-empty caption per image; K3 must launch in each; questions/s,
     captions/s and tokens per answer printed; every hypothesis each bf16
     beam search ended with re-scored in fp32 on the card (one
     teacher-forced pass of the Vicuna weights in fp32), whose order must
     be the bf16 order but between scores within 0.05 nats a token, every
     gap printed; then the split of an
     answer's time (EVA-ViT-g, Q-Former, encode, decode steps at 2 and 5
     rows, the beam's sort and cache reorder);
 13. InstructBLIP reference: the model cut to 2 EVA / 2 Q-Former / 2
     decoder layers at full width: encode's output, a prompt's prefill and
     two decode steps' logits on the card (bf16) against the same params in
     fp32 on the CPU; then a 5-beam generate_beam of 8 tokens in fp32 on
     the card and on the CPU, over the fp32 cache and over the int8 one:
     whether the tokens agree, and where they part, the log-probability
     gap of the two prefixes;
 13b. the opt-in serving modes and LLaVA's last runners (new phases, all
     fatal): the W8A8 product (ops/quant.int8_matmul_w8a8: torch._int_mm,
     as the JAX package computes it outside Pallas) on one 7B layer's
     stacks at 128, 256, 640 and 3072 rows, its codes and output on the
     card against the CPU's, timed beside the dispatch without act_quant
     (K1 tiled or the dequant path), the dequant path and cuBLAS bf16
     (the card's own crossover; printed as a `w8a8_product` JSON line); the
     7B int8 POPE runner with --quant w8a8 grouped (dual VDD,
     --calibrate) on phase 6's file, its questions/s beside phase 6's int8
     grouped rate and its answers against phase 6's, a recorder showing
     every stacked call of >= 256 rows on the W8A8 product and none on the
     dequant path; generate_batch_groups at G = 4 with the int8 KV cache
     and the bf16 one (answers/s, peak memory, answers that agree; one
     layer's grouped decode attention timed with each) and one `generate`
     with kv_quant="int8"; runners/sampling.run_sweep --grid smoke twice
     under one seed (the sampled answers must be equal); runners/
     bias_probe.run on 4 questions (every record with its none, unk, zero,
     one, noise and naive dumps); the 2-layer 7B cut's W8A8 prefill logits
     and its int8-cache prefill and decode logits on the card against fp32
     on the CPU; runners/qwen_pope.run --quant w8a8 grouped on phase 10's
     tree (every stacked call of >= 256 rows on W8A8); K1, K2 and K3 must
     launch in every runner phase;
 13c. parallelism (after the bias probe, the 7B trees freed): 2 ranks
     spawned on the one card (parallel/dryrun.spawn; gloo, both on cuda:0:
     they measure correctness, not tensor-parallel speed), any rank's
     failure fatal. Each builds the random 7B int8 tree and runs the POPE
     runner with --dist auto (dual VDD, --no-group-by-image --batch-size 6,
     --calibrate): rank 0's merged answers must hold every question once,
     in order, and equal phase 6's one-rank answers of that layout (each
     rank's 6 questions are one lockstep call of the same questions as
     there), questions/s printed beside it; then a TP = 2 engine on the
     tree (generate dual VDD, generate_batch, generate_batch_groups) under
     a recorder of the shard shapes each kernel takes, K1, K2 and K3
     required (launches_by_path tp2, 7b_pope_runner_dist_auto), its
     first-step logits within 5e-2 of the one-rank engine's; the 2-layer
     full-width fp32 cut's greedy tokens under data 1 x model 2 and
     data 2 x model 1 equal to one rank's; one fp32 train step of the cut
     under both meshes within 1e-3 (loss) and 2 lr (params) of the
     unsharded step. Then, one tree at a time on each rank, TP = 2 engines
     of the four other families, each beside a one-rank engine on rank 0
     (first-step logits within 5e-2 of its largest): Qwen-VL-7B int8 at
     full width and depth (generate dual VDD, generate_batch of 4,
     generate_batch_groups of 2 x 3; K1, K2 and K3 required,
     launches_by_path tp2_qwen), InstructBLIP-Vicuna-7B bf16 at full width
     and depth (generate_batch of 4 text prompts, a 5-beam generate_beam on
     query features; K3 required, tp2_blip), LLaVA-MPT-7B and BLIP-2
     OPT-2.7b bf16 at full width with 8 of their 32 decoder layers
     (generate, generate_batch / generate_beam; tp2_mpt, tp2_opt); and
     each family's 2-layer full-width fp32 cut, whose greedy tokens under
     data 1 x model 2 must equal one rank's. Then K1, K2 and K3 held
     against their plain versions and timed at the shard shapes those
     engines sent them (each kernel's `tp2`, `tp2_qwen` and `tp2_blip`
     records);
 14. the model paths' own shapes: the 7B path, the LLaVA runner phases,
     the Qwen ones and the InstructBLIP ones run under recorders that note
     what reaches each kernel; K1 at every row count they sent a 7B-shaped stack (Qwen-VL-7B's
     decoder has LLaVA-v1.5-7B's stacks) that phase 3 did not check (the
     Qwen prefills' tiled-regime rows among them), checked and timed as
     phase 3 does under K1's path_rows, the rows each family sent under
     rows_by_path; K2 at Qwen's [151936, 4096] lm_head (1187 x 128
     channels, not a multiple of the tiled regime's 256) at every row count
     the Qwen runs sent it, and at 65 and 640 rows (the tiled regime),
     under by_path's qwen_int8_runner; every shape K3 took in those paths
     that phase 3 did not check.
 15. the last decoder families, bf16 at full width and depth, random
     weights from a seed (after phase 13, each tree freed before the next):
     LLaVA-MPT-7B (MPT-7B + CLIP ViT-L/336 + mlp2x_gelu) through
     DecodeEngine.generate with dual VDD and with VCD and generate_batch of
     6 POPE prompts in the mpt template, generate_batch_groups refused;
     BLIP-2 OPT-2.7b: encode_image_queries of an image and its noised copy,
     then generate with VCD on precomputed_feats, and a 5-beam 30-token
     generate_beam caption; BLIP-2 FlanT5-XL: t5_generate on 4 images,
     t5_encode_with_prefix + t5_candidate_losses ranking 4 candidates,
     encode_image_queries_instruct; stage-1 BLIP-2: extract_features,
     match (ITM, ITC), compute_sim_matrix over 8 x 8 with the ITM re-rank,
     a greedy generate_caption. Each path prints its wall, tokens per
     answer, answers (captions) per second, first-token seconds and peak
     memory, and its launches (K1-K4 at zero: no TPU kernel on these
     paths) under launches_by_path. Then 2-layer full-width references
     (MPT, OPT, T5 with 2 + 2 layers) bf16 on the card against fp32 on the
     CPU, a 5-beam fp32 OPT generate_beam card against CPU, and a 2-layer
     BLIP-2 OPT (.bin, LAVIS names) and LLaVA-MPT (.safetensors, HF names)
     checkpoint loaded through the new converters, every leaf exact.
 16. LLaVA training (after phase 15, on a card freed of every serving
     tree): LLaVA-v1.5-7B as the port's zoo builds it (LlavaModel
     size 7b: bf16, random, full width and depth, 7.06 G parameters)
     trained by runners/train's llava step with main's optimizer
     (build_optimizer: AdamW, the decay mask, clip 1.0, warm-up-cosine)
     through framework.runner.Runner, on 2 rows of <image> + a 16-token
     caption from the caption data path (coco_caption, synthetic images,
     the mock tokenizer; 608 positions): one warm step and 4 timed; s/step,
     tokens/s, model TFLOP/s, peak memory and each loss (finite) printed,
     also as a `train_7b` JSON line; then runners/train.main with a
     captioning YAML on a 2-layer full-width checkpoint written here, 2
     epochs (checkpoint_last each epoch) and a resume from checkpoint_last
     for a third; then the 7B cut to 2 decoder / 2 vision layers in fp32
     (TF32 off), 3 AdamW steps (warm-up, clip) and 4 micro-steps with
     accum_grad_iters=2, card against CPU in lockstep: each loss within
     1e-3 relative, every leaf within 2 x lr x updates, the gap printed
     call by call. K1-K4 must not launch
     (launches_by_path 7b_train and train_cli).
 17. the LAVIS zoo (after phase 16), random weights from a seed: the train
     CLI's four LAVIS archs through runners/train's step, main's optimizer
     and framework.runner.Runner on the CLI's data path (synthetic images,
     the mock tokenizer) at the JAX package's configs, fp32 -
     albef_retrieval (ViT-B/16 at 384, BERT-base fused from layer 6, a
     65536-entry queue; batch 16), albef_classification (batch 16),
     blip_classification (ViT-B/16 at 224; batch 32) and clip (ViT-B/32 +
     its 12-layer text tower; batch 64), one warm step and 3 timed each;
     BLIP-2's stage-1
     pretrain_forward (EVA ViT-g + Q-Former, batch 8), opt_forward_loss
     at OPT-2.7b and t5_forward_loss at FlanT5-XL (batch 4), bf16, each
     with one backward into the Q-Former side (the ViT and LM frozen);
     BLIP (ViT-B/16 at 224) generate_caption greedy and with 3 beams on 4
     images and compute_sim_matrix 8 x 8 with the ITM re-rank of the top
     4. Each prints s/step (s), samples/s and peak memory beside the card,
     the train phases also as `lavis_train` / `blip2_losses` JSON lines.
     K1-K4 must not launch (launches_by_path `*_train`, `blip2_*_loss`,
     `blip_*`). The 2-layer cuts of these families run after phase 18.
 18. the evaluation CLI, ALPRO + TimeSformer and GPT-2 dialogue (after
     phase 17), random weights from a seed, fp32: runners/evaluate.main
     on tiny YAMLs (the zoo's tiny trees, on the card) for `retrieval`
     (albef_retrieval and clip over synthetic images, alpro_retrieval over
     synthetic videos), `multimodal_classification` (albef_classification)
     and `vqa` (albef_vqa); then at the JAX package's full configs the
     CLI's VQA loop (_eval_vqa) with albef_vqa and blip_vqa (16 questions,
     a 128-answer list, 128 candidates), its retrieval loop
     (_eval_retrieval) with alpro_retrieval (TimeSformer-B/16 at 224, 8
     frames, BERT-base; 16 videos x 32 captions, the re-rank of the top
     16), alpro_qa's qa_logits on 16 videos at 1500 classes, one ALPRO
     retrieval_train_step at batch 8 with its backward, and GPT-2 small
     dialogue (len_video_ft 4224): dialogue_forward's loss on 8 dialogues
     of 40 feature rows + 200 tokens, dialogue_generate of 20 tokens for 4.
     Each prints s per call, questions/s, videos/s or samples/s and peak
     memory beside the card, and the `eval_full` JSON line. Then every
     LAVIS family cut to 2 layers per tower at full width, fp32 (phase
     17's, ALPRO's retrieval step and GPT-2's dialogue loss; TF32 off),
     card against CPU: the losses (BLIP's ITM logits) within 1e-3
     relative. K1-K4 must not launch (launches_by_path `eval_cli_*`,
     `eval_*`, `alpro_*`, `gpt_*`).
 19. the rest of the LAVIS zoo (after phase 18, before the 2-layer cuts),
     random weights from a seed at the JAX package's default configs,
     test tokenizers: PnP-VQA's predict_answers (BLIP ViT-B/16 at 224 with
     BERT-base for ITM and captions, fp32; FlanT5-XL's widths, bf16) on 4
     images x 1 question with its defaults (50 captions, 20 patches, one
     caption a FiD context, 20 answer tokens, 10 rounds at most);
     Img2Prompt (the same towers) on the same images: forward_itm,
     forward_cap with the ITM filter (100 captions; the threshold at the
     median match probability of a calibration round, as a random ITM
     head shifts them all by a seed's offset), answer_extraction,
     forward_qa_generation over each image's <= 31 contexts in 10-row
     chunks and prompts_construction; BLIP-Diffusion (CLIP ViT-L/14 at
     224, a Q-Former of 16 queries over 1024-wide features, the CLIP text
     tower 768 x 12, fp32): ctx_embeddings for 4 subjects, train_loss at
     batch 4 on [4, 4, 64, 64] latents with its backward, generate with
     50 DDIM steps and classifier-free guidance on [1, 4, 64, 64], and a
     5-step generate with a prompt-to-prompt AttentionStore at the UNet's
     attention site. The UNet is a small torch stand-in (pooled latents,
     one cross-attention site over the prompt embedding): the times are
     BLIP-Diffusion's own path, not Stable Diffusion's. Each prints s per
     call, questions/s, s/step or images/s and peak memory beside the
     card. K1-K4 must not launch (launches_by_path `pnp_*`,
     `img2prompt_*`, `blip_diffusion_*`). The 2-layer cuts of PnP-VQA (the
     GradCAM row, the FiD logits) and BLIP-Diffusion (ctx_embeddings,
     encode_prompt_ctx, train_loss at fixed draws) run with the LAVIS
     reference phase, card against CPU within 1e-3.

Prints a JSON line with each kernel's record (launches: both main paths'
counts, per path under launches_by_path; K1's and K4's prefill-row times
under prefill, K1's and K4's per decode row count under by_rows, K1's at
the model paths' other row counts under path_rows, K2's times per path
under by_path (each row count under its by_rows), K3's per shape under by_shape,
with its CUDA-graph times as graph_ms / graph_library_ms and its row
errors; K1's, K2's and K3's at the TP = 2 shard shapes under tp2);
S1-S7: launches, errors and times from the run of the twin that runs
each, S7's graph times as graph_ms / graph_library_ms), the card's name
and power limit, then as the last line
{"ok": true, "device": {...}}. Each InstructBLIP phase's wall time, and
the whole run's, are printed. Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gzip
import json
import re
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# bf16 results of two fp32 reductions in different orders (and K4's tiled
# regime rounding each dequantized weight to bf16, as the TPU kernel does)
# may land one bf16 ulp apart (<= 2^-7 of the largest output); allow twice.
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
GROUPS = 4          # image groups per grouped call: the POPE runner's cap
GROUP_CALLS = 3     # G = 4 calls: one generate_batch_groups (warm-up), then submit/collect
LM_HEAD_7B = (32000, 4096)
LM_HEAD_13B = (32000, 5120)
LM_HEAD_QWEN = (151936, 4096)
STACKS_13B = {"qkv": (15360, 5120), "o": (5120, 5120), "gateup": (27648, 5120), "down": (5120, 13824)}
L_13B = 40
# the card's published peaks (H100 SXM data sheet), for the bounds
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12


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


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the bf16 tensor-core rate, whichever is larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> tuple:
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is False — this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}, count {torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    # fp32 references in full fp32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, smi


def phase_build() -> None:
    from llava_align_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    path = _kernels.library_path()
    _kernels.lib()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({'nvcc ' + format(_kernels.build_seconds, '.2f') + ' s' if _kernels.build_seconds else 'cached'}) -> {path}")
    text = (path.parent / "build.log").read_text()
    for line in text.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log("  ptxas: " + line.strip())
    # K3's tensor-core kernel holds Q fragments, S and O in registers, the
    # wgmma main loop of K1/K2/K4 its 128 accumulators, the streaming
    # kernel its widened weights and accumulators: a spill would put them
    # in local memory
    spills = ptxas_spill_stores(text)
    for what, key, n_inst in (("K3 tensor-core kernel", "flash_fwd_mma_kernel", 2),
                              ("wgmma main loop (K1/K2 int8, K4 int4)", "wq_gemm_kernel", 2),
                              # 4 formats x 4 row bounds (8, 16, 32, 64)
                              ("tensor-core streaming kernel (K1/K2, S1-S3, S5, S6)", "stream_mma_kernel", 16),
                              # 6 row bounds (8, 16, 24, 32, 48, 72)
                              ("K4's streaming kernel (decode rows)", "int4_stream_kernel", 6)):
        inst = {fn: n for fn, n in spills.items() if key in fn}
        log(f"  {what}, spill-store bytes per instance: {inst}")
        if len(inst) != n_inst or any(inst.values()):
            raise AssertionError(f"{what}: expected {n_inst} instances without spills, got {inst}")
    # ptxas C7515: wgmma serialized (each MMA waited for), which undoes the
    # main loop's overlap of widening and MMAs
    serial = [line.strip() for line in text.splitlines() if "C7515" in line and "wq_gemm_kernel" in line]
    if serial:
        raise AssertionError(f"the wgmma main loop is serialized by ptxas: {serial}")


def ptxas_spill_stores(build_log: str) -> dict:
    """{function: spill-store bytes} from nvcc's -Xptxas -v output."""
    spills, fn = {}, None
    for line in build_log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            spills[fn] = int(m.group(1))
    return spills


# the 7B decode step, the VCD runner's decode steps (Q = 6 x 2 ungrouped, 2
# images x 6 x 2 grouped), the twins' rows, the grouped decode step (and
# the POPE runner's at Q = 6), the runner's grouped decode step (2 images),
# DECODE_MAX_ROWS
K1_ROWS = (3, 12, 16, 18, 24, 36, 64)


def k1_phase_rows(prefill_rows: int) -> dict:
    """The row counts phase 3 checks K1 at, by SHAPES_7B stack: K1_ROWS on
    every stack, and the text-branch prefill's rows on the O >= D stacks,
    the only ones the JAX rule streams at that count."""
    from llava_align_tpu_torch.ops import quant
    from llava_align_tpu_torch.scripts._common import SHAPES_7B

    return {name: K1_ROWS + ((prefill_rows,) if quant._stream_rows_ok(prefill_rows, O, D) else ())
            for name, (O, D) in SHAPES_7B.items()}


def k1_rows_record(rows_by_stack: dict, g, L: int = 32, shapes=None) -> tuple:
    """K1 against its plain version on random int8 [L, O, D] stacks of
    SHAPES_7B (LLaVA-v1.5-7B's, which Qwen-VL-7B's decoder shares) at each
    row count of rows_by_stack[name], layers 0 and L-1; each row count timed
    (the kernel with the layer rotated, so each call streams weights L2
    does not hold; plain; torch.matmul on a bf16 weight dequantized
    beforehand) and summed over the stacks that take it: ({rows: record
    with its bound and its stacks}, the largest error). shapes: the
    stacks' [O, D] by name, when not SHAPES_7B's (a TP shard's)."""
    from llava_align_tpu_torch.ops import quant
    from llava_align_tpu_torch.scripts._common import SHAPES_7B, matmul_work

    dev = torch.device("cuda:0")
    per_rows, err = {}, 0.0
    for name, (O, D) in (shapes or SHAPES_7B).items():
        if not rows_by_stack.get(name):
            continue
        q = torch.randint(-127, 128, (L, O, D), dtype=torch.int8, device=dev, generator=g)
        s = (torch.rand((L, O), device=dev, generator=g) + 0.5) / (127.0 * D**0.5)
        w_bf16 = [quant.dequantize({"q": q[i], "s": s[i]}, torch.bfloat16) for i in range(2)]
        for B in rows_by_stack[name]:
            h = torch.randn((B, D), device=dev, generator=g).to(torch.bfloat16)
            for li in (0, L - 1):
                err = max(err, compare(
                    quant.int8_matmul_stacked(h, q, s, li),
                    quant.int8_matmul_stacked_plain(h, q, s, li),
                    f"{name} [{L},{O},{D}] B={B} ({quant.stream_regime(h.dtype, B)}) li={li}",
                ))
            ms = cuda_ms(lambda i: quant.int8_matmul_stacked(h, q, s, i % L), 64)
            plain_ms = cuda_ms(lambda i: quant.int8_matmul_stacked_plain(h, q, s, i % L), 16)
            lib_ms = cuda_ms(lambda i: torch.matmul(h, w_bf16[i % 2].t()), 32)
            nb, fl = matmul_work(B, O, D, O * D, 4 * O)
            log(f"  {name} B={B}: kernel {ms:.4f} ms ({O * D / (ms * 1e-3) / 1e9:.0f} GB/s of int8 weights), "
                f"plain {plain_ms:.4f} ms, library (torch.matmul, bf16 weight) {lib_ms:.4f} ms, "
                f"bound {bound(nb, fl)['bound_ms']:.4f} ms")
            r = per_rows.setdefault(B, dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, flops=0.0, stacks=[]))
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms), ("bytes", nb),
                             ("flops", fl)):
                r[key] += val
            r["stacks"].append(name)
        del q, s, w_bf16
        torch.cuda.empty_cache()
    for B, r in per_rows.items():
        r.update(bound(r.pop("bytes"), r.pop("flops")))
        log(f"  one 7B layer's {'/'.join(r['stacks'])} at B={B}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    return per_rows, err


def phase_kernels_int8(grouped_decode_rows, prefill_rows: int) -> dict:
    """K1 and K2 against their plain versions at the 7B path's shapes (K1
    at K1_ROWS, each timed per layer under by_rows, and at its text-branch
    prefill's `prefill_rows` on the O >= D stacks; K2 at the 13B lm_head's
    grouped rows too, every row count timed under by_path's by_rows)."""
    from llava_align_tpu_torch.ops import quant

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(0)
    rec = {}

    log("kernels: K1 int8_matmul_stacked (decoder linears) vs plain, bf16; tensor-core streaming up to "
        f"{quant.DECODE_MAX_ROWS} rows, tiled above (the O >= D stacks' {prefill_rows}-row "
        "text-branch prefill)")
    per_rows, k1_err = k1_rows_record(k1_phase_rows(prefill_rows), g)
    by_rows = {str(B): per_rows[B] for B in K1_ROWS}
    # top-level numbers: the 7B decode step (3 rows: dual-branch VDD)
    top = {k: per_rows[3][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
    rec["K1"] = dict(top, max_abs_err=k1_err, by_rows=by_rows,
                     prefill=dict(per_rows[prefill_rows], rows=prefill_rows))

    log("kernels: K2 int8_matmul_cuda (lm_head) vs plain, bf16; streaming up to "
        f"{quant.DECODE_MAX_ROWS} rows, tiled above")
    # per path: (lm_head shape, the path's decode rows, the rows its record times)
    k2_paths = {
        "7b_int8_generate": (LM_HEAD_7B, (1, 2, 3, 18), 3),
        # the POPE runner: image rows, text rows and decode rows at Q = 6,
        # the grouped decode rows at 2 images
        "7b_int8_pope_runner": (LM_HEAD_7B, (6, 12, 18, 36), 18),
        # the VCD runner: 12 image rows (main, cd) and decode rows at Q = 6,
        # 24 decode rows grouped at 2 images
        "7b_int8_vcd_runner": (LM_HEAD_7B, (12, 24), 12),
        "13b_int4_grouped": (LM_HEAD_13B, tuple(grouped_decode_rows) + (65, quant.STREAM_MAX_ROWS),
                             grouped_decode_rows[-1]),
    }
    k2_err, k2_by_path = 0.0, {}
    for path, ((O, D), rows_list, head_rows) in k2_paths.items():
        k2_by_path[path], err = k2_path_record(O, D, rows_list, head_rows, g)
        k2_err = max(k2_err, err)
    # top-level numbers: the 7B path's decode step, as in the K1 record
    top = {k: v for k, v in k2_by_path["7b_int8_generate"].items() if k not in ("shape", "rows", "by_rows")}
    rec["K2"] = dict(top, max_abs_err=k2_err, by_path=k2_by_path)
    return rec


def k2_path_record(O: int, D: int, rows_list, head_rows: int, g) -> tuple:
    """K2 on a random int8 [O, D] lm_head against its plain version at each
    row count of rows_list, each timed (kernel, plain, torch.matmul on the
    weight dequantized to bf16 beforehand) beside its bound: (the path's
    record, with head_rows' numbers on top and every row count under
    by_rows, and the largest error)."""
    from llava_align_tpu_torch.ops import quant
    from llava_align_tpu_torch.scripts._common import matmul_work

    dev = torch.device("cuda:0")
    per_rows, err = {}, 0.0
    q = torch.randint(-127, 128, (O, D), dtype=torch.int8, device=dev, generator=g)
    s = (torch.rand((O,), device=dev, generator=g) + 0.5) / (127.0 * D**0.5)
    w_bf16 = quant.dequantize({"q": q, "s": s}, torch.bfloat16)
    for B in rows_list:
        h = torch.randn((B, D), device=dev, generator=g).to(torch.bfloat16)
        err = max(err, compare(
            quant.int8_matmul_cuda(h, q, s), quant.int8_matmul_plain(h, q, s),
            f"lm_head [{O},{D}] B={B} ({quant.stream_regime(h.dtype, B)})",
        ))
        ms = cuda_ms(lambda i: quant.int8_matmul_cuda(h, q, s), 32)
        plain_ms = cuda_ms(lambda i: quant.int8_matmul_plain(h, q, s), 16)
        lib_ms = cuda_ms(lambda i: torch.matmul(h, w_bf16.t()), 32)
        b = bound(*matmul_work(B, O, D, O * D, 4 * O))
        log(f"  lm_head [{O},{D}] B={B}: kernel {ms:.4f} ms ({O * D / (ms * 1e-3) / 1e9:.0f} GB/s of "
            f"int8 weights), plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
        per_rows[str(B)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **b)
    del q, s, w_bf16
    torch.cuda.empty_cache()
    return dict(shape=[O, D], rows=head_rows, **per_rows[str(head_rows)], by_rows=per_rows), err


K3_TILE = 64  # keys per tile of K3's tensor-core kernel
K3_FAULTS = ("skip_tile", "no_rescale", "mask_off_by_one")


def row_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """K3's measure: the worst over the output rows (b, s, h) of max|got -
    want| over the row, over max|want| over the row. One bound for the
    whole tensor would be set by the first rows, which attend to one key
    and are the largest outputs (|v| up to ~4, against ~0.1 for a row over
    300 keys): a fault in a late key tile would pass under it."""
    diff = (got.float() - want.float()).abs().amax(-1)
    ref = want.float().abs().amax(-1)
    return (diff / ref.clamp_min(torch.finfo(torch.float32).tiny)).max().item()


def flash_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, fault: str | None = None) -> torch.Tensor:
    """K3's bf16 algorithm in PyTorch, fp32: 64-key tiles, the online max
    and sum, P rounded to bf16 before PV, the output to bf16. Unfaulted,
    it is the control of K3's row tolerance (what the design's own rounding
    costs). `fault` plants one bug in the rows of the last query block (the
    longest rows, whose outputs are the smallest) that the tolerance must
    catch: "skip_tile" (they skip the middle key tile), "no_rescale" (their
    acc is not rescaled when the running max grows), "mask_off_by_one"
    (they also see the key after them)."""
    B, S, H, Dh = q.shape
    K = k.shape[2]
    qf = q.float().reshape(B, S, K, H // K, Dh).permute(0, 2, 3, 1, 4)  # [B, K, G, S, Dh]
    kf, vf = (x.float().permute(0, 2, 1, 3) for x in (k, v))            # [B, K, S, Dh]
    rows = torch.arange(S, device=q.device)[:, None]
    last = (S - 1) // K3_TILE
    late = rows // K3_TILE == last if fault else torch.zeros_like(rows, dtype=torch.bool)
    m = torch.full(qf.shape[:-1] + (1,), -1e30, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, S, K3_TILE):
        keys = torch.arange(k0, min(k0 + K3_TILE, S), device=q.device)[None, :]
        sc = torch.einsum("bkgqd,bksd->bkgqs", qf, kf[:, :, k0:k0 + K3_TILE]) * Dh**-0.5
        masked = keys > rows + (late & (fault == "mask_off_by_one")).int()
        if fault == "skip_tile" and k0 // K3_TILE == last // 2:
            masked = masked | late
        sc = sc.masked_fill(masked, -1e30)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = torch.where(late, acc, acc * corr) if fault == "no_rescale" else acc * corr
        acc = acc + torch.einsum("bkgqs,bksd->bkgqd", p.to(torch.bfloat16).float(), vf[:, :, k0:k0 + K3_TILE])
        m = m_new
    out = acc / torch.where(l == 0, torch.ones_like(l), l)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, Dh).to(q.dtype)


def phase_kernel_flash(attn_shapes) -> dict:
    """K3 against its plain version and SDPA at the prefill shapes of both
    model paths, row by row (row_err) at KERNEL_TOL; the rule is shown to
    sit between the control (flash_tiled) and each planted fault that the
    shape can show (no_rescale needs more than one key tile). The record is
    the first shape's, with every shape under by_shape."""
    from llava_align_tpu_torch.ops import attention
    from llava_align_tpu_torch.scripts._common import graph_ms

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(3)
    log(f"kernels: K3 flash_attention (causal prefill, tensor cores) vs plain, bf16, each output row "
        f"within {KERNEL_TOL:g} of its largest |plain|; kernel and SDPA timed eager (CUDA events), "
        "and as 20 launches in one CUDA graph (device time without the host's)")
    k3_err = k3_row = 0.0
    by_shape = []
    for B, S, H, Dh in attn_shapes:
        what = f"[{B},{S},{H},{Dh}]"
        qkv = [torch.randn((B, S, H, Dh), device=dev, generator=g).to(torch.bfloat16)
               for _ in range(3)]
        got, want = attention.flash_attention(*qkv), attention.flash_attention_plain(*qkv)
        err = (got.float() - want.float()).abs().max().item()
        row = row_err(got, want)
        control = row_err(flash_tiled(*qkv), want)
        # a fault in the running max's rescale needs a second key tile to show
        planted = {f: flash_tiled(*qkv, fault=f) for f in K3_FAULTS if f != "no_rescale" or S > K3_TILE}
        faults = {f: row_err(x, want) for f, x in planted.items()}
        # the same faults under one bound for the whole tensor, for the record
        whole = {f: ((x.float() - want.float()).abs().max() / want.float().abs().max()).item()
                 for f, x in planted.items()}
        ok = np.isfinite(row) and row <= KERNEL_TOL and control <= KERNEL_TOL
        caught = all(r > KERNEL_TOL for r in faults.values())
        log(f"  {what}: max_abs_err={err:.6g}, worst row {row:.6g} (control, bf16 P: {control:.6g}; "
            f"planted faults: " + ", ".join(f"{f} {r:.6g}" for f, r in faults.items())
            + f") tol={KERNEL_TOL:g} {'ok' if ok and caught else 'FAIL'}; under one bound for the "
            "whole tensor the faults read " + ", ".join(f"{f} {r:.6g}" for f, r in whole.items()))
        if not ok:
            raise AssertionError(f"K3 {what}: kernel disagrees with its plain version")
        if not caught:
            raise AssertionError(f"K3 {what}: the row tolerance lets a planted fault through")
        k3_err, k3_row = max(k3_err, err), max(k3_row, row)
        qt, kt, vt = (x.transpose(1, 2) for x in qkv)  # [B, H, S, Dh], as SDPA takes it
        kernel = lambda *_: attention.flash_attention(*qkv)  # noqa: E731
        sdpa = lambda *_: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)  # noqa: E731
        ms, lib_ms = cuda_ms(kernel, 20), cuda_ms(sdpa, 20)
        g_ms, g_lib_ms = graph_ms(kernel, dev, 20), graph_ms(sdpa, dev, 20)
        plain_ms = cuda_ms(lambda _: attention.flash_attention_plain(*qkv), 5)
        nbytes = 4 * B * S * H * Dh * 2
        flops = 4.0 * Dh * H * B * S * (S + 1) / 2  # QK and PV over the causal pairs
        b = bound(nbytes, flops)
        log(f"  {what}: kernel {ms:.4f} ms eager, {g_ms:.4f} ms in a graph ({flops / (g_ms * 1e-3) / 1e12:.1f} "
            f"TFLOP/s); library (SDPA) {lib_ms:.4f} ms eager, {g_lib_ms:.4f} ms in a graph; kernel/SDPA "
            f"{ms / lib_ms:.2f}x eager, {g_ms / g_lib_ms:.2f}x in a graph; plain {plain_ms:.4f} ms; bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
        by_shape.append(dict(shape=[B, S, H, Dh], ms=ms, library_ms=lib_ms, graph_ms=g_ms,
                             graph_library_ms=g_lib_ms, plain_ms=plain_ms, max_abs_err=err,
                             row_err=row, control_row_err=control, fault_row_err=faults,
                             fault_whole_err=whole, **b))
        del qkv, got, want, planted, qt, kt, vt
    top = {k: v for k, v in by_shape[0].items()
           if k in ("ms", "library_ms", "graph_ms", "graph_library_ms", "plain_ms", "bound_ms", "bound_by")}
    torch.cuda.synchronize()
    return dict(top, max_abs_err=k3_err, max_row_err=k3_row, by_shape=by_shape)


def random_int4_stack(L: int, O: int, D: int, g) -> tuple:
    dev = torch.device("cuda:0")
    q4 = torch.randint(-128, 128, (L, D // 2, O), dtype=torch.int8, device=dev, generator=g)
    gs = (torch.rand((L, D // 128, O), device=dev, generator=g) + 0.5) / (7.0 * D**0.5)
    return q4, gs


def int4_crossover_rows() -> list:
    """(dtype, rows) on both sides of each of K4's regime thresholds: the
    bf16 streaming kernel from 1 row (it measured faster than the skinny
    regime there, which keeps fp32's 1-2 rows) and its last row count, the
    wgmma regime's first."""
    from llava_align_tpu_torch.ops import quant

    bf16 = [(torch.bfloat16, B) for B in (1, 2, 3, quant.INT4_STREAM_MAX_ROWS, quant.INT4_WGMMA_MIN_ROWS)]
    return bf16 + [(torch.float32, B) for B in range(1, quant.INT4_SKINNY_MAX_ROWS + 1)]


def phase_kernels_int4(decode_rows, prefill_rows) -> dict:
    """K4 at each 13B stack, layers 0 and 39, at the grouped path's row
    counts (decode, then the prefills), timed; at the rows on both sides of
    each bf16 regime threshold (int4_crossover_rows), checked, each line
    naming its regime (quant.int4_regime)."""
    from llava_align_tpu_torch.ops import quant
    from llava_align_tpu_torch.scripts._common import matmul_work

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(4)
    log(f"kernels: K4 int4_matmul_stacked (13B int4 decoder linears) vs plain, bf16: the streaming kernel up "
        f"to {quant.INT4_STREAM_MAX_ROWS} rows, wgmma above; fp32: the skinny regime up to "
        f"{quant.INT4_SKINNY_MAX_ROWS} rows")
    stacks = {name: random_int4_stack(L_13B, O, D, g) for name, (O, D) in STACKS_13B.items()}
    rows_all = list(decode_rows) + list(prefill_rows)
    per_rows = {B: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, flops=0.0) for B in rows_all}
    err = 0.0
    for name, (q4, gs) in stacks.items():
        Dp, O = q4.shape[1], q4.shape[2]
        D = 2 * Dp
        w_bf16 = [quant.dequantize_int4({"q4": q4[i], "gs": gs[i]}, torch.bfloat16) for i in range(2)]
        for B in rows_all:
            h = torch.randn((B, D), device=dev, generator=g).to(torch.bfloat16)
            for li in (0, L_13B - 1):
                err = max(err, compare(
                    quant.int4_matmul_stacked(h, q4, gs, li),
                    quant.int4_matmul_stacked_plain(h, q4, gs, li),
                    f"{name} [{L_13B},{Dp},{O}] B={B} li={li} {quant.int4_regime(h.dtype, B)}",
                ))
            if B == decode_rows[0]:
                # both sides of each regime threshold
                cross = int4_crossover_rows()
                hs_all = torch.randn((max(B for _, B in cross), D), device=dev, generator=g)
                for dtype, Bs in cross:
                    hs = hs_all[:Bs].to(dtype).contiguous()
                    for li in (0, L_13B - 1):
                        err = max(err, compare(
                            quant.int4_matmul_stacked(hs, q4, gs, li),
                            quant.int4_matmul_stacked_plain(hs, q4, gs, li),
                            f"{name} [{L_13B},{Dp},{O}] B={Bs} {str(dtype)[6:]} li={li} "
                            f"{quant.int4_regime(dtype, Bs)}",
                        ))
            big = B > 512
            ms = cuda_ms(lambda i: quant.int4_matmul_stacked(h, q4, gs, i % L_13B), 10 if big else 40)
            plain_ms = cuda_ms(lambda i: quant.int4_matmul_stacked_plain(h, q4, gs, i % L_13B), 2, warmup=1)
            lib_ms = cuda_ms(lambda i: torch.matmul(h, w_bf16[i % 2].t()), 10 if big else 40)
            nb, fl = matmul_work(B, O, D, Dp * O, 4.0 * (D // 128) * O)
            r = per_rows[B]
            r["ms"] += ms
            r["plain_ms"] += plain_ms
            r["library_ms"] += lib_ms
            r["bytes"] += nb
            r["flops"] += fl
            log(f"  {name} B={B} ({quant.int4_regime(h.dtype, B)}): kernel {ms:.4f} ms "
                f"({Dp * O / (ms * 1e-3) / 1e9:.0f} GB/s of packed weights, {fl / (ms * 1e-3) / 1e12:.1f} TFLOP/s), plain {plain_ms:.4f} ms, library "
                f"(torch.matmul, bf16 weight) {lib_ms:.4f} ms, bound {bound(nb, fl)['bound_ms']:.4f} ms")
        del w_bf16
    for B, r in per_rows.items():
        r.update(bound(r.pop("bytes"), r.pop("flops")))
        log(f"  one 13B layer's four linears at B={B}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    del stacks
    torch.cuda.empty_cache()
    head = per_rows[decode_rows[-1]]  # the G = 4 decode step, the grouped path's headline
    prefill = [dict(rows=B, **per_rows[B]) for B in prefill_rows]
    by_rows = {str(B): per_rows[B] for B in decode_rows}
    return dict(head, max_abs_err=err, by_rows=by_rows, prefill=prefill)


# kernels-line entries of the microbenchmark path: TPU kernel -> (the twin
# that runs it, the key of the kernel's record in the twin's main() result,
# the port's wrapper, its source, the TPU kernel's file:line)
PROBE_KERNELS = {
    "S1a": ("bench_int4_probe", "int4_mm", "int4_rowmajor_matmul_stacked",
            "llava_align_tpu_torch/csrc/stream_mma.cuh", "scripts/bench_int4_probe.py:58"),
    "S1b": ("bench_int4_probe", "int4_native_mm", "int8_matmul_stacked",
            "llava_align_tpu_torch/csrc/int8_mm.cu", "scripts/bench_int4_probe.py:115"),
    "S2a": ("bench_int4_probe2", "int4_mm", "int4_rowmajor_matmul_stacked",
            "llava_align_tpu_torch/csrc/stream_mma.cuh", "scripts/bench_int4_probe2.py:55"),
    "S2b": ("bench_int4_probe2", "int4_native_mm", "int8_matmul_stacked",
            "llava_align_tpu_torch/csrc/int8_mm.cu", "scripts/bench_int4_probe2.py:182"),
    "S3": ("bench_int4_probe3", "int4_mm", "int4_rowmajor_matmul_stacked",
           "llava_align_tpu_torch/csrc/stream_mma.cuh", "scripts/bench_int4_probe3.py:46"),
    "S4": ("bench_int4_transposed", "int4t_mm", "int4_matmul_stacked",
           "llava_align_tpu_torch/csrc/int4_mm.cu", "scripts/bench_int4_transposed.py:43"),
    "S5": ("bench_bf16_stream", "stream_mm", "bf16_matmul_stacked",
           "llava_align_tpu_torch/csrc/stream_mma.cuh", "scripts/bench_bf16_stream.py:37"),
    "S6": ("probe_int4_kernel_bisect", "kern", "int4_rowmajor_matmul_stacked",
           "llava_align_tpu_torch/csrc/stream_mma.cuh", "scripts/probe_int4_kernel_bisect.py:24"),
    "S7": ("probe_mosaic_ops", "tryk", "repeat2d", "llava_align_tpu_torch/csrc/repeat2d.cu",
           "scripts/probe_mosaic_ops.py:9"),
}


def phase_probes() -> dict:
    """The microbenchmark path: each twin's main() once, at its TPU
    script's shapes, on the card; every count is reset before a twin and
    read after it. Each twin must launch the kernels of its TPU script. A
    twin's main() returns its kernels' records (error against the plain
    version at the twin's shapes; kernel, plain and library ms; the timed
    work's bytes and operations): each error is held here at KERNEL_TOL
    (S7 exact) and each record becomes the S entry's numbers."""
    import importlib

    from llava_align_tpu_torch.scripts import TWINS

    counts, results = {}, {}
    for twin in TWINS:
        mod = importlib.import_module(f"llava_align_tpu_torch.scripts.{twin}")
        log(f"microbenchmark twin {twin}:")
        reset_launches()
        t0 = time.perf_counter()
        results[twin] = mod.main([])
        torch.cuda.synchronize()
        counts[twin] = read_launches()
        torch.cuda.empty_cache()
        log(f"  {twin}: {time.perf_counter() - t0:.2f} s, launches "
            f"{ {k: v for k, v in counts[twin].items() if v} }")
    dead = [(sid, twin, w) for sid, (twin, _, w, _, _) in PROBE_KERNELS.items() if counts[twin][w] <= 0]
    if dead:
        raise AssertionError(f"kernels not launched by their twins: {dead}")
    entries = {}
    for sid, (twin, key, w, _, _) in PROBE_KERNELS.items():
        r = results[twin][key]
        tol = 0.0 if sid == "S7" else KERNEL_TOL * r["ref_max"]
        ok = np.isfinite(r["max_abs_err"]) and r["max_abs_err"] <= tol
        b = bound(r["bytes"], r["flops"])
        log(f"  {sid} ({twin}.{key}): max_abs_err={r['max_abs_err']:.6g} tol={tol:.6g} "
            f"{'ok' if ok else 'FAIL'}; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}); launches {counts[twin][w]}")
        if not ok:
            raise AssertionError(f"{sid}: the kernel disagrees with its plain version in {twin}")
        entries[sid] = dict(launches=counts[twin][w], max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], library_ms=r["library_ms"], **b,
                            **{k: r[k] for k in ("graph_ms", "graph_library_ms") if k in r})
        if "graph_ms" in r:
            log(f"  {sid} in a CUDA graph: kernel {r['graph_ms']:.4f} ms, library {r['graph_library_ms']:.4f} ms")
    return entries


def pope_requests(tokenizer, image_size: int):
    """POPE-style requests: llava_v1 prompts and seeded uint8 images."""
    from llava_align_tpu_torch.runners.common import POPE_OBJECTS, build_prompt
    from llava_align_tpu_torch.tokenization import tokenizer_image_token

    rng = np.random.default_rng(0)
    return [
        (tokenizer_image_token(build_prompt(q, "llava_v1")[0], tokenizer),
         rng.integers(0, 256, (3, image_size, image_size), dtype=np.uint8))
        for q in QUESTIONS[:N_REQUESTS]
    ]


def grouped_shapes(num_image_tokens: int, bucket: int = 128) -> dict:
    """The 13B grouped path's row counts, from the MockTokenizer prompts."""
    from llava_align_tpu_torch.runners.common import MockTokenizer, pope_groups

    prefix, suffixes, _ = pope_groups(MockTokenizer(), 336, 1)[0]
    pad = lambda n, m: -(-max(n, m) // m) * m  # noqa: E731
    pad_prefix = pad(len(prefix) - 1 + num_image_tokens, bucket)
    pad_txt = pad(len(prefix), bucket)  # 'unk' keeps the sentinel's slot; 'none' is 1 shorter
    pad_suf = pad(max(len(s) for s in suffixes), 32)
    rows_q = 6 * 3  # questions x VDD branches
    # the prefills' rows: image prefixes, text-branch prefixes (unk, none),
    # suffixes
    prefill_rows = (GROUPS * pad_prefix, GROUPS * 2 * pad_txt, GROUPS * rows_q * pad_suf)
    return dict(pad_prefix=pad_prefix, pad_txt=pad_txt, pad_suf=pad_suf,
                decode_rows=(rows_q, GROUPS * rows_q), prefill_rows=prefill_rows)


def dual_vdd_config():
    from llava_align_tpu_torch.config import GenerationConfig

    return GenerationConfig(
        max_new_tokens=NEW_TOKENS, do_sample=False, use_dd=True, use_dd_unk=True,
        cd_alpha=1.0, cd_beta=0.1, eos_token_id=10**9,  # EOS out of range: full length
    )


def check_output(out, V: int, what: str) -> None:
    probs = out.first_scores_top_probs
    if out.num_generated != NEW_TOKENS or len(out.token_ids) != NEW_TOKENS:
        raise AssertionError(f"{what}: {out.num_generated} tokens, expected {NEW_TOKENS}")
    if not all(0 <= t < V for t in out.token_ids):
        raise AssertionError(f"{what}: token ids out of the vocab: {out.token_ids}")
    if not (np.all(np.isfinite(probs)) and np.all(np.diff(probs) <= 0) and probs.sum() <= 1 + 1e-5):
        raise AssertionError(f"{what}: bad first-step scores {probs[:8]}")


def wrappers():
    from llava_align_tpu_torch.ops import attention, quant
    from llava_align_tpu_torch.ops import stream_probes as sp

    return {
        "int8_matmul_stacked": quant.int8_matmul_stacked,
        "int8_matmul_cuda": quant.int8_matmul_cuda,
        "flash_attention": attention.flash_attention,
        "int4_matmul_stacked": quant.int4_matmul_stacked,
        "int4_rowmajor_matmul_stacked": sp.int4_rowmajor_matmul_stacked,
        "bf16_matmul_stacked": sp.bf16_matmul_stacked,
        "repeat2d": sp.repeat2d,
    }


def reset_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


def load_7b(dev, quant: str = "int8"):
    """Random LLaVA-v1.5-7B as the runners' load_model("random:7b", quant)
    builds it: int8 for the 7B path, the POPE and MME runners; with no quant
    (bf16) for the MMMU command line, which loads it so."""
    from llava_align_tpu_torch.runners.common import load_model

    t0 = time.perf_counter()
    lm = load_model("random:7b", quant=quant, device=dev, seed=0)
    torch.cuda.synchronize()
    log(f"built random LLaVA-v1.5-7B ({quant}) on {dev} in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return lm


def phase_main_path(lm) -> dict:
    """LLaVA-v1.5-7B int8, dual-branch VDD, through DecodeEngine.generate."""
    from llava_align_tpu_torch.decoding.engine import DecodeEngine
    from llava_align_tpu_torch.ops import quant

    engine = DecodeEngine(lm.params, lm.cfg, dual_vdd_config())
    requests = pope_requests(lm.tokenizer, lm.cfg.vision.image_size)
    V = lm.cfg.text.vocab_size

    # every call that takes the dequant path, as (rows, O, D): none may be
    # one the JAX rule streams (an O >= D stack at 65..640 rows)
    dequant_calls = collections.Counter()
    dequant = quant.int8_matmul_dequant

    def counted_dequant(h, q, s):
        dequant_calls[(h.numel() // h.shape[-1], q.shape[0], q.shape[1])] += 1
        return dequant(h, q, s)

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    stats = []
    quant.int8_matmul_dequant = counted_dequant
    try:
        for i, (ids, image) in enumerate(requests):
            out = engine.generate(ids, image)
            torch.cuda.synchronize()
            check_output(out, V, f"request {i}")
            decode_s = out.seconds_total - out.seconds_to_first_token
            tps = (out.num_generated - 1) / decode_s
            stats.append((out.seconds_total, out.seconds_to_first_token, tps))
            log(f"  request {i}{' (warm-up)' if i == 0 else ''}: prompt {len(ids)} ids -> spliced "
                f"{out.prompt_length}, tokens {out.token_ids}, total {out.seconds_total:.4f} s, "
                f"prefill+first token {out.seconds_to_first_token:.4f} s, decode {tps:.2f} tok/s")
    finally:
        quant.int8_matmul_dequant = dequant
    launches = read_launches()
    log(f"  dequant-path calls (rows, O, D): {dict(dequant_calls)}")
    streamable = [c for c in dequant_calls if quant._stream_rows_ok(*c)]
    if streamable:
        raise AssertionError(f"calls the JAX rule streams took the dequant path: {streamable}")
    peak = torch.cuda.max_memory_allocated()
    steady = stats[1:]
    log(f"  launches during the 7B path: {launches}")
    log(f"  steady requests (1..{len(stats) - 1}): mean total {np.mean([s[0] for s in steady]):.4f} s, "
        f"mean prefill+first token {np.mean([s[1] for s in steady]):.4f} s, "
        f"mean decode {np.mean([s[2] for s in steady]):.2f} tok/s; "
        f"peak memory {peak / 2**30:.2f} GiB")
    require_launches(launches, ("int8_matmul_stacked", "int8_matmul_cuda", "flash_attention"), "the 7B path")
    del engine
    torch.cuda.empty_cache()
    return launches


RUNNER_IMAGES = 2  # images of the runner phase's question file, 6 questions each
RUNNER_LAYOUTS = {  # runner flags of each run: ungrouped lockstep, then grouped by image
    "batch": ["--no-group-by-image", "--batch-size", "6"],
    "grouped": ["--group-by-image"],
}
RUNNER_MODES = {  # the decoding of each runner phase: dual VDD, then VCD
    "pope": ["--use_dd", "--use_dd_unk"],
    "vcd": ["--use_cd", "--noise_step", "500"],
}


def write_pope_files(root) -> tuple:
    """A POPE-style question file (RUNNER_IMAGES images x 6 questions, the
    image files absent) and its ground truth, under `root`."""
    from llava_align_tpu_torch.runners.common import POPE_OBJECTS

    root.mkdir(parents=True, exist_ok=True)
    qf, gt = root / "smoke_POPE_questions.jsonl", root / "smoke_POPE_gt.jsonl"
    with open(qf, "w") as f_q, open(gt, "w") as f_gt:
        for i in range(6 * RUNNER_IMAGES):
            q = {"question_id": i, "image": f"COCO_val2014_{i // 6:012d}.jpg",
                 "text": f"Is there a {POPE_OBJECTS[i % 6]} in the image?"}
            f_q.write(json.dumps(q) + "\n")
            f_gt.write(json.dumps(dict(q, label="yes" if i % 2 == 0 else "no")) + "\n")
    return qf, gt


def runner_shapes(tokenizer, cfg, bucket: int = 128) -> dict:
    """The POPE runner's 7B prefill buckets for the question file's prompts
    (one-word suffix: the file name holds POPE): the image rows' and the
    text rows'."""
    from llava_align_tpu_torch.runners.common import POPE_OBJECTS, build_prompt
    from llava_align_tpu_torch.tokenization import tokenizer_image_token

    ids = tokenizer_image_token(build_prompt(f"Is there a {POPE_OBJECTS[2]} in the image?", "llava_v1",
                                             one_word=True)[0], tokenizer)
    pad = lambda n: -(-max(n, bucket) // bucket) * bucket  # noqa: E731
    return dict(pad_img=pad(len(ids) - 1 + cfg.num_image_tokens), pad_txt=pad(len(ids)))


@contextlib.contextmanager
def patched(obj, attr: str, value):
    """Within `with`, obj.attr is value."""
    old = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield value
    finally:
        setattr(obj, attr, old)


class PathRecorder:
    """Within `with`, notes what a model path sends the kernels: each (q
    shape, k shape, dtype) the decoders' causal prefill (models/llama's
    causal_attention, which models/qwen runs too) routes to K3 in `k3`; by
    weight [O, D], each row count that the dispatch of a stacked int8
    linear (models/llama.int8_matmul_stacked_dispatch, or a tensor-parallel
    shard's int8_matmul_stacked_tp) routes to K1 in `k1` and that of an
    int8 lm_head (models/llama.int8_matmul) routes to K2 in
    `k2`; and the seconds of each quantize_qwen_params call (the Qwen
    runners' --quant int8) in `quant_s`. Under act_quant (--quant w8a8) a
    stacked call of W8A8_MIN_ROWS rows or more is noted by rows in `w8a8`
    if it took the W8A8 product and in `w8a8_missed` if not; every call of
    the dequant path is counted by (rows, O, D) in `dequant`."""

    def __init__(self):
        self.k3, self.k1, self.k2 = set(), collections.defaultdict(set), collections.defaultdict(set)
        self.quant_s = []
        self.w8a8, self.w8a8_missed, self.dequant = (collections.Counter() for _ in range(3))

    def __enter__(self):
        from llava_align_tpu_torch.models import llama
        from llava_align_tpu_torch.ops import attention, quant

        causal, stacked, lm_head = llama.causal_attention, llama.int8_matmul_stacked_dispatch, llama.int8_matmul
        stacked_tp = llama.int8_matmul_stacked_tp
        quantize, dequant = quant.quantize_qwen_params, quant.int8_matmul_dequant

        def k3_recording(q, k, v, *, impl="auto"):
            route = attention.causal_attention_impl(q.shape[3], q.shape[2], k.shape[2], q.dtype)
            if (route if impl == "auto" else impl) == "pallas":
                self.k3.add((tuple(q.shape), tuple(k.shape), q.dtype))
            return causal(q, k, v, impl=impl)

        def k1_recording(h, wq, li, **kw):
            rows, (O, D) = h.numel() // h.shape[-1], wq["q"].shape[1:]
            w8a8_due = kw.get("act_quant") and rows >= quant.W8A8_MIN_ROWS
            if quant._stream_rows_ok(rows, O, D) and not w8a8_due:
                self.k1[(O, D)].add(rows)
            n0 = quant.int8_matmul_w8a8.launches
            out = stacked(h, wq, li, **kw)
            if w8a8_due:
                (self.w8a8 if quant.int8_matmul_w8a8.launches > n0 else self.w8a8_missed)[rows] += 1
            return out

        def k1_tp_recording(h, wq, li, group, mode, **kw):
            # a tensor-parallel shard: its own [O, D] and rows, as the dispatch reads them
            rows, (O, D) = h.numel() // h.shape[-1], wq["q"].shape[1:]
            if quant._stream_rows_ok(rows, O, D) and not (kw.get("act_quant") and rows >= quant.W8A8_MIN_ROWS):
                self.k1[(O, D)].add(rows)
            return stacked_tp(h, wq, li, group, mode, **kw)

        def dequant_counted(h, q, s):
            self.dequant[(h.numel() // h.shape[-1], q.shape[0], q.shape[1])] += 1
            return dequant(h, q, s)

        def k2_recording(h, wq):
            rows, (O, D) = h.numel() // h.shape[-1], wq["q"].shape
            if quant._stream_rows_ok(rows, O, D):
                self.k2[(O, D)].add(rows)
            return lm_head(h, wq)

        def timed_quantize(params):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = quantize(params)
            torch.cuda.synchronize()
            self.quant_s.append(time.perf_counter() - t0)
            return out

        self.patches = contextlib.ExitStack()
        for obj, attr, fn in ((llama, "causal_attention", k3_recording),
                              (llama, "int8_matmul_stacked_dispatch", k1_recording),
                              (llama, "int8_matmul_stacked_tp", k1_tp_recording),
                              (llama, "int8_matmul", k2_recording), (quant, "quantize_qwen_params", timed_quantize),
                              (quant, "int8_matmul_dequant", dequant_counted)):
            self.patches.enter_context(patched(obj, attr, fn))
        return self

    def __exit__(self, *exc):
        return self.patches.__exit__(*exc)


def require_launches(launches: dict, names, what: str) -> None:
    dead = [n for n in names if launches[n] <= 0]
    if dead:
        raise AssertionError(f"kernels not launched by {what}: {dead}")


K123 = ("int8_matmul_stacked", "int8_matmul_cuda", "flash_attention")


@dataclasses.dataclass
class RunnerModel:
    """A model the runner phases hand the runners: within patch(), the
    runners' loader (`loader`: module, attribute name) returns `model`.
    `tag` prefixes the phases' path names, `what` names the model in the
    log, `args` are the flags that name it to every runner and `family`
    those the MME and MMMU runners add; `pope` is the POPE runner module
    that serves it, `kernels` those each run must launch. The POPE phase
    runs it once per entry of `layouts` (runner flags by name), requires
    the `dumps` of every record, and scores the calibrated `settings`."""

    tag: str
    what: str
    loader: tuple
    model: object
    args: tuple
    family: tuple = ()
    pope: object = None
    kernels: tuple = K123
    layouts: dict = dataclasses.field(default_factory=lambda: dict(RUNNER_LAYOUTS))
    dumps: tuple = ("naive", "none", "unk")
    settings: tuple = ("naive", "none", "unk", "none_unk")  # evals.pope main's calibrated report

    def patch(self):
        module, attr = self.loader
        return patched(module, attr, lambda *a, **k: self.model)


def timed_run(model: RunnerModel, rec: PathRecorder, fn) -> tuple:
    """fn() with model's loader patched and rec recording, the launch
    counts reset before it and read after it: (its result, seconds,
    launches, seconds of quantize_qwen_params in it)."""
    q0 = len(rec.quant_s)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with model.patch(), rec:
        out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out, secs, read_launches(), sum(rec.quant_s[q0:])


def rate_text(n_q: int, secs: float, quant_s: float) -> str:
    text = f"{n_q} questions in {secs:.4f} s, {n_q / secs:.4f} questions/s"
    if quant_s:
        text += (f" (quantize_qwen_params {quant_s:.4f} s of it; without it {secs - quant_s:.4f} s, "
                 f"{n_q / (secs - quant_s):.4f} questions/s)")
    return text


TRACE_DIR = Path(__file__).resolve().parent / "build" / "trace_7b_decode"


def phase_utilities(lm, smoke_dir: Path, smi: str) -> None:
    """The utility modules on the card: utils.profiling.trace around one
    7B int8 dual-VDD `generate` (a torch.profiler Chrome trace, kept
    gzipped under build/trace_7b_decode/), which must name K1's kernel
    (the tensor-core streaming kernel, stream_mma_kernel) and K3's; the trace's kernel time summed
    beside the call's wall; and framework.data.JsonlDataset on the POPE
    question file, which must take the native line index (built with g++
    into build/native/) and read every row as json does."""
    from llava_align_tpu_torch.decoding.engine import DecodeEngine
    from llava_align_tpu_torch.framework.data import JsonlDataset
    from llava_align_tpu_torch.utils.profiling import TRACE_FILE, PhaseTimer, trace

    engine = DecodeEngine(lm.params, lm.cfg, dual_vdd_config())
    ids, image = pope_requests(lm.tokenizer, lm.cfg.vision.image_size)[1]
    engine.generate(ids, image)  # warm: the trace holds one steady call
    timer = PhaseTimer()
    with trace(str(TRACE_DIR)), timer.phase("traced generate"):
        out = engine.generate(ids, image)
    check_output(out, lm.cfg.text.vocab_size, "traced generate")
    events = json.loads((TRACE_DIR / TRACE_FILE).read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = collections.Counter(e["name"] for e in kernels)
    k1 = sum(n for name, n in names.items() if "stream_mma_kernel" in name)
    k3 = sum(n for name, n in names.items() if "flash" in name)
    busy_ms = sum(e.get("dur", 0) for e in kernels) / 1e3
    wall = timer.report()["traced generate"]["total_s"]
    log(f"trace (utils.profiling.trace) of one 7B int8 dual-VDD generate on {smi}: "
        f"{TRACE_DIR / TRACE_FILE} ({(TRACE_DIR / TRACE_FILE).stat().st_size / 1e6:.2f} MB), {len(kernels)} kernel "
        f"events, {k1} of K1's stream_mma_kernel, {k3} of K3's; kernels {busy_ms:.3f} ms of the call's "
        f"{wall * 1e3:.3f} ms wall (PhaseTimer, synchronized); most launched: "
        f"{[(name[:90], n) for name, n in names.most_common(4)]}")
    if not k1 or not k3:
        raise AssertionError("the trace names no launch of K1's or K3's kernel")
    with open(TRACE_DIR / TRACE_FILE, "rb") as f_in, gzip.open(TRACE_DIR / (TRACE_FILE + ".gz"), "wb") as f_out:
        shutil.copyfileobj(f_in, f_out)  # chrome://tracing and Perfetto read it gzipped
    (TRACE_DIR / TRACE_FILE).unlink()

    qf = smoke_dir / "smoke_POPE_questions.jsonl"
    ds = JsonlDataset(str(qf))
    rows = [json.loads(line) for line in qf.read_text().splitlines() if line.strip()]
    log(f"JsonlDataset on {qf.name}: native {ds.native}, {len(ds)} rows")
    if not ds.native or [ds[i] for i in range(len(ds))] != rows:
        raise AssertionError("JsonlDataset: not the native path, or rows differ from json's")
    del engine


def phase_runner(model: RunnerModel, root, smi: str, mode: str, rec: PathRecorder) -> tuple:
    """model's POPE runner (runners/pope for LLaVA, runners/qwen_pope for
    Qwen-VL, runners/blip_pope for InstructBLIP) on the card in one decoding
    mode (RUNNER_MODES: dual VDD, or VCD), once per entry of model.layouts,
    each with the launch counts reset before it and read after it,
    --calibrate; every record with its model.dumps; then the port's scorer
    on each answers file (its command line: the plain report, and the
    calibrated one where the records carry 'unk'; else the calibrated
    model.settings through its functions). Returns the launches by layout
    and the questions/s by layout (without the quantization a run may
    include)."""
    import io

    from llava_align_tpu_torch.evals import pope as pope_eval

    qf, gt = write_pope_files(root)
    n_q = 6 * RUNNER_IMAGES
    by_layout, rates = {}, {}
    for layout, flags in model.layouts.items():
        name = f"{model.tag}_{mode}_runner_{layout}"
        answers = root / f"{name}.jsonl"
        args = model.pope.build_parser().parse_args([
            *model.args, "--question-file", str(qf), "--answers-file", str(answers), *RUNNER_MODES[mode],
            "--cd_alpha", "1", "--cd_beta", "0.1", "--max_new_tokens", str(NEW_TOKENS), "--temperature", "0",
            "--synthetic-images", "--calibrate", *flags])
        _, secs, launches, quant_s = timed_run(model, rec, lambda: model.pope.run(args))
        recs = pope_eval.load_jsonl(str(answers))
        rates[layout] = n_q / (secs - quant_s)
        log(f"POPE runner {name} ({model.what}, {' '.join(RUNNER_MODES[mode] + flags)}, --calibrate) on {smi}: "
            f"{rate_text(n_q, secs, quant_s)}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"  launches of K1 {launches['int8_matmul_stacked']}, K2 {launches['int8_matmul_cuda']}, "
            f"K3 {launches['flash_attention']}")
        log(f"  answers: {[r['text'] for r in recs]}")
        if [r["question_id"] for r in recs] != list(range(n_q)):
            raise AssertionError(f"{name}: answers for {[r['question_id'] for r in recs]}")
        bad = [r["question_id"] for r in recs
               if not all(isinstance(r.get(k), dict) and r[k] for k in model.dumps)]
        if bad:
            raise AssertionError(f"{name}: records without {'/'.join(model.dumps)} dumps: {bad}")
        require_launches(launches, model.kernels, f"the POPE runner, {name}")
        report = io.StringIO()
        with contextlib.redirect_stdout(report):
            rc = pope_eval.main([str(gt), str(answers)])
            if "unk" not in model.dumps:
                print(pope_eval.format_calibrated_report(pope_eval.score_pope_calibrated(
                    pope_eval.load_jsonl(str(gt)), recs, settings=model.settings)))
        for line in report.getvalue().splitlines():
            log(f"  score: {line}")
        if rc != 0 or any(f"[{x}]" not in report.getvalue() for x in model.settings):
            raise AssertionError(f"{name}: the POPE scorer failed (rc {rc}) or gave no calibrated report")
        by_layout[name] = launches
    torch.cuda.empty_cache()
    return by_layout, rates


def runner_attn_shapes(k3_seen, checked) -> list:
    """The [B, S, H, Dh] shapes K3 took in the runner phases (POPE with VDD
    and with VCD, MME, MMMU) that are not in `checked`; each must be one
    phase_kernel_flash can make (bf16, as many k/v heads as q heads, as
    LLaVA-v1.5-7B has)."""
    new = []
    for q_shape, k_shape, dtype in sorted(k3_seen, key=str):
        if dtype != torch.bfloat16 or k_shape != q_shape:
            raise AssertionError(f"K3 took q {q_shape} k {k_shape} {dtype} in a runner phase: "
                                 "not a shape its check makes")
        if q_shape not in checked and q_shape not in new:
            new.append(q_shape)
    return new


def path_k1_rows(k1_seen: dict, checked: dict) -> dict:
    """The row counts K1 took on each SHAPES_7B stack in the recorded model
    paths (k1_seen: {(O, D): rows}) that `checked` ({stack: rows}) does not
    hold, by stack; each [O, D] must be a SHAPES_7B stack."""
    from llava_align_tpu_torch.scripts._common import SHAPES_7B

    names = {shape: name for name, shape in SHAPES_7B.items()}
    new = {}
    for shape, rows in sorted(k1_seen.items()):
        if shape not in names:
            raise AssertionError(f"K1 took a [{shape}] stack in a model path: not a shape its check makes")
        extra = sorted(set(rows) - set(checked[names[shape]]))
        if extra:
            new[names[shape]] = extra
    return new


def to_fp32(node, device="cpu"):
    """The tree on `device`, its float leaves in fp32."""
    if isinstance(node, dict):
        return {k: to_fp32(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [to_fp32(v, device) for v in node]
    return node.to(device, torch.float32) if node.is_floating_point() else node.to(device)


def cut_config(full, dtype=None):
    """full width, 2 decoder layers, 3 vision layers (select_layer -2 runs 2)."""
    cfg = dataclasses.replace(
        full, text=dataclasses.replace(full.text, num_layers=2),
        vision=dataclasses.replace(full.vision, num_layers=3),
    )
    if dtype is not None:
        cfg = dataclasses.replace(
            cfg, text=dataclasses.replace(cfg.text, dtype=dtype),
            vision=dataclasses.replace(cfg.vision, dtype=dtype),
        )
    return cfg


def llama_logits_steps(p_llama, c_text, embeds, length: int, steps, device, act_quant: bool = False,
                       kv_quant: bool = False) -> list:
    """The LLaMA decoder's logits at the last real position (`length`) of
    one prompt's `embeds` [1, S, D], then at one decode step per token of
    `steps`, as fp32 CPU tensors; act_quant (W8A8) and kv_quant (the int8
    cache) as the engine passes them."""
    from llava_align_tpu_torch.models import llama

    S = embeds.shape[1]
    cache = llama.init_cache(c_text, 1, S + len(steps), device=device, kv_quant=kv_quant)
    zero = torch.zeros((1,), dtype=torch.long, device=device)
    hidden, _ = llama.forward(p_llama, c_text, embeds, torch.arange(S, device=device)[None], cache, zero,
                              act_quant=act_quant)
    out = [llama.last_token_logits(p_llama, hidden, zero + length - 1)]
    for i, tok in enumerate(steps):
        pos = zero + length + i
        emb = llama.embed_tokens(p_llama, torch.full((1, 1), tok, device=device))
        hidden, _ = llama.forward(p_llama, c_text, emb, pos[:, None], cache, pos, act_quant=act_quant)
        out.append(llama.logits_from_hidden(p_llama, hidden[:, 0]))
    return [o.float().cpu() for o in out]


def phase_reference(dev) -> None:
    """Full-width 7B model cut to 2 decoder / 2 vision layers: prefill and
    decode logits on the card (kernels) against fp32 on the CPU (plain)."""
    from llava_align_tpu_torch.config import LlavaConfig
    from llava_align_tpu_torch.models import llava
    from llava_align_tpu_torch.ops.image import normalize_device
    from llava_align_tpu_torch.runners.common import MockTokenizer
    from llava_align_tpu_torch.utils.synthetic import build_random_llava_params

    cfg = cut_config(LlavaConfig.llava_v15_7b())
    cfg32 = cut_config(LlavaConfig.llava_v15_7b(), torch.float32)
    params = build_random_llava_params(cfg, quant="int8", device=dev, seed=1)
    params_cpu = to_fp32(params)
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
        return llama_logits_steps(p["llama"], c.text, embeds, plan.length, steps, device)

    got, ref = run(params, cfg, dev), run(params_cpu, cfg32, torch.device("cpu"))
    for name, g, r in zip(("prefill", "decode 1", "decode 2"), got, ref):
        rel_check(g, r, f"7B reference {name}: max|card - cpu fp32| / max|cpu|")
    del params, params_cpu
    torch.cuda.empty_cache()


def rel_check(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    err = (got - want).abs().max().item() / want.abs().max().item()
    ok = np.isfinite(err) and err <= REFERENCE_TOL
    log(f"{what} = {err:.4g} (tol {REFERENCE_TOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: out of tolerance")
    return err


def finite_check(a: torch.Tensor, b: torch.Tensor, what: str) -> float:
    """First-step fused scores against a reference where both are finite
    (the plausibility cutoff may differ for tokens right at it, on at most
    1% of the vocabulary), within REFERENCE_TOL of the largest."""
    both = torch.isfinite(a) & torch.isfinite(b)
    differ = (torch.isfinite(a) != torch.isfinite(b)).float().mean().item()
    log(f"  {what}: {int(both.sum())} scores finite in both, cutoff disagrees on {differ:.4%}")
    if differ > 0.01:
        raise AssertionError(f"{what}: the plausibility cutoffs disagree on {differ:.2%} of the vocab")
    return rel_check(a[both], b[both], f"{what}: max|diff| / max|ref|")


def phase_vcd_reference(dev) -> None:
    """VCD `generate` (use_cd, cd_alpha 1, cd_beta 0.1, noise step 500) on
    the full-width 7B model cut to 2 decoder / 2 vision layers, int8: the
    first-step fused scores on the card against the same params in fp32 on
    the CPU, both given one eps (numpy, seeded) for the noised image, so
    the noise is not what differs."""
    from llava_align_tpu_torch.config import GenerationConfig, LlavaConfig
    from llava_align_tpu_torch.decoding import engine as engine_mod
    from llava_align_tpu_torch.ops import noise
    from llava_align_tpu_torch.runners.common import MockTokenizer
    from llava_align_tpu_torch.utils.synthetic import build_random_llava_params

    cfg = cut_config(LlavaConfig.llava_v15_7b())
    cfg32 = cut_config(LlavaConfig.llava_v15_7b(), torch.float32)
    params = build_random_llava_params(cfg, quant="int8", device=dev, seed=3)
    params_cpu = to_fp32(params)
    ids, image = pope_requests(MockTokenizer(), cfg.vision.image_size)[0]
    eps = torch.from_numpy(np.random.default_rng(9).standard_normal((1, 3, 336, 336)).astype(np.float32))
    gen = GenerationConfig(max_new_tokens=1, do_sample=False, use_cd=True, cd_alpha=1.0, cd_beta=0.1,
                           noise_step=500, eos_token_id=10**9)
    real = engine_mod.add_diffusion_noise
    engine_mod.add_diffusion_noise = lambda x, t, generator=None: noise.add_diffusion_noise(x, t, eps=eps)
    try:
        with torch.inference_mode():
            got = engine_mod.DecodeEngine(params, cfg, gen).submit_generate(ids, image)["first_scores"]
            want = engine_mod.DecodeEngine(params_cpu, cfg32, gen).submit_generate(ids, image)["first_scores"]
    finally:
        engine_mod.add_diffusion_noise = real
    finite_check(got.float().cpu(), want, "7B VCD reference: generate card vs cpu fp32, first-step fused scores")
    del params, params_cpu
    torch.cuda.empty_cache()


# the published liuhaotian/llava-v1.5-7b config.json, cut to 2 decoder layers
CKPT_CONFIG = {
    "architectures": ["LlavaLlamaForCausalLM"], "bos_token_id": 1, "eos_token_id": 2, "hidden_act": "silu",
    "hidden_size": 4096, "image_aspect_ratio": "pad", "intermediate_size": 11008, "max_length": 4096,
    "max_position_embeddings": 4096, "mm_hidden_size": 1024, "mm_projector_type": "mlp2x_gelu",
    "mm_use_im_patch_token": False, "mm_use_im_start_end": False, "mm_vision_select_feature": "patch",
    "mm_vision_select_layer": -2, "mm_vision_tower": "openai/clip-vit-large-patch14-336",
    "model_type": "llava", "num_attention_heads": 32, "num_hidden_layers": 2, "num_key_value_heads": 32,
    "pad_token_id": 0, "rms_norm_eps": 1e-05, "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "vocab_size": 32000,
}
CKPT_VISION = "model.vision_tower.vision_tower.vision_model."
# port leaf -> HF key template (linears of the decoder [out, in] as stored)
CKPT_LLAMA_LAYERS = {
    "attn_norm": "input_layernorm", "q": "self_attn.q_proj", "k": "self_attn.k_proj",
    "v": "self_attn.v_proj", "o": "self_attn.o_proj", "mlp_norm": "post_attention_layernorm",
    "gate": "mlp.gate_proj", "up": "mlp.up_proj", "down": "mlp.down_proj",
}
CKPT_VISION_LINEARS = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
                       "o": "self_attn.out_proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}


def checkpoint_state_dict(dev, seed: int) -> dict:
    """An HF-format llava-v1.5-7b state dict with CKPT_CONFIG's 2 decoder
    layers and the whole ViT-L/336 tower, bf16, on the card, from a seed."""
    g = torch.Generator(device=dev).manual_seed(seed)
    D, F, V, L = 4096, 11008, 32000, CKPT_CONFIG["num_hidden_layers"]
    vD, vF, vL, P, n_pos = 1024, 4096, 24, 14, 577

    def w(*shape, one=False):
        x = torch.randn(shape, generator=g, device=dev) * 0.02
        return (x + 1 if one else x).to(torch.bfloat16)

    sd = {"model.embed_tokens.weight": w(V, D), "model.norm.weight": w(D, one=True), "lm_head.weight": w(V, D)}
    shapes = {"q": (D, D), "k": (D, D), "v": (D, D), "o": (D, D), "gate": (F, D), "up": (F, D), "down": (D, F)}
    for i in range(L):
        for leaf, name in CKPT_LLAMA_LAYERS.items():
            key = f"model.layers.{i}.{name}.weight"
            sd[key] = w(D, one=True) if leaf.endswith("norm") else w(*shapes[leaf])
    sd[CKPT_VISION + "embeddings.class_embedding"] = w(vD)
    sd[CKPT_VISION + "embeddings.patch_embedding.weight"] = w(vD, 3, P, P)
    sd[CKPT_VISION + "embeddings.position_embedding.weight"] = w(n_pos, vD)
    for name in ("pre_layrnorm", "post_layernorm"):
        sd[CKPT_VISION + name + ".weight"], sd[CKPT_VISION + name + ".bias"] = w(vD, one=True), w(vD)
    vshapes = {"q": (vD, vD), "k": (vD, vD), "v": (vD, vD), "o": (vD, vD), "fc1": (vF, vD), "fc2": (vD, vF)}
    for i in range(vL):
        p = CKPT_VISION + f"encoder.layers.{i}."
        for leaf, name in CKPT_VISION_LINEARS.items():
            sd[p + name + ".weight"], sd[p + name + ".bias"] = w(*vshapes[leaf]), w(vshapes[leaf][0])
        for name in ("layer_norm1", "layer_norm2"):
            sd[p + name + ".weight"], sd[p + name + ".bias"] = w(vD, one=True), w(vD)
    sd["model.mm_projector.0.weight"], sd["model.mm_projector.0.bias"] = w(D, vD), w(D)
    sd["model.mm_projector.2.weight"], sd["model.mm_projector.2.bias"] = w(D, D), w(D)
    return sd


def checkpoint_leaf_sources(params: dict, sd: dict):
    """(what, loaded leaf, its source under the HF → port mapping) for
    every leaf of the tree: decoder stacks per layer, CLIP kernels
    transposed, the patch conv flattened to [3*P*P, D], projector kernels
    transposed."""
    llama, vision = params["llama"], params["vision"]
    yield "embed", llama["embed"], sd["model.embed_tokens.weight"]
    yield "final_norm", llama["final_norm"], sd["model.norm.weight"]
    yield "lm_head", llama["lm_head"], sd["lm_head.weight"]
    for leaf, name in CKPT_LLAMA_LAYERS.items():
        for i in range(llama["layers"][leaf].shape[0]):
            yield f"layers.{leaf}[{i}]", llama["layers"][leaf][i], sd[f"model.layers.{i}.{name}.weight"]
    conv = sd[CKPT_VISION + "embeddings.patch_embedding.weight"]
    yield "cls", vision["cls"], sd[CKPT_VISION + "embeddings.class_embedding"]
    yield "patch_embed", vision["patch_embed"], conv.reshape(conv.shape[0], -1).t()
    yield "pos_embed", vision["pos_embed"], sd[CKPT_VISION + "embeddings.position_embedding.weight"]
    for leaf, name in (("pre_ln", "pre_layrnorm"), ("post_ln", "post_layernorm")):
        yield f"{leaf}.scale", vision[leaf]["scale"], sd[CKPT_VISION + name + ".weight"]
        yield f"{leaf}.bias", vision[leaf]["bias"], sd[CKPT_VISION + name + ".bias"]
    layers = vision["layers"]
    for i in range(layers["q"]["kernel"].shape[0]):
        p = CKPT_VISION + f"encoder.layers.{i}."
        for leaf, name in CKPT_VISION_LINEARS.items():
            yield f"vision.{leaf}.kernel[{i}]", layers[leaf]["kernel"][i], sd[p + name + ".weight"].t()
            yield f"vision.{leaf}.bias[{i}]", layers[leaf]["bias"][i], sd[p + name + ".bias"]
        for leaf, name in (("ln1", "layer_norm1"), ("ln2", "layer_norm2")):
            yield f"vision.{leaf}.scale[{i}]", layers[leaf]["scale"][i], sd[p + name + ".weight"]
            yield f"vision.{leaf}.bias[{i}]", layers[leaf]["bias"][i], sd[p + name + ".bias"]
    for j, layer in enumerate(params["projector"]["layers"]):
        yield f"projector[{j}].kernel", layer["kernel"], sd[f"model.mm_projector.{2 * j}.weight"].t()
        yield f"projector[{j}].bias", layer["bias"], sd[f"model.mm_projector.{2 * j}.bias"]


def phase_checkpoint(dev, smi: str) -> dict:
    """Write a llava-v1.5-7b-shaped checkpoint dir (CKPT_CONFIG: 2 decoder
    layers, the whole vision tower; weights from a seed, bf16, in two
    pytorch_model-0000{1,2}-of-00002.bin shards under HF key names) to a
    temporary dir; load it with utils.hf_convert.load_llava_checkpoint onto
    the card; hold every leaf exactly against its source tensor; quantize
    the decoder int8 and run one dual-VDD greedy `generate`, which must
    launch K1, K2 and K3."""
    import shutil
    import tempfile

    from llava_align_tpu_torch.decoding.engine import DecodeEngine
    from llava_align_tpu_torch.ops.quant import quantize_llama_params
    from llava_align_tpu_torch.runners.common import MockTokenizer
    from llava_align_tpu_torch.utils import hf_convert

    root = Path(tempfile.mkdtemp(prefix="llava_ckpt_"))
    try:
        sd = checkpoint_state_dict(dev, seed=4)
        n_params = sum(t.numel() for t in sd.values())
        (root / "config.json").write_text(json.dumps(CKPT_CONFIG))
        keys = sorted(sd)
        t0 = time.perf_counter()
        for n, part in enumerate((keys[: len(keys) // 2], keys[len(keys) // 2:]), 1):
            torch.save({k: sd[k].cpu() for k in part}, root / f"pytorch_model-{n:05d}-of-00002.bin")
        log(f"checkpoint: wrote {n_params / 1e9:.3f} G parameters (bf16) as two .bin shards in "
            f"{time.perf_counter() - t0:.2f} s")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, cfg = hf_convert.load_llava_checkpoint(str(root), torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in root.glob("pytorch_model-*.bin"))
        log(f"checkpoint load on {smi}: {nbytes / 1e9:.4f} GB of .bin shards in {secs:.4f} s, "
            f"{nbytes / secs / 1e9:.4f} GB/s (files just written: read from the page cache)")
        n_leaf = 0
        for what, got, want in checkpoint_leaf_sources(params, sd):
            if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
                raise AssertionError(f"checkpoint leaf {what}: not its source tensor "
                                     f"({got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)})")
            n_leaf += 1
        log(f"  {n_leaf} leaves (layers counted one by one) equal their source tensors exactly")
        del sd
        params = dict(params, llama=quantize_llama_params(params["llama"]))
        engine = DecodeEngine(params, cfg, dual_vdd_config())
        ids, image = pope_requests(MockTokenizer(), cfg.vision.image_size)[0]
        reset_launches()
        out = engine.generate(ids, image)
        torch.cuda.synchronize()
        launches = read_launches()
        check_output(out, cfg.text.vocab_size, "checkpoint generate")
        log(f"  int8 dual-VDD generate on the loaded checkpoint: tokens {out.token_ids}, "
            f"{out.seconds_total:.4f} s; launches {launches}")
        require_launches(launches, ("int8_matmul_stacked", "int8_matmul_cuda", "flash_attention"),
                         "generate on the loaded checkpoint")
        del engine, params
        torch.cuda.empty_cache()
        phase_parity_check(root, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


PARITY_TOL = 1e-3  # parity_check's --tol: text logits absolute, vision features relative to their RMS
PARITY_WORDS = ("is", "there", "a", "dog", "in", "the", "image", "please", "answer", "this", "question", "with",
                "one", "word", "user", "assistant", ":", ".", "?")


def phase_parity_check(root: Path, smi: str) -> None:
    """The port's parity CLI (python -m llava_align_tpu_torch.utils.parity_check)
    on the checkpoint dir phase 7b wrote (2 decoder layers at full width, the
    whole ViT-L/336), given a wordpiece tokenizer (vocab.txt) and a seeded
    PNG: the port's text-only last-position logits and its image features
    (encode_images) in fp32 on the card against transformers'
    LlamaForCausalLM and CLIPVisionModel + the projector built from the
    checkpoint's own state dict, in fp32 on the card; it must exit 0 at
    --tol PARITY_TOL."""
    from PIL import Image

    (root / "vocab.txt").write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *PARITY_WORDS]) + "\n")
    (root / "tokenizer_config.json").write_text(json.dumps({"tokenizer_class": "BertTokenizer", "do_lower_case": True}))
    rng = np.random.default_rng(12)
    Image.fromarray(rng.integers(0, 256, (336, 336, 3), dtype=np.uint8)).save(root / "parity.png")
    cmd = [sys.executable, "-m", "llava_align_tpu_torch.utils.parity_check", "--model-path", str(root),
           "--prompt", "Is there a dog in the image?", "--image", str(root / "parity.png"), "--dtype", "float32",
           "--tol", str(PARITY_TOL)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    report = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    log(f"parity_check CLI on the 2-layer full-width checkpoint on {smi} (fp32, TF32 off, against transformers "
        f"on the card): exit {proc.returncode} in {secs:.2f} s; {report}")
    if proc.returncode != 0:
        raise AssertionError(f"parity_check failed (tol {PARITY_TOL}):\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")


MME_CATEGORIES = {"existence": True, "count": False}  # category -> images/ + questions_answers_YN/ layout


def write_mme_files(root) -> tuple:
    """An MME question file (2 categories x 2 images x MME's 2 questions,
    the image files absent) and its MME_Benchmark-shaped ground truth."""
    from llava_align_tpu_torch.runners.common import POPE_OBJECTS

    data = root / "MME_Benchmark"
    lines = []
    for ci, (cat, nested) in enumerate(MME_CATEGORIES.items()):
        qa_dir = data / cat / "questions_answers_YN" if nested else data / cat
        qa_dir.mkdir(parents=True, exist_ok=True)
        if nested:
            (data / cat / "images").mkdir(exist_ok=True)
        for i in range(2):
            name = f"{ci * 2 + i:06d}.png"
            qs = [f"Is there a {POPE_OBJECTS[ci * 2 + i + j]} in this image? Please answer yes or no."
                  for j in range(2)]
            (qa_dir / name.replace(".png", ".txt")).write_text(f"{qs[0]}\tYes\n{qs[1]}\tNo\n")
            lines += [{"question_id": f"{cat}/{name}", "image": f"{cat}/{name}", "text": q, "category": cat}
                      for q in qs]
    qf = root / "llava_mme.jsonl"
    qf.write_text("".join(json.dumps(l) + "\n" for l in lines))
    return qf, data, len(lines)


def phase_mme(model: RunnerModel, root, smi: str, rec: PathRecorder) -> dict:
    """The MME runner (runners/mme.run: the POPE runner without the one-word
    suffix, then the category files and the score; --model-family routes
    Qwen-VL to runners/qwen_pope) on `model`, dual VDD, greedy, 8 new
    tokens, grouped by image (MME's 2 questions per image); model.kernels
    must launch."""
    import io

    from llava_align_tpu_torch.evals.pope import load_jsonl
    from llava_align_tpu_torch.runners import mme

    root.mkdir(parents=True, exist_ok=True)
    qf, data, n_q = write_mme_files(root)
    answers = root / f"{model.tag}_mme" / "answers.jsonl"
    args = mme.build_parser().parse_args([
        *model.args, *model.family, "--question-file", str(qf), "--answers-file", str(answers),
        "--mme-data-root", str(data), *RUNNER_MODES["pope"], "--cd_alpha", "1", "--cd_beta", "0.1",
        "--max_new_tokens", str(NEW_TOKENS), "--temperature", "0", "--synthetic-images"])
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        report, secs, launches, quant_s = timed_run(model, rec, lambda: mme.run(args))
    recs = load_jsonl(str(answers))
    log(f"MME runner {' '.join(model.family)} ({model.what}, dual VDD, grouped by image) on {smi}: "
        f"{rate_text(n_q, secs, quant_s)}; launches {launches}")
    log(f"  answers: {[r['text'] for r in recs]}")
    for line in printed.getvalue().splitlines():
        log(f"  score: {line}")
    if len(recs) != n_q or sorted(report.get("Perception", {}).get("tasks", {})) != sorted(MME_CATEGORIES):
        raise AssertionError(f"MME {model.tag}: {len(recs)} answers, report {report}")
    require_launches(launches, model.kernels, f"the MME runner, {model.tag}")
    torch.cuda.empty_cache()
    return launches


MMMU_SAMPLES = [
    {"id": "validation_Math_1", "subject": "Math", "question_type": "multiple-choice", "answer": "B",
     "all_choices": ["A", "B", "C", "D"], "index2ans": {"A": "1", "B": "2", "C": "3", "D": "4"},
     "final_input_prompt": "<image 1> How many dots are there?\n(A) 1\n(B) 2\n(C) 3\n(D) 4\n"
                           "Answer with the option's letter from the given choices directly.", "image": "m1.png"},
    {"id": "validation_Math_2", "subject": "Math", "question_type": "open", "answer": "42",
     "final_input_prompt": "<image 1> What is six times seven?\nAnswer the question using a single word "
                           "or phrase.", "image": "m2.png"},
    {"id": "validation_Art_1", "subject": "Art", "question_type": "multiple-choice", "answer": "C",
     "all_choices": ["A", "B", "C"], "index2ans": {"A": "oil", "B": "ink", "C": "tempera"},
     "final_input_prompt": "<image 1> Which medium was used?\n(A) oil\n(B) ink\n(C) tempera\n"
                           "Answer with the option's letter from the given choices directly.", "image": "a1.png"},
    {"id": "validation_Art_2", "subject": "Art", "question_type": "open", "answer": ["blue", "azure"],
     "final_input_prompt": "<image 1> What colour is the sky?\nAnswer the question using a single word "
                           "or phrase.", "image": "a2.png"},
]


def phase_mmmu(model: RunnerModel, root, smi: str, rec: PathRecorder) -> dict:
    """The MMMU runner's command line (runners/mmmu.main: run, then score
    with the none_unk setting and print the table; --model-family routes
    Qwen-VL to its run_qwen) on `model`, 4 samples written here (multiple
    choice and open), dual VDD, greedy, 8 new tokens, --calibrate;
    model.kernels must launch."""
    import io

    from llava_align_tpu_torch.evals.pope import load_jsonl
    from llava_align_tpu_torch.runners import mmmu

    root.mkdir(parents=True, exist_ok=True)
    qf, answers = root / "mmmu_val.jsonl", root / f"{model.tag}_mmmu_answers.jsonl"
    qf.write_text("".join(json.dumps(x) + "\n" for x in MMMU_SAMPLES))
    argv = [*model.args, *model.family, "--question-file", str(qf), "--answers-file", str(answers),
            *RUNNER_MODES["pope"], "--cd_alpha", "1", "--cd_beta", "0.1", "--max_new_tokens", str(NEW_TOKENS),
            "--temperature", "0", "--synthetic-images", "--calibrate", "--score-setting", "none_unk",
            "--print-table"]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc, secs, launches, quant_s = timed_run(model, rec, lambda: mmmu.main(argv))
    recs = load_jsonl(str(answers))
    n_q = len(MMMU_SAMPLES)
    log(f"MMMU runner {' '.join(model.family)} ({model.what}, dual VDD, --calibrate) on {smi}: "
        f"{rate_text(n_q, secs, quant_s)}, scoring included; launches {launches}")
    log(f"  answers: {[r['text'] for r in recs]}")
    for line in printed.getvalue().splitlines():
        log(f"  score: {line}")
    probes = [r["question_id"] for r in recs if r["all_choices"] and not (r.get("none") and r.get("unk"))]
    if rc != 0 or len(recs) != n_q or probes or "Overall" not in printed.getvalue():
        raise AssertionError(f"MMMU {model.tag}: rc {rc}, {len(recs)} answers, records without probes {probes}")
    require_launches(launches, model.kernels, f"the MMMU runner, {model.tag}")
    torch.cuda.empty_cache()
    return launches


def phase_grouped(dev, shapes) -> dict:
    """LLaVA-v1.5-13B int4, dual-branch VDD, through the grouped entry points."""
    from llava_align_tpu_torch.decoding.engine import DecodeEngine
    from llava_align_tpu_torch.runners.common import load_model
    from llava_align_tpu_torch.runners.common import pope_groups

    t0 = time.perf_counter()
    lm = load_model("random:13b", quant="int4", device=dev, seed=0)
    torch.cuda.synchronize()
    log(f"13B grouped path: built random LLaVA-v1.5-13B int4 (group 128) on {dev} in "
        f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    engine = DecodeEngine(lm.params, lm.cfg, dual_vdd_config())
    V = lm.cfg.text.vocab_size
    calls = [pope_groups(lm.tokenizer, lm.cfg.vision.image_size, GROUPS, seed=1 + c)
             for c in range(GROUP_CALLS)]
    prefix, suffixes, _ = calls[0][0]
    log(f"  POPE split: prefix {len(prefix)} ids (bucket {shapes['pad_prefix']} with the image), "
        f"suffixes {[len(s) for s in suffixes]} ids (bucket {shapes['pad_suf']}), text prefixes "
        f"bucket {shapes['pad_txt']}")

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    outs = engine.generate_batch_prefix(*calls[0][0])
    torch.cuda.synchronize()
    one = time.perf_counter() - t1
    for q, out in enumerate(outs):
        check_output(out, V, f"generate_batch_prefix question {q}")
    at_g1 = read_launches()
    log(f"  generate_batch_prefix (1 image x 6 questions, includes warm-up): {one:.4f} s, "
        f"{6 / one:.2f} questions/s, first tokens {[o.token_ids[:3] for o in outs[:2]]}; "
        f"launches {at_g1}")

    # the first G = 4 call through generate_batch_groups (it warms up), the
    # rest through submit_batch_groups / collect_batch_groups in the POPE
    # runner's order (submit g+1 before collecting g); the port's submit
    # runs the whole call, so the loop is sequential
    t1 = time.perf_counter()
    outs = engine.generate_batch_groups(calls[0])
    per_call, n_q = [outs[0].seconds_total], len(outs)
    for q, out in enumerate(outs):
        check_output(out, V, f"generate_batch_groups question {q}")
    log(f"  grouped call 0, generate_batch_groups (warm-up, G={GROUPS} x 6 questions): "
        f"prefill+first token {outs[0].seconds_to_first_token:.4f} s, call {outs[0].seconds_total:.4f} s")
    handle = engine.submit_batch_groups(calls[1])
    for c in range(2, GROUP_CALLS + 1):
        nxt = engine.submit_batch_groups(calls[c]) if c < GROUP_CALLS else None
        outs = engine.collect_batch_groups(handle)
        for q, out in enumerate(outs):
            check_output(out, V, f"grouped call {c - 1} question {q}")
        n_q += len(outs)
        per_call.append(outs[0].seconds_total)
        log(f"  grouped call {c - 1}, submit/collect (G={GROUPS} x 6 questions): "
            f"prefill+first token {outs[0].seconds_to_first_token:.4f} s, call {outs[0].seconds_total:.4f} s")
        handle = nxt
    torch.cuda.synchronize()
    loop = time.perf_counter() - t1
    launches = read_launches()
    at_g4 = {n: launches[n] - at_g1[n] for n in launches}
    peak = torch.cuda.max_memory_allocated()
    steady = float(np.mean(per_call[1:]))
    log(f"  launches during the 13B grouped path: {launches} (the G = 4 calls alone: {at_g4})")
    log(f"  G={GROUPS} calls: {GROUP_CALLS}, {n_q} questions in {loop:.4f} s "
        f"({n_q / loop:.2f} questions/s with the warm-up call); steady calls (1..{GROUP_CALLS - 1}) "
        f"{steady:.4f} s per call, {GROUPS * 6 / steady:.2f} questions/s; peak memory "
        f"{peak / 2**30:.2f} GiB")
    for what, counts in (("G = 1 call", at_g1), ("G = 4 calls", at_g4)):
        require_launches(counts, ("int4_matmul_stacked", "int8_matmul_cuda", "flash_attention"),
                         f"the 13B grouped path's {what}")
    del engine, lm
    torch.cuda.empty_cache()
    return launches


def phase_grouped_reference(dev) -> None:
    """13B int4 at full width cut to 2 decoder / 2 vision layers: the
    grouped path's first-step fused scores on the card against the fp32 CPU
    run of the same params (plain versions), and against `generate` on the
    card for the same question. Scores are compared where both are finite
    (the plausibility cutoff may differ for tokens right at it)."""
    from llava_align_tpu_torch.config import LlavaConfig
    from llava_align_tpu_torch.decoding.engine import DecodeEngine
    from llava_align_tpu_torch.runners.common import MockTokenizer, pope_groups
    from llava_align_tpu_torch.utils.synthetic import build_random_llava_params

    cfg = cut_config(LlavaConfig.llava_v15_13b())
    cfg32 = cut_config(LlavaConfig.llava_v15_13b(), torch.float32)
    params = build_random_llava_params(cfg, quant="int4", device=dev, seed=2)
    params_cpu = to_fp32(params)
    prefix, suffixes, image = pope_groups(MockTokenizer(), cfg.vision.image_size, 1, seed=7)[0]
    group = [(prefix, suffixes[:2], image)]
    gen = dataclasses.replace(dual_vdd_config(), max_new_tokens=1)

    with torch.inference_mode():
        card = DecodeEngine(params, cfg, gen)
        got = card.submit_batch_groups(group)["first_scores"].float().cpu()
        single = card.submit_generate(prefix + suffixes[0], image)["first_scores"].float().cpu()
        want = DecodeEngine(params_cpu, cfg32, gen).submit_batch_groups(group)["first_scores"]

    finite_check(got, want, "13B grouped reference: grouped card vs cpu fp32, first-step fused scores")
    finite_check(got[0], single, "13B grouped reference: grouped vs generate on the card, question 0")
    del params, params_cpu
    torch.cuda.empty_cache()


def load_qwen_7b(dev):
    """Random Qwen-VL-7B in bf16 at full width and depth, as the Qwen
    runners' load_qwen_model would hand a checkpoint's tree over."""
    from llava_align_tpu_torch.models.qwen_vl import QwenVLConfig
    from llava_align_tpu_torch.runners.pope import _tensors
    from llava_align_tpu_torch.utils.synthetic import build_random_qwen_vl_params

    cfg = QwenVLConfig.qwen_vl_7b()
    t0 = time.perf_counter()
    params = build_random_qwen_vl_params(cfg, quant="none", device=dev, seed=0)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _tensors(params))
    log(f"Qwen-VL path: built random Qwen-VL-7B bf16 ({n / 1e9:.3f} G parameters: 32 decoder layers, "
        f"48 ViT layers at {cfg.vision.image_size} px, {cfg.vision.n_queries} queries) on {dev} in "
        f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return params, cfg


def qwen_runner_model(params, cfg) -> tuple:
    """What the Qwen runners' load_qwen_model returns for the given tree:
    the mock tokenizer, its EOS id out of the vocabulary (every answer runs
    its full length)."""
    from llava_align_tpu_torch.runners.qwen_pope import QwenMockTokenizer

    class Tokenizer(QwenMockTokenizer):
        eod_id = 10**9

    return Tokenizer(), params, cfg, "random-qwen-vl-7b"


QWEN_LONG_TOKENS = 2100  # a text prompt whose cache (2112 + 2) passes seq_length 2048


def phase_qwen_reference(dev) -> None:
    """Qwen-VL-7B at full width cut to 2 decoder / 2 vision layers, int8, a
    nonzero c_attn_b: the prefill and two decode steps' logits of an image
    prompt, and of a QWEN_LONG_TOKENS-token text prompt at the NTK alpha of
    its cache length (past seq_length: alpha > 1, log-n above 1 past
    position 2048), on the card against the same params in fp32 on the CPU."""
    from llava_align_tpu_torch.models import qwen, qwen_vl
    from llava_align_tpu_torch.models.llava import plan_splice, splice
    from llava_align_tpu_torch.utils.synthetic import build_random_qwen_vl_params

    full = qwen_vl.QwenVLConfig.qwen_vl_7b()

    def cut(dtype=None):
        kw = {"dtype": dtype} if dtype else {}
        return dataclasses.replace(full, text=dataclasses.replace(full.text, num_layers=2, **kw),
                                   vision=dataclasses.replace(full.vision, num_layers=2, **kw))

    params = build_random_qwen_vl_params(cut(), quant="int8", device=dev, seed=5)
    b = params["qwen"]["layers"]["c_attn_b"]
    b.copy_(torch.randn(b.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(6)) * 0.5)
    params_cpu = to_fp32(params)
    rng = np.random.default_rng(8)
    span, _ = qwen_vl.sentinelize_span(qwen_vl.make_image_span_ids(full), full)
    H = full.vision.image_size
    image = rng.standard_normal((1, 3, H, H)).astype(np.float32)
    prompts = {"image prompt": span + [int(t) for t in rng.integers(3, 150000, 12)],
               f"{QWEN_LONG_TOKENS}-token text prompt": [int(t) for t in rng.integers(3, 150000, QWEN_LONG_TOKENS)]}
    steps = (1234, 98765)  # fixed next tokens, so both sides decode the same sequence

    @torch.inference_mode()
    def run(p, c, ids, device):
        n_img = c.vision.n_queries if any(t < 0 for t in ids) else 0
        plan = plan_splice(ids, n_img, -(-(len(ids) - 1 + n_img) // 64) * 64)
        feats = (qwen_vl.encode_images(p, c, torch.from_numpy(image).to(device)) if n_img
                 else torch.zeros((1, 1, c.text.hidden_size), dtype=c.text.dtype, device=device))
        t = {k: torch.from_numpy(np.asarray(getattr(plan, k)))[None].to(device)
             for k in ("tokens", "tok_gather", "img_gather", "is_image")}
        embeds = splice(qwen.embed_tokens(p["qwen"], t["tokens"]), t["tok_gather"], t["img_gather"],
                        t["is_image"], feats)
        S = embeds.shape[1]
        cache_len = S + len(steps)
        alpha = qwen.ntk_alpha_for_len(c.text, cache_len)
        cache = qwen.init_cache(c.text, 1, cache_len, device=device)
        zero = torch.zeros((1,), dtype=torch.long, device=device)
        hidden, _ = qwen.forward(p["qwen"], c.text, embeds, torch.arange(S, device=device)[None], cache, zero,
                                 ntk_alpha=alpha)
        out = [qwen.logits_from_hidden(p["qwen"], hidden[:, plan.length - 1])]
        for i, tok in enumerate(steps):
            pos = zero + plan.length + i
            emb = qwen.embed_tokens(p["qwen"], torch.full((1, 1), tok, device=device))
            hidden, _ = qwen.forward(p["qwen"], c.text, emb, pos[:, None], cache, pos, ntk_alpha=alpha)
            out.append(qwen.logits_from_hidden(p["qwen"], hidden[:, 0]))
        return alpha, [o.float().cpu() for o in out]

    for what, ids in prompts.items():
        alpha, got = run(params, cut(), ids, dev)
        _, ref = run(params_cpu, cut(torch.float32), ids, torch.device("cpu"))
        log(f"Qwen-VL reference, {what}: {len(ids)} ids, NTK alpha {alpha}")
        if ("text" in what) != (alpha > 1):
            raise AssertionError(f"{what}: NTK alpha {alpha} (the long prompt must pass seq_length)")
        for name, g, r in zip(("prefill", "decode 1", "decode 2"), got, ref):
            rel_check(g, r, f"Qwen-VL reference, {what}, {name}: max|card - cpu fp32| / max|cpu|")
    del params, params_cpu
    torch.cuda.empty_cache()


BLIP_CAPTION_IMAGES = 4  # synthetic images of the caption phase


def load_blip_7b(dev):
    """Random InstructBLIP-Vicuna-7B in bf16 at full width and depth
    (EVA-ViT-g: 39 layers at 224 px; the 12-layer Q-Former, 32 queries;
    Vicuna-7B: 32 layers), built by instructblip.init on the card, as the
    BLIP runners' load_blip_model would hand a checkpoint's tree over."""
    from llava_align_tpu_torch.models import instructblip
    from llava_align_tpu_torch.runners.pope import _tensors

    cfg = instructblip.InstructBlipConfig.vicuna7b()
    t0 = time.perf_counter()
    params = instructblip.init(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n = {part: sum(t.numel() for t in _tensors(params[part])) for part in params}
    log(f"InstructBLIP path: built random InstructBLIP-Vicuna-7B bf16 ({sum(n.values()) / 1e9:.3f} G parameters: "
        f"EVA-ViT-g {n['visual'] / 1e9:.3f} G ({cfg.vision.num_layers} layers at {cfg.vision.image_size} px), "
        f"Q-Former {n['qformer'] / 1e9:.3f} G ({cfg.qformer.num_layers} layers, {cfg.num_query_tokens} queries), "
        f"Vicuna-7B {n['llama'] / 1e9:.3f} G ({cfg.text.num_layers} layers)) on {dev} in "
        f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return params, cfg


def blip_runner_models(params, cfg) -> tuple:
    """RunnerModels of the BLIP runners for the given tree, with the mock
    tokenizer on the Vicuna and the BERT side (EOS 2, the runners' own: a
    random tree may stop early): the POPE runner's (one layout, the
    naive/none/noise dumps) and the caption runner's (its own loader)."""
    from llava_align_tpu_torch.runners import blip_pope, caption
    from llava_align_tpu_torch.runners.common import MockTokenizer

    pope_model = RunnerModel(
        "blip", "InstructBLIP-Vicuna-7B bf16", (blip_pope, "load_blip_model"),
        (MockTokenizer(), MockTokenizer(), params, cfg, "random-instructblip-vicuna7b"),
        ("--model-path", "random:instructblip-vicuna7b"), pope=blip_pope, kernels=("flash_attention",),
        layouts={"single": []}, dumps=("naive", "none", "noise"), settings=("naive", "none", "noise", "none_noise"))
    return pope_model, dataclasses.replace(pope_model, loader=(caption, "load_blip_model"))


@contextlib.contextmanager
def generated_tokens():
    """Within `with`, the list of the tokens each answer generated: every
    DecodeEngine.collect_generate of an engine that decodes more than one
    token (the scoring calls decode one), every generate_beam."""
    from llava_align_tpu_torch.decoding.engine import DecodeEngine

    counts = []
    collect, beam = DecodeEngine.collect_generate, DecodeEngine.generate_beam

    def counted_collect(self, handle):
        out = collect(self, handle)
        if self.gen.max_new_tokens > 1:
            counts.append(out.num_generated)
        return out

    def counted_beam(self, *a, **k):
        out = beam(self, *a, **k)
        counts.append(out.num_generated)
        return out

    with patched(DecodeEngine, "collect_generate", counted_collect), \
            patched(DecodeEngine, "generate_beam", counted_beam):
        yield counts


@contextlib.contextmanager
def captured_beams():
    """Within `with`, a list of every generate_beam call's (input_ids,
    precomputed_feats, eos id, length_penalty, the beam fn's final
    hypotheses: decoding/beam.make_beam_fn's fn.hypotheses)."""
    from llava_align_tpu_torch.decoding import engine as engine_mod

    calls, fns = [], []
    make, beam = engine_mod.make_beam_fn, engine_mod.DecodeEngine.generate_beam

    def kept_make(*a, **k):
        fns.append(make(*a, **k))
        return fns[-1]

    def recorded_beam(self, input_ids, image=None, **k):
        out = beam(self, input_ids, image, **k)
        seqs, lens, scores = (t.cpu() for t in fns[-1].hypotheses)
        calls.append(dict(ids=list(input_ids), feats=k.get("precomputed_feats"), eos=self.gen.eos_token_id,
                          length_penalty=k.get("length_penalty", 1.0), seqs=seqs, lens=lens, scores=scores,
                          best=out.token_ids))
        return out

    with patched(engine_mod, "make_beam_fn", kept_make), patched(engine_mod.DecodeEngine, "generate_beam", recorded_beam):
        yield calls


BEAM_TIE_TOL = 0.05  # nats a token: two hypotheses' fp32 scores this close may swap under bf16


@torch.inference_mode()
def phase_beam_rescore(params, cfg, calls, dev, smi: str) -> None:
    """Queue 3 check 1: every hypothesis each bf16 beam search of the
    caption run ended with (the finished ones and, where the search ran to
    its length, the running ones) re-scored in fp32 on the card by one
    teacher-forced pass of the same Vicuna weights in fp32 over the same
    query features: its summed log-probability (the finished ones' eos
    included), normalized as the beam normalizes it (length + 1 for a
    finished one, length for a running one, to length_penalty). The fp32
    order must be the bf16 order, except between two hypotheses whose fp32
    scores lie within BEAM_TIE_TOL; every gap is printed."""
    from llava_align_tpu_torch.decoding.adapters import InstructBlipAdapter
    from llava_align_tpu_torch.decoding.beam import NEG

    cfg32 = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, dtype=torch.float32))
    p32 = {"llama": to_fp32(params["llama"], dev)}
    adapter = InstructBlipAdapter(cfg32)
    K = len(calls[0]["scores"]) // 2
    worst = 0.0
    for i, c in enumerate(calls):
        feats = c["feats"][:1].to(dev, torch.float32)
        hyps = []
        for j in range(2 * K):
            score = float(c["scores"][j])
            if score <= NEG / 2:
                continue
            n = int(c["lens"][j])
            toks = c["seqs"][j, :n].tolist() + ([c["eos"]] if j < K else [])
            norm = max(len(toks), 1) ** c["length_penalty"]
            hyps.append((score, blip_seq_logprob(adapter, p32, cfg32, c["ids"], feats, toks, dev) / norm, j))
        hyps.sort(key=lambda h: -h[0])  # the bf16 order: the one returned first
        fp32 = [h[1] for h in hyps]
        gaps = [fp32[a] - fp32[a + 1] for a in range(len(fp32) - 1)]
        swapped = [(a, b) for a in range(len(hyps)) for b in range(a + 1, len(hyps)) if fp32[b] > fp32[a]]
        bad = [(a, b) for a, b in swapped if fp32[b] - fp32[a] > BEAM_TIE_TOL]
        worst = max([worst] + [fp32[b] - fp32[a] for a, b in swapped])
        log(f"bf16 beams, caption {i}: {len(hyps)} hypotheses (slots {[h[2] for h in hyps]}), bf16 scores "
            f"{[round(h[0], 4) for h in hyps]}, fp32 {[round(x, 4) for x in fp32]}; fp32 gaps between neighbours "
            f"in the bf16 order {[round(x, 4) for x in gaps]}; pairs the fp32 scores order the other way "
            f"{swapped} (tie tol {BEAM_TIE_TOL})")
        if bad:
            raise AssertionError(f"bf16 beams, caption {i}: fp32 reorders {bad} beyond the tie tolerance")
        if hyps and c["best"] != c["seqs"][hyps[0][2], :int(c["lens"][hyps[0][2]])].tolist():
            raise AssertionError(f"bf16 beams, caption {i}: the returned caption is not the best-scored hypothesis")
    log(f"bf16 beams on {smi}: {len(calls)} captions' hypotheses re-scored in fp32: the order holds, the largest "
        f"reversal {worst:.4g} nats a token (tie tol {BEAM_TIE_TOL})")
    del p32
    torch.cuda.empty_cache()


def phase_caption(model: RunnerModel, root, smi: str, rec: PathRecorder) -> tuple:
    """The caption runner (runners/caption.run: CaptionTask, 5-beam
    generate_beam) at its defaults (5 beams, max_len 30, min_len 8) on
    BLIP_CAPTION_IMAGES synthetic images; val_epoch0.json must hold one
    non-empty caption per image, and K3 must launch. Returns (launches,
    each beam search's inputs and final hypotheses: captured_beams)."""
    import io

    from llava_align_tpu_torch.runners import caption

    root.mkdir(parents=True, exist_ok=True)
    qf, result_dir = root / "smoke_captions.jsonl", root / "blip_captions"
    qf.write_text("".join(json.dumps({"image": f"COCO_val2014_{100 + i:012d}.jpg", "image_id": i + 1}) + "\n"
                          for i in range(BLIP_CAPTION_IMAGES)))
    args = caption.build_parser().parse_args([*model.args, "--question-file", str(qf), "--result-dir",
                                              str(result_dir), "--synthetic-images"])
    with contextlib.redirect_stdout(io.StringIO()), generated_tokens() as counts, captured_beams() as beams:
        _, secs, launches, _ = timed_run(model, rec, lambda: caption.run(args))
    caps = json.loads((result_dir / "val_epoch0.json").read_text())
    n = BLIP_CAPTION_IMAGES
    log(f"caption runner ({model.what}, {args.num_beams} beams, max_len {args.max_len}, min_len {args.min_len}) "
        f"on {smi}: {n} captions in {secs:.4f} s, {n / secs:.4f} captions/s; tokens per caption {counts}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}")
    log(f"  captions: {[c['caption'] for c in caps]}")
    if [c["image_id"] for c in caps] != list(range(1, n + 1)) or not all(c["caption"] for c in caps):
        raise AssertionError(f"caption runner: {caps}")
    require_launches(launches, model.kernels, "the caption runner")
    torch.cuda.empty_cache()
    return launches, beams


def phase_blip_split(params, cfg, dev, smi: str) -> None:
    """Where an InstructBLIP answer's time goes, on the bf16 tree: the
    EVA-ViT-g forward of one 224-px image, the Q-Former's (32 queries, a
    96-id instruction: the POPE prompts' bucket), a whole encode, one decode
    step (llama.forward of one token and the lm_head) at the POPE runner's
    2 rows (main, cd; cache 136) and the caption runner's 5 beams (cache
    94), and the beam's own work a step (the top 2K of 5 x 32000 scores by
    a stable sort; the cache rows' reorder). Each the mean of 5 calls by
    CUDA events, eager, so the host's launch gaps count as they do in the
    runners. The decode step's bound: its bf16 weights read once."""
    from llava_align_tpu_torch.decoding import beam
    from llava_align_tpu_torch.models import eva_vit, instructblip, llama, qformer

    g = torch.Generator(device=dev).manual_seed(13)
    image = torch.randn((1, 3, cfg.vision.image_size, cfg.vision.image_size), generator=g, device=dev)
    tid = torch.randint(3, 259, (1, 96), generator=g, device=dev)
    tmask = torch.ones_like(tid)
    times = {}
    with torch.inference_mode():
        feats = eva_vit.forward(params["visual"], cfg.vision, image).to(cfg.qformer.dtype)
        queries = params["query_tokens"][None]
        times["EVA-ViT-g forward"] = cuda_ms(lambda _: eva_vit.forward(params["visual"], cfg.vision, image), 5)
        times["Q-Former forward"] = cuda_ms(
            lambda _: qformer.forward(params["qformer"], cfg.qformer, queries, feats, tid, tmask), 5)
        times["encode (both, ln_vision, llm_proj)"] = cuda_ms(
            lambda _: instructblip.encode(params, cfg, image, tid, tmask), 5)
        for rows, S in ((2, 136), (5, 94)):
            cache = llama.init_cache(cfg.text, rows, S, device=dev)
            pos = torch.full((rows,), S - 2, device=dev)
            emb = llama.embed_tokens(params["llama"], torch.full((rows, 1), 100, device=dev))

            def step(_):
                hidden, _ = llama.forward(params["llama"], cfg.text, emb, pos[:, None], cache, pos)
                return llama.logits_from_hidden(params["llama"], hidden[:, 0])

            times[f"decode step, {rows} rows"] = cuda_ms(step, 5)
        scores = torch.randn((5 * cfg.text.vocab_size,), generator=g, device=dev)
        times["beam top 2K (a stable sort of 5 x 32000)"] = cuda_ms(lambda _: beam._top(scores, 10), 5)
        parents = torch.tensor([0, 0, 1, 2, 4], device=dev)
        times["beam cache reorder (5 rows x 94 positions)"] = cuda_ms(lambda _: beam._gather_cache(cache, parents), 5)
    layer_bytes = sum(t.numel() * t.element_size() for t in params["llama"]["layers"].values())
    step_bound = (layer_bytes + params["llama"]["lm_head"].numel() * 2) / PEAK_BYTES_PER_S * 1e3
    log(f"InstructBLIP split on {smi} (ms per call, CUDA events over 5 eager calls): "
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
        + f"; a decode step's bound {step_bound:.4f} ms (bytes: the bf16 decoder weights and lm_head read once)")
    torch.cuda.empty_cache()


def blip_cut(full, dtype=None):
    """full width, 2 EVA layers, 2 Q-Former layers (one with
    cross-attention), 2 decoder layers."""
    kw = {"dtype": dtype} if dtype else {}
    return dataclasses.replace(full, **{part: dataclasses.replace(getattr(full, part), num_layers=2, **kw)
                                        for part in ("vision", "qformer", "text")})


def blip_seq_logprob(adapter, p, c, ids, feats, toks, device) -> float:
    """The summed log-probability of `toks` after the prompt `ids` (with
    features `feats`) under the model behind `adapter` (InstructBLIP's or
    BLIP-2 OPT's): one teacher-forced prefill."""
    from llava_align_tpu_torch.models.llava import plan_splice

    plan = plan_splice(list(ids) + list(toks), c.num_query_tokens, len(ids) + len(toks) - 1 + c.num_query_tokens)
    t = [torch.from_numpy(np.asarray(getattr(plan, k)))[None].to(device)
         for k in ("tokens", "tok_gather", "img_gather", "is_image")]
    embeds = adapter.splice_embeds(p, *t, feats)
    S = embeds.shape[1]
    hidden, _ = adapter.forward(p, embeds, torch.arange(S, device=device)[None], None, None, max_seq_len=S)
    first = plan.length - len(toks) - 1  # the position whose logits give toks[0]
    logp = torch.log_softmax(adapter.logits(p, hidden[0, first: plan.length - 1]), dim=-1)
    return logp[torch.arange(len(toks)), torch.tensor(toks)].sum().item()


def phase_blip_reference(dev) -> None:
    """InstructBLIP-Vicuna-7B at full width cut by blip_cut, bf16: encode's
    output (a padded instruction), a prompt's prefill logits and two decode
    steps' logits on the card against the same params in fp32 on the CPU,
    at REFERENCE_TOL; then a 5-beam generate_beam of 8 tokens with the cut
    in fp32 on the card and on the CPU, over the fp32 cache and over the
    int8 one: whether the tokens agree, and where they part, the gap
    between the two prefixes' log-probabilities under the fp32 CPU model
    (how near a tie the card broke the other way)."""
    from llava_align_tpu_torch.config import GenerationConfig
    from llava_align_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from llava_align_tpu_torch.decoding.adapters import InstructBlipAdapter
    from llava_align_tpu_torch.decoding.engine import DecodeEngine
    from llava_align_tpu_torch.models import instructblip
    from llava_align_tpu_torch.models.llava import plan_splice
    from llava_align_tpu_torch.runners.blip_pope import qformer_text
    from llava_align_tpu_torch.runners.common import MockTokenizer

    full = instructblip.InstructBlipConfig.vicuna7b()
    cpu = torch.device("cpu")
    params = instructblip.init(blip_cut(full), device=dev, seed=11)
    params_cpu = to_fp32(params)
    rng = np.random.default_rng(12)
    H = full.vision.image_size
    image = torch.from_numpy(rng.standard_normal((1, 3, H, H)).astype(np.float32))
    prompt = "Is there a dining table in the image? Please answer this question with one word."
    tid, tmask = (torch.from_numpy(a) for a in qformer_text(MockTokenizer(), prompt, full))
    ids = [IMAGE_TOKEN_INDEX] + MockTokenizer()(prompt).input_ids
    Q = full.num_query_tokens
    plan = plan_splice(ids, Q, -(-(len(ids) - 1 + Q) // 32) * 32)
    steps = (29871, 3869)  # fixed next tokens, so both sides decode the same sequence

    @torch.inference_mode()
    def run(p, c, device):
        feats = instructblip.encode(p, c, image.to(device, c.vision.dtype), tid.to(device), tmask.to(device))
        t = [torch.from_numpy(np.asarray(getattr(plan, k)))[None].to(device)
             for k in ("tokens", "tok_gather", "img_gather", "is_image")]
        embeds = InstructBlipAdapter(c).splice_embeds(p, *t, feats)
        return [feats.float().cpu()] + llama_logits_steps(p["llama"], c.text, embeds, plan.length, steps, device)

    launches = read_launches()["flash_attention"]
    got, ref = run(params, blip_cut(full), dev), run(params_cpu, blip_cut(full, torch.float32), cpu)
    if read_launches()["flash_attention"] <= launches:
        raise AssertionError("the InstructBLIP reference's prefill did not launch K3")
    for name, g, r in zip(("encode", "prefill", "decode 1", "decode 2"), got, ref):
        rel_check(g, r, f"InstructBLIP reference {name}: max|card - cpu fp32| / max|cpu|")

    # the beams in fp32 on both sides (K3 fp32 on the card's CUDA cores),
    # over the fp32 cache and over the int8 one (the beams reorder its
    # scale planes with the values)
    del params
    torch.cuda.empty_cache()
    cfg32 = blip_cut(full, torch.float32)
    gen = GenerationConfig(max_new_tokens=8, do_sample=False, eos_token_id=2, pad_token_id=0)
    params_card = to_fp32(params_cpu, dev)
    for cache, kv_quant in (("fp32", None), ("int8", "int8")):
        beams, feats = {}, {}
        with torch.inference_mode():
            for side, p, device in (("card", params_card, dev), ("cpu", params_cpu, cpu)):
                feats[side] = instructblip.encode(p, cfg32, image.to(device), tid.to(device), tmask.to(device))
                engine = DecodeEngine(p, cfg32, gen, adapter=InstructBlipAdapter(cfg32), bucket=32,
                                      kv_quant=kv_quant)
                beams[side] = engine.generate_beam(ids, num_beams=5, precomputed_feats=feats[side]).token_ids
        a, b = beams["card"], beams["cpu"]
        log(f"InstructBLIP reference, 5-beam generate_beam of 8 tokens, fp32, {cache} cache: card {a}, cpu {b}")
        if a == b:
            log(f"  the card's and the CPU's beams over the {cache} cache agree token for token")
        else:
            k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
            lp = {side: blip_seq_logprob(InstructBlipAdapter(cfg32), params_cpu, cfg32, ids, feats["cpu"], seq[: k + 1],
                                         cpu)
                  for side, seq in (("card", a), ("cpu", b))}
            log(f"  the beams part at step {k}: log-probabilities of the prefixes to it under the fp32 CPU model "
                f"card {lp['card']:.6f}, cpu {lp['cpu']:.6f}, gap {lp['cpu'] - lp['card']:.3g}")
    del params_cpu, params_card
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the opt-in serving modes (W8A8 and the int8 KV cache) and LLaVA's last
# runners (the sampling sweep, the bias probe)
# ---------------------------------------------------------------------------

W8A8_ROWS = (128, 256, 640, 3072)  # the JAX rule's crossover (256) on both sides, a prefill's 640 and 3072


def phase_w8a8_product(smi: str) -> dict:
    """The W8A8 product (ops/quant.int8_matmul_w8a8: the activations'
    quantization and the fp32 epilogue in PyTorch around torch._int_mm, no
    TPU kernel behind it) on one 7B layer's four int8 stacks, bf16 rows,
    at W8A8_ROWS: its codes and its output on the card against the same
    call on the CPU (the o stack at 256 rows; exact codes, the product
    within KERNEL_TOL), then timed beside what the dispatch runs there
    without act_quant (K1's tiled regime on the O >= D stacks up to 640
    rows, else the dequant path), the dequant path alone and cuBLAS bf16
    (torch.matmul on a weight dequantized beforehand). Returns the layer's
    sums by rows."""
    from llava_align_tpu_torch.ops import quant
    from llava_align_tpu_torch.scripts._common import SHAPES_7B, matmul_work

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(13)
    stacks = {}
    for name, (O, D) in SHAPES_7B.items():
        q = torch.randint(-127, 128, (2, O, D), dtype=torch.int8, device=dev, generator=g)
        s = (torch.rand((2, O), device=dev, generator=g) + 0.5) / (127.0 * D**0.5)
        stacks[name] = (q, s, quant.dequantize({"q": q[1], "s": s[1]}, torch.bfloat16))
    q, s, _ = stacks["o"]
    h = torch.randn((256, q.shape[2]), device=dev, generator=g).to(torch.bfloat16)
    hf = h.float()
    a_dev = quant.w8a8_row_scale(hf.abs().amax(-1, keepdim=True))
    a_cpu = quant.w8a8_row_scale(hf.cpu().abs().amax(-1, keepdim=True))
    if not (torch.equal(a_dev.cpu(), a_cpu) and torch.equal(quant.w8a8_quantize(hf, a_dev).cpu(),
                                                            quant.w8a8_quantize(hf.cpu(), a_cpu))):
        raise AssertionError("W8A8: the card's row scales or int8 codes differ from the CPU's")
    compare(quant.int8_matmul_w8a8(h, q[1], s[1]).cpu(),
            quant.int8_matmul_w8a8(h.cpu(), q[1].cpu(), s[1].cpu()), "W8A8 o [4096, 4096] B=256, card vs CPU")
    log(f"W8A8 product vs the dispatch's path without act_quant, K1 tiled, dequant and cuBLAS bf16, "
        f"one 7B layer, on {smi}")
    table = {}
    for B in W8A8_ROWS:
        h = torch.randn((B, 11008), device=dev, generator=g).to(torch.bfloat16)
        row = dict(w8a8_ms=0.0, default_ms=0.0, k1_ms=0.0, dequant_ms=0.0, cublas_ms=0.0, bytes=0.0, flops=0.0)
        for name, (q, s, w_bf16) in stacks.items():
            O, D = q.shape[1:]
            x = h[:, :D].contiguous()
            w8 = cuda_ms(lambda i: quant.int8_matmul_w8a8(x, q[1], s[1]), 20)
            deq = cuda_ms(lambda i: quant.int8_matmul_dequant(x, q[1], s[1]), 20)
            cub = cuda_ms(lambda i: torch.matmul(x, w_bf16.t()), 20)
            k1 = cuda_ms(lambda i: quant.int8_matmul_stacked(x, q, s, 1), 20) if quant._stream_rows_ok(B, O, D) else None
            nb, fl = matmul_work(B, O, D, O * D, 4 * O)
            log(f"  {name} [{O},{D}] B={B}: W8A8 {w8:.4f} ms, K1 tiled "
                f"{'n/a' if k1 is None else f'{k1:.4f} ms'}, dequant {deq:.4f} ms, cuBLAS bf16 {cub:.4f} ms")
            for key, val in (("w8a8_ms", w8), ("dequant_ms", deq), ("cublas_ms", cub), ("bytes", nb),
                             ("flops", fl), ("default_ms", deq if k1 is None else k1), ("k1_ms", k1 or 0.0)):
                row[key] += val
        row.update(bound(row.pop("bytes"), row.pop("flops")))
        table[str(B)] = row
        log(f"  one 7B layer at B={B}: W8A8 {row['w8a8_ms']:.4f} ms, the dispatch without act_quant "
            f"{row['default_ms']:.4f} ms (K1 tiled {row['k1_ms']:.4f} ms of it), dequant alone "
            f"{row['dequant_ms']:.4f} ms, cuBLAS bf16 {row['cublas_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}); W8A8 / default {row['w8a8_ms'] / row['default_ms']:.3f}x")
    del stacks
    torch.cuda.empty_cache()
    log("w8a8_product " + json.dumps({"smi": smi, "by_rows": table}))
    return table


def check_w8a8_path(rec: PathRecorder, what: str, dequant_below_ok: bool = False) -> None:
    """Every stacked call of W8A8_MIN_ROWS rows or more that `rec` saw took
    the W8A8 product, and some did; no call took the dequant path, or with
    dequant_below_ok none of W8A8_MIN_ROWS rows or more (below them the
    JAX rule sends an O < D stack there, act_quant or not)."""
    from llava_align_tpu_torch.ops import quant

    log(f"  {what}: stacked calls on the W8A8 product by rows {dict(sorted(rec.w8a8.items()))}; "
        f"W8A8-due calls elsewhere {dict(rec.w8a8_missed)}; dequant-path calls (rows, O, D) {dict(rec.dequant)}")
    bad_dequant = [c for c in rec.dequant if c[0] >= quant.W8A8_MIN_ROWS or not dequant_below_ok]
    if not rec.w8a8 or rec.w8a8_missed or bad_dequant:
        raise AssertionError(f"{what}: not every stacked call of >= 256 rows took W8A8, or these took the "
                             f"dequant path: {bad_dequant}")


def agreement(root, a: str, b: str) -> str:
    """How many answers of answers file b agree with a's (same question)."""
    from llava_align_tpu_torch.evals import pope as pope_eval

    ra, rb = (pope_eval.load_jsonl(str(root / f"{n}.jsonl")) for n in (a, b))
    same = sum(x["text"] == y["text"] for x, y in zip(ra, rb))
    return f"{same} of {len(ra)} answers agree with {a}"


def phase_w8a8_runner(model: RunnerModel, root, smi: str, rates: dict, dequant_below_ok: bool = False) -> tuple:
    """model's POPE runner with --quant w8a8, grouped, dual VDD,
    --calibrate, on the POPE phase's question file (through phase_runner:
    K1, K2 and K3 must launch, every record with its dumps, scored), under
    its own recorder: every stacked call of >= 256 rows on the W8A8
    product, none on the dequant path (check_w8a8_path). Its questions/s
    beside the int8 grouped rate of the same run (`rates`), and its
    answers against the int8 grouped run's. Returns (launches by path, the
    recorder)."""
    rec = PathRecorder()
    launches, w8 = phase_runner(model, root, smi, "pope", rec)
    check_w8a8_path(rec, f"{model.tag} --quant w8a8", dequant_below_ok)
    base = model.tag.replace("_w8a8", "")
    log(f"POPE runner {model.what} --quant w8a8 grouped on {smi}: {w8['grouped']:.4f} questions/s; --quant int8 "
        f"grouped in this run {rates['grouped']:.4f} questions/s ({w8['grouped'] / rates['grouped']:.3f}x); "
        + agreement(root, f"{base}_pope_runner_grouped", f"{model.tag}_pope_runner_grouped"))
    return launches, rec


def phase_kv_cache(lm, smi: str) -> dict:
    """The int8 KV cache on the 7B int8 tree, greedy dual VDD, EOS out of
    range: generate_batch_groups at G = GROUPS image groups x 6 questions
    (as bench.py's _kvq side bench runs it), with kv_quant="int8" and with
    the bf16 cache, each a warm-up call then GROUP_CALLS - 1 timed calls:
    answers/s and peak memory of each, and how many answers agree; one
    layer's grouped decode attention at this path's shapes, timed with
    each cache; then one `generate` with kv_quant="int8". K1, K2 and K3
    must launch in each."""
    from llava_align_tpu_torch.decoding.engine import DecodeEngine
    from llava_align_tpu_torch.runners.common import pope_groups

    V = lm.cfg.text.vocab_size
    calls = [pope_groups(lm.tokenizer, lm.cfg.vision.image_size, GROUPS, seed=20 + c) for c in range(GROUP_CALLS)]
    reset_launches()
    answers, result = {}, {}
    for cache in ("bf16", "int8"):
        engine = DecodeEngine(lm.params, lm.cfg, dual_vdd_config(), kv_quant="int8" if cache == "int8" else None)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        outs = engine.generate_batch_groups(calls[0])  # warm-up
        t0 = time.perf_counter()
        for c in range(1, GROUP_CALLS):
            outs += engine.generate_batch_groups(calls[c])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = (GROUP_CALLS - 1) * GROUPS * 6
        for i, out in enumerate(outs):
            check_output(out, V, f"kv cache {cache} question {i}")
        answers[cache] = [o.token_ids for o in outs]
        result[cache] = dict(answers_per_s=n / secs, peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        log(f"int8 KV cache phase, {cache} cache, generate_batch_groups G={GROUPS} x 6 questions, dual VDD, "
            f"greedy, {NEW_TOKENS} tokens, on {smi}: {n} answers in {secs:.4f} s, "
            f"{result[cache]['answers_per_s']:.4f} answers/s; peak memory {result[cache]['peak_gib']:.2f} GiB")
        del engine
    same = sum(a == b for a, b in zip(answers["bf16"], answers["int8"]))
    log(f"  int8 against bf16 cache: {result['int8']['answers_per_s'] / result['bf16']['answers_per_s']:.3f}x "
        f"answers/s, peak memory {result['int8']['peak_gib']:.2f} vs {result['bf16']['peak_gib']:.2f} GiB; "
        f"{same} of {len(answers['bf16'])} answers (all {NEW_TOKENS} tokens) agree")
    phase_kv_attention(smi)
    out = DecodeEngine(lm.params, lm.cfg, dual_vdd_config(), kv_quant="int8").generate(
        *pope_requests(lm.tokenizer, lm.cfg.vision.image_size)[1])
    check_output(out, V, "generate with kv_quant=int8")
    log(f"  generate with kv_quant=int8: tokens {out.token_ids}, total {out.seconds_total:.4f} s")
    launches = read_launches()
    require_launches(launches, K123, "the int8 KV cache phase")
    torch.cuda.empty_cache()
    return launches


def phase_kv_attention(smi: str) -> None:
    """One layer's decode_attention_shared_grouped at the G = 4 grouped
    path's shapes (72 rows: 4 groups x 6 questions x [main | unk, none];
    a 640-position image segment per group, a 128-position text segment
    per (group, kind), a 40-position local cache), bf16 operands against
    int8 (values, scales) ones: plain PyTorch, which widens the int8
    values to fp32 as the JAX package's einsums do; held to each other at
    REFERENCE_TOL (the cache's quantization error)."""
    from llava_align_tpu_torch.ops import attention, quant

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(17)
    G, Qg, P, P2, S, H, Dh = GROUPS, 6, 640, 128, 40, 32, 128

    def rnd(*shape):
        return torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)

    q, kc, vc = rnd(3 * G * Qg, 1, H, Dh), rnd(3 * G * Qg, S, H, Dh), rnd(3 * G * Qg, S, H, Dh)
    seg = dict(k_sh=rnd(G, P, H, Dh), v_sh=rnd(G, P, H, Dh), k_sh2=rnd(2 * G, P2, H, Dh), v_sh2=rnd(2 * G, P2, H, Dh))
    lengths = torch.full((3 * G * Qg,), S - 1, device=dev)
    sh_len = torch.cat([torch.full((G * Qg,), P - 7, device=dev), torch.full((2 * G * Qg,), P2 - 9, device=dev)])

    def call(kc_, vc_, seg_):
        return attention.decode_attention_shared_grouped(q, kc_, vc_, lengths, seg_["k_sh"], seg_["v_sh"], sh_len,
                                                         Qg, seg_["k_sh2"], seg_["v_sh2"], Qg)

    q8 = {k: quant.kv_quantize_block(v) for k, v in seg.items()}
    kc8, vc8 = quant.kv_quantize_block(kc), quant.kv_quantize_block(vc)
    rel_check(call(kc8, vc8, q8).float(), call(kc, vc, seg).float(),
              "grouped decode attention, int8 against bf16 operands")
    bf16_ms = cuda_ms(lambda i: call(kc, vc, seg), 10)
    int8_ms = cuda_ms(lambda i: call(kc8, vc8, q8), 10)
    log(f"  one layer's grouped decode attention (72 rows, segments {G}x{P} + {2 * G}x{P2}, local {S}) on {smi}: "
        f"bf16 operands {bf16_ms:.4f} ms, int8 operands {int8_ms:.4f} ms ({int8_ms / bf16_ms:.3f}x)")


def phase_quant_reference(dev) -> None:
    """The full-width 7B model cut to 2 decoder / 2 vision layers, int8:
    the W8A8 prefill's logits (act_quant: its 640 rows take the W8A8
    product) and, over the int8 KV cache, the prefill and two decode
    steps' logits, on the card against the same params and code in fp32 on
    the CPU, at REFERENCE_TOL."""
    from llava_align_tpu_torch.config import LlavaConfig
    from llava_align_tpu_torch.models import llava
    from llava_align_tpu_torch.ops import quant
    from llava_align_tpu_torch.ops.image import normalize_device
    from llava_align_tpu_torch.runners.common import MockTokenizer
    from llava_align_tpu_torch.utils.synthetic import build_random_llava_params

    cfg = cut_config(LlavaConfig.llava_v15_7b())
    cfg32 = cut_config(LlavaConfig.llava_v15_7b(), torch.float32)
    params = build_random_llava_params(cfg, quant="int8", device=dev, seed=1)
    params_cpu = to_fp32(params)
    ids, image = pope_requests(MockTokenizer(), cfg.vision.image_size)[0]
    plan = llava.plan_splice(ids, cfg.num_image_tokens, -(-(len(ids) - 1 + cfg.num_image_tokens) // 128) * 128)
    steps = (29871, 3869)

    @torch.inference_mode()
    def run(p, c, device, **mode):
        pixels = normalize_device(torch.from_numpy(image)[None].to(device), c.vision.dtype)
        feats = llava.encode_images(p, c, pixels)
        t = {k: torch.from_numpy(np.asarray(getattr(plan, k)))[None].to(device)
             for k in ("tokens", "tok_gather", "img_gather", "is_image")}
        embeds = llava.splice_embeds(p, c, t["tokens"], t["tok_gather"], t["img_gather"], t["is_image"], feats)
        return llama_logits_steps(p["llama"], c.text, embeds, plan.length, steps, device, **mode)

    cpu = torch.device("cpu")
    n0 = quant.int8_matmul_w8a8.launches
    got, ref = run(params, cfg, dev, act_quant=True), run(params_cpu, cfg32, cpu, act_quant=True)
    if quant.int8_matmul_w8a8.launches == n0:
        raise AssertionError("the W8A8 reference's prefill did not take the W8A8 product")
    rel_check(got[0], ref[0], "7B W8A8 reference prefill: max|card - cpu fp32| / max|cpu|")
    got, ref = run(params, cfg, dev, kv_quant=True), run(params_cpu, cfg32, cpu, kv_quant=True)
    for name, g_, r_ in zip(("prefill", "decode 1", "decode 2"), got, ref):
        rel_check(g_, r_, f"7B int8-cache reference {name}: max|card - cpu fp32| / max|cpu|")
    del params, params_cpu
    torch.cuda.empty_cache()


def phase_sampling_sweep(model: RunnerModel, root, smi: str, rec: PathRecorder) -> dict:
    """runners/sampling.run_sweep --grid smoke (default, temp_0.5,
    top_p_0.5, top_k_5) on the POPE question file, dual VDD, sampled,
    grouped by image, twice with one --seed: the two sweeps' sampled tokens
    must be equal, answer by answer. K1, K2 and K3 must launch in each."""
    from llava_align_tpu_torch.evals import pope as pope_eval
    from llava_align_tpu_torch.runners import sampling

    qf, _ = write_pope_files(root)
    runs, launches = [], {}
    for r in range(2):
        args = sampling.build_parser().parse_args([
            *model.args, "--question-file", str(qf), "--answers-file", str(root / f"sweep{r}_setting.jsonl"),
            "--use_dd", "--use_dd_unk", "--cd_alpha", "1", "--cd_beta", "0.1", "--max_new_tokens",
            str(NEW_TOKENS), "--synthetic-images", "--seed", "7", "--grid", "smoke"])
        files, secs, launches, _ = timed_run(model, rec, lambda: sampling.run_sweep(args))
        recs = [pope_eval.load_jsonl(f) for f in files]
        n_q = sum(len(x) for x in recs)
        log(f"sampling sweep {r} (--grid smoke: {[Path(f).stem for f in files]}, {model.what}) on {smi}: "
            f"{n_q} answers in {secs:.4f} s, {n_q / secs:.4f} questions/s; K1 {launches['int8_matmul_stacked']}, "
            f"K2 {launches['int8_matmul_cuda']}, K3 {launches['flash_attention']}")
        if [len(x) for x in recs] != [6 * RUNNER_IMAGES] * 4:
            raise AssertionError(f"sampling sweep {r}: answers per point {[len(x) for x in recs]}")
        require_launches(launches, model.kernels, f"sampling sweep {r}")
        runs.append([[x["text"] for x in point] for point in recs])
    same = sum(a == b for pa, pb in zip(*runs) for a, b in zip(pa, pb))
    log(f"  the two sweeps under --seed 7: {same} of {sum(len(p) for p in runs[0])} sampled answers equal; "
        f"answers at the points {[p[:2] for p in runs[0]]}")
    if runs[0] != runs[1]:
        raise AssertionError("the sampling sweep is not reproducible under one seed")
    return launches


def phase_bias_probe(model: RunnerModel, root, smi: str, rec: PathRecorder) -> dict:
    """runners/bias_probe.run on 4 POPE questions (images absent:
    --synthetic-images): every record must carry the none, unk, zero, one
    and noise dumps and naive. K1, K2 and K3 must launch."""
    from llava_align_tpu_torch.evals import pope as pope_eval
    from llava_align_tpu_torch.runners import bias_probe

    qf, _ = write_pope_files(root)
    answers = root / "bias_probe.jsonl"
    args = bias_probe.build_parser().parse_args([*model.args, "--question-file", str(qf), "--answers-file",
                                                 str(answers), "--synthetic-images", "--max-questions", "4",
                                                 "--temperature", "0"])
    _, secs, launches, _ = timed_run(model, rec, lambda: bias_probe.run(args))
    recs = pope_eval.load_jsonl(str(answers))
    log(f"bias probe ({model.what}, 4 questions x 6 probes) on {smi}: {secs:.4f} s, {4 / secs:.4f} questions/s; "
        f"K1 {launches['int8_matmul_stacked']}, K2 {launches['int8_matmul_cuda']}, K3 {launches['flash_attention']}; "
        f"first record {json.dumps({k: dict(list(v.items())[:3]) for k, v in recs[0].items() if isinstance(v, dict)})}")
    dumps = ("none", "unk", "zero", "one", "noise", "naive")
    if len(recs) != 4 or not all(all(isinstance(r.get(k), dict) and r[k] for k in dumps) for r in recs):
        raise AssertionError(f"bias probe: records without the {dumps} dumps")
    require_launches(launches, K123, "the bias probe")
    return launches



# ---------------------------------------------------------------------------
# the last decoder families: LLaVA-MPT-7B and BLIP-2 (OPT-2.7b, FlanT5-XL,
# the stage-1 Q-Former). No TPU kernel lies on their paths (MPT's alibi
# attention, OPT's Dh 80, T5, EVA-ViT and the Q-Former are plain torch, as
# XLA runs them in JAX; none of these trees is quantized), so each path's
# launches_by_path entry records K1-K4 at zero.
# ---------------------------------------------------------------------------

FAMILY_BEAMS = 5
FAMILY_CAPTION_TOKENS = 30
FAMILY_IMAGES = 4     # t5_generate's and generate_caption's images
RETRIEVAL = 8         # compute_sim_matrix: 8 images x 8 texts
RETRIEVAL_K = 4       # its ITM re-rank of the top 4


def n_params(tree) -> int:
    from llava_align_tpu_torch.runners.pope import _tensors

    return sum(t.numel() for t in _tensors(tree))


def timed(fn) -> tuple:
    """fn() with the launch counts reset before it and read after it, the
    peak-memory counter reset: (its result, seconds, launches)."""
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_launches()


def family_report(what: str, smi: str, secs: float, tokens: list, unit: str, first_s: float, launches: dict) -> None:
    """One line per path: wall, tokens per answer, answers (captions) per
    second, first-token seconds, peak memory, beside the card."""
    log(f"{what} on {smi}: wall {secs:.4f} s, tokens per {unit[:-1]} {tokens}, {len(tokens) / secs:.4f} {unit}/s, "
        f"first-token {first_s:.4f} s, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches {launches}")
    hit = {k: v for k, v in launches.items() if v}
    if hit:
        log(f"  (kernel launches on this path: {hit})")


def mpt_requests(image_size: int):
    """POPE-style requests in the `mpt` conversation template: POPE's 6
    object questions (MockTokenizer ids), 2 seeded uint8 images, 3
    questions each."""
    from llava_align_tpu_torch.runners.common import POPE_OBJECTS, MockTokenizer, build_prompt
    from llava_align_tpu_torch.tokenization import tokenizer_image_token

    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, (3, image_size, image_size), dtype=np.uint8) for _ in range(2)]
    return [(tokenizer_image_token(build_prompt(f"Is there a {obj} in the image?", "mpt")[0], MockTokenizer()),
             images[i // 3]) for i, obj in enumerate(POPE_OBJECTS)]


def phase_llava_mpt(dev, smi: str) -> dict:
    """LLaVA-MPT-7B (MPT-7B: d 4096, 32 layers, 32 heads, vocab 50432;
    CLIP ViT-L/336 + mlp2x_gelu) in bf16 at full width and depth, random
    weights from a seed: DecodeEngine.generate with dual VDD and with VCD
    (3 requests each after a warm-up), generate_batch of 6 POPE-style
    prompts, 8 new tokens, greedy, EOS out of range; generate_batch_groups
    must be refused (no shared-prefix forward, as in JAX)."""
    from llava_align_tpu_torch.decoding.adapters import LlavaMptAdapter
    from llava_align_tpu_torch.decoding.engine import DecodeEngine
    from llava_align_tpu_torch.models import llava_mpt

    cfg = llava_mpt.LlavaMptConfig()
    t0 = time.perf_counter()
    params = llava_mpt.init(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    t = cfg.text
    log(f"LLaVA-MPT path: built random LLaVA-MPT-7B bf16 ({n_params(params) / 1e9:.3f} G parameters: MPT-7B "
        f"{n_params(params['mpt']) / 1e9:.3f} G (d {t.d_model}, {t.n_layers} layers, {t.n_heads} heads, vocab "
        f"{t.vocab_size}), CLIP ViT-L/336 {n_params(params['vision']) / 1e9:.3f} G, {cfg.mm_projector_type}) on "
        f"{dev} in {time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    adapter = LlavaMptAdapter(cfg)
    reqs = mpt_requests(cfg.vision.image_size)
    vdd = dual_vdd_config()
    vcd = dataclasses.replace(vdd, use_dd=False, use_dd_unk=False, use_cd=True, noise_step=500)
    by_path = {}
    with torch.inference_mode():
        for name, gen in (("dual VDD", vdd), ("VCD", vcd)):
            engine = DecodeEngine(params, cfg, gen, adapter=adapter)
            engine.generate(*reqs[0])  # warm-up: cuBLAS, the allocator
            outs, secs, launches = timed(lambda: [engine.generate(ids, im) for ids, im in reqs[:3]])
            for o in outs:
                check_output(o, t.vocab_size, f"LLaVA-MPT-7B generate ({name})")
            family_report(f"LLaVA-MPT-7B generate ({name}, 3 requests, prefill {outs[0].prompt_length} positions)",
                          smi, secs, [o.num_generated for o in outs], "answers",
                          float(np.mean([o.seconds_to_first_token for o in outs])), launches)
            by_path[f"mpt_generate_{name.split()[-1].lower()}"] = launches
        engine = DecodeEngine(params, cfg, vdd, adapter=adapter)
        outs, secs, launches = timed(lambda: engine.generate_batch(reqs))
        for o in outs:
            check_output(o, t.vocab_size, "LLaVA-MPT-7B generate_batch")
        family_report(f"LLaVA-MPT-7B generate_batch (dual VDD, {len(reqs)} POPE prompts, mpt template)", smi, secs,
                      [o.num_generated for o in outs], "answers", outs[0].seconds_to_first_token, launches)
        log(f"  answers: {[o.token_ids for o in outs[:2]]} ...")
        by_path["mpt_generate_batch"] = launches
        try:
            engine.generate_batch_groups([(reqs[0][0][:8], [reqs[0][0][8:]], reqs[0][1])])
        except ValueError as e:
            log(f"  generate_batch_groups refused, as in JAX: {e}")
        else:
            raise AssertionError("LLaVA-MPT: generate_batch_groups was not refused")
        phase_mpt_prefill_split(params["mpt"], t, -(-outs[0].prompt_length // 128) * 128, dev, smi)
    del params, engine
    torch.cuda.empty_cache()
    return by_path


def phase_mpt_prefill_split(p, t, S: int, dev, smi: str) -> None:
    """Where an MPT-7B prefill's time goes: mpt.forward of one S-position
    row (the image row's bucket) against one layer's alibi attention
    (plain fp32 torch) at that shape, times the layers; beside it
    scaled_dot_product_attention given the same alibi + causal bias as a
    float mask (a yardstick only: the port never calls it). CUDA events,
    the mean of 3 eager calls."""
    from llava_align_tpu_torch.models import mpt

    g = torch.Generator(device=dev).manual_seed(14)
    x = torch.randn((1, S, t.d_model), generator=g, device=dev).to(t.dtype)
    pos = torch.arange(S, device=dev)[None]
    q, k, v = (torch.randn((1, S, t.n_heads, t.head_dim), generator=g, device=dev).to(t.dtype) for _ in range(3))
    slopes = torch.from_numpy(mpt.alibi_slopes(t.n_heads, t.alibi_bias_max)).to(dev)
    kp = torch.arange(S, device=dev)
    causal = torch.ones((S, S), dtype=torch.bool, device=dev).tril()
    bias = (slopes[:, None, None] * kp.float()).masked_fill(~causal, float("-inf"))[None].to(t.dtype)
    prefill_ms = cuda_ms(lambda _: mpt.forward(p, t, x, pos), 3)
    attn_ms = cuda_ms(lambda _: mpt._alibi_attention(q, k, v, slopes, kp, causal.expand(1, S, S)), 3)
    sdpa_ms = cuda_ms(lambda _: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                               v.transpose(1, 2), attn_mask=bias), 3)
    log(f"LLaVA-MPT-7B prefill split on {smi} (CUDA events, mean of 3 eager calls): mpt.forward of one {S}-position "
        f"row {prefill_ms:.4f} ms; one layer's alibi attention [1, {S}, {t.n_heads}, {t.head_dim}] {attn_ms:.4f} ms, "
        f"x {t.n_layers} layers = {attn_ms * t.n_layers:.4f} ms ({attn_ms * t.n_layers / prefill_ms:.1%} of the "
        f"prefill); SDPA with the same bias as a float mask {sdpa_ms:.4f} ms a layer (a yardstick)")


def phase_blip2_opt(dev, smi: str) -> dict:
    """BLIP-2 OPT-2.7b (EVA-ViT-g, 39 layers at 224 px; the 12-layer
    Q-Former, 32 queries; OPT-2.7b: 32 layers, d 2560, Dh 80) in bf16 at
    full width and depth: per question encode_image_queries on the image
    and on its noised copy (noise step 500), then generate with VCD on
    precomputed_feats (3 questions after a warm-up); then generate_beam
    with 5 beams and 30 new tokens (min 8) as a caption, on 2 images."""
    from llava_align_tpu_torch.config import GenerationConfig
    from llava_align_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from llava_align_tpu_torch.decoding.adapters import Blip2OptAdapter
    from llava_align_tpu_torch.decoding.engine import DecodeEngine
    from llava_align_tpu_torch.models import blip2
    from llava_align_tpu_torch.ops.noise import add_diffusion_noise
    from llava_align_tpu_torch.runners.common import MockTokenizer

    cfg = blip2.Blip2OptConfig()
    t0 = time.perf_counter()
    params = blip2.init_opt(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    log(f"BLIP-2 OPT path: built random BLIP-2 OPT-2.7b bf16 ({n_params(params) / 1e9:.3f} G parameters: EVA-ViT-g "
        f"{n_params(params['visual']) / 1e9:.3f} G, Q-Former {n_params(params['qformer']) / 1e9:.3f} G, OPT-2.7b "
        f"{n_params(params['lm']) / 1e9:.3f} G (head dim {cfg.text.head_dim})) on {dev} in "
        f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    tok = MockTokenizer()
    H, vdt = cfg.vision.image_size, cfg.vision.dtype
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.standard_normal((4, 3, H, H)).astype(np.float32)).to(dev, vdt)
    g = torch.Generator(device=dev).manual_seed(5)
    adapter = Blip2OptAdapter(cfg)
    by_path = {}
    with torch.inference_mode():
        def encode(image):
            noised = add_diffusion_noise(image, 500, generator=g)
            return torch.cat([blip2.encode_image_queries(params, cfg, image), blip2.encode_image_queries(params, cfg, noised)])

        gen = dataclasses.replace(dual_vdd_config(), use_dd=False, use_dd_unk=False, use_cd=True)
        engine = DecodeEngine(params, cfg, gen, adapter=adapter)
        questions = [[IMAGE_TOKEN_INDEX] + tok(f"Question: {q} Answer:").input_ids for q in QUESTIONS[:3]]
        engine.generate(questions[0], precomputed_feats=encode(images[:1]))  # warm-up
        t_enc = []

        def answer_all():
            outs = []
            for i, ids in enumerate(questions):
                t1 = time.perf_counter()
                feats = encode(images[i : i + 1])
                torch.cuda.synchronize()
                t_enc.append(time.perf_counter() - t1)
                outs.append(engine.generate(ids, precomputed_feats=feats))
            return outs

        outs, secs, launches = timed(answer_all)
        for o in outs:
            check_output(o, cfg.text.vocab_size, "BLIP-2 OPT generate (VCD)")
        family_report("BLIP-2 OPT-2.7b encode (image + noised) + generate (VCD, 3 questions)", smi, secs,
                      [o.num_generated for o in outs], "answers",
                      float(np.mean([e + o.seconds_to_first_token for e, o in zip(t_enc, outs)])), launches)
        log(f"  encodes {', '.join(f'{e:.4f}' for e in t_enc)} s (two streams each)")
        by_path["blip2_opt_generate_vcd"] = launches

        beam_gen = GenerationConfig(max_new_tokens=FAMILY_CAPTION_TOKENS, do_sample=False, eos_token_id=2)
        beam_engine = DecodeEngine(params, cfg, beam_gen, adapter=adapter)
        prompt = [IMAGE_TOKEN_INDEX] + tok("a photo of").input_ids
        one = DecodeEngine(params, cfg, dataclasses.replace(beam_gen, max_new_tokens=1), adapter=adapter)
        feats = [blip2.encode_image_queries(params, cfg, images[i : i + 1]) for i in range(2)]
        one.generate_beam(prompt, num_beams=FAMILY_BEAMS, precomputed_feats=feats[0])  # warm-up
        _, first_s, _ = timed(lambda: one.generate_beam(prompt, num_beams=FAMILY_BEAMS, precomputed_feats=feats[0]))
        outs, secs, launches = timed(lambda: [beam_engine.generate_beam(prompt, num_beams=FAMILY_BEAMS,
                                                                        min_new_tokens=8, precomputed_feats=f)
                                              for f in feats])
        if not all(8 <= o.num_generated <= FAMILY_CAPTION_TOKENS for o in outs):
            raise AssertionError(f"BLIP-2 OPT beams: {[o.num_generated for o in outs]} tokens")
        family_report(f"BLIP-2 OPT-2.7b generate_beam ({FAMILY_BEAMS} beams, max {FAMILY_CAPTION_TOKENS} tokens, "
                      "min 8, 2 captions)", smi, secs, [o.num_generated for o in outs], "captions", first_s, launches)
        by_path["blip2_opt_generate_beam"] = launches
    del params, engine, beam_engine, one, feats
    torch.cuda.empty_cache()
    return by_path


def phase_blip2_t5(dev, smi: str) -> dict:
    """BLIP-2 FlanT5-XL (EVA-ViT-g, the Q-Former, Flan-T5-XL: 24 + 24
    layers, d 2048) in bf16 at full width and depth: t5_generate on 4
    images (greedy, up to 30 tokens, eos 1); t5_encode_with_prefix +
    t5_candidate_losses ranking 4 candidates per image;
    encode_image_queries_instruct once (a 4-image batch)."""
    from llava_align_tpu_torch.models import blip2
    from llava_align_tpu_torch.runners.common import MockTokenizer

    cfg = blip2.Blip2T5Config()
    t0 = time.perf_counter()
    params = blip2.init_t5(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    log(f"BLIP-2 T5 path: built random BLIP-2 FlanT5-XL bf16 ({n_params(params) / 1e9:.3f} G parameters: EVA-ViT-g "
        f"{n_params(params['visual']) / 1e9:.3f} G, Q-Former {n_params(params['qformer']) / 1e9:.3f} G, Flan-T5-XL "
        f"{n_params(params['lm']) / 1e9:.3f} G) on {dev} in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    tok = MockTokenizer()
    H = cfg.vision.image_size
    images = torch.from_numpy(np.random.default_rng(6).standard_normal((FAMILY_IMAGES, 3, H, H)).astype(np.float32))
    images = images.to(dev, cfg.vision.dtype)
    prompts = [tok(f"Question: {q} Short answer:").input_ids[1:] + [1] for q in QUESTIONS[:FAMILY_IMAGES]]
    by_path = {}
    with torch.inference_mode():
        blip2.t5_generate(params, cfg, images[:1], prompts[:1], max_new_tokens=2)  # warm-up
        _, first_s, _ = timed(lambda: blip2.t5_generate(params, cfg, images, prompts, max_new_tokens=1))
        caps, secs, launches = timed(lambda: blip2.t5_generate(params, cfg, images, prompts,
                                                               max_new_tokens=FAMILY_CAPTION_TOKENS))
        if len(caps) != FAMILY_IMAGES or not all(0 <= x < cfg.text.vocab_size for c in caps for x in c):
            raise AssertionError(f"t5_generate: {caps}")
        family_report(f"BLIP-2 FlanT5-XL t5_generate ({FAMILY_IMAGES} images, greedy, max "
                      f"{FAMILY_CAPTION_TOKENS} tokens)", smi, secs, [len(c) for c in caps], "answers", first_s,
                      launches)
        by_path["blip2_t5_generate"] = launches

        cands = [tok(c).input_ids[1:] + [1] for c in ("yes", "no", "a dog", "a dining table")]
        cand_ids = torch.zeros((len(cands), max(map(len, cands))), dtype=torch.long, device=dev)
        for i, c in enumerate(cands):
            cand_ids[i, : len(c)] = torch.tensor(c)
        ids = torch.zeros((FAMILY_IMAGES, max(map(len, prompts))), dtype=torch.long, device=dev)
        for i, p in enumerate(prompts):
            ids[i, : len(p)] = torch.tensor(p)
        mask = (ids > 0).long()

        def rank():
            q_emb = blip2.encode_image_queries(params, cfg, images)
            enc, enc_mask = blip2.t5_encode_with_prefix(params, cfg, q_emb, ids, mask)
            return blip2.t5_candidate_losses(params, cfg, enc, enc_mask, cand_ids)

        losses, secs, launches = timed(rank)
        losses = losses.float().cpu().numpy()
        if losses.shape != (FAMILY_IMAGES, len(cands)) or not np.isfinite(losses).all():
            raise AssertionError(f"t5_candidate_losses: {losses}")
        log(f"BLIP-2 FlanT5-XL candidate ranking ({len(cands)} candidates x {FAMILY_IMAGES} images) on {smi}: "
            f"{secs:.4f} s, {FAMILY_IMAGES / secs:.4f} images/s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; ranks {np.argsort(losses, axis=-1).tolist()}; "
            f"launches {launches}")
        by_path["blip2_t5_rank"] = launches

        qtext = torch.tensor([[101] + tok("Is there a dog?").input_ids[1:] + [102]] * FAMILY_IMAGES, device=dev)
        q, secs, launches = timed(lambda: blip2.encode_image_queries_instruct(params, cfg, images, qtext,
                                                                              torch.ones_like(qtext)))
        if q.shape != (FAMILY_IMAGES, cfg.num_query_tokens, cfg.text.d_model) or not torch.isfinite(q).all():
            raise AssertionError(f"encode_image_queries_instruct: {tuple(q.shape)}")
        log(f"BLIP-2 FlanT5-XL encode_image_queries_instruct ({FAMILY_IMAGES} images) on {smi}: {secs:.4f} s; "
            f"launches {launches}")
        by_path["blip2_t5_instruct_encode"] = launches
    del params
    torch.cuda.empty_cache()
    return by_path


def phase_blip2_stage1(dev, smi: str) -> dict:
    """Stage-1 BLIP-2 (EVA-ViT-g, the Q-Former with its MLM head,
    vision/text projections to 256, the ITM head) in bf16 at full width and
    depth: extract_features in each mode, match with the ITM and ITC heads,
    compute_sim_matrix over 8 images x 8 texts with the ITM re-rank of the
    top 4, and a greedy generate_caption (30 tokens at most, min 10) on 4
    images."""
    from llava_align_tpu_torch.models import blip2
    from llava_align_tpu_torch.runners.common import MockTokenizer

    cfg = blip2.Blip2QformerConfig()
    t0 = time.perf_counter()
    params = blip2.init_stage1(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    log(f"BLIP-2 stage-1 path: built random BLIP-2 (Q-Former) bf16 ({n_params(params) / 1e9:.3f} G parameters) on "
        f"{dev} in {time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    tok = MockTokenizer()
    H = cfg.vision.image_size
    images = torch.from_numpy(np.random.default_rng(7).standard_normal((RETRIEVAL, 3, H, H)).astype(np.float32))
    images = images.to(dev, cfg.vision.dtype)
    texts = [f"a photo of a {o}" for o in ("dog", "person", "dining table", "car", "bicycle", "chair", "cat", "bus")]
    ids = torch.zeros((RETRIEVAL, cfg.max_txt_len), dtype=torch.long, device=dev)
    for i, s in enumerate(texts):
        row = [101] + tok(s).input_ids[1:] + [102]
        ids[i, : len(row)] = torch.tensor(row)
    mask = (ids > 0).long()
    by_path = {}
    with torch.inference_mode():
        blip2.match(params, cfg, images[:1], ids[:1], mask[:1])  # warm-up
        for mode in ("image", "text", "multimodal"):
            out, secs, launches = timed(lambda: blip2.extract_features(params, cfg, images, ids, mask, mode=mode))
            shapes = {k: tuple(v.shape) for k, v in out.items() if v is not None}
            if not all(torch.isfinite(v.float()).all() for v in out.values() if v is not None):
                raise AssertionError(f"extract_features({mode}): not finite")
            log(f"BLIP-2 stage-1 extract_features({mode}, {RETRIEVAL} inputs) on {smi}: {secs:.4f} s, {shapes}")
            by_path[f"blip2_stage1_features_{mode}"] = launches
        for head in ("itm", "itc"):
            out, secs, launches = timed(lambda: blip2.match(params, cfg, images, ids, mask, head))
            log(f"BLIP-2 stage-1 match({head}, {RETRIEVAL} pairs) on {smi}: {secs:.4f} s, shape {tuple(out.shape)}")
            by_path[f"blip2_stage1_match_{head}"] = launches
        (i2t, t2i), secs, launches = timed(lambda: blip2.compute_sim_matrix(params, cfg, images, ids, mask,
                                                                             k_test=RETRIEVAL_K))
        for name, m in (("i2t", i2t), ("t2i", t2i)):
            if m.shape != (RETRIEVAL, RETRIEVAL) or not ((m != -100.0).sum(1) == RETRIEVAL_K).all():
                raise AssertionError(f"compute_sim_matrix {name}: {m}")
        log(f"BLIP-2 stage-1 compute_sim_matrix ({RETRIEVAL} x {RETRIEVAL}, ITM re-rank of the top {RETRIEVAL_K}) "
            f"on {smi}: {secs:.4f} s, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; i2t top-1 "
            f"{i2t.argmax(1).tolist()}; launches {launches}")
        by_path["blip2_stage1_sim_matrix"] = launches
        kw = dict(bos_token_id=101, eos_token_id=102, min_length=10)
        imgs = images[:FAMILY_IMAGES]
        _, first_s, _ = timed(lambda: blip2.generate_caption(params, cfg, imgs, max_new_tokens=1, **kw))
        caps, secs, launches = timed(lambda: blip2.generate_caption(params, cfg, imgs,
                                                                    max_new_tokens=FAMILY_CAPTION_TOKENS, **kw))
        lengths = [int(np.argmax(np.append(r, 102) == 102)) for r in caps]
        if caps.shape[0] != FAMILY_IMAGES or min(lengths) < 9:
            raise AssertionError(f"generate_caption: {caps}")
        family_report(f"BLIP-2 stage-1 generate_caption (greedy, {FAMILY_IMAGES} images, max "
                      f"{FAMILY_CAPTION_TOKENS} tokens, min 10)", smi, secs, lengths, "captions", first_s, launches)
        by_path["blip2_stage1_caption"] = launches
    del params
    torch.cuda.empty_cache()
    return by_path


def adapter_logits_steps(adapter, p, embeds, length: int, steps, device) -> list:
    """A decoder's logits (through `adapter`) at the last real position
    (`length`) of one prompt's `embeds` [1, S, D], then at one decode step
    per token of `steps`, as fp32 CPU tensors."""
    S = embeds.shape[1]
    cache = adapter.init_cache(1, S + len(steps), device=device)
    zero = torch.zeros((1,), dtype=torch.long, device=device)
    kw = dict(max_seq_len=S + len(steps))
    hidden, _ = adapter.forward(p, embeds, torch.arange(S, device=device)[None], cache, zero, **kw)
    out = [adapter.logits(p, hidden[:, length - 1])]
    for i, tok in enumerate(steps):
        pos = zero + length + i
        emb = adapter.embed_tokens(p, torch.full((1, 1), tok, device=device))
        hidden, _ = adapter.forward(p, emb, pos[:, None], cache, pos, **kw)
        out.append(adapter.logits(p, hidden[:, 0]))
    return [o.float().cpu() for o in out]


def splice_plan_tensors(plan, device) -> list:
    return [torch.from_numpy(np.asarray(getattr(plan, k)))[None].to(device)
            for k in ("tokens", "tok_gather", "img_gather", "is_image")]


def mpt_cut(full, dtype=None):
    """full width, 2 MPT layers, 3 CLIP layers (select_layer -2 runs 2)."""
    kw = {"dtype": dtype} if dtype else {}
    return dataclasses.replace(full, text=dataclasses.replace(full.text, n_layers=2, **kw),
                               vision=dataclasses.replace(full.vision, num_layers=3, **kw))


def t5_cut(full, dtype=None):
    """blip_cut, and 2 T5 decoder layers."""
    cut = blip_cut(full, dtype)
    return dataclasses.replace(cut, text=dataclasses.replace(cut.text, num_decoder_layers=2))


def phase_family_references(dev) -> None:
    """The new families cut to 2 layers at full width, bf16 on the card
    against the same params in fp32 on the CPU, at REFERENCE_TOL:
    LLaVA-MPT (the image prompt's prefill logits and two decode steps'),
    BLIP-2 OPT (encode_image_queries, prefill, two decode steps), BLIP-2
    T5 (encode_image_queries, the T5 encoder's states, three decode_steps'
    logits); then a 5-beam generate_beam of 8 tokens of the OPT cut in
    fp32, card against CPU (agreement, or the log-probability gap where
    they part)."""
    from llava_align_tpu_torch.config import GenerationConfig
    from llava_align_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from llava_align_tpu_torch.decoding.adapters import Blip2OptAdapter, LlavaMptAdapter
    from llava_align_tpu_torch.decoding.engine import DecodeEngine
    from llava_align_tpu_torch.models import blip2, llava_mpt, t5
    from llava_align_tpu_torch.models.llava import plan_splice
    from llava_align_tpu_torch.ops.image import normalize_device
    from llava_align_tpu_torch.runners.common import MockTokenizer

    cpu = torch.device("cpu")
    steps = (300, 400)  # fixed next tokens, so both sides decode the same sequence

    # LLaVA-MPT
    full = llava_mpt.LlavaMptConfig()
    params = llava_mpt.init(mpt_cut(full), device=dev, seed=1)
    params_cpu = to_fp32(params)
    ids, image = mpt_requests(full.vision.image_size)[0]
    plan = plan_splice(ids, full.num_image_tokens, -(-(len(ids) - 1 + full.num_image_tokens) // 128) * 128)

    @torch.inference_mode()
    def run_mpt(p, c, device):
        a = LlavaMptAdapter(c)
        feats = a.encode_images(p, normalize_device(torch.from_numpy(image)[None].to(device), c.vision.dtype))
        embeds = a.splice_embeds(p, *splice_plan_tensors(plan, device), feats)
        return adapter_logits_steps(a, p, embeds, plan.length, steps, device)

    got, ref = run_mpt(params, mpt_cut(full), dev), run_mpt(params_cpu, mpt_cut(full, torch.float32), cpu)
    for name, g, r in zip(("prefill", "decode 1", "decode 2"), got, ref):
        rel_check(g, r, f"LLaVA-MPT reference {name} ({plan.length} positions): max|card - cpu fp32| / max|cpu|")
    del params, params_cpu
    torch.cuda.empty_cache()

    # BLIP-2 OPT and T5
    rng = np.random.default_rng(8)
    tok = MockTokenizer()
    full_opt = blip2.Blip2OptConfig()
    H = full_opt.vision.image_size
    image = torch.from_numpy(rng.standard_normal((1, 3, H, H)).astype(np.float32))
    ids = [IMAGE_TOKEN_INDEX] + tok("Question: Is there a dog in the image? Answer:").input_ids
    Q = full_opt.num_query_tokens
    plan = plan_splice(ids, Q, -(-(len(ids) - 1 + Q) // 32) * 32)
    params = blip2.init_opt(blip_cut(full_opt), device=dev, seed=2)
    params_cpu = to_fp32(params)

    @torch.inference_mode()
    def run_opt(p, c, device):
        a = Blip2OptAdapter(c)
        feats = blip2.encode_image_queries(p, c, image.to(device, c.vision.dtype))
        embeds = a.splice_embeds(p, *splice_plan_tensors(plan, device), feats)
        return [feats.float().cpu()] + adapter_logits_steps(a, p, embeds, plan.length, steps, device)

    got, ref = run_opt(params, blip_cut(full_opt), dev), run_opt(params_cpu, blip_cut(full_opt, torch.float32), cpu)
    for name, g, r in zip(("encode", "prefill", "decode 1", "decode 2"), got, ref):
        rel_check(g, r, f"BLIP-2 OPT reference {name}: max|card - cpu fp32| / max|cpu|")
    del params
    torch.cuda.empty_cache()

    # the OPT cut's beams in fp32 on both sides
    cfg32 = blip_cut(full_opt, torch.float32)
    params_card = to_fp32(params_cpu, dev)
    gen = GenerationConfig(max_new_tokens=8, do_sample=False, eos_token_id=2, pad_token_id=0)
    beams, feats = {}, {}
    with torch.inference_mode():
        for side, p, device in (("card", params_card, dev), ("cpu", params_cpu, cpu)):
            feats[side] = blip2.encode_image_queries(p, cfg32, image.to(device))
            engine = DecodeEngine(p, cfg32, gen, adapter=Blip2OptAdapter(cfg32), bucket=32)
            beams[side] = engine.generate_beam(ids, num_beams=FAMILY_BEAMS, precomputed_feats=feats[side]).token_ids
    a, b = beams["card"], beams["cpu"]
    log(f"BLIP-2 OPT reference, {FAMILY_BEAMS}-beam generate_beam of 8 tokens, fp32: card {a}, cpu {b}")
    if a == b:
        log("  the card's and the CPU's beams agree token for token")
    else:
        k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        lp = {side: blip_seq_logprob(Blip2OptAdapter(cfg32), params_cpu, cfg32, ids, feats["cpu"], seq[: k + 1], cpu)
              for side, seq in (("card", a), ("cpu", b))}
        log(f"  the beams part at step {k}: log-probabilities of the prefixes to it under the fp32 CPU model "
            f"card {lp['card']:.6f}, cpu {lp['cpu']:.6f}, gap {lp['cpu'] - lp['card']:.3g}")
    del params_cpu, params_card
    torch.cuda.empty_cache()

    full_t5 = blip2.Blip2T5Config()
    params = blip2.init_t5(t5_cut(full_t5), device=dev, seed=3)
    params_cpu = to_fp32(params)
    prompt = torch.tensor([tok("Question: Is there a dog in the image? Short answer:").input_ids[1:] + [1]])
    dec_steps = (0, 300, 400)  # the decoder start token, then fixed tokens

    @torch.inference_mode()
    def run_t5(p, c, device):
        q_emb = blip2.encode_image_queries(p, c, image.to(device, c.vision.dtype))
        ids_d = prompt.to(device)
        enc, mask = blip2.t5_encode_with_prefix(p, c, q_emb, ids_d, torch.ones_like(ids_d))
        cross = t5.precompute_cross_kv(p["lm"], c.text, enc)
        cache = t5.init_self_cache(c.text, 1, len(dec_steps), device=device)
        out = [q_emb.float().cpu(), enc.float().cpu()]
        for t_, tok_id in enumerate(dec_steps):
            logits, cache = t5.decode_step(p["lm"], c.text, torch.tensor([tok_id], device=device), t_, cache, cross,
                                           mask)
            out.append(logits.float().cpu())
        return out

    got, ref = run_t5(params, t5_cut(full_t5), dev), run_t5(params_cpu, t5_cut(full_t5, torch.float32), cpu)
    for name, g, r in zip(("encode", "T5 encoder", "decode 0", "decode 1", "decode 2"), got, ref):
        rel_check(g, r, f"BLIP-2 T5 reference {name}: max|card - cpu fp32| / max|cpu|")
    del params, params_cpu
    torch.cuda.empty_cache()


# checkpoints of the new families, written from a random 2-layer tree under
# the LAVIS / HF key names (the inverse of utils/hf_convert's mappings)

MPT_VISION = "transformer.vision_tower.vision_tower.vision_model."
MPT_PROJECTOR = "transformer.mm_projector."
SAFETENSORS_TAGS = {torch.bfloat16: "BF16", torch.float32: "F32"}


def eva_state_dict(vis, cfg, prefix: str = "visual_encoder.") -> dict:
    W, P = cfg.width, cfg.patch_size
    lay = vis["layers"]
    sd = {prefix + "patch_embed.proj.weight": vis["patch_embed"]["w"].reshape(W, 3, P, P),
          prefix + "patch_embed.proj.bias": vis["patch_embed"]["b"], prefix + "cls_token": vis["cls"].reshape(1, 1, W),
          prefix + "pos_embed": vis["pos_embed"].reshape(1, -1, W)}
    leaves = {"norm1.weight": lay["norm1"]["scale"], "norm1.bias": lay["norm1"]["bias"], "attn.qkv.weight": lay["qkv_w"],
              "attn.q_bias": lay["q_bias"], "attn.v_bias": lay["v_bias"], "attn.proj.weight": lay["proj"]["w"],
              "attn.proj.bias": lay["proj"]["b"], "norm2.weight": lay["norm2"]["scale"],
              "norm2.bias": lay["norm2"]["bias"], "mlp.fc1.weight": lay["fc1"]["w"], "mlp.fc1.bias": lay["fc1"]["b"],
              "mlp.fc2.weight": lay["fc2"]["w"], "mlp.fc2.bias": lay["fc2"]["b"]}
    for i in range(cfg.num_layers):
        sd.update({f"{prefix}blocks.{i}.{k}": v[i] for k, v in leaves.items()})
    return sd


def qformer_state_dict(qf, prefix: str = "Qformer.bert.") -> dict:
    sd = {}

    def lin(key, p):
        sd[prefix + key + ".weight"], sd[prefix + key + ".bias"] = p["w"], p["b"]

    def ln(key, p):
        sd[prefix + key + ".weight"], sd[prefix + key + ".bias"] = p["scale"], p["bias"]

    emb = qf["embeddings"]
    sd[prefix + "embeddings.word_embeddings.weight"] = emb["word"]
    sd[prefix + "embeddings.position_embeddings.weight"] = emb["position"]
    ln("embeddings.LayerNorm", emb["ln"])
    for i, lp in enumerate(qf["layers"]):
        b = f"encoder.layer.{i}."
        for att, name in (("self_attn", "attention"), ("cross_attn", "crossattention")):
            if att in lp:
                for leaf, key in (("query", "self.query"), ("key", "self.key"), ("value", "self.value"),
                                  ("out", "output.dense")):
                    lin(f"{b}{name}.{key}", lp[att][leaf])
                ln(f"{b}{name}.output.LayerNorm", lp[att]["ln"])
        for part in ("", "_query"):
            lin(f"{b}intermediate{part}.dense", lp["intermediate" + part])
            lin(f"{b}output{part}.dense", lp["output" + part])
            ln(f"{b}output{part}.LayerNorm", lp[f"output{part}_ln"])
    return sd


def blip2_opt_state_dict(params, cfg) -> dict:
    """A LAVIS blip2_opt state dict of `params` (the Q-Former's text branch
    kept)."""
    sd = eva_state_dict(params["visual"], cfg.vision)
    sd.update({"ln_vision.weight": params["ln_vision"]["scale"], "ln_vision.bias": params["ln_vision"]["bias"],
               "query_tokens": params["query_tokens"][None], "opt_proj.weight": params["proj"]["w"],
               "opt_proj.bias": params["proj"]["b"]})
    sd.update(qformer_state_dict(params["qformer"]))
    lm, p = params["lm"], "opt_model.model.decoder."
    sd.update({p + "embed_tokens.weight": lm["embed_tokens"], p + "embed_positions.weight": lm["embed_positions"],
               p + "final_layer_norm.weight": lm["final_ln"]["scale"], p + "final_layer_norm.bias": lm["final_ln"]["bias"]})
    lay = lm["layers"]
    for i in range(cfg.text.num_layers):
        for leaf, name in (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"), ("v", "self_attn.v_proj"),
                           ("out", "self_attn.out_proj"), ("fc1", "fc1"), ("fc2", "fc2")):
            sd[f"{p}layers.{i}.{name}.weight"], sd[f"{p}layers.{i}.{name}.bias"] = lay[leaf]["w"][i], lay[leaf]["b"][i]
        for leaf, name in (("attn_ln", "self_attn_layer_norm"), ("ffn_ln", "final_layer_norm")):
            sd[f"{p}layers.{i}.{name}.weight"] = lay[leaf]["scale"][i]
            sd[f"{p}layers.{i}.{name}.bias"] = lay[leaf]["bias"][i]
    return sd


def llava_mpt_state_dict(params, cfg) -> dict:
    """An HF LLaVA-MPT state dict of `params` (MPT without norm biases, as
    MPT-7B ships: the converter's zeros stand for them)."""
    m, p = params["mpt"], "transformer."
    sd = {p + "wte.weight": m["wte"], p + "norm_f.weight": m["norm_f"]["scale"]}
    lay = m["layers"]
    for i in range(cfg.text.n_layers):
        for leaf, name in (("wqkv", "attn.Wqkv"), ("out_proj", "attn.out_proj"), ("up_proj", "ffn.up_proj"),
                           ("down_proj", "ffn.down_proj"), ("norm_1", "norm_1"), ("norm_2", "norm_2")):
            w = lay[leaf]["scale"] if leaf.startswith("norm") else lay[leaf]
            sd[f"{p}blocks.{i}.{name}.weight"] = w[i]
    v, P = params["vision"], cfg.vision.patch_size
    D = v["cls"].shape[0]
    sd.update({MPT_VISION + "embeddings.class_embedding": v["cls"],
               MPT_VISION + "embeddings.patch_embedding.weight": v["patch_embed"].t().reshape(D, 3, P, P),
               MPT_VISION + "embeddings.position_embedding.weight": v["pos_embed"]})
    for leaf, name in (("pre_ln", "pre_layrnorm"), ("post_ln", "post_layernorm")):
        sd[MPT_VISION + name + ".weight"], sd[MPT_VISION + name + ".bias"] = v[leaf]["scale"], v[leaf]["bias"]
    for i in range(cfg.vision.num_layers):
        q = MPT_VISION + f"encoder.layers.{i}."
        for leaf, name in CKPT_VISION_LINEARS.items():
            sd[q + name + ".weight"] = v["layers"][leaf]["kernel"][i].t()
            sd[q + name + ".bias"] = v["layers"][leaf]["bias"][i]
        for leaf, name in (("ln1", "layer_norm1"), ("ln2", "layer_norm2")):
            sd[q + name + ".weight"], sd[q + name + ".bias"] = v["layers"][leaf]["scale"][i], v["layers"][leaf]["bias"][i]
    for j, layer in enumerate(params["projector"]["layers"]):
        sd[f"{MPT_PROJECTOR}{2 * j}.weight"], sd[f"{MPT_PROJECTOR}{2 * j}.bias"] = layer["kernel"].t(), layer["bias"]
    return sd


def write_safetensors(path, sd: dict) -> None:
    """One .safetensors file of sd (the format the port's reader takes)."""
    header, blobs, off = {}, [], 0
    for k, t in sd.items():
        b = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[k] = {"dtype": SAFETENSORS_TAGS[t.dtype], "shape": list(t.shape), "data_offsets": [off, off + len(b)]}
        blobs.append(b)
        off += len(b)
    h = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(len(h).to_bytes(8, "little") + h + b"".join(blobs))


def trees_equal(got, want, path: str = "") -> int:
    """Leaf-exact comparison (dtype, shape, values) of two trees; the number
    of leaves held."""
    if isinstance(want, dict):
        if sorted(got) != sorted(want):
            raise AssertionError(f"{path}: keys {sorted(got)} vs {sorted(want)}")
        return sum(trees_equal(got[k], want[k], f"{path}.{k}") for k in want)
    if isinstance(want, list):
        if len(got) != len(want):
            raise AssertionError(f"{path}: {len(got)} vs {len(want)} entries")
        return sum(trees_equal(g, w, f"{path}[{i}]") for i, (g, w) in enumerate(zip(got, want)))
    if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"checkpoint leaf {path}: not its source tensor ({got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)})")
    return 1


def phase_family_checkpoints(dev, smi: str) -> None:
    """A 2-layer BLIP-2 OPT (LAVIS names, two .bin shards) and a 2-layer
    LLaVA-MPT (3 CLIP layers; HF names, one .safetensors file written here)
    at full width, bf16, from random trees: each written to a temporary dir, read
    by utils.hf_convert.load_state_dict and converted onto the card
    (convert_blip2_opt; convert_mpt + convert_clip + convert_projector),
    every leaf held exactly against the tree it was written from."""
    import shutil
    import tempfile

    from llava_align_tpu_torch.models import blip2, llava_mpt
    from llava_align_tpu_torch.utils import hf_convert

    cases = (
        ("BLIP-2 OPT-2.7b", blip_cut(blip2.Blip2OptConfig()), blip2.init_opt, blip2_opt_state_dict, "bin",
         lambda sd, c: hf_convert.convert_blip2_opt(sd, c, device=dev)),
        ("LLaVA-MPT-7B", mpt_cut(llava_mpt.LlavaMptConfig()), llava_mpt.init, llava_mpt_state_dict, "safetensors",
         lambda sd, c: {"mpt": hf_convert.convert_mpt(sd, c.text, device=dev),
                        "vision": hf_convert.convert_clip(sd, c.vision, prefix=MPT_VISION, device=dev),
                        "projector": hf_convert.convert_projector(sd, c.mm_projector_type, c.text.dtype,
                                                                  prefix=MPT_PROJECTOR, device=dev)}),
    )
    for what, cfg, init, to_sd, fmt, convert in cases:
        root = Path(tempfile.mkdtemp(prefix="family_ckpt_"))
        try:
            params = init(cfg, device=dev, seed=5)
            sd = {k: v.cpu() for k, v in to_sd(params, cfg).items()}
            if fmt == "bin":
                keys = sorted(sd)
                for n, part in enumerate((keys[: len(keys) // 2], keys[len(keys) // 2:]), 1):
                    torch.save({k: sd[k] for k in part}, root / f"pytorch_model-{n:05d}-of-00002.bin")
            else:
                write_safetensors(root / "model.safetensors", sd)
            nbytes = sum(f.stat().st_size for f in root.iterdir())
            del sd
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loaded = convert(hf_convert.load_state_dict(str(root)), cfg)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            n = trees_equal(loaded, params, what)
            log(f"{what} checkpoint (2 layers, full width, {fmt}) on {smi}: {nbytes / 1e9:.4f} GB read and converted "
                f"in {secs:.4f} s, {nbytes / secs / 1e9:.4f} GB/s (files just written: the page cache); {n} leaves "
                f"equal their source tensors exactly")
            del params, loaded
        finally:
            shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# training (LLaVA): the 7B step at full width and depth, the config CLI on
# a 2-layer full-width checkpoint, and the fp32 reference card vs CPU
# ---------------------------------------------------------------------------

TRAIN_CAPTION = ("a photo of a small dog sitting on a red mat next to an old wooden chair in the sun "
                 "by the window")  # 19 words: the mock tokenizer keeps 16
TRAIN_BATCH = 2
TRAIN_TIMED = 4
# the reference's optimizer: the registered schedule with a real warm-up
# (from 1e-5 to 1e-4 over one step), the clip on
TRAIN_REF_LR = 1e-4
TRAIN_REF_TOL = 1e-3


def write_caption_files(root: Path, n: int) -> Path:
    """A coco_caption annotation file of n rows over n // 2 image names
    (absent: the data path's synthetic images)."""
    root.mkdir(parents=True, exist_ok=True)
    ann = root / "captions.json"
    ann.write_text(json.dumps([{"image": f"img_{i // 2}.jpg", "caption": f"{TRAIN_CAPTION} {i}",
                                "image_id": i // 2} for i in range(n)]))
    return ann


def caption_loader(cfg, ann: Path, batch: int, prep):
    """The train CLI's data path for one epoch: coco_caption through
    build_datasets_for_model (BlipImageEvalProcessor at the tower's size),
    _batches with the mock tokenizer, then the arch's prep."""
    from llava_align_tpu_torch.framework.datasets import build_datasets_for_model
    from llava_align_tpu_torch.framework.registry import registry
    from llava_align_tpu_torch.runners import train as train_cli
    from llava_align_tpu_torch.runners.common import resolve_tokenizer

    task = registry.get_task_class("captioning")()
    sets = build_datasets_for_model(task, types.SimpleNamespace(cfg=cfg), {"coco_caption": {
        "build_info": {"train": {"ann_paths": [str(ann)], "vis_root": str(ann.parent)}}, "synthetic_images": True}})
    tokenize = resolve_tokenizer({}, cfg.text.vocab_size)
    return [prep(b) for b in train_cli._batches(sets["coco_caption"]["train"], batch, tokenize=tokenize)]


def train_flops(cfg, B: int, S: int) -> float:
    """Model FLOPs of one step (forward + backward = 3 x forward): 2 per
    multiply-add over each dense weight the step runs (the decoder's
    layers and lm_head at B*S positions, the CLIP layers select_layer runs
    at B*(1+N) positions, the projector at B*N), plus attention's QK^T and
    PV at full S x S as mha computes them."""
    t, v = cfg.text, cfg.vision
    D, F, L, V = t.hidden_size, t.intermediate_size, t.num_layers, t.vocab_size
    dec = L * (2 * D * t.q_dim + 2 * D * t.kv_dim + 3 * D * F) + D * V
    vD, vF, vL = v.hidden_size, v.intermediate_size, v.num_layers + 1 + v.select_layer
    Nv = 1 + v.num_patches
    vis = vL * (4 * vD * vD + 2 * vD * vF)
    proj = vD * D + D * D
    attn = L * 2 * 2 * B * S * S * t.q_dim + vL * 2 * 2 * B * Nv * Nv * vD
    return 3 * (2 * dec * B * S + 2 * vis * B * Nv + 2 * proj * B * v.num_patches + attn)


def train_step_split(cfg, params, opt_state, tx, batch) -> dict:
    """One train step as make_train_step runs it, timed in its parts
    (synchronized wall): the loss's forward, autograd's backward, and the
    optimizer's in-place update."""
    from llava_align_tpu_torch.train import trainer

    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    leaves = trainer.trainable_leaves(params)
    with torch.enable_grad():
        loss = trainer.multimodal_lm_loss(params, cfg, batch)
        torch.cuda.synchronize()
        out["forward"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    torch.cuda.synchronize()
    out["backward"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tx.step(params, grads, opt_state)
    torch.cuda.synchronize()
    out["optimizer"] = time.perf_counter() - t0
    return out


def phase_train(dev, smi: str) -> dict:
    """LLaVA-v1.5-7B as the port's zoo builds it (LlavaModel(size="7b"):
    bf16, random, full width and depth, CLIP ViT-L/336 included) trained by
    runners/train's llava step with main's optimizer (build_optimizer at
    its defaults: linear_warmup_cosine_lr from 1e-4, weight decay 0.05 under
    the decay mask, clip 1.0) through framework.runner.Runner (no
    checkpoint: ~56 GB of params and moments), on TRAIN_BATCH rows of
    <image> + a 16-token caption from the caption data path (608
    positions): one warm step, then TRAIN_TIMED timed, then one more split
    into forward, backward and optimizer. Prints s/step, tokens/s, model
    TFLOP/s, peak memory, each step's loss (finite), and the kernels'
    launches (K1-K4 must stay at 0: no TPU kernel on this
    path). A batch that does not fit retries with one row."""
    import tempfile

    from llava_align_tpu_torch.framework.model_zoo import LlavaModel
    from llava_align_tpu_torch.framework.optims import build_optimizer
    from llava_align_tpu_torch.framework.runner import Runner, RunnerConfig
    from llava_align_tpu_torch.runners import train as train_cli

    t0 = time.perf_counter()
    model = LlavaModel(size="7b", device=dev)
    torch.cuda.synchronize()
    n = n_params(model.params)
    log(f"train: built LlavaModel(size='7b') on {dev} in {time.perf_counter() - t0:.2f} s: {n / 1e9:.4f} G "
        f"parameters, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    root = Path(tempfile.mkdtemp(prefix="llava_train_"))
    try:
        for batch in (TRAIN_BATCH, 1):
            steps = 1 + TRAIN_TIMED
            tx = build_optimizer(init_lr=1e-4, max_steps=steps, steps_per_epoch=steps)
            step, init_state, prep = train_cli._make_train_step("llava", model, tx, device=dev)
            batches = caption_loader(model.cfg, write_caption_files(root, batch * steps), batch, prep)
            secs, losses = [], []

            def timed_step(params, opt_state, b):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = step(params, opt_state, b)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
                losses.append(float(out[2]))
                return out

            try:
                opt_state = init_state(model.params)
                reset_launches()
                torch.cuda.reset_peak_memory_stats()
                runner = Runner(RunnerConfig(max_epoch=1, output_dir=str(root / "out"), save_last=False,
                                             log_freq=100), timed_step, model.params, opt_state, lambda e: batches)
                runner.train()
                break
            except torch.cuda.OutOfMemoryError:
                if batch == 1:
                    raise
                log(f"train: batch {batch} does not fit ({torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                    "at the failure); taking batch 1")
                runner = opt_state = None
                torch.cuda.empty_cache()
        torch.cuda.synchronize()
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        S = batches[0]["tokens"].shape[1]
        if not all(np.isfinite(losses)) or len(losses) != steps:
            raise AssertionError(f"train: losses {losses}")
        if any(launches.values()):
            raise AssertionError(f"train: a kernel launched under autograd: {launches}")
        s_step = sum(secs[1:]) / TRAIN_TIMED
        flops = train_flops(model.cfg, batch, S)
        split = train_step_split(model.cfg, runner.params, runner.opt_state, tx, batches[-1])
        log(f"train 7B on {smi}: batch {batch} x {S} positions, steps {[round(s, 4) for s in secs]} s "
            f"(first = warm-up); {s_step:.4f} s/step, {batch * S / s_step:.1f} tokens/s (positions), "
            f"{flops / s_step / 1e12:.2f} model TFLOP/s ({flops / 1e12:.2f} TFLOP a step), peak "
            f"{peak:.2f} GiB; losses {[round(x, 4) for x in losses]}; launches {launches}")
        log(f"  one more step split on {smi}: " + ", ".join(f"{k} {v:.4f} s" for k, v in split.items()))
        print(json.dumps({"train_7b": {"batch": batch, "positions": S, "params": n, "s_per_step": s_step,
                                       "split_s": split,
                                       "step_s": secs, "tokens_per_s": batch * S / s_step,
                                       "model_tflops": flops / s_step / 1e12, "peak_gib": peak,
                                       "losses": losses}}), flush=True)
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    del model, runner, opt_state, step, batches
    torch.cuda.empty_cache()
    return launches


def phase_train_cli(dev, smi: str) -> dict:
    """runners/train.main on the card (no run.device: the GPU) with a
    captioning YAML: a llava-v1.5-7b-shaped checkpoint dir (CKPT_CONFIG: 2
    decoder layers at full width, the whole ViT-L/336; bf16 .bin shards
    written here) as model_path, coco_caption over 4 synthetic images, batch
    2, 2 epochs, checkpoint_last written each epoch; then a resume from
    checkpoint_last (run.resume_ckpt_path) to max_epoch 3 trains one more
    epoch. Each epoch's loss must be finite, the state's epoch/iters/count
    must follow, and no kernel may launch."""
    import shutil
    import tempfile

    import yaml

    from llava_align_tpu_torch.framework.runner import CHECKPOINT_FILE, Runner
    from llava_align_tpu_torch.runners import train as train_cli

    root = Path(tempfile.mkdtemp(prefix="llava_train_cli_"))
    losses = []
    orig = Runner.train_epoch

    def recording(self, epoch):
        stats = orig(self, epoch)
        losses.append(stats["loss"])
        return stats

    try:
        ckpt = root / "ckpt"
        ckpt.mkdir()
        sd = checkpoint_state_dict(dev, seed=11)
        (ckpt / "config.json").write_text(json.dumps(CKPT_CONFIG))
        torch.save({k: v.cpu() for k, v in sd.items()}, ckpt / "pytorch_model.bin")
        del sd
        ann = write_caption_files(root, 8)
        cfg = {"model": {"arch": "llava", "model_path": str(ckpt)},
               "datasets": {"coco_caption": {"build_info": {"train": {"ann_paths": [str(ann)],
                                                                      "vis_root": str(root)}},
                                             "synthetic_images": True}},
               "run": {"task": "captioning", "batch_size_train": 2, "max_epoch": 2, "init_lr": 1e-4,
                       "warmup_steps": 1, "warmup_lr": 1e-5, "log_freq": 100, "output_dir": str(root / "out")}}
        (root / "train.yaml").write_text(yaml.safe_dump(cfg))
        state_path = root / "out" / "checkpoint_last" / CHECKPOINT_FILE
        reset_launches()
        with patched(Runner, "train_epoch", recording):
            t0 = time.perf_counter()
            train_cli.main(["--cfg-path", str(root / "train.yaml")])
            torch.cuda.synchronize()
            t_main = time.perf_counter() - t0
            state = torch.load(state_path, map_location="cpu", weights_only=True)
            if (state["epoch"], state["iters"], state["opt_state"]["count"]) != (1, 8, 8):
                raise AssertionError(f"train CLI: checkpoint_last at epoch {state['epoch']}, iters "
                                     f"{state['iters']}, count {state['opt_state']['count']}")
            del state
            t0 = time.perf_counter()
            train_cli.main(["--cfg-path", str(root / "train.yaml"), "--options", "run.max_epoch=3",
                            f"run.resume_ckpt_path={root / 'out' / 'checkpoint_last'}"])
            torch.cuda.synchronize()
            t_resume = time.perf_counter() - t0
        launches = read_launches()
        state = torch.load(state_path, map_location="cpu", weights_only=True)
        ok = (state["epoch"], state["iters"], state["opt_state"]["count"]) == (2, 12, 12)
        nbytes = state_path.stat().st_size
        del state
        log(f"train CLI on {smi}: main (2 epochs of 4 steps, checkpoint_last each epoch, {nbytes / 1e9:.3f} GB) "
            f"{t_main:.2f} s, resume (1 epoch) {t_resume:.2f} s; per-epoch losses {[round(x, 4) for x in losses]}; "
            f"launches {launches}")
        if not ok or len(losses) != 3 or not all(np.isfinite(losses)):
            raise AssertionError(f"train CLI: resume state {ok}, losses {losses}")
        if any(launches.values()):
            raise AssertionError(f"train CLI: a kernel launched under autograd: {launches}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def tree_copy(node, device):
    """A copy of the tree on `device` (a new tensor even where it lies
    there already: training updates in place)."""
    if isinstance(node, dict):
        return {k: tree_copy(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [tree_copy(v, device) for v in node]
    return node.to(device, copy=True)


def phase_train_reference(dev) -> None:
    """The 7B model cut to 2 decoder / 2 vision layers at full width, fp32
    (TF32 off), trained 3 AdamW steps (registered warm-up-cosine schedule
    warming up from 1e-5 over one step, clip 1.0) on the card and on the
    CPU from the same params and batches (1 row of <image> + 16 tokens),
    then a second run of 4 micro-steps with accum_grad_iters=2: each step's
    loss within TRAIN_REF_TOL relative, every leaf within 2 x lr x applied
    steps (Adam's sign-like step turns rounding noise in a near-zero
    gradient into up to +-lr). Card and CPU run in lockstep, and each
    call's loss gap and the params' gap after it are printed."""
    from llava_align_tpu_torch.config import LlavaConfig
    from llava_align_tpu_torch.framework.optims import build_optimizer, tree_leaves
    from llava_align_tpu_torch.runners import train as train_cli
    from llava_align_tpu_torch.utils.synthetic import build_random_llava_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cut_config(LlavaConfig.llava_v15_7b(), torch.float32)
    cpu_params = build_random_llava_params(cfg, device="cpu", seed=5)
    import tempfile

    root = Path(tempfile.mkdtemp(prefix="llava_train_ref_"))
    for accum, calls in ((1, 3), (2, 4)):
        runs, secs = {}, {}
        for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
            tx = build_optimizer(init_lr=TRAIN_REF_LR, warmup_steps=1, warmup_start_lr=1e-5, max_steps=3,
                                 max_grad_norm=1.0, accum_grad_iters=accum)
            step, init_state, prep = train_cli._make_train_step("llava", types.SimpleNamespace(cfg=cfg), tx,
                                                                device=device)
            params = tree_copy(cpu_params, device)
            runs[name] = [params, init_state(params), step, caption_loader(cfg, write_caption_files(root, calls), 1,
                                                                           prep)]
            secs[name] = 0.0
        # card and CPU in lockstep, each call's loss and params compared as they go
        per_step = []
        for i in range(calls):
            losses = {}
            for name, r in runs.items():
                t0 = time.perf_counter()
                r[0], r[1], loss = r[2](r[0], r[1], r[3][i])
                losses[name] = float(loss)
                if name == "card":
                    torch.cuda.synchronize()
                secs[name] += time.perf_counter() - t0
            with torch.no_grad():
                dmax = max(float((a.detach().cpu() - b.detach()).abs().max())
                           for a, b in zip(tree_leaves(runs["card"][0]), tree_leaves(runs["cpu"][0])))
            per_step.append((losses["card"], losses["cpu"], abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"]),
                             dmax, int(runs["cpu"][1]["count"])))
        cl, rl = [x[0] for x in per_step], [x[1] for x in per_step]
        rel = max(x[2] for x in per_step)
        dmax = per_step[-1][3]
        cc, rc = runs["card"][1]["count"], runs["cpu"][1]["count"]
        bound = 2 * TRAIN_REF_LR * rc
        ok = cc == rc == calls // accum and rel <= TRAIN_REF_TOL and dmax <= bound
        log(f"train reference (2-layer 7B cut, fp32, accum {accum}, {calls} calls, {rc} updates): losses card "
            f"{[round(x, 6) for x in cl]} cpu {[round(x, 6) for x in rl]}, max rel {rel:.3g} (tol "
            f"{TRAIN_REF_TOL}); max |param card - cpu| {dmax:.3g} (bound 2 lr steps {bound:.3g}); card "
            f"{secs['card']:.2f} s, cpu {secs['cpu']:.2f} s {'ok' if ok else 'FAIL'}")
        # the gap split by call: the loss of call i is computed before its update (call 0: the
        # untouched params, forward only), the params after it
        for i, (a, b, r, d, n) in enumerate(per_step):
            log(f"  call {i}: loss card {a:.8f} cpu {b:.8f}, rel {r:.3g}; after it ({n} updates) max |param card "
                f"- cpu| {d:.3g}")
        if not ok:
            raise AssertionError("train reference: card and CPU disagree")
        del runs
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the LAVIS zoo (ALBEF, BLIP, CLIP, BLIP-2's training losses): the CLI's
# four train archs at the JAX configs, BLIP-2's three losses with their
# backward, BLIP captions and retrieval, each at full width and depth, then
# 2-layer full-width fp32 cuts card against CPU. No TPU kernel lies on
# these paths (plain torch, as XLA runs them in JAX): each path's
# launches_by_path entry records K1-K4 at zero.
# ---------------------------------------------------------------------------

LAVIS_TIMED = 3  # timed steps after one warm step
LAVIS_REF_TOL = 1e-3
LAVIS_CAPTIONS = 4
LAVIS_PROMPT = [30522, 1037, 3861, 1997]  # [DEC] a picture of


def lavis_arch_models(dev) -> list:
    """(arch, what, model, batch, builder) of the CLI's four LAVIS archs at
    the JAX package's configs, random fp32 trees from a seed on `dev`."""
    from llava_align_tpu_torch.models import albef, blip, blip_variants, clip

    acfg, bcfg, ccfg = albef.AlbefConfig(num_classes=3), blip.BlipConfig(), clip.ClipConfig()
    return [
        ("albef_retrieval", "ALBEF retrieval (ViT-B/16 at 384, BERT-base fused from layer 6, a 65536 queue)",
         types.SimpleNamespace(cfg=acfg, params=albef.init(acfg, "retrieval", device=dev, seed=1)), 16,
         "retrieval"),
        ("albef_classification", "ALBEF classification (the same towers, 3 classes)",
         types.SimpleNamespace(cfg=acfg, params=albef.init(acfg, "classification", device=dev, seed=2)), 16,
         "multimodal_classification"),
        ("blip_classification", "BLIP classification (ViT-B/16 at 224, BERT-base, 3 classes)",
         types.SimpleNamespace(cfg=bcfg, params=blip_variants.init_classification(bcfg, 3, device=dev, seed=3)), 32,
         "multimodal_classification"),
        ("clip", "CLIP (ViT-B/32 at 224, the 12-layer text tower)",
         types.SimpleNamespace(cfg=ccfg, params=clip.init(ccfg, device=dev, seed=4)), 64, "retrieval"),
    ]


def lavis_batches(arch: str, model, builder: str, batch: int, n: int, root: Path, prep) -> list:
    """n batches of the CLI's data path: `builder` over synthetic images
    (build_datasets_for_model's processor at the tower's size), _batches
    with the mock tokenizer, the arch's prep."""
    from llava_align_tpu_torch.framework.datasets import build_datasets_for_model
    from llava_align_tpu_torch.framework.registry import registry
    from llava_align_tpu_torch.runners import train as train_cli
    from llava_align_tpu_torch.runners.common import resolve_tokenizer

    root.mkdir(parents=True, exist_ok=True)
    ann = root / f"{arch}.json"
    rows = batch * n
    if builder == "retrieval":
        ann.write_text(json.dumps([{"image": f"img_{i}.jpg", "caption": f"{TRAIN_CAPTION} {i}", "image_id": i}
                                   for i in range(rows)]))
    else:
        ann.write_text(json.dumps([{"image": f"img_{i}.jpg", "sentence": f"{TRAIN_CAPTION} {i}", "label": i % 3}
                                   for i in range(rows)]))
    task = registry.get_task_class(builder)()
    sets = build_datasets_for_model(task, model, {"tiny": {"builder": builder, "synthetic_images": True,
                                                           "build_info": {"train": {"ann_paths": [str(ann)]}}}})
    tokenize = resolve_tokenizer({}, model.cfg.text.vocab_size)
    return [prep(b) for b in train_cli._batches(sets["tiny"]["train"], batch, tokenize=tokenize)]


def phase_lavis_train(dev, smi: str) -> dict:
    """Each of the train CLI's LAVIS archs (albef_retrieval, its momentum
    tree and queue in the step's state; albef_classification;
    blip_classification; clip) at the JAX package's config, fp32, random
    from a seed: runners/train's step with main's optimizer
    (build_optimizer's defaults) through framework.runner.Runner on the
    CLI's data path, one warm step and LAVIS_TIMED timed. Prints s/step,
    samples/s, peak memory and the losses (finite). K1-K4 must not
    launch."""
    import shutil
    import tempfile

    from llava_align_tpu_torch.framework.optims import build_optimizer
    from llava_align_tpu_torch.framework.runner import Runner, RunnerConfig
    from llava_align_tpu_torch.runners import train as train_cli

    root = Path(tempfile.mkdtemp(prefix="lavis_train_"))
    by_path, rows = {}, {}
    try:
        for arch, what, model, batch, builder in lavis_arch_models(dev):
            n = n_params(model.params)
            steps = 1 + LAVIS_TIMED
            tx = build_optimizer(init_lr=1e-4, max_steps=steps, steps_per_epoch=steps)
            step, init_state, prep = train_cli._make_train_step(arch, model, tx, device=dev)
            batches = lavis_batches(arch, model, builder, batch, steps, root, prep)
            secs, losses = [], []

            def timed_step(params, opt_state, b):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = step(params, opt_state, b)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
                losses.append(float(out[2]))
                return out

            reset_launches()
            torch.cuda.reset_peak_memory_stats()
            Runner(RunnerConfig(max_epoch=1, output_dir=str(root / "out"), save_last=False, log_freq=100),
                   timed_step, model.params, init_state(model.params), lambda e: batches).train()
            launches = read_launches()
            peak = torch.cuda.max_memory_allocated() / 2**30
            if len(losses) != steps or not all(np.isfinite(losses)):
                raise AssertionError(f"{arch}: losses {losses}")
            if any(launches.values()):
                raise AssertionError(f"{arch}: a kernel launched under autograd: {launches}")
            s_step = sum(secs[1:]) / LAVIS_TIMED
            log(f"{what} on {smi}: train CLI step ({n / 1e6:.1f} M parameters, fp32, batch {batch}), steps "
                f"{[round(s, 4) for s in secs]} s (first = warm-up); {s_step:.4f} s/step, {batch / s_step:.2f} "
                f"samples/s, peak {peak:.2f} GiB; losses {[round(x, 4) for x in losses]}; launches {launches}")
            rows[arch] = {"batch": batch, "params": n, "s_per_step": s_step, "samples_per_s": batch / s_step,
                          "step_s": secs, "peak_gib": peak, "losses": losses}
            by_path[f"{arch}_train"] = launches
            model.params = None
            del model, step, init_state, batches
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"lavis_train": rows}), flush=True)
    return by_path


def blip2_trainable(params) -> list:
    """The leaves BLIP-2's LAVIS training updates: the Q-Former, the query
    tokens and the heads / LM projection (the ViT and the LM frozen)."""
    from llava_align_tpu_torch.framework.optims import tree_leaves

    return [x for k, v in params.items() if k not in ("visual", "ln_vision", "lm") for x in tree_leaves(v)]


def phase_blip2_losses(dev, smi: str) -> dict:
    """BLIP-2's three training losses at full width and depth, bf16, random
    from a seed, each with its backward into the trainable leaves (the
    ViT and the LM frozen, as LAVIS trains them): stage 1's pretrain_forward
    (EVA ViT-g + the Q-Former: ITC, ITM with sampled hard negatives, the
    captioning LM) on 8 images x 32 tokens, opt_forward_loss at OPT-2.7b and
    t5_forward_loss at FlanT5-XL on 4 images. One warm call, one timed."""
    from llava_align_tpu_torch.models import blip2

    rng = np.random.default_rng(11)
    by_path, rows = {}, {}
    cases = (("stage1", "BLIP-2 stage 1 pretrain_forward", blip2.Blip2QformerConfig(), blip2.init_stage1, 8),
             ("opt", "BLIP-2 OPT-2.7b opt_forward_loss", blip2.Blip2OptConfig(), blip2.init_opt, 4),
             ("t5", "BLIP-2 FlanT5-XL t5_forward_loss", blip2.Blip2T5Config(), blip2.init_t5, 4))
    for name, what, cfg, init, B in cases:
        params = init(cfg, device=dev, seed=5)
        H = cfg.vision.image_size
        images = torch.from_numpy(rng.standard_normal((B, 3, H, H)).astype(np.float32)).to(dev, cfg.vision.dtype)
        vocab = cfg.qformer.vocab_size if name == "stage1" else cfg.text.vocab_size
        ids = torch.from_numpy(rng.integers(3, vocab, (B, 32 if name == "stage1" else 24))).to(dev)
        mask = torch.ones_like(ids)
        mask[-1, -6:], ids[-1, -6:] = 0, 0
        gen = torch.Generator(device=dev).manual_seed(0)
        if name == "stage1":
            def loss_fn():
                return blip2.pretrain_forward(params, cfg, images, ids, mask, bos_token_id=101, pad_token_id=0,
                                              generator=gen)["loss"]
        elif name == "opt":
            def loss_fn():
                return blip2.opt_forward_loss(params, cfg, images, ids, mask, pad_token_id=0)
        else:
            def loss_fn():
                return blip2.t5_forward_loss(params, cfg, images, ids[:, :16], mask[:, :16], ids[:, 16:],
                                             mask[:, 16:])
        leaves = blip2_trainable(params)
        for x in leaves:
            x.requires_grad_(True)

        def fwd_bwd():
            with torch.enable_grad():
                loss = loss_fn()
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            return float(loss.detach()), sum(float(g.float().square().sum()) for g in grads if g is not None) ** 0.5

        fwd_bwd()  # warm-up
        (loss, gnorm), secs, launches = timed(fwd_bwd)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not (np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0):
            raise AssertionError(f"{what}: loss {loss}, gradient norm {gnorm}")
        if any(launches.values()):
            raise AssertionError(f"{what}: a kernel launched: {launches}")
        log(f"{what} + backward on {smi} ({n_params(params) / 1e9:.3f} G parameters bf16, "
            f"{sum(x.numel() for x in leaves) / 1e6:.1f} M trainable, batch {B}): {secs:.4f} s/step, "
            f"{B / secs:.2f} samples/s, peak {peak:.2f} GiB; loss {loss:.4f}, gradient norm {gnorm:.4g}; "
            f"launches {launches}")
        rows[name] = {"batch": B, "s_per_step": secs, "samples_per_s": B / secs, "peak_gib": peak, "loss": loss}
        by_path[f"blip2_{name}_loss"] = launches
        del params, leaves, images
        torch.cuda.empty_cache()
    print(json.dumps({"blip2_losses": rows}), flush=True)
    return by_path


def phase_blip(dev, smi: str) -> dict:
    """BLIP (ViT-B/16 at 224, BERT-base with cross-attention) at full width
    and depth, fp32, random from a seed: generate_caption greedy and with 3
    beams (20 tokens at most) on LAVIS_CAPTIONS images, and
    compute_sim_matrix over RETRIEVAL images x texts with the ITM re-rank of
    the top RETRIEVAL_K."""
    from llava_align_tpu_torch.models import blip

    cfg = blip.BlipConfig()
    params = blip.init(cfg, device=dev, seed=6)
    H = cfg.vision.image_size
    rng = np.random.default_rng(12)
    images = torch.from_numpy(rng.standard_normal((RETRIEVAL, 3, H, H)).astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.integers(1000, 30000, (RETRIEVAL, 16))).to(dev)
    ids[:, 0] = 101
    mask = torch.ones_like(ids)
    by_path = {}
    kw = dict(max_new_tokens=20, eos_token_id=102)
    blip.generate_caption(params, cfg, images[:1], LAVIS_PROMPT, max_new_tokens=1)  # warm-up
    for beams in (1, 3):
        caps, secs, launches = timed(lambda: blip.generate_caption(params, cfg, images[:LAVIS_CAPTIONS],
                                                                   LAVIS_PROMPT, num_beams=beams, **kw))
        if len(caps) != LAVIS_CAPTIONS or not all(len(c) <= 20 for c in caps):
            raise AssertionError(f"BLIP captions: {caps}")
        family_report(f"BLIP generate_caption ({'greedy' if beams == 1 else f'{beams} beams'}, {LAVIS_CAPTIONS} "
                      "images, 20 tokens at most)", smi, secs, [len(c) for c in caps], "captions", float("nan"),
                      launches)
        by_path[f"blip_caption_{beams}"] = launches
    (i2t, t2i), secs, launches = timed(lambda: blip.compute_sim_matrix(params, cfg, images, ids, mask,
                                                                        k_test=RETRIEVAL_K))
    for name, m in (("i2t", i2t), ("t2i", t2i)):
        if m.shape != (RETRIEVAL, RETRIEVAL) or not ((m != -100.0).sum(1) == RETRIEVAL_K).all():
            raise AssertionError(f"BLIP compute_sim_matrix {name}: {m}")
    log(f"BLIP compute_sim_matrix ({RETRIEVAL} x {RETRIEVAL}, ITM re-rank of the top {RETRIEVAL_K}) on {smi}: "
        f"{secs:.4f} s, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}")
    by_path["blip_sim_matrix"] = launches
    if any(v for p in by_path.values() for v in p.values()):
        raise AssertionError(f"BLIP: a kernel launched: {by_path}")
    del params
    torch.cuda.empty_cache()
    return by_path


def phase_lavis_reference(dev) -> None:
    """Each new family cut to 2 layers per tower at full width, fp32 (TF32
    off), the same params and inputs on the card and on the CPU: the losses
    (ITM logits for BLIP) within LAVIS_REF_TOL relative."""
    from llava_align_tpu_torch.utils.lavis_cuts import cut_cases, tree_to

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for what, params, fn in cut_cases().values():
        t0 = time.perf_counter()
        with torch.no_grad():
            want = fn(params, torch.device("cpu"))
            got = fn(tree_to(params, dev), dev).cpu()
        err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-12)
        ok = bool(torch.isfinite(got).all()) and err <= LAVIS_REF_TOL
        log(f"LAVIS reference, {what} (2 layers per tower, full width, fp32): card {got.flatten()[:4].tolist()} "
            f"cpu {want.flatten()[:4].tolist()}, max rel {err:.3g} (tol {LAVIS_REF_TOL}), "
            f"{time.perf_counter() - t0:.2f} s {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"LAVIS reference {what}: card and CPU disagree")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the evaluation CLI, ALPRO + TimeSformer and GPT-2 dialogue (phase 18):
# evaluate.main on tiny YAMLs, the CLI's VQA and retrieval loops at the JAX
# configs, ALPRO QA and its train step, GPT-2 dialogue. Plain torch, no TPU
# kernel on these paths: each launches_by_path entry holds K1-K4 at zero.
# ---------------------------------------------------------------------------

EVAL_CAPTIONS = ["a dog on a couch", "a red bicycle", "two cats asleep", "a man with a kite", "dog again here",
                 "bike once more", "cats in the sun", "kite over a beach"]
EVAL_VQA = (16, 128)          # questions, answer list (= candidates)
ALPRO_RET = (16, 32, 16)      # videos, captions, k_test
ALPRO_QA_CLASSES = 1500       # LAVIS's MSRVTT-QA answer classes
ALPRO_TRAIN_BATCH = 8
GPT_DIALOGUE = (8, 40, 200)   # dialogues, feature rows, tokens
GPT_GENERATE = (4, 20)        # dialogues, new tokens


def eval_cli_yaml(root: Path, case: str, arch: str, task: str) -> Path:
    """A tiny evaluation YAML for `arch` (its zoo entry's random tiny tree)
    over synthetic images (videos for alpro_retrieval)."""
    import yaml

    root.mkdir(parents=True, exist_ok=True)
    ann, run, model, info = root / f"{case}.json", {"task": task, "split": "test"}, {"arch": arch}, {}
    builder = task
    if task == "retrieval":
        key = "video" if arch.startswith("alpro") else "image"
        builder = "video_retrieval" if key == "video" else "retrieval"
        rows = [{key: f"{key}{i}.jpg", "caption": EVAL_CAPTIONS[2 * i: 2 * i + 2], "image_id": i} for i in range(4)]
        run["k_test"] = 2
    elif task == "multimodal_classification":
        rows = [{"image": f"{i}.jpg", "sentence": c, "label": i % 2} for i, c in enumerate(EVAL_CAPTIONS[:4])]
        model["num_classes"] = 2
    else:
        answers = ["dog", "cat", "two", "red", "kite"]
        rows = [{"image": f"q{i}.jpg", "question": f"what is in picture {i}?", "question_id": i,
                 "answer": [answers[i % 5]] * 3 + [answers[(i + 1) % 5]] * 7} for i in range(4)]
        (root / "answers.json").write_text(json.dumps(answers))
        info["answer_list_path"] = str(root / "answers.json")
        run.update(num_ans_candidates=3, task_args={"result_dir": str(root / "results")})
    ann.write_text(json.dumps(rows))
    cfg = {"run": run, "model": model,
           "datasets": {"tiny": {"builder": builder, "synthetic_images": True,
                                 "build_info": {"test": {"ann_paths": [str(ann)], **info}}}}}
    path = root / f"{case}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def phase_eval_cli(smi: str) -> dict:
    """runners/evaluate.main, as a user runs it on the card (no
    run.device), on each tiny YAML: its metrics line must carry the task's
    keys in range. K1-K4 must not launch."""
    import shutil
    import tempfile

    from llava_align_tpu_torch.runners import evaluate

    root = Path(tempfile.mkdtemp(prefix="eval_cli_"))
    by_path = {}
    try:
        for arch, task in (("albef_retrieval", "retrieval"), ("clip", "retrieval"), ("alpro_retrieval", "retrieval"),
                           ("albef_classification", "multimodal_classification"), ("albef_vqa", "vqa")):
            path = eval_cli_yaml(root / arch, arch, arch, task)
            metrics, secs, launches = timed(lambda: evaluate.main(["--cfg-path", str(path)]))
            keys = {"retrieval": ("txt_r1", "img_r10", "r_mean"), "multimodal_classification": ("acc", "n"),
                    "vqa": ("accuracy", "n")}[task]
            if not all(k in metrics for k in keys) or not 0 <= metrics["agg_metrics"] <= 100:
                raise AssertionError(f"evaluate.main {arch}: {metrics}")
            if any(launches.values()):
                raise AssertionError(f"evaluate.main {arch}: a kernel launched: {launches}")
            log(f"evaluate.main {task} / {arch} (the zoo's tiny tree, fp32) on {smi}: {secs:.4f} s; "
                f"agg_metrics {metrics['agg_metrics']:.4f}; launches {launches}")
            by_path[f"eval_cli_{arch}"] = launches
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return by_path


def eval_full_models(dev) -> dict:
    """The JAX package's full configs, random fp32 trees from a seed on
    `dev`: name → (what, model namespace)."""
    from llava_align_tpu_torch.models import albef, alpro, blip, blip_variants, gpt2

    acfg, bcfg = albef.AlbefConfig(), blip.BlipConfig()
    ap, bp = albef.init(acfg, "vqa", device=dev, seed=21), blip_variants.init_vqa(bcfg, device=dev, seed=22)
    vcfg, qcfg = alpro.AlproConfig(), alpro.AlproConfig(num_classes=ALPRO_QA_CLASSES)
    return {
        "albef_vqa": ("ALBEF VQA (ViT-B/16 at 384, BERT-base fused from layer 6, a 6-layer answer decoder)",
                      types.SimpleNamespace(cfg=acfg, params=ap, predict_answers=functools.partial(
                          albef.rank_answers, ap, acfg))),
        "blip_vqa": ("BLIP VQA (ViT-B/16 at 224, BERT-base encoder and decoder)",
                     types.SimpleNamespace(cfg=bcfg, params=bp, predict_answers=functools.partial(
                         blip_variants.vqa_rank_answers, bp, bcfg))),
        "alpro_retrieval": ("ALPRO retrieval (TimeSformer-B/16 at 224, 8 frames; BERT-base fused from layer 6)",
                            types.SimpleNamespace(cfg=vcfg, params=alpro.init(vcfg, "retrieval", device=dev,
                                                                              seed=23))),
        "alpro_qa": (f"ALPRO QA ({ALPRO_QA_CLASSES} classes)",
                     types.SimpleNamespace(cfg=qcfg, params=alpro.init(qcfg, "qa", device=dev, seed=24))),
        "gpt_dialogue": ("GPT-2 small dialogue (len_video_ft 4224)",
                         types.SimpleNamespace(cfg=gpt2.GptDialogueConfig(), params=gpt2.dialogue_init(
                             gpt2.GptDialogueConfig(), device=dev, seed=25))),
    }


def eval_dataset(task, model, builder: str, rows: list, root: Path, **info):
    """The split "test" of `builder` over `rows` (synthetic images or
    videos), through build_datasets_for_model (the processor at the tower's
    size)."""
    from llava_align_tpu_torch.framework.datasets import build_datasets_for_model

    root.mkdir(parents=True, exist_ok=True)
    ann = root / f"{builder}.json"
    ann.write_text(json.dumps(rows))
    sets = build_datasets_for_model(task, model, {"d": {"builder": builder, "synthetic_images": True,
                                                        "build_info": {"test": {"ann_paths": [str(ann)], **info}}}})
    return sets["d"]["test"]


def phase_eval_full(dev, smi: str) -> dict:
    """At the JAX package's full configs: the CLI's VQA loop with albef_vqa
    and blip_vqa, its retrieval loop with alpro_retrieval, alpro_qa's
    qa_logits, one ALPRO retrieval_train_step with its backward, GPT-2
    dialogue's loss and greedy generate. One warm call (a smaller one for
    the CLI loops), one timed."""
    import shutil
    import tempfile

    from llava_align_tpu_torch.framework.optims import tree_leaves
    from llava_align_tpu_torch.framework.registry import registry
    from llava_align_tpu_torch.models import alpro, gpt2
    from llava_align_tpu_torch.runners import evaluate
    from llava_align_tpu_torch.runners.common import resolve_tokenizer

    root = Path(tempfile.mkdtemp(prefix="eval_full_"))
    models, by_path, rows = eval_full_models(dev), {}, {}
    try:
        nq, na = EVAL_VQA
        answers = [f"answer {i}" for i in range(na)]
        (root / "answers.json").write_text(json.dumps(answers))
        qrows = [{"image": f"q{i}.jpg", "question": f"what is shown in picture number {i}?", "question_id": i,
                  "answer": [answers[i % na]] * 3 + [answers[(i + 7) % na]] * 7} for i in range(nq)]
        for name in ("albef_vqa", "blip_vqa"):
            what, model = models.pop(name)
            task = registry.get_task_class("vqa")(result_dir=str(root / "results"))
            tokenize = resolve_tokenizer({}, model.cfg.text.vocab_size)
            run = {"num_ans_candidates": na, "split": "test"}
            warm = eval_dataset(task, model, "vqa", qrows[:1], root / f"{name}_warm",
                                answer_list_path=str(root / "answers.json"))
            evaluate._eval_vqa(task, model, warm, run, tokenize, dev)
            data = eval_dataset(task, model, "vqa", qrows, root / name, answer_list_path=str(root / "answers.json"))
            metrics, secs, launches = timed(lambda: evaluate._eval_vqa(task, model, data, run, tokenize, dev))
            if metrics["n"] != nq or not 0 <= metrics["accuracy"] <= 100:
                raise AssertionError(f"{name} _eval_vqa: {metrics}")
            log(f"{what} on {smi}: the CLI's VQA loop, {nq} questions x {na} answers ({na} candidates): "
                f"{secs:.4f} s, {nq / secs:.2f} questions/s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                f"accuracy {metrics['accuracy']:.2f}; launches {launches}")
            rows[name] = {"s": secs, "questions_per_s": nq / secs, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            by_path[f"eval_{name}"] = launches
            del model
            torch.cuda.empty_cache()

        nv, nt, k = ALPRO_RET
        what, model = models.pop("alpro_retrieval")
        task = registry.get_task_class("retrieval")()
        tokenize = resolve_tokenizer({}, model.cfg.text.vocab_size)
        vrows = [{"video": f"v{i}.mp4", "caption": [f"{TRAIN_CAPTION} {2 * i}", f"a clip of scene {2 * i + 1}"],
                  "image_id": i} for i in range(nv)]
        model.compute_sim_matrix = functools.partial(alpro.compute_sim_matrix, model.params, model.cfg)
        warm = eval_dataset(task, model, "video_retrieval", vrows[:2], root / "alpro_warm")
        evaluate._eval_retrieval(task, model, warm, {"k_test": 1}, tokenize, dev)
        data = eval_dataset(task, model, "video_retrieval", vrows, root / "alpro")
        metrics, secs, launches = timed(lambda: evaluate._eval_retrieval(task, model, data, {"k_test": k}, tokenize,
                                                                         dev))
        if len(data.text) != nt or not all(0 <= metrics[m] <= 100 for m in ("txt_r1", "img_r1", "r_mean")):
            raise AssertionError(f"alpro_retrieval _eval_retrieval: {metrics}")
        log(f"{what} on {smi}: the CLI's retrieval loop, {nv} videos x {nt} captions, the VTM re-rank of the top "
            f"{k}: {secs:.4f} s, {nv / secs:.2f} videos/s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"r_mean {metrics['r_mean']:.2f}; launches {launches}")
        rows["alpro_retrieval"] = {"s": secs, "videos_per_s": nv / secs,
                                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        by_path["eval_alpro_retrieval"] = launches
        video = torch.from_numpy(np.stack([data[i]["video"] for i in range(nv)])).to(dev)
        ids, mask = (torch.from_numpy(x).to(dev) for x in tokenize([f"{TRAIN_CAPTION} {i}" for i in range(nv)]))

        # ALPRO's train step at batch 8, its backward into every leaf
        params, cfg, b = model.params, model.cfg, ALPRO_TRAIN_BATCH
        leaves = [x for x in tree_leaves(params) if x.is_floating_point()]
        for x in leaves:
            x.requires_grad_(True)
        gen = torch.Generator(device=dev).manual_seed(0)

        def train_step():
            with torch.enable_grad():
                out = alpro.retrieval_train_step(params, cfg, gen, video[:b], ids[:b], mask[:b])
                grads = torch.autograd.grad(out["loss"], leaves, allow_unused=True)
            return float(out["loss"].detach()), sum(float(g.square().sum()) for g in grads if g is not None) ** 0.5

        train_step()  # warm-up
        (loss, gnorm), secs, launches = timed(train_step)
        if not (np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0):
            raise AssertionError(f"ALPRO retrieval_train_step: loss {loss}, gradient norm {gnorm}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"ALPRO retrieval_train_step + backward on {smi} ({n_params(params) / 1e6:.1f} M parameters fp32, batch "
            f"{b}): {secs:.4f} s/step, {b / secs:.2f} samples/s, peak {peak:.2f} GiB; loss {loss:.4f}, gradient "
            f"norm {gnorm:.4g}; launches {launches}")
        rows["alpro_train"] = {"s_per_step": secs, "samples_per_s": b / secs, "peak_gib": peak, "loss": loss}
        by_path["alpro_train"] = launches
        del model, params, leaves
        torch.cuda.empty_cache()

        what, model = models.pop("alpro_qa")
        with torch.inference_mode():
            alpro.qa_logits(model.params, model.cfg, video[:1], ids[:1], mask[:1])  # warm-up
            logits, secs, launches = timed(lambda: alpro.qa_logits(model.params, model.cfg, video, ids, mask))
        if logits.shape != (nv, ALPRO_QA_CLASSES) or not torch.isfinite(logits).all():
            raise AssertionError(f"alpro_qa qa_logits: {tuple(logits.shape)}")
        log(f"{what} qa_logits on {smi}: {nv} videos, {secs:.4f} s, {nv / secs:.2f} videos/s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}")
        rows["alpro_qa"] = {"s": secs, "videos_per_s": nv / secs, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        by_path["alpro_qa"] = launches
        del model, video
        torch.cuda.empty_cache()

        what, model = models.pop("gpt_dialogue")
        p, cfg = model.params, model.cfg
        nd, sv, st = GPT_DIALOGUE
        g = torch.Generator(device=dev).manual_seed(3)
        fts = torch.randn((nd, sv, cfg.len_video_ft), generator=g, device=dev)
        tok = torch.randint(7, cfg.gpt.vocab_size, (nd, st), generator=g, device=dev)
        amask = torch.ones((nd, sv + st), dtype=torch.long, device=dev)
        amask[-1, -20:] = 0
        labels = torch.full((nd, sv + st), -1, dtype=torch.long, device=dev)
        labels[:, -(st // 6):] = tok[:, -(st // 6):]  # the answer tokens
        types_ = torch.randint(0, 7, (nd, sv + st), generator=g, device=dev)
        with torch.inference_mode():
            gpt2.dialogue_forward(p, cfg, tok[:1], fts[:1])  # warm-up
            out, secs, launches = timed(lambda: gpt2.dialogue_forward(p, cfg, tok, fts, amask, types_, labels))
        loss = float(out["loss"])
        if not np.isfinite(loss):
            raise AssertionError(f"GPT dialogue_forward: loss {loss}")
        log(f"{what} dialogue_forward on {smi}: {nd} dialogues x ({sv} feature rows + {st} tokens), {secs:.4f} s, "
            f"{nd / secs:.2f} samples/s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss {loss:.4f}; "
            f"launches {launches}")
        rows["gpt_dialogue_forward"] = {"s": secs, "samples_per_s": nd / secs, "loss": loss,
                                        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        by_path["gpt_dialogue_forward"] = launches
        ng, new = GPT_GENERATE
        gpt2.dialogue_generate(p, cfg, tok[:1].cpu().numpy(), fts[:1].cpu().numpy(), max_new_tokens=2)  # warm-up
        toks, secs, launches = timed(lambda: gpt2.dialogue_generate(p, cfg, tok[:ng].cpu().numpy(),
                                                                   fts[:ng].cpu().numpy(), max_new_tokens=new))
        if toks.shape != (ng, new) or not ((toks >= 0) & (toks < cfg.gpt.vocab_size)).all():
            raise AssertionError(f"GPT dialogue_generate: {toks}")
        log(f"{what} dialogue_generate on {smi}: {ng} dialogues, {new} greedy tokens, {secs:.4f} s, "
            f"{ng * new / secs:.2f} tokens/s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"launches {launches}")
        rows["gpt_dialogue_generate"] = {"s": secs, "tokens_per_s": ng * new / secs,
                                         "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        by_path["gpt_dialogue_generate"] = launches
        del model, p
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if any(v for path in by_path.values() for v in path.values()):
        raise AssertionError(f"phase 18: a kernel launched: {by_path}")
    print(json.dumps({"eval_full": rows}), flush=True)
    return by_path


# ---------------------------------------------------------------------------
# the rest of the LAVIS zoo (phase 19): PnP-VQA, Img2Prompt, BLIP-Diffusion
# and the prompt-to-prompt controllers, at the JAX package's default
# configs. Plain torch, no TPU kernel on these paths: each launches_by_path
# entry holds K1-K4 at zero.
# ---------------------------------------------------------------------------

ZOO_IMAGES = 4
ZOO_QUESTIONS = ("what is the man holding?", "what color is the car?", "how many people are there?",
                 "where is the dog sitting?")
BERT_CLS, BERT_SEP = 101, 102
CLIP_BOS, CLIP_EOS = 49406, 49407
T5_MAX_LEN = 512  # the reference tokenizes QG and FiD contexts with truncation at 512
DIFFUSION_STEPS = 50
PTP_STEPS = 5


def crc_ids(text: str, lo: int, hi: int) -> list:
    """A test tokenizer: each word a crc32 id in [lo, hi)."""
    import zlib

    return [zlib.crc32(w.encode()) % (hi - lo) + lo for w in text.split()]


def pad_rows(rows: list, width: int = 0) -> tuple:
    """(ids, mask) int64 numpy arrays of the rows, right-padded with 0."""
    width = max(width, max(map(len, rows)))
    ids, mask = np.zeros((len(rows), width), np.int64), np.zeros((len(rows), width), np.int64)
    for i, r in enumerate(rows):
        ids[i, : len(r)], mask[i, : len(r)] = r, 1
    return ids, mask


def bert_tokenize(texts) -> tuple:
    return pad_rows([[BERT_CLS] + crc_ids(t, 1000, 30000) + [BERT_SEP] for t in texts])


def t5_tokenize(texts) -> tuple:
    return pad_rows([crc_ids(t, 100, 32000)[: T5_MAX_LEN - 1] + [1] for t in texts])


def clip_tokenize(texts, length: int) -> torch.Tensor:
    """CLIP ids [n, length]: BOS, the words, EOS, cut to `length` and
    padded with EOS (as the reference's tokenizer pads)."""
    rows = [([CLIP_BOS] + crc_ids(t, 1000, 49000))[: length - 1] + [CLIP_EOS] for t in texts]
    return torch.tensor([r + [CLIP_EOS] * (length - len(r)) for r in rows])


def decode_words(row) -> str:
    return " ".join(f"w{t}" for t in row)


class StandInUnet:
    """A small stand-in for BLIP-Diffusion's UNet (the reference takes
    diffusers' UNet2DConditionModel; as in the JAX package, the UNet is the
    caller's): the latents 4x4 average-pooled into tokens, a sinusoidal
    timestep embedding added, ONE cross-attention site over the prompt
    embedding (where a prompt-to-prompt hook sees the probabilities as
    numpy [B * heads, tokens, words]), projected back to 4 channels and
    upsampled, plus 0.1 x the latents."""

    def __init__(self, dev, text_width: int, width: int = 320, heads: int = 8, seed: int = 0):
        g = torch.Generator(device=dev).manual_seed(seed)

        def w(i, o):
            return torch.randn((i, o), generator=g, device=dev) / i**0.5

        self.w_in, self.wq, self.wk = w(4, width), w(width, width), w(text_width, width)
        self.wv, self.wo, self.w_out = w(text_width, width), w(width, width), w(width, 4)
        self.width, self.heads = width, heads

    def __call__(self, x, t, cond, hook=None):
        import math

        B, C, H, W = x.shape
        tok = F.avg_pool2d(x, 4).flatten(2).transpose(1, 2)  # [B, n, 4]
        n, half, Dh = tok.shape[1], self.width // 2, self.width // self.heads
        ang = t.float()[:, None] * torch.exp(-math.log(10000.0) * torch.arange(half, device=x.device) / half)
        tok = tok @ self.w_in + torch.cat([ang.sin(), ang.cos()], -1)[:, None]
        q = (tok @ self.wq).reshape(B, n, self.heads, Dh).transpose(1, 2)
        k = (cond @ self.wk).reshape(B, -1, self.heads, Dh).transpose(1, 2)
        v = (cond @ self.wv).reshape(B, -1, self.heads, Dh).transpose(1, 2)
        probs = torch.softmax(q @ k.transpose(-1, -2) / Dh**0.5, dim=-1)  # [B, heads, n, S]
        if hook is not None:
            host = hook(probs.reshape(B * self.heads, n, -1).float().cpu().numpy(), True)
            probs = torch.as_tensor(np.ascontiguousarray(host), device=x.device).reshape(probs.shape)
        a = (probs @ v).transpose(1, 2).reshape(B, n, self.width) @ self.wo
        out = ((tok + a) @ self.w_out).transpose(1, 2).reshape(B, C, H // 4, W // 4)
        return F.interpolate(out, scale_factor=4, mode="nearest") + 0.1 * x


def zoo_report(what: str, smi: str, secs: float, rate: str, launches: dict) -> None:
    log(f"{what} on {smi}: {secs:.4f} s, {rate}, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches {launches}")


def phase_pnp_vqa(dev, smi: str, images: torch.Tensor) -> dict:
    """PnP-VQA's predict_answers at PnpVqaConfig() on ZOO_IMAGES images x 1
    question, its defaults (50 captions of top-k 50 sampling over 20
    gradcam-drawn patches, one caption a FiD context, 20 answer tokens).
    One warm call at 1 image and 2 captions, one timed."""
    from llava_align_tpu_torch.models import pnp_vqa

    cfg = pnp_vqa.PnpVqaConfig()
    params = pnp_vqa.init(cfg, device=dev, seed=19)
    g = torch.Generator(device=dev).manual_seed(19)
    kw = dict(tokenize_q=bert_tokenize, tokenize_ctx=t5_tokenize, decode_cap=decode_words, decode_ans=decode_words,
              prompt_ids=LAVIS_PROMPT, generator=g)
    pnp_vqa.predict_answers(params, cfg, images[:1], list(ZOO_QUESTIONS[:1]), num_captions=2, max_len=2, **kw)
    (answers, captions, cams), secs, launches = timed(
        lambda: pnp_vqa.predict_answers(params, cfg, images, list(ZOO_QUESTIONS), **kw))
    n_caps = [len(c) for c in captions]
    if len(answers) != ZOO_IMAGES or cams.shape != (ZOO_IMAGES, cfg.itm.vision.num_patches) or \
            not np.isfinite(cams).all() or not all(0 < n <= 50 for n in n_caps):
        raise AssertionError(f"PnP-VQA: answers {answers}, captions {n_caps}, gradcams {cams.shape}")
    zoo_report(f"PnP-VQA predict_answers ({ZOO_IMAGES} images x 1 question, captions kept {n_caps}, answer "
               f"tokens {[len(a.split()) for a in answers]})", smi, secs,
               f"{ZOO_IMAGES / secs:.4f} questions/s", launches)
    del params
    torch.cuda.empty_cache()
    return {"pnp_vqa_predict_answers": launches}


def phase_img2prompt(dev, smi: str, images: torch.Tensor) -> dict:
    """Img2Prompt at Img2PromptConfig() on the same images: forward_itm,
    forward_cap with the ITM filter (100 captions an image), then per image
    answer_extraction, forward_qa_generation over its <= 31 contexts in
    10-row chunks (30 tokens) and prompts_construction. A calibration
    round (which warms the caption path) and a warm question generation
    first, then each stage timed."""
    from llava_align_tpu_torch.models import blip, img2prompt, pnp_vqa

    cfg = img2prompt.Img2PromptConfig()
    params = img2prompt.init(cfg, device=dev, seed=20)
    g = torch.Generator(device=dev).manual_seed(20)
    q = [ZOO_QUESTIONS[0]] * ZOO_IMAGES
    q_ids, q_mask = (torch.from_numpy(a).to(dev) for a in bert_tokenize(q))

    def qg(captions):
        prompts, n_questions = [], []
        for rows in captions:
            texts = [decode_words(r) for r in rows]
            contexts, answers, ans_to_cap = img2prompt.answer_extraction(texts)
            ids, mask = (torch.from_numpy(a).to(dev) for a in t5_tokenize(contexts))
            questions = [decode_words(r) for r in img2prompt.forward_qa_generation(params["qg"], cfg.qg, ids, mask)]
            n_questions.append(len(questions))
            prompts.append(img2prompt.prompts_construction(q[0], texts, questions, answers, ans_to_cap))
        return prompts, n_questions

    # a random ITM head shifts every match probability by an offset that
    # depends on the seed: the filter keeps the pairs above the median match
    # probability of one calibration round (forward_cap's draws and ITM
    # inputs), so about half pass, as with a trained head at 0.5
    cams = img2prompt.forward_itm(params, cfg, images, q_ids, q_mask)
    with torch.no_grad():
        enc = blip.vit_forward(params["cap"]["visual"], cfg.cap.vision, images)
        flat, rows = pnp_vqa.sampled_patch_captions(params["cap"], cfg.cap, enc, cams, LAVIS_PROMPT, g, None,
                                                    num_captions=100, num_patches=20, max_new_tokens=20)
        cap_ids, cap_mask = (torch.from_numpy(a).to(dev) for a in pad_rows([[BERT_CLS] + r + [BERT_SEP]
                                                                              for r in rows]))
        threshold = float(img2prompt.itm_rank(params["itm"], cfg.itm, flat, cap_ids, cap_mask).median())
    kw = dict(decode=decode_words, itm_threshold=threshold)
    qg([[[1037, 3899, 2006, 1037, 2795], [1037, 2417, 2482]]])
    by_path = {}
    cams, secs, by_path["img2prompt_forward_itm"] = timed(
        lambda: img2prompt.forward_itm(params, cfg, images, q_ids, q_mask))
    zoo_report(f"Img2Prompt forward_itm ({ZOO_IMAGES} images)", smi, secs, f"{ZOO_IMAGES / secs:.4f} images/s",
               by_path["img2prompt_forward_itm"])
    captions, secs, by_path["img2prompt_forward_cap"] = timed(
        lambda: img2prompt.forward_cap(params, cfg, images, cams, LAVIS_PROMPT, g, **kw))
    n_caps = [len(c) for c in captions]
    if not all(n > 0 for n in n_caps):
        raise AssertionError(f"Img2Prompt forward_cap kept {n_caps} captions (threshold {threshold})")
    zoo_report(f"Img2Prompt forward_cap with the ITM filter (100 captions an image, threshold {threshold:.4f}; "
               f"kept {n_caps})", smi, secs,
               f"{sum(n_caps) / secs:.4f} captions/s", by_path["img2prompt_forward_cap"])
    (prompts, n_questions), secs, by_path["img2prompt_questions"] = timed(lambda: qg(captions))
    if not all(0 < n <= 31 for n in n_questions) or not all(p.endswith("\nAnswer:") for p in prompts):
        raise AssertionError(f"Img2Prompt: questions {n_questions}, prompts {[p[-40:] for p in prompts]}")
    zoo_report(f"Img2Prompt answer_extraction + forward_qa_generation + prompts_construction ({n_questions} "
               f"questions, prompts of {[len(p) for p in prompts]} characters)", smi, secs,
               f"{sum(n_questions) / secs:.4f} questions generated/s", by_path["img2prompt_questions"])
    del params
    torch.cuda.empty_cache()
    return by_path


def phase_blip_diffusion(dev, smi: str) -> dict:
    """BLIP-Diffusion at BlipDiffusionConfig() (fp32) with StandInUnet:
    ctx_embeddings for 4 subjects, train_loss at batch 4 on [4, 4, 64, 64]
    latents with its backward into the Q-Former, its query tokens, ProjLayer
    and the CLIP text tower (one warm step, LAVIS_TIMED timed), generate
    with DIFFUSION_STEPS DDIM steps and guidance 7.5 on [1, 4, 64, 64], and
    a PTP_STEPS-step generate with a prompt-to-prompt AttentionStore at the
    UNet's attention site."""
    from llava_align_tpu_torch.framework.optims import tree_leaves
    from llava_align_tpu_torch.models import blip_diffusion as bd
    from llava_align_tpu_torch.models import ptp

    cfg = bd.BlipDiffusionConfig()
    params = bd.init(cfg, device=dev, seed=21)
    unet = StandInUnet(dev, cfg.text.text.width, seed=22)
    g = torch.Generator(device=dev).manual_seed(21)
    rng = np.random.default_rng(21)
    H, Q, ctx_len = cfg.vision.image_size, cfg.qformer.query_length, cfg.text.text.context_length
    pix = torch.from_numpy(rng.standard_normal((4, 3, H, H)).astype(np.float32)).to(dev)
    subj_ids, subj_mask = (torch.from_numpy(a).to(dev) for a in bert_tokenize(["dog", "red backpack", "cat",
                                                                              "teapot"]))
    prompts = bd.build_prompt(["swimming in the sea", "on a mountain", "in the snow", "on a table"],
                              ["dog", "backpack", "cat", "teapot"])
    prompt_ids = clip_tokenize(prompts, ctx_len - Q).to(dev)  # the prompt plus its queries fit 77 positions
    neg_ids = clip_tokenize([""], ctx_len).to(dev)
    by_path = {}
    with torch.no_grad():
        bd.ctx_embeddings(params, cfg, pix, subj_ids, subj_mask)
        ctx, secs, by_path["blip_diffusion_ctx_embeddings"] = timed(
            lambda: bd.ctx_embeddings(params, cfg, pix, subj_ids, subj_mask))
    if ctx.shape != (4, Q, cfg.text.text.width) or not torch.isfinite(ctx).all():
        raise AssertionError(f"BLIP-Diffusion ctx_embeddings: {ctx.shape}")
    zoo_report("BLIP-Diffusion ctx_embeddings (4 subjects: CLIP ViT-L/14 at 224, the Q-Former, ProjLayer)", smi, secs,
               f"{4 / secs:.4f} subjects/s", by_path["blip_diffusion_ctx_embeddings"])

    trained = {k: params[k] for k in ("qformer", "query_tokens", "proj")}
    trained["text_layers"] = params["text"]["text_layers"]
    leaves = tree_leaves(trained)
    for x in leaves:
        x.requires_grad_(True)
    latents = torch.randn((4, 4, 64, 64), generator=g, device=dev)

    def step():
        loss = bd.train_loss(params, cfg, g, latents, prompt_ids, pix, subj_ids, subj_mask, unet)
        grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), max(float(x.abs().max()) for x in grads)

    step()
    runs = [timed(step) for _ in range(LAVIS_TIMED)]
    secs = float(np.mean([r[1] for r in runs]))
    losses = [r[0][0] for r in runs]
    if not all(np.isfinite(losses)) or not all(np.isfinite(r[0][1]) for r in runs):
        raise AssertionError(f"BLIP-Diffusion train_loss: {[r[0] for r in runs]}")
    by_path["blip_diffusion_train_loss"] = runs[-1][2]
    zoo_report(f"BLIP-Diffusion train_loss + backward (batch 4, [4, 4, 64, 64] latents, {n_params(trained)} "
               f"trained parameters; losses {losses})", smi, secs,
               f"{secs:.4f} s/step, {4 / secs:.4f} samples/s (steps {[round(r[1], 4) for r in runs]})",
               by_path["blip_diffusion_train_loss"])
    for x in leaves:
        x.requires_grad_(False)

    gen = dict(latent_shape=(1, 4, 64, 64), guidance_scale=7.5)
    args = (prompt_ids[:1], neg_ids, pix[:1], subj_ids[:1], subj_mask[:1])
    bd.generate(params, cfg, g, *args, unet, num_inference_steps=2, **gen)
    out, secs, by_path["blip_diffusion_generate"] = timed(
        lambda: bd.generate(params, cfg, g, *args, unet, num_inference_steps=DIFFUSION_STEPS, **gen))
    if out.shape != (1, 4, 64, 64) or not torch.isfinite(out).all():
        raise AssertionError(f"BLIP-Diffusion generate: {out.shape}")
    zoo_report(f"BLIP-Diffusion generate ({DIFFUSION_STEPS} DDIM steps, CFG 7.5, [1, 4, 64, 64], the stand-in UNet)",
               smi, secs, f"{1 / secs:.4f} images/s, {secs / DIFFUSION_STEPS:.4f} s/step",
               by_path["blip_diffusion_generate"])

    store = ptp.register_attention_control(ptp.AttentionStore(), 2)  # 2 UNet calls a step (CFG), one site each
    hook = ptp.make_attn_hook(store, "mid")
    out, secs, by_path["blip_diffusion_ptp"] = timed(lambda: bd.generate(
        params, cfg, g, *args, functools.partial(unet, hook=hook), num_inference_steps=PTP_STEPS, **gen))
    maps = {k: [m.shape for m in v] for k, v in store.attention_store.items() if v}
    # one site, two calls a step: two maps, each summed over the steps
    if store.cur_step != PTP_STEPS or sum(map(len, maps.values())) != 2 or not torch.isfinite(out).all():
        raise AssertionError(f"prompt-to-prompt AttentionStore: step {store.cur_step}, maps {maps}")
    zoo_report(f"BLIP-Diffusion generate with a prompt-to-prompt AttentionStore ({PTP_STEPS} steps; the controller "
               f"stored {sum(map(len, maps.values()))} map(s) {maps} over {store.cur_step} steps)", smi, secs,
               f"{secs / PTP_STEPS:.4f} s/step", by_path["blip_diffusion_ptp"])
    del params, unet
    torch.cuda.empty_cache()
    return by_path


def phase_zoo_tail(dev, smi: str) -> dict:
    """Phase 19: PnP-VQA, Img2Prompt, BLIP-Diffusion (with its
    prompt-to-prompt run). K1-K4 must not launch."""
    rng = np.random.default_rng(19)
    images = torch.from_numpy(rng.standard_normal((ZOO_IMAGES, 3, 224, 224)).astype(np.float32)).to(dev)
    by_path = {}
    for what, phase in (("PnP-VQA", lambda: phase_pnp_vqa(dev, smi, images)),
                        ("Img2Prompt", lambda: phase_img2prompt(dev, smi, images)),
                        ("BLIP-Diffusion", lambda: phase_blip_diffusion(dev, smi))):
        t0 = time.perf_counter()
        by_path.update(phase())
        log(f"{what} phase wall {time.perf_counter() - t0:.2f} s (the trees' builds included)")
    if any(v for p in by_path.values() for v in p.values()):
        raise AssertionError(f"phase 19: a kernel launched: {by_path}")
    return by_path


# ---------------------------------------------------------------------------
# the parallel phase: ranks spawned on the one card (gloo, both on cuda:0)
# ---------------------------------------------------------------------------

PARALLEL_RANKS = 2
PARALLEL_TIMEOUT = 600.0  # seconds for the ranks, their start included
# the train cut's batch: one row per 'data' slice, <image> + a 16-token caption
PARALLEL_TRAIN_ROWS = 2
# the sharded train step against the unsharded one: Adam's first moment
# (0.1 x the clipped gradient) per leaf, relative to the leaf's largest
# (floored at 1e-3 of the tree's largest: the CLIP key bias's gradient is
# rounding noise), and the params outside the noise elements (the CPU
# test's 1e-5). A dropped shard gradient or a wrong global norm moves mu
# by a large part of itself and the params by lr.
PARALLEL_MU_TOL = 1e-3
PARALLEL_PARAM_TOL = 1e-5


def parallel_train_samples(cfg, n: int) -> list:
    """n rows of <image> + 16 caption tokens, normalized images from a seed."""
    from llava_align_tpu_torch.constants import IMAGE_TOKEN_INDEX

    rng = np.random.default_rng(11)
    H = cfg.vision.image_size
    return [{"input_ids": [1, IMAGE_TOKEN_INDEX] + rng.integers(3, cfg.text.vocab_size, 16).tolist(),
             "images": rng.normal(size=(3, H, H)).astype(np.float32)} for _ in range(n)]


def parallel_rank(rank: int, world: int, device: str, smoke_dir: str) -> dict:
    """One rank of the parallel phase (parallel/dryrun.spawn: gloo, every
    rank on cuda:0): LLaVA's checks (parallel_llava), then, with its trees
    freed, the four other families' (parallel_families). Returns what the
    parent checks."""
    import torch.distributed as dist

    from llava_align_tpu_torch.parallel.dist import rank_device
    from llava_align_tpu_torch.parallel.mesh import make_mesh

    dev = rank_device(device)

    def say(msg: str) -> None:
        log(f"[rank {rank}/{world}, {dist.get_backend()}] {msg}")

    out = parallel_llava(rank, dev, Path(smoke_dir), say)
    torch.cuda.empty_cache()
    out.update(parallel_families(rank, dev, make_mesh(model=PARALLEL_RANKS, data=1), say))
    return out


def parallel_llava(rank: int, dev, smoke_dir: Path, say) -> dict:
    """LLaVA on one rank of the parallel phase. In order: the POPE runner
    with --dist auto on the 7B int8 tree; the TP = 2 engine on it (generate
    dual VDD, generate_batch, generate_batch_groups) under a PathRecorder,
    and on rank 0 the first-step logits against the one-rank engine; the
    2-layer full-width fp32 cut's greedy tokens under data = 1, model = 2
    and data = 2, model = 1 against one rank; one fp32 train step of the
    cut under both meshes against the unsharded step."""
    import torch.distributed as dist

    from llava_align_tpu_torch.config import LlavaConfig
    from llava_align_tpu_torch.decoding.engine import DecodeEngine
    from llava_align_tpu_torch.framework.optims import tree_leaves
    from llava_align_tpu_torch.parallel.mesh import make_mesh
    from llava_align_tpu_torch.parallel.sharding import shard_params, unshard_params
    from llava_align_tpu_torch.runners import pope
    from llava_align_tpu_torch.runners.common import MockTokenizer, pope_groups
    from llava_align_tpu_torch.train import trainer
    from llava_align_tpu_torch.utils.synthetic import build_random_llava_params

    out = {}

    # ---- the POPE runner, --dist auto: one whole 7B per rank, each its chunk
    lm = load_7b(dev)
    args = pope.build_parser().parse_args([
        "--model-path", "random:7b", "--quant", "int8", "--question-file",
        str(smoke_dir / "smoke_POPE_questions.jsonl"), "--answers-file", str(smoke_dir / "7b_pope_runner_dist.jsonl"),
        *RUNNER_MODES["pope"], "--cd_alpha", "1", "--cd_beta", "0.1", "--max_new_tokens", str(NEW_TOKENS),
        "--temperature", "0", "--synthetic-images", "--calibrate", *RUNNER_LAYOUTS["batch"], "--dist", "auto"])
    reset_launches()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    with patched(pope, "load_model", lambda *a, **k: lm):
        path = pope.run(args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    out["dist_runner"] = dict(path=path, secs=secs, launches=read_launches())
    say(f"POPE runner --dist auto: {path} in {secs:.4f} s; launches {out['dist_runner']['launches']}")

    # ---- the TP = 2 engine on the same tree
    gen = dual_vdd_config()
    mesh = make_mesh(model=PARALLEL_RANKS, data=1)
    requests = pope_requests(lm.tokenizer, lm.cfg.vision.image_size)
    groups = pope_groups(lm.tokenizer, lm.cfg.vision.image_size, 2, seed=1)
    rec = PathRecorder()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with rec:
        engine = DecodeEngine(lm.params, lm.cfg, gen, mesh=mesh)
        first = engine.submit_generate(*requests[0])
        first_logits = prefill_logits(engine, *requests[0])
        tp_generate = [engine.generate(ids, image).token_ids for ids, image in requests[1:3]]
        tp_batch = [o.token_ids for o in engine.generate_batch(requests)]
        tp_groups = [o.token_ids for o in engine.generate_batch_groups(groups)]
    torch.cuda.synchronize()
    tp_secs = time.perf_counter() - t0
    out["tp2"] = dict(launches=read_launches(), secs=tp_secs, int8_tp=bool(engine._int8_tp),
                      k1={f"{O}x{D}": sorted(r) for (O, D), r in rec.k1.items()},
                      k2={f"{O}x{D}": sorted(r) for (O, D), r in rec.k2.items()},
                      k3=sorted({tuple(q) for q, _, _ in rec.k3}),
                      shards={k: list(v["q"].shape) for k, v in engine.params["llama"]["layers"].items()
                              if isinstance(v, dict)})
    say(f"TP=2 engine (7B int8): generate, generate_batch of {len(requests)}, generate_batch_groups of "
        f"{len(groups)} x 6 in {tp_secs:.4f} s; launches {out['tp2']['launches']}; shards {out['tp2']['shards']}")
    if rank == 0:
        one = DecodeEngine(lm.params, lm.cfg, gen)
        want = one.submit_generate(*requests[0])
        a, b = first_logits, prefill_logits(one, *requests[0])
        rel = ((a - b).abs().max() / b.abs().max()).item()
        out["tp2"].update(first_rel=rel, tokens_equal=first["tokens"] == want["tokens"],
                          batch_equal=tp_batch == [o.token_ids for o in one.generate_batch(requests)])
        say(f"TP=2 first-step logits (the image rows' prefill) against the one-rank engine: max rel {rel:.3g} "
            f"of the largest; first request's tokens "
            f"{'equal' if out['tp2']['tokens_equal'] else 'differ'}, generate_batch's "
            f"{'equal' if out['tp2']['batch_equal'] else 'differ'} (bf16: the row-parallel sums round in "
            "another order)")
        del one
    del engine, lm, first
    torch.cuda.empty_cache()

    # ---- the 2-layer full-width fp32 cut: greedy tokens under both meshes = one rank's
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cut_config(LlavaConfig.llava_v15_7b(), torch.float32)
    params = build_random_llava_params(cfg, device=dev, seed=5)
    reqs = pope_requests(MockTokenizer(), cfg.vision.image_size)
    one = DecodeEngine(params, cfg, gen)
    want = ([one.generate(*reqs[0]).token_ids], [o.token_ids for o in one.generate_batch(reqs)])
    meshes = {f"data{d}_model{m}": make_mesh(model=m, data=d) for d, m in ((1, PARALLEL_RANKS), (PARALLEL_RANKS, 1))}
    for name, mesh in meshes.items():
        eng = DecodeEngine(params, cfg, gen, mesh=mesh)
        got = ([eng.generate(*reqs[0]).token_ids], [o.token_ids for o in eng.generate_batch(reqs)])
        out[f"fp32_{name}"] = dict(equal=got == want, tokens=got[0][0], want=want[0][0])
        say(f"fp32 cut, {name}: generate {got[0][0]} (one rank {want[0][0]}), generate_batch of {len(reqs)} "
            f"{'equal' if got[1] == want[1] else 'DIFFER'}")
        del eng
    del one
    torch.cuda.empty_cache()

    # ---- one fp32 train step of the cut under both meshes against the unsharded step
    samples = parallel_train_samples(cfg, PARALLEL_TRAIN_ROWS)
    pad = -(-(len(samples[0]["input_ids"]) - 1 + cfg.num_image_tokens) // 64) * 64
    batch = trainer.batch_to_device(trainer.build_train_batch(cfg, samples, pad_to=pad), dev)
    kw = dict(lr=TRAIN_REF_LR, warmup_steps=0, total_steps=10, max_grad_norm=1.0)
    opt = trainer.make_optimizer(**kw)
    ref_p, ref_st, ref_loss = trainer.make_train_step(cfg, opt)(tree_copy(params, dev), opt.init(params), batch)
    ref_leaves = [x.detach() for x in tree_leaves(ref_p)]
    ref_mu = tree_leaves(ref_st["mu"])
    # Adam's first step moves each element by lr * sign(g): the elements
    # whose gradient is rounding noise (sqrt(nu) below 1e-6 of the
    # largest) may move either way, 2 lr apart; the rest must agree
    rms = [x.sqrt() for x in tree_leaves(ref_st["nu"])]
    top = max(float(x.max()) for x in rms)
    noise = [(x > 0) & (x < 1e-6 * top) for x in rms]
    mu_top = max(float(x.abs().max()) for x in ref_mu)
    for name, mesh in meshes.items():
        specs = trainer.train_shardings(cfg, params, mesh.shape[1])
        opt = trainer.make_optimizer(**kw)
        local = shard_params(tree_copy(params, dev), specs, mesh)
        t0 = time.perf_counter()
        local, st, loss = trainer.make_train_step(cfg, opt, mesh=mesh)(local, opt.init(local), batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        with torch.no_grad():
            got = unshard_params(local, specs, mesh)
            diffs = [(a - b).abs() for a, b in zip(tree_leaves(got), ref_leaves)]
            dmax = max(float(d[~z].max()) if bool((~z).any()) else 0.0 for d, z in zip(diffs, noise))
            noise_max = max(float(d[z].max()) if bool(z.any()) else 0.0 for d, z in zip(diffs, noise))
            # mu = (1 - b1) * the clipped gradient: the gradients and the
            # clip's global norm, per leaf against the unsharded step's
            mu = tree_leaves(unshard_params(st["mu"], specs, mesh))
            mu_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-3 * mu_top)
                         for a, b in zip(mu, ref_mu))
        rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        out[f"train_{name}"] = dict(loss=float(loss), ref_loss=float(ref_loss), rel=rel, dmax=dmax,
                                    noise_max=noise_max, n_noise=int(sum(int(z.sum()) for z in noise)),
                                    mu_rel=mu_rel, secs=secs)
        say(f"fp32 cut train step, {name}: loss {float(loss):.6f} (unsharded {float(ref_loss):.6f}, rel {rel:.3g}); "
            f"max |param - unsharded| {dmax:.3g} ({out[f'train_{name}']['n_noise']} noise elements: "
            f"{noise_max:.3g}); Adam mu (the clipped gradient) per leaf within {mu_rel:.3g} of the leaf's "
            f"largest; {secs:.3f} s")
        del local, got, st, mu
    return out


@torch.inference_mode()
def prefill_logits(engine, ids, image=None, feats=None) -> torch.Tensor:
    """The first-step logits [rows, V] (fp32) of one request's image rows
    (main, and cd under VCD), as `generate` prefills them: from an image,
    or from precomputed query features [rows, N, D]."""
    n_tok = None if feats is None else int(feats.shape[1])
    pad, *pack = engine._pack(ids, True, kinds=engine.img_kinds, num_image_tokens=n_tok)
    feats = engine._request_features(image, None) if feats is None else feats.to(engine.device)
    cache = engine.adapter.init_cache(len(engine.img_kinds), pad + 1, device=engine.device)
    return engine._prefill(pack, pad, feats, cache, 0, pad + 1).float()


FAMILY_TP_LAYERS = 8  # LLaVA-MPT-7B's and OPT-2.7b's decoder depth in the TP = 2 check (of 32)
FAMILY_TP_KINDS = {"qwen": "Qwen-VL-7B int8", "blip": "InstructBLIP-Vicuna-7B bf16",
                   "mpt": f"LLaVA-MPT-7B bf16 ({FAMILY_TP_LAYERS} of 32 MPT layers)",
                   "opt": f"BLIP-2 OPT-2.7b bf16 ({FAMILY_TP_LAYERS} of 32 OPT layers)"}
FAMILY_TP_TOKENS = 8
FAMILY_TP_BEAM_TOKENS = 12


def family_tp_setups(dev):
    """Per family of the TP = 2 check, a function that makes (params, cfg,
    adapter, requests) at full width on `dev`: Qwen-VL-7B int8 at full depth (the
    decoder int8 as the runners quantize it, ViT-bigG bf16), InstructBLIP-
    Vicuna-7B bf16 at full depth, LLaVA-MPT-7B and BLIP-2 OPT-2.7b bf16 with
    FAMILY_TP_LAYERS decoder layers; and of the fp32 cut of each (2 decoder
    layers, 2 vision layers where the engine encodes, full width). Requests
    from seeds: Qwen's image prompts ('unk' ids as the runners pass them)
    and images (normalized, float), InstructBLIP's and OPT's query features
    ([main, noised] rows, N(0, 1)) and prompts, LLaVA-MPT's mpt-template
    POPE prompts; every request's ids inside the vocab."""
    from llava_align_tpu_torch.constants import IMAGE_TOKEN_INDEX as S
    from llava_align_tpu_torch.decoding import adapters
    from llava_align_tpu_torch.models import blip2, instructblip, llava_mpt, qwen_vl
    from llava_align_tpu_torch.runners.common import MockTokenizer, build_prompt
    from llava_align_tpu_torch.utils.synthetic import build_random_qwen_vl_params

    def qwen(cut: bool):
        full = qwen_vl.QwenVLConfig.qwen_vl_7b()
        cfg = full if not cut else dataclasses.replace(
            full, text=dataclasses.replace(full.text, num_layers=2, dtype=torch.float32),
            vision=dataclasses.replace(full.vision, num_layers=2, dtype=torch.float32))
        params = build_random_qwen_vl_params(cfg, quant="none" if cut else "int8", device=dev, seed=0)
        rng = np.random.default_rng(31)
        span, _ = qwen_vl.sentinelize_span(qwen_vl.make_image_span_ids(cfg), cfg)
        common = [int(t) for t in rng.integers(3, 150000, 12)]
        tails = [[int(t) for t in rng.integers(3, 150000, n)] for n in (4, 3, 5, 4, 3, 5)]
        unk = [int(t) for t in rng.integers(3, 150000, 4)]
        H = cfg.vision.image_size
        images = [rng.standard_normal((3, H, H)).astype(np.float32) for _ in range(2)]
        reqs = dict(ids=[span + common + t for t in tails], unk=[unk + common + t for t in tails],
                    images=images, prefix=span + common, tails=tails)
        return params, cfg, adapters.QwenVLAdapter(cfg), reqs

    def query_family(kind: str, cut: bool):
        if kind == "blip":
            full = instructblip.InstructBlipConfig.vicuna7b()
            cfg = blip_cut(full, torch.float32) if cut else full
            params, cls = instructblip.init(cfg, device=dev, seed=0), adapters.InstructBlipAdapter
        else:
            full = blip2.Blip2OptConfig()
            depth = 2 if cut else FAMILY_TP_LAYERS
            cfg = dataclasses.replace(full, text=dataclasses.replace(full.text, num_layers=depth,
                                                                     **({"dtype": torch.float32} if cut else {})))
            params, cls = blip2.init_opt(cfg, device=dev, seed=0), adapters.Blip2OptAdapter
        g = torch.Generator(device=dev).manual_seed(32)
        feats = torch.randn((2, cfg.num_query_tokens, cfg.text.hidden_size), generator=g, device=dev).to(cfg.text.dtype)
        tok = MockTokenizer()
        text = [tok(f"Question: is there a {o} in the image? Answer:").input_ids for o in ("dog", "car", "cat", "tree")]
        return params, cfg, cls(cfg), dict(ids=[S] + text[0][1:], feats=feats, text=text)

    def mpt(cut: bool):
        full = llava_mpt.LlavaMptConfig()
        cfg = mpt_cut(full, torch.float32) if cut else dataclasses.replace(
            full, text=dataclasses.replace(full.text, n_layers=FAMILY_TP_LAYERS))
        params = llava_mpt.init(cfg, device=dev, seed=0)
        return params, cfg, adapters.LlavaMptAdapter(cfg), dict(reqs=mpt_requests(cfg.vision.image_size))

    return {"qwen": qwen, "blip": lambda cut: query_family("blip", cut), "mpt": mpt,
            "opt": lambda cut: query_family("opt", cut)}


def family_tp_calls(kind: str, make, reqs: dict) -> dict:
    """Each entry point the family's adapter takes, on the engines
    `make(flags)` builds (greedy; Qwen: generate with dual VDD, its 'unk'
    ids given, generate_batch of 4 (main + 'none'), generate_batch_groups
    of 2 images x 3 questions; InstructBLIP: generate_batch of 4 text-only
    prompts, a 5-beam generate_beam on the features; LLaVA-MPT: generate
    with dual VDD, generate_batch of 6; BLIP-2 OPT: generate with VCD on
    the features, a 5-beam generate_beam): {entry: tokens}."""
    def toks(outs):
        return [o.token_ids for o in outs]

    if kind == "qwen":
        ids, unk, images = reqs["ids"], reqs["unk"], reqs["images"]
        dual = make(dict(use_dd=True, use_dd_unk=True))
        groups = [(reqs["prefix"], reqs["tails"][3 * g: 3 * g + 3], images[g],
                   [{"unk": u} for u in unk[3 * g: 3 * g + 3]]) for g in range(2)]
        return {"generate": [dual.generate(ids[i], images[i // 3], branch_ids={"unk": unk[i]}).token_ids
                             for i in (0, 3)],
                "generate_batch": toks(make(dict(use_dd=True)).generate_batch(
                    [(ids[i], images[i // 3]) for i in range(4)])),
                "generate_batch_groups": toks(dual.generate_batch_groups(groups))}
    if kind == "mpt":
        dual = make(dict(use_dd=True, use_dd_unk=True))
        return {"generate": dual.generate(*reqs["reqs"][0]).token_ids,
                "generate_batch": toks(dual.generate_batch(reqs["reqs"]))}
    out = {"generate_beam": make({}, FAMILY_TP_BEAM_TOKENS).generate_beam(
        reqs["ids"], precomputed_feats=reqs["feats"][:1], num_beams=FAMILY_BEAMS).token_ids}
    if kind == "blip":
        out["generate_batch"] = toks(make({}).generate_batch([(t, None) for t in reqs["text"]]))
    else:
        out["generate"] = make(dict(use_cd=True)).generate(reqs["ids"], None, precomputed_feats=reqs["feats"]).token_ids
    return out


def family_first_logits(kind: str, engine, reqs: dict) -> torch.Tensor:
    """The first-step logits of the family's first image request."""
    if kind == "qwen":
        return prefill_logits(engine, reqs["ids"][0], image=reqs["images"][0])
    if kind == "mpt":
        return prefill_logits(engine, *reqs["reqs"][0])
    return prefill_logits(engine, reqs["ids"], feats=reqs["feats"][:1])


def parallel_families(rank: int, dev, mesh, say) -> dict:
    """The four other families under TP = 2 (one tree at a time, freed
    before the next): each entry point of family_tp_calls on the sharded
    engine under a PathRecorder (launches, the shard shapes each kernel
    took), on rank 0 the first-step logits against the one-rank engine's;
    then the fp32 cut's greedy tokens under data 1 x model 2 against one
    rank's."""
    from llava_align_tpu_torch.config import GenerationConfig
    from llava_align_tpu_torch.decoding.engine import DecodeEngine

    out = {}
    setups = family_tp_setups(dev)
    for kind, setup in setups.items():
        t0 = time.perf_counter()
        params, cfg, adapter, reqs = setup(False)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0

        def make(flags, tokens=FAMILY_TP_TOKENS, m=mesh):
            gen = GenerationConfig(max_new_tokens=tokens, do_sample=False, eos_token_id=10**9, cd_alpha=1.0,
                                   cd_beta=0.1, noise_step=500, **flags)
            return DecodeEngine(params, cfg, gen, adapter=adapter, mesh=m)

        rec = PathRecorder()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with rec, torch.inference_mode():
            eng = make({} if kind in ("blip", "opt") else dict(use_dd=True))
            first = family_first_logits(kind, eng, reqs)
            tokens = family_tp_calls(kind, make, reqs)
        torch.cuda.synchronize()
        res = dict(launches=read_launches(), secs=time.perf_counter() - t0, build_s=build_s,
                   tp_layers=bool(eng.adapter.tp_layers), int8_tp=bool(eng._int8_tp),
                   cache_kv_heads=int(eng.adapter.cache_kv_heads),
                   k1={f"{O}x{D}": sorted(r) for (O, D), r in rec.k1.items()},
                   k2={f"{O}x{D}": sorted(r) for (O, D), r in rec.k2.items()},
                   k3=sorted({tuple(q) for q, _, _ in rec.k3}),
                   tokens={k: (v[:2] if isinstance(v[0], list) else v) for k, v in tokens.items()})
        say(f"TP=2 {kind}: {res['secs']:.2f} s (build {build_s:.2f} s); launches {res['launches']}; layers split "
            f"{res['tp_layers']}, int8 TP {res['int8_tp']}, cache kv heads {res['cache_kv_heads']}; K1 rows by shard "
            f"{res['k1']}, K2 {res['k2']}, K3 q shapes {res['k3']}")
        if rank == 0:
            with torch.inference_mode():
                one = DecodeEngine(params, cfg, eng.gen, adapter=adapter)
                want = family_first_logits(kind, one, reqs)
            res["first_rel"] = ((first - want).abs().max() / want.abs().max()).item()
            say(f"TP=2 {kind}: first-step logits within {res['first_rel']:.3g} of the one-rank engine's largest")
            del one
        out[f"tp2_{kind}"] = res
        del eng, params, first
        torch.cuda.empty_cache()

    # the fp32 cuts: greedy tokens under data 1 x model 2 against one rank's
    for kind, setup in setups.items():
        params, cfg, adapter, reqs = setup(True)

        def make(flags, tokens=FAMILY_TP_TOKENS, m=None):
            gen = GenerationConfig(max_new_tokens=tokens, do_sample=False, eos_token_id=10**9, cd_alpha=1.0,
                                   cd_beta=0.1, noise_step=500, **flags)
            return DecodeEngine(params, cfg, gen, adapter=adapter, mesh=m)

        with torch.inference_mode():
            want = family_tp_calls(kind, make, reqs)
            got = family_tp_calls(kind, lambda f, t=FAMILY_TP_TOKENS: make(f, t, mesh), reqs)
        out[f"fp32_{kind}"] = dict(equal=got == want, entries=sorted(got))
        say(f"fp32 cut {kind}, data1_model2: {sorted(got)} {'equal' if got == want else 'DIFFER from'} one rank's")
        del params
        torch.cuda.empty_cache()
    return out



def phase_parallel(smoke_dir: Path, smi: str, one_rank_rate: float) -> tuple:
    """The parallel phase: PARALLEL_RANKS ranks spawned on the one card
    (gloo, both on cuda:0: two ranks sharing a card measure correctness,
    not tensor-parallel speed), each running parallel_rank; any rank's
    failure fails the run. Checks: the --dist auto answers, merged by rank
    0, hold every question once, in order, and equal the one-rank run's
    (7b_pope_runner_batch: --no-group-by-image --batch-size 6, so each
    rank's chunk of 6 questions is one lockstep call of the same 6
    questions as the one-rank run's, and every kernel sees the same rows);
    the TP = 2 engine launched K1, K2 and K3 (launches_by_path tp2), with
    its first-step logits within REFERENCE_TOL (of the largest) of the
    one-rank engine's;
    the fp32 cut's greedy tokens equal one rank's under both meshes; the
    train steps against the unsharded step: the loss within TRAIN_REF_TOL,
    Adam's first moment (the clipped gradient) per leaf within
    PARALLEL_MU_TOL of the leaf's largest, the params within
    PARALLEL_PARAM_TOL except the elements whose gradient is rounding
    noise (within 2 lr: Adam's first step moves each by lr * sign(g)). Then K1, K2 and K3 are held against their plain
    versions and timed at the shard shapes the TP engine sent them.
    Returns (launches by path, the tp2 kernel records)."""
    from llava_align_tpu_torch.evals.pope import load_jsonl
    from llava_align_tpu_torch.parallel.dryrun import spawn

    t0 = time.perf_counter()
    results = spawn(parallel_rank, PARALLEL_RANKS, (str(smoke_dir),), device="cuda", timeout=PARALLEL_TIMEOUT)
    log(f"parallel phase: {PARALLEL_RANKS} ranks on {smi} (gloo, one card) ran in {time.perf_counter() - t0:.2f} s "
        "(their start and the trees' builds included)")

    def summed(key: str) -> dict:
        return {n: sum(r[key]["launches"][n] for r in results) for n in results[0][key]["launches"]}

    # --dist auto
    merged = load_jsonl(str(smoke_dir / "7b_pope_runner_dist.jsonl"))
    single = load_jsonl(str(smoke_dir / "7b_pope_runner_batch.jsonl"))
    n_q = 6 * RUNNER_IMAGES
    if [r["question_id"] for r in merged] != list(range(n_q)):
        raise AssertionError(f"--dist auto: merged answers for {[r['question_id'] for r in merged]}")
    texts_equal = [r["text"] for r in merged] == [r["text"] for r in single]
    records_equal = merged == single
    secs = max(r["dist_runner"]["secs"] for r in results)
    log(f"POPE runner --dist auto ({PARALLEL_RANKS} ranks on one card, LLaVA-v1.5-7B int8, dual VDD, "
        f"{' '.join(RUNNER_LAYOUTS['batch'])}, --calibrate) on {smi}: {n_q} questions in {secs:.4f} s, "
        f"{n_q / secs:.4f} questions/s (the one-rank run of the same layout in this run: {one_rank_rate:.4f} "
        f"questions/s); merged answers {'equal' if texts_equal else 'DIFFER from'} the one-rank run's, whole "
        f"records {'equal' if records_equal else 'differ'}")
    if not texts_equal:
        raise AssertionError("--dist auto: the merged answers differ from the one-rank run's")
    paths = {"7b_pope_runner_dist_auto": summed("dist_runner"), "tp2": summed("tp2")}
    require_launches(paths["7b_pope_runner_dist_auto"], K123, "the POPE runner under --dist auto")
    require_launches(paths["tp2"], K123, "the TP = 2 engine")
    tp = results[0]["tp2"]
    log(f"TP=2 engine on {smi}: int8 TP {tp['int8_tp']}, shards {tp['shards']}, {tp['secs']:.4f} s (two ranks "
        f"on one card: correctness, not TP speed); launches {paths['tp2']}; K1 rows by shard {tp['k1']}, "
        f"K2 {tp['k2']}, K3 q shapes {tp['k3']}; first-step logits within {tp['first_rel']:.3g} of the one-rank "
        f"engine's largest (tol {REFERENCE_TOL})")
    if not tp["int8_tp"] or not tp["first_rel"] <= REFERENCE_TOL:
        raise AssertionError("TP = 2 engine: int8 TP off, or first-step logits off the one-rank engine's")
    for res in results:
        for name in ("data1_model2", "data2_model1"):
            if not res[f"fp32_{name}"]["equal"]:
                raise AssertionError(f"fp32 cut {name}: greedy tokens differ from one rank's")
            t = res[f"train_{name}"]
            if not (t["rel"] <= TRAIN_REF_TOL and t["mu_rel"] <= PARALLEL_MU_TOL and t["dmax"] <= PARALLEL_PARAM_TOL
                    and t["noise_max"] <= 2 * TRAIN_REF_LR):
                raise AssertionError(f"train step {name}: loss rel {t['rel']:.3g}, mu {t['mu_rel']:.3g}, params "
                                     f"{t['dmax']:.3g} or noise elements {t['noise_max']:.3g} off")
    log("parallel phase: fp32 cut greedy tokens equal one rank's under data 1 x model 2 and data 2 x model 1; "
        "train steps " + ", ".join(
            f"{n}: loss rel {results[0][f'train_{n}']['rel']:.3g}, mu {results[0][f'train_{n}']['mu_rel']:.3g}, "
            f"params {results[0][f'train_{n}']['dmax']:.3g} (noise elements {results[0][f'train_{n}']['noise_max']:.3g})"
            for n in ("data1_model2", "data2_model1"))
        + f" (tol {TRAIN_REF_TOL}, {PARALLEL_MU_TOL:g}, {PARALLEL_PARAM_TOL:g}, {2 * TRAIN_REF_LR:g})")

    # the four other families under TP = 2
    for kind in FAMILY_TP_KINDS:
        fam = results[0][f"tp2_{kind}"]
        paths[f"tp2_{kind}"] = summed(f"tp2_{kind}")
        log(f"TP=2 {FAMILY_TP_KINDS[kind]} on {smi}: {fam['secs']:.4f} s (rank 0; its build {fam['build_s']:.2f} s); "
            f"launches (both ranks) {paths[f'tp2_{kind}']}; layer stacks split {fam['tp_layers']}, int8 TP "
            f"{fam['int8_tp']}, cache kv heads a rank {fam['cache_kv_heads']}; first-step logits within "
            f"{fam['first_rel']:.3g} of the one-rank engine's largest (tol {REFERENCE_TOL}); tokens {fam['tokens']}")
        if not fam["tp_layers"] or not fam["first_rel"] <= REFERENCE_TOL:
            raise AssertionError(f"TP = 2 {kind}: layers not split, or first-step logits off the one-rank engine's")
        for res in results:
            if not res[f"fp32_{kind}"]["equal"]:
                raise AssertionError(f"fp32 cut {kind}, data 1 x model 2: greedy tokens differ from one rank's")
    require_launches(paths["tp2_qwen"], K123, "the TP = 2 Qwen-VL-7B int8 engine")
    require_launches(paths["tp2_blip"], ("flash_attention",), "the TP = 2 InstructBLIP-Vicuna-7B engine")
    if not results[0]["tp2_qwen"]["int8_tp"]:
        raise AssertionError("TP = 2 Qwen-VL-7B: the int8 stacks did not split")
    log("parallel phase: the four families' fp32 cuts give one rank's greedy tokens under data 1 x model 2 ("
        + "; ".join(f"{k}: {results[0][f'fp32_{k}']['entries']}" for k in FAMILY_TP_KINDS) + ")")

    # the kernels at the shard shapes the TP engines sent them
    g = torch.Generator(device="cuda:0").manual_seed(13)
    records = {"K1": {}, "K2": {}, "K3": {}}
    for tag, path in (("tp2", tp), ("tp2_qwen", results[0]["tp2_qwen"]), ("tp2_blip", results[0]["tp2_blip"])):
        log(f"kernels at the {tag} shard shapes (random weights of those shapes), against their plain versions")
        if path["k1"]:
            shapes = {k: tuple(int(x) for x in k.split("x")) for k in path["k1"]}
            k1_rows, k1_err = k1_rows_record({k: tuple(v) for k, v in path["k1"].items()}, g, shapes=shapes)
            records["K1"][tag] = dict(shapes={k: list(v) for k, v in shapes.items()}, max_abs_err=k1_err,
                                      by_rows={str(B): r for B, r in sorted(k1_rows.items())})
        if path["k2"]:
            (k2_shape, k2_rows), = path["k2"].items()
            O, D = (int(x) for x in k2_shape.split("x"))
            k2, k2_err = k2_path_record(O, D, k2_rows, max(r for r in k2_rows if r <= 64), g)
            records["K2"][tag] = dict(k2, max_abs_err=k2_err)
        if path["k3"]:
            k3 = phase_kernel_flash([tuple(q) for q in path["k3"]])
            records["K3"][tag] = dict(by_shape=k3["by_shape"], max_abs_err=k3["max_abs_err"],
                                      max_row_err=k3["max_row_err"])
    return paths, records


def main() -> int:
    t_start = time.perf_counter()
    name, smi = phase_device()
    dev = torch.device("cuda:0")
    phase_build()
    from llava_align_tpu_torch.config import LlavaConfig
    from llava_align_tpu_torch.runners.common import MockTokenizer

    # the 7B path's prefill lengths: image row and text rows at 128-buckets
    ids = pope_requests(MockTokenizer(), 336)[0][0]
    main_lens = (-(-(len(ids) - 1 + 576) // 128) * 128, -(-len(ids) // 128) * 128)
    shapes = grouped_shapes(576)
    log(f"13B grouped path shapes: {shapes}")
    runner = runner_shapes(MockTokenizer(), LlavaConfig.llava_v15_7b())
    log(f"POPE runner 7B prefill buckets: {runner}")
    attn_shapes = [(1, 640, 32, 128), (2, 128, 32, 128), (1, main_lens[0], 32, 128),
                   (2, main_lens[1], 32, 128), (GROUPS, shapes["pad_prefix"], 40, 128),
                   (2 * GROUPS, shapes["pad_txt"], 40, 128),
                   # the POPE runner at --batch-size 6: 6 image rows, 12 text rows
                   (6, runner["pad_img"], 32, 128), (12, runner["pad_txt"], 32, 128)]
    # the text-branch rows (unk, none) prefill together at their bucket
    prefill_rows = 2 * main_lens[1]
    rec = phase_kernels_int8(shapes["decode_rows"], prefill_rows)
    rec["K3"] = phase_kernel_flash(attn_shapes)
    rec["K4"] = phase_kernels_int4(shapes["decode_rows"], shapes["prefill_rows"])
    torch.cuda.synchronize()
    probes = phase_probes()
    phase_w8a8_product(smi)
    from llava_align_tpu_torch.runners import bias_probe, mmmu, pope, qwen_pope

    # what the LLaVA model paths and the Qwen-VL ones send K1, K2 and K3
    rec_llava, rec_qwen = PathRecorder(), PathRecorder()
    lm = load_7b(dev)
    with rec_llava:
        by_path = {"7b_int8_generate": phase_main_path(lm)}
    torch.cuda.synchronize()
    smoke_dir = Path(__file__).resolve().parent / "build" / "pope_smoke"
    llava = RunnerModel("7b", "LLaVA-v1.5-7B int8", (pope, "load_model"), lm,
                        ("--model-path", "random:7b", "--quant", "int8"), pope=pope)
    runner_launches, vdd_rates = phase_runner(llava, smoke_dir, smi, "pope", rec_llava)
    by_path.update(runner_launches)
    phase_utilities(lm, smoke_dir, smi)
    # VCD through the same runner, layouts and question file
    vcd_launches, vcd_rates = phase_runner(llava, smoke_dir, smi, "vcd", rec_llava)
    by_path.update(vcd_launches)
    for layout in RUNNER_LAYOUTS:
        log(f"POPE runner {layout} on {smi}: VCD {vcd_rates[layout]:.4f} questions/s, dual VDD "
            f"{vdd_rates[layout]:.4f} questions/s in this run ({vcd_rates[layout] / vdd_rates[layout]:.3f}x)")
    by_path["7b_mme_runner"] = phase_mme(llava, smoke_dir, smi, rec_llava)
    # the opt-in serving modes and LLaVA's last runners, on the same 7B int8 tree
    t0 = time.perf_counter()
    llava_w8a8 = dataclasses.replace(llava, tag="7b_w8a8", what="LLaVA-v1.5-7B int8 + W8A8",
                                     args=("--model-path", "random:7b", "--quant", "w8a8"),
                                     layouts={"grouped": RUNNER_LAYOUTS["grouped"]})
    w8a8_launches, rec_llava_w8a8 = phase_w8a8_runner(llava_w8a8, smoke_dir, smi, vdd_rates)
    by_path.update(w8a8_launches)
    with rec_llava:
        by_path["7b_int8_kv_cache"] = phase_kv_cache(lm, smi)
    by_path["7b_sampling_sweep"] = phase_sampling_sweep(llava, smoke_dir, smi, rec_llava)
    by_path["7b_bias_probe"] = phase_bias_probe(dataclasses.replace(llava, loader=(bias_probe, "load_model")),
                                                smoke_dir, smi, rec_llava)
    log(f"W8A8 runner, int8 KV cache, sampling sweep and bias probe phases wall {time.perf_counter() - t0:.2f} s")
    del lm, llava, llava_w8a8  # the 7B int8 tree goes before the bf16 one of the MMMU runner is built
    torch.cuda.empty_cache()
    # parallelism: ranks spawned on the card (their own trees; this process holds none now)
    t0 = time.perf_counter()
    par_paths, par_records = phase_parallel(smoke_dir, smi, vdd_rates["batch"])
    by_path.update(par_paths)
    for kid, by_tag in par_records.items():
        for tag, r in by_tag.items():
            rec[kid][tag] = r
            rec[kid]["max_abs_err"] = max(rec[kid]["max_abs_err"], r["max_abs_err"])
    log(f"parallel phase wall {time.perf_counter() - t0:.2f} s (the ranks' start, builds and kernel checks included)")
    llava_bf16 = RunnerModel("7b", "LLaVA-v1.5-7B bf16", (mmmu, "load_model"), load_7b(dev, "none"),
                             ("--model-path", "random:7b"), kernels=("flash_attention",))
    by_path["7b_mmmu_runner"] = phase_mmmu(llava_bf16, smoke_dir, smi, rec_llava)
    del llava_bf16
    torch.cuda.empty_cache()
    from llava_align_tpu_torch.utils.profiling import PhaseTimer

    timer = PhaseTimer()  # synchronizes the card on entering and leaving
    with timer.phase("7b_reference"):
        phase_reference(dev)
    log(f"PhaseTimer (utils.profiling) of the 7B reference phase: {timer.report()}")
    phase_vcd_reference(dev)
    torch.cuda.synchronize()
    phase_quant_reference(dev)
    torch.cuda.synchronize()
    by_path["7b_checkpoint_generate"] = phase_checkpoint(dev, smi)
    torch.cuda.synchronize()
    by_path["13b_int4_grouped"] = phase_grouped(dev, shapes)
    torch.cuda.synchronize()
    phase_grouped_reference(dev)
    torch.cuda.synchronize()

    # the Qwen-VL paths, on a bf16 tree built after every LLaVA tree is
    # freed; each run quantizes it (--quant int8), timed apart
    qwen_params, qwen_cfg = load_qwen_7b(dev)
    qwen = RunnerModel("qwen", "Qwen-VL-7B int8", (qwen_pope, "load_qwen_model"),
                       qwen_runner_model(qwen_params, qwen_cfg),
                       ("--model-path", "random:qwen-vl-7b", "--quant", "int8"),
                       family=("--model-family", "qwen"), pope=qwen_pope)
    qwen_launches, qwen_rates = phase_runner(qwen, smoke_dir, smi, "pope", rec_qwen)
    by_path.update(qwen_launches)
    by_path["qwen_mme_runner"] = phase_mme(qwen, smoke_dir, smi, rec_qwen)
    by_path["qwen_mmmu_runner"] = phase_mmmu(qwen, smoke_dir, smi, rec_qwen)
    qwen_w8a8 = dataclasses.replace(qwen, tag="qwen_w8a8", what="Qwen-VL-7B int8 + W8A8",
                                    args=("--model-path", "random:qwen-vl-7b", "--quant", "w8a8"),
                                    layouts={"grouped": RUNNER_LAYOUTS["grouped"]})
    w8a8_launches, rec_qwen_w8a8 = phase_w8a8_runner(qwen_w8a8, smoke_dir, smi, qwen_rates, dequant_below_ok=True)
    by_path.update(w8a8_launches)
    log(f"POPE runner on {smi}, without the quantization: Qwen-VL-7B int8 "
        + ", ".join(f"{k} {v:.4f}" for k, v in qwen_rates.items())
        + " questions/s; LLaVA-v1.5-7B int8 dual VDD in this run: "
        + ", ".join(f"{k} {v:.4f}" for k, v in vdd_rates.items()) + " questions/s")
    log(f"quantize_qwen_params of the bf16 Qwen-VL-7B tree on {smi}: "
        + ", ".join(f"{t:.4f}" for t in rec_qwen.quant_s) + " s")
    del qwen, qwen_w8a8, qwen_params
    torch.cuda.empty_cache()
    phase_qwen_reference(dev)
    torch.cuda.synchronize()

    # the InstructBLIP paths (bf16, as the BLIP runners load it: no quant),
    # on a tree built after the Qwen one is freed
    rec_blip = PathRecorder()
    t0 = time.perf_counter()
    blip_params, blip_cfg = load_blip_7b(dev)
    blip, blip_caption = blip_runner_models(blip_params, blip_cfg)
    with generated_tokens() as counts:
        blip_launches, blip_rates = phase_runner(blip, smoke_dir, smi, "vcd", rec_blip)
    by_path.update(blip_launches)
    log(f"InstructBLIP POPE runner (VCD, --calibrate) on {smi}: {blip_rates['single']:.4f} questions/s; tokens "
        f"per answer {counts}; phase wall {time.perf_counter() - t0:.2f} s (the tree's build included)")
    t0 = time.perf_counter()
    by_path["blip_caption_runner"], beams = phase_caption(blip_caption, smoke_dir, smi, rec_blip)
    log(f"caption phase wall {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_beam_rescore(blip_params, blip_cfg, beams, dev, smi)
    log(f"bf16 beam re-score phase wall {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_blip_split(blip_params, blip_cfg, dev, smi)
    log(f"InstructBLIP split phase wall {time.perf_counter() - t0:.2f} s")
    del blip, blip_caption, blip_params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_blip_reference(dev)
    torch.cuda.synchronize()
    log(f"InstructBLIP reference phase wall {time.perf_counter() - t0:.2f} s")

    # the last decoder families: LLaVA-MPT-7B, BLIP-2 OPT-2.7b, FlanT5-XL and
    # stage 1, bf16 at full width and depth (no TPU kernel on their paths:
    # their launches_by_path entries hold K1-K4 at zero)
    for what, phase in (("LLaVA-MPT-7B", phase_llava_mpt), ("BLIP-2 OPT-2.7b", phase_blip2_opt),
                        ("BLIP-2 FlanT5-XL", phase_blip2_t5), ("BLIP-2 stage 1", phase_blip2_stage1)):
        t0 = time.perf_counter()
        by_path.update(phase(dev, smi))
        log(f"{what} phase wall {time.perf_counter() - t0:.2f} s (the tree's build included)")
    for what, phase in (("new families' reference", phase_family_references),
                        ("new families' checkpoint", lambda d: phase_family_checkpoints(d, smi))):
        t0 = time.perf_counter()
        phase(dev)
        torch.cuda.synchronize()
        log(f"{what} phase wall {time.perf_counter() - t0:.2f} s")

    # LLaVA training (autograd: no TPU kernel lies on these paths, and the
    # wrappers refuse grad inputs; their launches_by_path entries hold K1-K4
    # at zero)
    for what, tag, phase in (("train 7B", "7b_train", phase_train), ("train CLI", "train_cli", phase_train_cli)):
        t0 = time.perf_counter()
        by_path[tag] = phase(dev, smi)
        log(f"{what} phase wall {time.perf_counter() - t0:.2f} s (the tree's build included)")
    t0 = time.perf_counter()
    phase_train_reference(dev)
    log(f"train reference phase wall {time.perf_counter() - t0:.2f} s")

    # the LAVIS zoo: the CLI's four archs, BLIP-2's losses, BLIP serving
    # (autograd or plain torch: K1-K4 at zero in their launches_by_path)
    for what, phase in (("LAVIS train CLI archs", phase_lavis_train), ("BLIP-2 losses", phase_blip2_losses),
                        ("BLIP", phase_blip)):
        t0 = time.perf_counter()
        by_path.update(phase(dev, smi))
        log(f"{what} phase wall {time.perf_counter() - t0:.2f} s (the trees' builds included)")
    # the evaluation CLI, ALPRO and GPT-2 dialogue (plain torch: K1-K4 at
    # zero in their launches_by_path), then every LAVIS family's 2-layer cut
    for what, phase in (("evaluation CLI", lambda d, s: phase_eval_cli(s)), ("evaluation at full size",
                                                                            phase_eval_full)):
        t0 = time.perf_counter()
        by_path.update(phase(dev, smi))
        log(f"{what} phase wall {time.perf_counter() - t0:.2f} s (the trees' builds included)")
    # PnP-VQA, Img2Prompt, BLIP-Diffusion and prompt-to-prompt (plain torch:
    # K1-K4 at zero in their launches_by_path), then every LAVIS family's
    # 2-layer cut, theirs included
    t0 = time.perf_counter()
    by_path.update(phase_zoo_tail(dev, smi))
    log(f"phase 19 wall {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_lavis_reference(dev)
    log(f"LAVIS reference phase wall {time.perf_counter() - t0:.2f} s")

    # K1 at every row count the model paths (LLaVA and Qwen) sent it that
    # phase 3 did not check: the Qwen prefills' tiled-regime rows
    k1_seen = collections.defaultdict(set)
    for r in (rec_llava, rec_qwen, rec_llava_w8a8, rec_qwen_w8a8):
        for shape, rows in r.k1.items():
            k1_seen[shape] |= rows
    k1_new = path_k1_rows(k1_seen, k1_phase_rows(prefill_rows))
    rows_by_path = {fam: {f"{O}x{D}": sorted(rows) for (O, D), rows in sorted(r.k1.items())}
                    for fam, r in (("llava", rec_llava), ("qwen", rec_qwen), ("llava_w8a8", rec_llava_w8a8),
                                   ("qwen_w8a8", rec_qwen_w8a8))}
    log(f"model paths: K1 took, by [O, D] stack, {rows_by_path}; not checked yet: {k1_new}")
    if not rec_qwen.k1:
        raise AssertionError("the Qwen runs sent K1 no call")
    rec["K1"]["rows_by_path"] = rows_by_path
    if k1_new:
        per_rows, err = k1_rows_record(k1_new, torch.Generator(device=dev).manual_seed(9))
        rec["K1"]["path_rows"] = {str(B): r for B, r in sorted(per_rows.items())}
        rec["K1"]["max_abs_err"] = max(rec["K1"]["max_abs_err"], err)

    # K2 at the Qwen lm_head: every row count the Qwen runs sent it, and the
    # tiled regime's first and last row counts
    from llava_align_tpu_torch.ops.quant import STREAM_MAX_ROWS

    k2_rows = rec_qwen.k2[LM_HEAD_QWEN] | rec_qwen_w8a8.k2[LM_HEAD_QWEN]
    log(f"kernels: K2 at the Qwen lm_head {list(LM_HEAD_QWEN)}, the Qwen runs' row counts "
        f"{sorted(k2_rows)} and the tiled regime's 65 and {STREAM_MAX_ROWS}")
    if not k2_rows:
        raise AssertionError("the Qwen runs sent K2 no call at the Qwen lm_head")
    qwen_k2, err = k2_path_record(*LM_HEAD_QWEN, sorted(k2_rows | {65, STREAM_MAX_ROWS}),
                                  max(r for r in k2_rows if r <= 64), torch.Generator(device=dev).manual_seed(7))
    rec["K2"]["by_path"]["qwen_int8_runner"] = qwen_k2
    rec["K2"]["max_abs_err"] = max(rec["K2"]["max_abs_err"], err)

    # every shape the model paths (LLaVA and Qwen) sent K3 that the K3
    # phase did not check
    seen = rec_llava.k3 | rec_qwen.k3 | rec_blip.k3 | rec_llava_w8a8.k3 | rec_qwen_w8a8.k3
    new_shapes = runner_attn_shapes(seen, set(attn_shapes))
    log(f"model paths: K3 took {sorted({q for q, _, _ in seen})} (Qwen runs: "
        f"{sorted({q for q, _, _ in rec_qwen.k3})}; InstructBLIP runs: {sorted({q for q, _, _ in rec_blip.k3})}); "
        f"not checked yet: {new_shapes}")
    if not rec_blip.k3:
        raise AssertionError("the InstructBLIP runs sent K3 no call")
    if new_shapes:
        more = phase_kernel_flash(new_shapes)
        rec["K3"]["by_shape"] += more["by_shape"]
        for k in ("max_abs_err", "max_row_err"):
            rec["K3"][k] = max(rec["K3"][k], more[k])

    sources = {
        "int8_matmul_stacked": ("K1", "llava_align_tpu_torch/csrc/int8_mm.cu", "llava_align_tpu/ops/quant.py:242"),
        "int8_matmul_cuda": ("K2", "llava_align_tpu_torch/csrc/int8_mm.cu", "llava_align_tpu/ops/quant.py:177"),
        "flash_attention": ("K3", "llava_align_tpu_torch/csrc/flash_attn.cu", "llava_align_tpu/ops/attention.py:611"),
        "int4_matmul_stacked": ("K4", "llava_align_tpu_torch/csrc/int4_mm.cu", "llava_align_tpu/ops/quant.py:541"),
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("by_rows", "by_path", "prefill", "rows_by_path", "path_rows", "graph_ms", "graph_library_ms",
             "max_row_err", "by_shape", "tp2", "tp2_qwen", "tp2_blip")
    kernels = [
        dict(name=n, route="cuda", source=src, replaces=rep,
             launches=sum(p[n] for p in by_path.values()),
             launches_by_path={path: p[n] for path, p in by_path.items()},
             **{k: rec[kid][k] for k in keys},
             **{k: rec[kid][k] for k in extra if k in rec[kid]})
        for n, (kid, src, rep) in sources.items()
    ] + [
        # the microbenchmark path: launches, errors and times from the twin's run
        dict(name=f"{sid} {w}", route="cuda", source=src, replaces=rep, twin=twin,
             launches=probes[sid]["launches"], **{k: probes[sid][k] for k in keys},
             **{k: probes[sid][k] for k in ("graph_ms", "graph_library_ms") if k in probes[sid]})
        for sid, (twin, _, w, src, rep) in PROBE_KERNELS.items()
    ]
    log(f"chip_smoke wall time: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
