"""POPE answer-generation runner (VDD/VCD + Post-Hoc logit dumping), the port of
llava_align_tpu/runners/pope.py with the same knobs and the same jsonl
records.

Capability parity: experiments/eval/llava_naive.py (plain answers) and
experiments/eval/calibrate/llava_calibrate.py (answers + naive/none/unk top-k
dicts for Post-Hoc calibration).

Example (the GPU unless --device cpu is given; --model-path is an HF-format
llava-v1.5 checkpoint dir, whose tokenizer needs transformers, or
random:{tiny,7b,13b}, a random-weight model with the mock tokenizer;
--synthetic-images stands in noise for missing image files):

    python -m llava_align_tpu_torch.runners.pope --model-path random:7b \\
        --quant int8 --question-file questions.jsonl --answers-file answers.jsonl \\
        --use_dd --use_dd_unk --cd_alpha 1 --cd_beta 0.1 --calibrate --synthetic-images
    python -m llava_align_tpu_torch.evals.pope questions.jsonl answers.jsonl

Routing as in the JAX runner: with --use_cd a group whose first question
has no image leaves the shared-prefix path (it has no noised prefix
segment), and anyres grid stacks decode one question at a time through
`generate`. --quant w8a8 is the JAX runner's opt-in throughput mode: int8
weights plus W8A8 at prefill row counts (DecodeEngine act_quant), not
bit-exact with --quant int8. --dist auto runs one process per rank
(torchrun, or ranks spawned with RANK / WORLD_SIZE / MASTER_ADDR /
MASTER_PORT set), each answering its chunk of the questions into a
.rank{r}-of-{n} part that rank 0 merges (runners/common.apply_dist_auto).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from llava_align_tpu_torch.calibrate.posthoc import calibrate_label_dict, get_prob_from_logits
from llava_align_tpu_torch.constants import IMAGE_TOKEN_INDEX
from llava_align_tpu_torch.decoding.engine import DecodeEngine
from llava_align_tpu_torch.framework.data import ListDataset, PrefetchLoader
from llava_align_tpu_torch.runners.common import (
    AnswerFile,
    apply_dist_auto,
    build_prompt,
    finish_dist_auto,
    load_image_tensor,
    load_model,
    load_questions_for,
    make_generation_config,
    postprocess_answer,
)
from llava_align_tpu_torch.tokenization import keyword_token_ids, tokenizer_image_token

# the JAX runner's budget when the device reports none (a 16 GB chip)
FALLBACK_DEVICE_BYTES = 16.0e9


def _tensors(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _tensors(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _tensors(v)
    elif isinstance(node, torch.Tensor):
        yield node


def _auto_group_batch(engine, Qg: int, max_new: int) -> int:
    """Analytic multi-group batch pick (the JAX runner's formula): as many
    image groups per call as the device memory allows, at most 4. One
    group's [prefix segment + 2 text-prefix segments + Qg * branches local
    rows] KV bytes against the card's total memory (torch.cuda.mem_get_info)
    less the weights and 1.2 GB; off the card, against 16 GB."""
    params_bytes = sum(t.numel() * t.element_size() for t in _tensors(engine.params))
    per_pos = sum(  # KV bytes per (row, position)
        t.numel() * t.element_size()
        for t in _tensors(engine.adapter.init_cache(1, 1, device=torch.device("meta")))
    )
    n_img_tok = getattr(engine.adapter, "num_image_tokens", 576) or 576
    bucket = max(int(getattr(engine, "bucket", 128)), 1)
    pad_prefix = -(-(n_img_tok + 128) // bucket) * bucket
    rows = Qg * max(len(engine.kinds), 1)
    group_bytes = (pad_prefix + 2 * bucket + rows * (32 + max_new)) * per_pos
    if engine.device.type == "cuda":
        hbm = float(torch.cuda.mem_get_info(engine.device)[1])
    else:
        hbm = FALLBACK_DEVICE_BYTES
    fit = int((hbm * 0.94 - params_bytes - 1.2e9) // max(group_bytes, 1))
    return max(1, min(4, fit))


def run(args) -> str:
    """Answer the question file into args.answers_file; returns its path
    (under --dist auto: the merged file on rank 0, the rank's part
    elsewhere)."""
    apply_dist_auto(args)
    device = torch.device(args.device) if args.device else None
    # w8a8 = int8 weights + opt-in W8A8 at prefill row counts (not
    # bit-exact with int8; ops/quant W8A8 note)
    act_quant = args.quant == "w8a8"
    quant = "int8" if act_quant else args.quant
    # load_model quantizes checkpoints and builds random:{7b,13b} quantized;
    # random:tiny loads in float and is quantized here, as in the JAX runner
    model = load_model(args.model_path, quant=quant, device=device)
    tokenizer, params, cfg = model.tokenizer, model.params, model.cfg
    if quant in ("int8", "int4") and args.model_path == "random:tiny":
        from llava_align_tpu_torch.ops.quant import quantize_llama_params

        params = dict(params, llama=quantize_llama_params(
            params["llama"], bits=4 if quant == "int4" else 8))

    questions = load_questions_for(args)
    if args.max_questions:
        questions = questions[: args.max_questions]
    ans = AnswerFile(args.answers_file, resume=args.resume)

    gen = make_generation_config(args)
    _, stop_str = build_prompt("x", args.conv_mode)
    stop_ids = keyword_token_ids([stop_str], tokenizer)
    engine = DecodeEngine(params, cfg, gen, stop_keyword_ids=stop_ids, act_quant=act_quant)
    score_engine: Optional[DecodeEngine] = None
    if args.calibrate:
        # content-free scoring runs use the plain decoding path (reference
        # calibrate_label_sapce, llava_calibrate.py:41-89)
        score_gen = make_generation_config(
            args, use_cd=False, use_dd=False, use_dd_unk=False, max_new_tokens=1
        )
        score_engine = DecodeEngine(params, cfg, score_gen, stop_keyword_ids=stop_ids,
                                    act_quant=act_quant)

    def rng(seed: int) -> torch.Generator:
        """A fresh sampling stream per engine call, as the JAX runner hands
        each call the same key."""
        return torch.Generator(device=engine.device).manual_seed(seed)

    one_word = args.one_word or "POPE" in args.question_file

    def prep_ids(line):
        prompt, _ = build_prompt(
            line["text"], args.conv_mode, with_image=True,
            mm_use_im_start_end=cfg.mm_use_im_start_end, one_word=one_word,
        )
        return tokenizer_image_token(prompt, tokenizer)

    def prep(line):
        image = load_image_tensor(
            args.image_folder, line.get("image", ""),
            image_size=cfg.vision.image_size,
            image_aspect_ratio=args.image_aspect_ratio,
            synthetic_ok=args.synthetic_images,
            grid_pinpoints=cfg.image_grid_pinpoints,
        )
        return prep_ids(line), image, stop_str

    def none_unk_ids(line):
        qs = line["text"]
        p_none, _ = build_prompt(qs, args.conv_mode, with_image=False, one_word=one_word)
        ids_none = tokenizer_image_token(p_none, tokenizer)
        p_unk, _ = build_prompt(qs, args.conv_mode, with_image=True, one_word=one_word)
        ids_unk = [
            tokenizer.unk_token_id if t == IMAGE_TOKEN_INDEX else t
            for t in tokenizer_image_token(p_unk, tokenizer)
        ]
        return ids_none, ids_unk

    def finalize(line, out, stop_str, out_none=None, out_unk=None):
        text = postprocess_answer(
            tokenizer.decode(out.token_ids, skip_special_tokens=True), stop_str
        )
        tokens_naive = calibrate_label_dict(
            out.first_scores_top_probs, out.first_scores_top_ids, tokenizer
        )
        record = {
            "question_id": line["question_id"],
            "prompt": line["text"],
            "text": text,
            "model_id": model.model_name,
            "image": line.get("image", ""),
            "logits_score": get_prob_from_logits(tokens_naive),
            "naive": tokens_naive,
            "metadata": {},
        }
        if out_none is not None:
            record["none"] = calibrate_label_dict(
                out_none.first_scores_top_probs, out_none.first_scores_top_ids, tokenizer
            )
        if out_unk is not None:
            record["unk"] = calibrate_label_dict(
                out_unk.first_scores_top_probs, out_unk.first_scores_top_ids, tokenizer
            )
        ans.write(record)

    t0 = time.time()
    n_done = 0
    pending = [l for l in questions if not ans.is_done(l["question_id"], l.get("text"))]
    B = max(1, args.batch_size)
    # shared-prefix grouping: POPE ships 6 consecutive questions per image;
    # their prompts differ only after the shared [system + <image>] prefix,
    # so the prefix prefills once per image group
    group_by_image = args.group_by_image and getattr(engine.adapter, "supports_shared_prefix", False)
    if group_by_image:
        groups = []
        cap = max(B, 6)
        for l in pending:
            if groups and len(groups[-1]) < cap and groups[-1][-1].get("image", "") == l.get("image", ""):
                groups[-1].append(l)
            else:
                groups.append([l])
    else:
        groups = [pending[i : i + B] for i in range(0, len(pending), B)]

    def prep_group(g):
        first = prep(g[0])
        rest = [prep_ids(l) for l in g[1:]] if group_by_image else [prep(l)[:2] for l in g[1:]]
        return first, rest

    # multi-group batching: GB uniform-size image groups decode in one call
    # (engine.generate_batch_groups); 0 = auto from the device memory
    GB = args.group_batch
    if GB <= 0 and group_by_image:
        GB = _auto_group_batch(engine, max(B, 6), args.max_new_tokens)
    GB = max(1, GB)
    if group_by_image and GB > 1:
        batches, cur = [], []
        for g in groups:
            if cur and (len(g) != len(cur[0]) or len(cur) >= GB):
                batches.append(cur)
                cur = []
            cur.append(g)
        if cur:
            batches.append(cur)
    else:
        batches = [[g] for g in groups]

    # worker threads tokenize and load images ahead of the device
    loader = PrefetchLoader(
        ListDataset(batches, transform=lambda b: [(g, prep_group(g)) for g in b]),
        batch_size=1, num_workers=2, prefetch=4,
    )
    start = 0

    def split_prefix(prepped_group):
        (ids0, image0, _), rest = prepped_group
        if args.use_cd and image0 is None:
            return None  # cd needs a noised prefix segment
        if image0 is not None and np.asarray(image0).ndim == 4:
            return None  # anyres grid stacks decode per question
        ids_list = [ids0] + rest
        p = DecodeEngine.common_token_prefix(ids_list)
        prefix = ids_list[0][:p]
        if IMAGE_TOKEN_INDEX not in prefix:
            return None
        return prefix, [ids[p:] for ids in ids_list], image0

    def _submit_scores(chunk, seed):
        """Queue both content-free scoring runs ('none' = the prompt without
        the image token; 'unk' = sentinel → unk id)."""
        nu = [none_unk_ids(l) for l in chunk]
        return (
            score_engine.submit_batch([(n_ids, None) for n_ids, _ in nu], generator=rng(seed)),
            score_engine.submit_batch([(u_ids, None) for _, u_ids in nu], generator=rng(seed)),
        )

    def _finish_chunk(chunk, outs, stop_str, seed, score_handles=None):
        nonlocal n_done
        outs_none = outs_unk = [None] * len(chunk)
        if score_handles is not None:
            h_none, h_unk = score_handles
            outs_none = score_engine.collect_batch(h_none)
            outs_unk = score_engine.collect_batch(h_unk)
        elif score_engine is not None:
            if len(chunk) == 1:
                ids_none, ids_unk = none_unk_ids(chunk[0])
                outs_none = [score_engine.generate(ids_none, None, generator=rng(seed))]
                outs_unk = [score_engine.generate(ids_unk, None, generator=rng(seed))]
            else:
                h_none, h_unk = _submit_scores(chunk, seed)
                outs_none = score_engine.collect_batch(h_none)
                outs_unk = score_engine.collect_batch(h_unk)
        for line, out, o_n, o_u in zip(chunk, outs, outs_none, outs_unk):
            finalize(line, out, stop_str, o_n, o_u)
        n_done += len(chunk)
        if args.verbose and n_done % 20 < len(chunk):
            rate = n_done / (time.time() - t0)
            print(f"{n_done} done, {rate:.2f} samples/s")

    # submit call g+1 before collecting call g, in the JAX runner's order;
    # the port's submit runs the whole call, so nothing overlaps
    in_flight = None  # (chunk, stop_str, seed, handle, score_handles)

    def _flush_pending():
        nonlocal in_flight
        if in_flight is None:
            return
        chunk_p, stop_p, seed_p, handle, sh = in_flight
        in_flight = None
        _finish_chunk(chunk_p, engine.collect_batch_groups(handle), stop_p, seed_p, score_handles=sh)

    for prepped_batch in loader:
        prepped_batch = prepped_batch[0]
        chunk = [l for g, _ in prepped_batch for l in g]
        stop_str = prepped_batch[0][1][0][2]
        seed = args.seed + start
        start += len(chunk)

        splits = [split_prefix(pg) for _, pg in prepped_batch] if group_by_image else []
        submit_ok = (
            group_by_image
            and all(len(g) > 1 for g, _ in prepped_batch)
            and len({len(g) for g, _ in prepped_batch}) == 1
            and splits
            and all(sp is not None for sp in splits)
        )
        multi = group_by_image and len(prepped_batch) > 1 and all(len(g) > 1 for g, _ in prepped_batch)
        if submit_ok:
            handle = engine.submit_batch_groups(splits, generator=rng(seed))
            # calibrate dumps: both content-free runs queued behind the main call
            score_handles = _submit_scores(chunk, seed) if score_engine is not None else None
            _flush_pending()
            in_flight = (chunk, stop_str, seed, handle, score_handles)
            continue
        _flush_pending()
        if multi and all(sp is not None for sp in splits):
            outs = engine.generate_batch_groups(splits, generator=rng(seed))
        else:
            outs = []
            for (g, ((ids0, image0, _), rest)), sp in zip(prepped_batch, splits or [None] * len(prepped_batch)):
                if len(g) == 1:
                    outs.append(engine.generate(ids0, image0, generator=rng(seed)))
                elif group_by_image and sp is not None:
                    prefix, suffixes, img0 = sp
                    outs.extend(engine.generate_batch_prefix(prefix, suffixes, img0, generator=rng(seed)))
                elif group_by_image and image0 is not None and np.asarray(image0).ndim == 4:
                    # anyres grid stacks are per-question engine inputs
                    outs.extend(engine.generate(ids, image0, generator=rng(seed)) for ids in [ids0] + rest)
                elif group_by_image:
                    outs.extend(engine.generate_batch([(ids, image0) for ids in [ids0] + rest],
                                                      generator=rng(seed)))
                else:
                    outs.extend(engine.generate_batch([(ids0, image0)] + list(rest), generator=rng(seed)))

        _finish_chunk(chunk, outs, stop_str, seed)

    _flush_pending()
    ans.close()
    return finish_dist_auto(args)


def build_parser() -> argparse.ArgumentParser:
    # knob names match the reference CLI (llava_calibrate.py:223-246) and
    # the JAX runner's
    p = argparse.ArgumentParser()
    p.add_argument("--model-path", type=str, required=True)
    p.add_argument("--model-base", type=str, default=None)
    p.add_argument("--image-folder", type=str, default="")
    p.add_argument("--question-file", type=str, required=True)
    p.add_argument("--answers-file", type=str, required=True)
    p.add_argument("--conv-mode", type=str, default="llava_v1")
    p.add_argument("--num-chunks", type=int, default=1)
    p.add_argument("--dist", default="none", choices=["none", "auto"],
                   help="auto: shard by torch.distributed rank (torchrun), one answers part per rank, merged by rank 0")
    p.add_argument("--chunk-idx", type=int, default=0)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_p", type=float, default=None)
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--noise_step", type=int, default=500)
    p.add_argument("--use_cd", action="store_true", default=False)
    p.add_argument("--use_dd", action="store_true", default=False)
    p.add_argument("--use_dd_unk", action="store_true", default=False)
    p.add_argument("--cd_alpha", type=float, default=1.0)
    p.add_argument("--cd_beta", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--calibrate", action="store_true", default=False,
                   help="also dump none/unk content-free top-k dicts")
    p.add_argument("--one-word", action="store_true", default=False)
    p.add_argument("--image-aspect-ratio", type=str, default=None)
    p.add_argument("--synthetic-images", action="store_true", default=False)
    p.add_argument("--resume", action="store_true", default=False)
    p.add_argument("--max-questions", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=1,
                   help="questions decoded in lockstep (packed Q*branches batch)")
    p.add_argument("--group-batch", type=int, default=0,
                   help="uniform-size image groups decoded per call "
                   "(engine.generate_batch_groups); 0 = auto from the device memory, capped at 4")
    p.add_argument("--group-by-image", action=argparse.BooleanOptionalAction, default=True,
                   help="lockstep-decode consecutive same-image questions with one shared "
                   "prefix KV prefill (POPE has 6 per image)")
    p.add_argument("--verbose", action="store_true", default=True)
    p.add_argument("--quant", default="none", choices=["none", "int8", "int4", "w8a8"],
                   help="decoder serving: int8 or int4 (group 128) weight-only; w8a8 = int8 "
                   "weights + dynamic activation quantization at prefill row counts, an opt-in "
                   "throughput mode, not bit-exact with int8. qwen supports int8/w8a8 only")
    p.add_argument("--device", default=None,
                   help="torch device for the model (default: the GPU; 'cpu' runs the kernels' "
                   "plain versions)")
    return p


if __name__ == "__main__":
    run(build_parser().parse_args())
