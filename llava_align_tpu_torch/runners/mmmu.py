"""MMMU benchmark runner (LLaVA + Qwen-VL engines) + calibrated N-way
Post-Hoc scoring: the port of llava_align_tpu/runners/mmmu.py (`run`,
`run_qwen`, `score`, `score_sweep`, `score_sweep_files`, `print_results`,
`build_parser`), with the same knobs and records.

Capability parity: experiments/eval/MMMU/run_llava.py (generation over val
samples), run_llava_calibrate.py (per-question dynamic choice LABEL_DICT,
content-free none/unk dumps, N-way affine calibration :82-135),
run_llava_calibrate_best.py (--calibrate-best: the degraded-image probes and
the 9-setting sweep), main_eval_only.py (parse + evaluate + instruction-level
accuracy), run_qwen_sampling.py:24-66 (--model-family qwen:
'<img>…</img>{q} Answer:' prompts with '<image 1>' stripped, eod stopping).

Input format: jsonl samples with
    {id, subject?, question_type, answer, final_input_prompt,
     all_choices?, index2ans?, image}

    python -m llava_align_tpu_torch.runners.mmmu --model-path random:tiny --device cpu \\
        --question-file mmmu.jsonl --answers-file answers.jsonl --synthetic-images \\
        --use_dd --use_dd_unk --calibrate --score-setting none_unk --print-table

Each question's sampling stream (and --calibrate-best's noise) is a
torch.Generator seeded args.seed + crc32(id) % 65536, where the JAX runner
seeds a PRNGKey so. The GPU unless --device cpu is given. --dist auto as in
the POPE runner; only rank 0 scores.
"""

from __future__ import annotations

import argparse
import json
import os
import zlib
from collections import defaultdict

import numpy as np
import torch

from llava_align_tpu_torch.calibrate.posthoc import calibrate_label_dict, get_prob_from_logits
from llava_align_tpu_torch.decoding.engine import DecodeEngine
from llava_align_tpu_torch.evals.mmmu import (
    calculate_ins_level_acc,
    calibrate_choice_probs,
    choice_label_dict,
    evaluate,
    parse_multi_choice_response,
    parse_open_response,
)
from llava_align_tpu_torch.runners.common import (
    AnswerFile,
    apply_dist_auto,
    finish_dist_auto,
    is_dist_worker,
    build_prompt,
    load_image_tensor,
    load_model,
    load_questions_for,
    make_generation_config,
    postprocess_answer,
)
from llava_align_tpu_torch.tokenization import keyword_token_ids, tokenizer_image_token


def _question_stream(device, seed: int, sid) -> torch.Generator:
    """A question's sampling stream, seeded seed + crc32(id) % 65536 (the
    JAX runner's PRNGKey seed)."""
    return torch.Generator(device=device).manual_seed(seed + (zlib.crc32(str(sid).encode()) % 65536))


def run_qwen(args) -> str:
    """MMMU over the Qwen-VL engine (reference run_qwen_sampling.py:24-66):
    prompt = image span + '{final_input_prompt minus <image 1>} Answer:',
    eod stopping. Records carry the llava path's fields, so every scorer
    (score, score_sweep, print_results) applies unchanged. --quant int8
    quantizes the decoder (as the JAX runner, only int8 acts)."""
    from llava_align_tpu_torch.decoding.adapters import QwenVLAdapter
    from llava_align_tpu_torch.models import qwen_vl as qwen_vl_model
    from llava_align_tpu_torch.runners.qwen_pope import _load_image, load_qwen_model

    apply_dist_auto(args)
    device = torch.device(args.device) if getattr(args, "device", None) else None
    tokenizer, params, cfg, model_name = load_qwen_model(args.model_path, device=device)
    if getattr(args, "quant", "none") == "int8":
        from llava_align_tpu_torch.ops.quant import quantize_qwen_params

        params = dict(params, qwen=quantize_qwen_params(params["qwen"]))
    eod = getattr(tokenizer, "eod_id", getattr(tokenizer, "eos_token_id", 2))
    samples = load_questions_for(args)
    if args.max_questions:
        samples = samples[: args.max_questions]
    ans = AnswerFile(args.answers_file, resume=args.resume)

    gen = make_generation_config(args, eos_token_id=eod, max_new_tokens=args.max_new_tokens)
    adapter = QwenVLAdapter(cfg)
    engine = DecodeEngine(params, cfg, gen, adapter=adapter, bucket=64)
    score_engine = None
    if getattr(args, "calibrate", False):
        score_gen = make_generation_config(
            args, eos_token_id=eod, use_cd=False, use_dd=False, use_dd_unk=False, max_new_tokens=1,
        )
        score_engine = DecodeEngine(params, cfg, score_gen, adapter=adapter, bucket=64)

    span = qwen_vl_model.make_image_span_ids(cfg)

    def _ids(text: str):
        return list(tokenizer(text).input_ids)

    def rng(sid) -> torch.Generator:
        return _question_stream(engine.device, args.seed, sid)

    def _finish(s, sid, out):
        q = s["final_input_prompt"].replace("<image 1>", "").strip()
        record = {
            "question_id": sid,
            "subject": s.get("subject", "all"),
            "question_type": s.get("question_type", "multiple-choice"),
            "answer": s.get("answer"),
            "all_choices": s.get("all_choices"),
            "index2ans": s.get("index2ans"),
            "text": tokenizer.decode(out.token_ids, skip_special_tokens=True).strip(),
            "model_id": model_name,
            "naive": calibrate_label_dict(out.first_scores_top_probs, out.first_scores_top_ids, tokenizer),
        }
        if score_engine is not None and s.get("all_choices"):
            # content-free probes as qwen_calibrate.py:36-41
            o = score_engine.generate(_ids(f"{q} Answer:"), None, generator=rng(sid))
            record["none"] = calibrate_label_dict(o.first_scores_top_probs, o.first_scores_top_ids, tokenizer)
            o = score_engine.generate(_ids(f"None {q} Answer:"), None, generator=rng(sid))
            record["unk"] = calibrate_label_dict(o.first_scores_top_probs, o.first_scores_top_ids, tokenizer)
        ans.write(record)

    # one question in flight without --calibrate: submit q+1 before
    # collecting q, in the JAX runner's order (the port's submit runs the
    # whole call, so nothing overlaps)
    in_flight = None
    for s in samples:
        sid = s.get("id", s.get("question_id"))
        if ans.is_done(sid):
            continue
        q = s["final_input_prompt"].replace("<image 1>", "").strip()
        sent_ids, _ = qwen_vl_model.sentinelize_span(span + _ids(f"{q} Answer:"), cfg)
        # the qwen 'unk' branch is a retokenized prompt ('None {q} Answer:',
        # qwen_calibrate.py:36-41): explicit ids, as in the qwen POPE runner
        branch_ids = {"unk": _ids(f"None {q} Answer:")} if gen.use_dd_unk else None
        image = _load_image(args, s.get("image", ""), cfg)
        if score_engine is None:
            handle = engine.submit_generate(sent_ids, image, generator=rng(sid), branch_ids=branch_ids)
            if in_flight is not None:
                _finish(*in_flight[:2], engine.collect_generate(in_flight[2]))
            in_flight = (s, sid, handle)
            continue
        _finish(s, sid, engine.generate(sent_ids, image, generator=rng(sid), branch_ids=branch_ids))
    if in_flight is not None:
        _finish(*in_flight[:2], engine.collect_generate(in_flight[2]))
    ans.close()
    return finish_dist_auto(args)


def run(args) -> str:
    if getattr(args, "model_family", "llava") == "qwen":
        return run_qwen(args)
    apply_dist_auto(args)
    device = torch.device(args.device) if getattr(args, "device", None) else None
    model = load_model(args.model_path, device=device)
    tokenizer, params, cfg = model.tokenizer, model.params, model.cfg
    samples = load_questions_for(args)
    if args.max_questions:
        samples = samples[: args.max_questions]
    ans = AnswerFile(args.answers_file, resume=args.resume)

    gen = make_generation_config(args)
    _, stop_str = build_prompt("x", args.conv_mode)
    stop_ids = keyword_token_ids([stop_str], tokenizer)
    engine = DecodeEngine(params, cfg, gen, stop_keyword_ids=stop_ids)
    score_engine = None
    if getattr(args, "calibrate", False) or getattr(args, "calibrate_best", False):
        score_gen = make_generation_config(
            args, use_cd=False, use_dd=False, use_dd_unk=False, max_new_tokens=1
        )
        score_engine = DecodeEngine(params, cfg, score_gen, stop_keyword_ids=stop_ids)

    def rng(sid) -> torch.Generator:
        return _question_stream(engine.device, args.seed, sid)

    # one question in flight on the no-calibrate path: submit q+1 before
    # collecting q, in the JAX runner's order (the port's submit runs the
    # whole call, so nothing overlaps)
    in_flight = None

    def _base_record(s, sid, stop_str, out):
        return {
            "question_id": sid,
            "subject": s.get("subject", "all"),
            "question_type": s.get("question_type", "multiple-choice"),
            "answer": s.get("answer"),
            "all_choices": s.get("all_choices"),
            "index2ans": s.get("index2ans"),
            "text": postprocess_answer(
                tokenizer.decode(out.token_ids, skip_special_tokens=True), stop_str
            ),
            "naive": calibrate_label_dict(
                out.first_scores_top_probs, out.first_scores_top_ids, tokenizer
            ),
        }

    def _flush_pending():
        nonlocal in_flight
        if in_flight is not None:
            ps, psid, pstop, ph = in_flight
            in_flight = None
            ans.write(_base_record(ps, psid, pstop, engine.collect_generate(ph)))

    for s in samples:
        sid = s.get("id", s.get("question_id"))
        if ans.is_done(sid):
            continue
        q = s["final_input_prompt"]
        prompt, stop_str = build_prompt(
            q, args.conv_mode, with_image=True,
            mm_use_im_start_end=cfg.mm_use_im_start_end,
        )
        input_ids = tokenizer_image_token(prompt, tokenizer)
        image = load_image_tensor(
            args.image_folder, s.get("image", ""),
            image_size=cfg.vision.image_size,
            image_aspect_ratio=args.image_aspect_ratio,
            synthetic_ok=args.synthetic_images,
        )
        if score_engine is None:
            handle = engine.submit_generate(input_ids, image, generator=rng(sid))
            _flush_pending()
            in_flight = (s, sid, stop_str, handle)
            continue
        out = engine.generate(input_ids, image, generator=rng(sid))
        record = _base_record(s, sid, stop_str, out)
        if s.get("all_choices"):
            p_none, _ = build_prompt(q, args.conv_mode, with_image=False)
            o = score_engine.generate(tokenizer_image_token(p_none, tokenizer), None, generator=rng(sid))
            record["none"] = calibrate_label_dict(
                o.first_scores_top_probs, o.first_scores_top_ids, tokenizer
            )
            ids_unk = [
                getattr(tokenizer, "unk_token_id", 0) if t == -200 else t
                for t in input_ids
            ]
            o = score_engine.generate(ids_unk, None, generator=rng(sid))
            record["unk"] = calibrate_label_dict(
                o.first_scores_top_probs, o.first_scores_top_ids, tokenizer
            )
            if getattr(args, "calibrate_best", False) and image is not None:
                # degraded-IMAGE probes for the full setting sweep
                # (run_llava_calibrate_best.py:237-250): pure diffusion
                # noise (step 999), all-zeros, all-ones, all in the
                # NORMALIZED pixel space the reference degrades
                from llava_align_tpu_torch.ops import noise
                from llava_align_tpu_torch.ops.image import normalize_host

                img_norm = (
                    normalize_host(np.asarray(image))
                    if np.asarray(image).dtype == np.uint8
                    else np.asarray(image, np.float32)
                )
                noised = noise.add_diffusion_noise(
                    img_norm, 999, generator=rng(sid), device=engine.device
                ).float().cpu().numpy()
                for probe_name, probe_img in (
                    ("noise", noised),
                    ("zero", np.zeros_like(img_norm)),
                    ("one", np.ones_like(img_norm)),
                ):
                    o = score_engine.generate(input_ids, probe_img, generator=rng(sid))
                    record[probe_name] = calibrate_label_dict(
                        o.first_scores_top_probs, o.first_scores_top_ids, tokenizer
                    )
        ans.write(record)
    _flush_pending()
    ans.close()
    return finish_dist_auto(args)


def score(answers_file: str, setting: str = "naive") -> dict:
    """Parse + evaluate per subject (reference main_eval_only.py), optionally
    calibrating multiple-choice probabilities with a content-free setting
    ('none' | 'unk' | 'none_unk')."""
    with open(os.path.expanduser(answers_file)) as f:
        records = [json.loads(line) for line in f]

    by_subject = defaultdict(list)
    for r in records:
        parsed = None
        if r["question_type"] == "multiple-choice" and r.get("all_choices"):
            choices = r["all_choices"]
            if setting != "naive" and r.get("naive"):
                label_dict = choice_label_dict(choices)
                naive_p = get_prob_from_logits(r["naive"], label_dict)
                cf = []
                for part in setting.split("_"):
                    if part in r:
                        cf.append(get_prob_from_logits(r[part], label_dict))
                if cf and np.sum(naive_p) > 0 and np.sum(cf) > 0:
                    cal = calibrate_choice_probs(naive_p, cf)
                    parsed = choices[int(np.argmax(cal))]
            if parsed is None:
                parsed = parse_multi_choice_response(
                    r["text"], choices, r.get("index2ans", {})
                )
        else:
            parsed = parse_open_response(r["text"])
        by_subject[r.get("subject", "all")].append(
            {
                "id": r["question_id"],
                "question_type": r["question_type"],
                "answer": r["answer"],
                "parsed_pred": parsed,
            }
        )

    results = {}
    for subject, samples in by_subject.items():
        _, m = evaluate(samples)
        results[subject] = {"acc": m["acc"], "num_example": len(samples)}
    overall = calculate_ins_level_acc(results)
    return {"subjects": results, "overall_acc": overall, "setting": setting}


def _parse_record(r: dict, pred) -> dict:
    """One answer record + a setting's raw prediction → evaluate() sample."""
    if r["question_type"] == "multiple-choice" and r.get("all_choices"):
        parsed = parse_multi_choice_response(
            str(pred), r["all_choices"], r.get("index2ans") or {}
        )
    else:
        parsed = parse_open_response(str(pred))
    return {
        "id": r.get("question_id", r.get("id")),
        "question_type": r["question_type"],
        "answer": r.get("answer"),
        "parsed_pred": parsed,
    }


def score_sweep(answers_file: str) -> dict:
    """Per-setting evaluation of the full calibration sweep + best pick
    (reference run_llava_calibrate_best.py produces the per-setting answer
    sets; main_eval_only.py evaluates each; this does both). Returns
    {settings: {name: {subjects, overall_acc}}, best_setting, table}."""
    from llava_align_tpu_torch.evals.mmmu import SWEEP_SETTINGS, results_table, settings_sweep

    with open(os.path.expanduser(answers_file)) as f:
        records = [json.loads(line) for line in f]
    sweep = settings_sweep(records)
    by_id = {str(r.get("question_id", r.get("id"))): r for r in records}

    out = {}
    for setting in SWEEP_SETTINGS:
        by_subject = defaultdict(list)
        for rid, pred in sweep[setting].items():
            r = by_id[rid]
            by_subject[r.get("subject", "all")].append(_parse_record(r, pred))
        subjects = {}
        for subject, samples in by_subject.items():
            _, m = evaluate(samples)
            subjects[subject] = {"acc": m["acc"], "num_example": len(samples)}
        out[setting] = {
            "subjects": subjects,
            "overall_acc": calculate_ins_level_acc(subjects),
        }
    best = max(out, key=lambda s: out[s]["overall_acc"])
    return {
        "settings": out,
        "best_setting": best,
        "best_overall_acc": out[best]["overall_acc"],
        "table": results_table(out[best]["subjects"]),
    }


def score_sweep_files(
    folder: str, prefix: str, setting: str = "naive", csv_path: str | None = None
) -> dict:
    """Aggregate per-setting MMMU answer files named ``{prefix}{setting}.jsonl``
    under `folder` (reference MMMU/samlping/main_eval_only.py:95-123:
    per-file evaluate + per-subject acc table; pandas/xlsx replaced with a
    returned dict + optional CSV)."""
    results = {}
    for file in sorted(os.listdir(os.path.expanduser(folder))):
        if not file.startswith(prefix):
            continue
        if not (file.endswith(".jsonl") or file.endswith(".json")):
            continue
        name = file[len(prefix):].rsplit(".", 1)[0] or "default"
        results[name] = score(os.path.join(folder, file), setting)
    if csv_path:
        with open(csv_path, "w") as f:
            f.write("setting,subject,acc,num_example\n")
            for name in sorted(results):
                rep = results[name]
                for subject, m in sorted(rep["subjects"].items()):
                    f.write(f"{name},{subject},{m['acc']:.4f},{m['num_example']}\n")
                f.write(f"{name},Overall,{rep['overall_acc']:.4f},\n")
    return results


def print_results(answers_file: str, setting: str = "naive") -> str:
    """Domain/subject accuracy table (reference print_results.py shape) for
    one setting of an answers file."""
    from llava_align_tpu_torch.evals.mmmu import results_table

    return results_table(score(answers_file, setting)["subjects"])


def build_parser() -> argparse.ArgumentParser:
    from llava_align_tpu_torch.runners.pope import build_parser as base

    p = base()
    p.add_argument("--score-setting", type=str, default="naive")
    p.add_argument("--calibrate-best", action="store_true", default=False,
                   help="dump ALL content-free probes (none/unk/noise/zero/"
                   "one) and sweep the 9 calibration settings, reporting "
                   "the best (reference run_llava_calibrate_best.py)")
    p.add_argument("--print-table", action="store_true", default=False,
                   help="print the domain/subject accuracy table "
                   "(reference print_results.py)")
    p.add_argument("--model-family", default="llava", choices=["llava", "qwen"],
                   help="qwen = reference MMMU run_qwen_sampling.py engine")
    return p


def main(argv=None) -> int:
    """Run and score: what `python -m llava_align_tpu_torch.runners.mmmu`
    prints is what the JAX runner's command line prints."""
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if "--score-sweep-files" in argv:
        # scoring-only CLI over a sweep's per-setting answer files
        # (reference MMMU/samlping/main_eval_only.py main)
        sp = argparse.ArgumentParser()
        sp.add_argument("--score-sweep-files", required=True)
        sp.add_argument("--sweep-prefix", default="")
        sp.add_argument("--sweep-csv", default="")
        sp.add_argument("--score-setting", default="naive")
        sa = sp.parse_args(argv)
        res = score_sweep_files(sa.score_sweep_files, sa.sweep_prefix, sa.score_setting,
                                csv_path=sa.sweep_csv or None)
        for name in sorted(res):
            print(name, f"overall_acc={res[name]['overall_acc']:.4f}")
        return 0

    a = build_parser().parse_args(argv)
    path = run(a)
    if is_dist_worker(a):
        # under --dist auto only rank 0 scores (it holds the merged file)
        print("rank != 0: skipping MMMU scoring")
        return 0
    if a.calibrate_best:
        res = score_sweep(path)
        print(json.dumps({k: v["overall_acc"] for k, v in res["settings"].items()}, indent=2))
        print(f"best: {res['best_setting']} ({res['best_overall_acc']:.4f})")
        if a.print_table:
            print(res["table"])
    else:
        res = score(path, a.score_setting)
        print(json.dumps(res, indent=2))
        if a.print_table:
            from llava_align_tpu_torch.evals.mmmu import results_table

            print(results_table(res["subjects"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
