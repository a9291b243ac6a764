"""The port's copies of the JAX package's pure-Python pieces must behave
identically: conversation prompts for every template, plan_splice,
tokenizer_image_token, get_model_name_from_path, MockTokenizer,
build_prompt, the grouped engine's host logic (common_token_prefix,
_txt_kind_prefix_bases), and VCD's diffusion schedule; and the verbatim
copies (evals/mme, evals/mmmu, the schedule, utils/moderation, the state
dict tools of utils/checkpoint_tools, PopeTask, text_only_plan,
engine.branch_token_ids, the LAVIS zoo's datasets, processors, tasks,
randaugment and the CLIP tokenizer, the evaluation tasks, the video and
dialogue data and processors, PnP-VQA's, Img2Prompt's and BLIP-Diffusion's
pure parts, data path and task, the prompt-to-prompt controllers, the
download layer, the rotating logger, and the rest of VERBATIM_COPIES)
must keep the originals' source, the package name aside. Exact equality."""

import dataclasses
import importlib
import inspect
import json

import numpy as np
import pytest

from llava_align_tpu import conversation as jconv
from llava_align_tpu import tokenization as jtok
from llava_align_tpu.constants import IMAGE_TOKEN_INDEX
from llava_align_tpu.models import llava as jllava
from llava_align_tpu.runners import common as jcommon
from llava_align_tpu_torch import constants as tconst
from llava_align_tpu_torch import conversation as tconv
from llava_align_tpu_torch import tokenization as ttok
from llava_align_tpu_torch.models import llava as tllava
from llava_align_tpu_torch.runners import common as tcommon


def test_constants_identical():
    from llava_align_tpu import constants as jconst

    names = [n for n in dir(jconst) if n.isupper()]
    assert names and all(getattr(tconst, n) == getattr(jconst, n) for n in names)


@pytest.mark.parametrize("mode", sorted(jconv.conv_templates))
def test_conversation_prompts_identical(mode):
    assert sorted(tconv.conv_templates) == sorted(jconv.conv_templates)
    for conv_mod in (jconv, tconv):
        assert conv_mod.conv_templates[mode].sep_style.name in tconv.SeparatorStyle.__members__
    turns = [
        [("<image>\nIs there a dog in the image?", None)],
        [("Describe it.", "A cat on a mat."), ("And the colour?", None)],
        [(("<image>\nWhat is shown?", "IMG", "pad"), None)],  # image-tuple first message
    ]
    for convo in turns:
        prompts = []
        for conv_mod in (jconv, tconv):
            conv = conv_mod.conv_templates[mode].copy()
            for user, assistant in convo:
                conv.append_message(conv.roles[0], user)
                conv.append_message(conv.roles[1], assistant)
            prompts.append((conv.get_prompt(), conv.stop_str, conv.dict()))
        assert prompts[0] == prompts[1]


@pytest.mark.parametrize("mode", ["llava_v1", "v1", "llava_v0", "llava_llama_2", "mpt", "plain"])
def test_build_prompt_identical(mode):
    for kw in ({}, {"with_image": False}, {"mm_use_im_start_end": True},
               {"one_word": True, "suffix": " Answer yes or no."}):
        assert tcommon.build_prompt("Is there a dog?", mode, **kw) == jcommon.build_prompt(
            "Is there a dog?", mode, **kw
        )


def test_plan_splice_identical():
    rng = np.random.default_rng(0)
    for trial in range(20):
        ids = [int(t) for t in rng.integers(3, 300, size=rng.integers(0, 12))]
        for _ in range(int(rng.integers(0, 3))):
            ids.insert(int(rng.integers(0, len(ids) + 1)), IMAGE_TOKEN_INDEX)
        n_img = int(rng.integers(0, 5))
        pad_to = len(ids) + max(n_img - 1, 0) * ids.count(IMAGE_TOKEN_INDEX) + int(rng.integers(0, 4))
        want = dataclasses.asdict(jllava.plan_splice(ids, n_img, pad_to))
        got = dataclasses.asdict(tllava.plan_splice(ids, n_img, pad_to))
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"trial {trial} {k}")
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
    with pytest.raises(ValueError):
        tllava.plan_splice([1, IMAGE_TOKEN_INDEX], 4, 3)


class _NoBosTokenizer:
    bos_token_id = None

    def __call__(self, text):
        class R:
            input_ids = [ord(c) % 50 + 10 for c in text]

        return R()


@pytest.mark.parametrize("tokenizer", [jcommon.MockTokenizer(), _NoBosTokenizer()],
                         ids=["mock_bos", "no_bos"])
def test_tokenizer_image_token_identical(tokenizer):
    for prompt in ("no image here", "<image>\nwhat?", "a <image> b <image> c", "<image>"):
        want = jtok.tokenizer_image_token(prompt, tokenizer)
        assert ttok.tokenizer_image_token(prompt, tokenizer) == want
        np.testing.assert_array_equal(
            ttok.tokenizer_image_token(prompt, tokenizer, return_tensors="np"),
            jtok.tokenizer_image_token(prompt, tokenizer, return_tensors="np"),
        )
        assert ttok.tokenizer_image_token(prompt, tokenizer, return_tensors="pt").tolist() == want
    assert ttok.keyword_token_ids(["</s>", "###"], tokenizer) == jtok.keyword_token_ids(
        ["</s>", "###"], tokenizer
    )


def test_mock_tokenizer_identical():
    t, j = tcommon.MockTokenizer(), jcommon.MockTokenizer()
    text = "USER: <image>\nIs there a dog? ASSISTANT: é€"
    assert t(text).input_ids == j(text).input_ids
    ids = j(text).input_ids + [0, 2]
    for skip in (True, False):
        assert t.decode(ids, skip_special_tokens=skip) == j.decode(ids, skip_special_tokens=skip)
    assert t.decode(np.int64(70)) == j.decode(np.int64(70))
    for attr in ("bos_token_id", "eos_token_id", "unk_token_id", "pad_token_id"):
        assert getattr(t, attr) == getattr(j, attr)


def _token_lists(rng):
    base = [int(t) for t in rng.integers(3, 50, size=rng.integers(0, 6))]
    return [base + [int(t) for t in rng.integers(3, 50, size=rng.integers(0, 5))]
            for _ in range(int(rng.integers(0, 5)))]


def test_common_token_prefix_identical():
    from llava_align_tpu.decoding.engine import DecodeEngine as JEngine
    from llava_align_tpu_torch.decoding.engine import DecodeEngine as TEngine

    rng = np.random.default_rng(0)
    cases = [[[1, 2, 3, 4], [1, 2, 3, 5, 6]], [[1, 2], [1, 2]], [], [[7]], [[1, 2, 3]]]
    cases += [_token_lists(rng) for _ in range(50)]
    for lists in cases:
        assert TEngine.common_token_prefix(lists) == JEngine.common_token_prefix(lists), lists


@pytest.fixture(scope="module")
def engines():
    """A JAX and a port DecodeEngine (dual VDD) for their host-side logic;
    neither runs a model here."""
    import jax

    from llava_align_tpu.config import GenerationConfig as JGen
    from llava_align_tpu.config import LlavaConfig as JCfg
    from llava_align_tpu.decoding.engine import DecodeEngine as JEngine
    from llava_align_tpu_torch.config import GenerationConfig as TGen
    from llava_align_tpu_torch.config import LlavaConfig as TCfg
    from llava_align_tpu_torch.decoding.engine import DecodeEngine as TEngine

    flags = dict(use_dd=True, use_dd_unk=True)
    jeng = JEngine(jax.eval_shape(lambda k: jllava.init(k, JCfg.tiny(97)), jax.random.PRNGKey(0)),
                   JCfg.tiny(97), JGen(**flags))
    teng = TEngine({"llama": {"embed": None}}, TCfg.tiny(97), TGen(**flags), device="cpu")
    return jeng, teng


def test_assemble_images_identical(engines):
    """Per-group images → one array: raw uint8 only when every present slot
    is uint8, else uint8 slots normalized on the host; None slots zero."""
    jeng, teng = engines
    rng = np.random.default_rng(3)
    H = 28
    u8 = [rng.integers(0, 256, (3, H, H), dtype=np.uint8) for _ in range(2)]
    f32 = rng.normal(size=(3, H, H)).astype(np.float32)
    for slots in ([u8[0], u8[1]], [u8[0], None], [u8[0], f32], [None, f32], [None, None]):
        want = jeng._assemble_images(slots, len(slots))
        got = teng._assemble_images(slots, len(slots))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_txt_kind_prefix_bases_identical(engines):
    """Which text kinds share a per-group prefix segment, and with which
    transformed prefix: the port's host logic against the JAX engine's."""
    jeng, teng = engines
    S = IMAGE_TOKEN_INDEX
    groups_list = [
        [([1, 5, S, 6], [[7, 8], [9]], None, None)],
        [([1, 5, S, 6], [[7], [8]], None, None), ([1, S], [[3], [4, 5]], None, None)],
        [([1, 5, 6], [[S, 8], [9]], None, None)],               # sentinel in a suffix
        [([S], [[2], [3]], None, None)],                        # 'none' prefix is empty
        [([1, S, 2], [[3], [4]], None, [{"unk": [1, 0, 2, 3]}, None])],  # explicit ids
        [([1, S, 2], [[3], [4]], None, [None, {"none": [1, 2, 4]}])],
    ]
    for groups in groups_list:
        for kind in ("unk", "none"):
            assert teng._txt_kind_prefix_bases(kind, groups) == jeng._txt_kind_prefix_bases(
                kind, groups), (kind, groups)


# ---------------------------------------------------------------------------
# the POPE slice's pure-Python copies: Post-Hoc calibration, the POPE
# scorers, the prefetch loader, the runner plumbing
# ---------------------------------------------------------------------------


def _posthoc_cases():
    from llava_align_tpu.runners.common import MockTokenizer

    rng = np.random.default_rng(5)
    probs = rng.random((12, 2))
    labels = rng.integers(0, 2, 12)
    top_probs = np.sort(rng.random(20))[::-1].astype(np.float32)
    top_ids = np.asarray([ord(c) + 3 for c in "yYnNo yes no".ljust(20, "a")])
    return {
        "calibrate_weight_diagonal": lambda m: m.calibrate_weight([0.7, 0.3], "diagonal_W"),
        "calibrate_weight_identity": lambda m: m.calibrate_weight([0.7, 0.3], "identity_W"),
        "apply_calibration": lambda m: m.apply_calibration([0.2, 0.6], *m.calibrate_weight([0.4, 0.6])),
        "eval_accuracy_plain": lambda m: m.eval_accuracy(probs, labels),
        "eval_accuracy_calibrated": lambda m: m.eval_accuracy(probs, labels, "diagonal_W", [0.55, 0.45]),
        "ece": lambda m: m.ece(probs, labels, n_bins=10),
        "calibrate_label_dict": lambda m: m.calibrate_label_dict(top_probs, top_ids, MockTokenizer(), 15),
        "get_prob_from_logits": lambda m: m.get_prob_from_logits({"Yes ": 0.25, "no": 0.5, "x": 0.1}),
    }


def _same(a, b):
    """Exact equality through tuples, lists, dicts and numpy arrays."""
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("case", list(_posthoc_cases()))
def test_posthoc_identical(case):
    from llava_align_tpu.calibrate import posthoc as jpost
    from llava_align_tpu_torch.calibrate import posthoc as tpost

    fn = _posthoc_cases()[case]
    assert _same(fn(tpost), fn(jpost))
    assert tpost.LABEL_DICT == jpost.LABEL_DICT and tpost.LABEL_TO_INT == jpost.LABEL_TO_INT


def _pope_files(tmp_path, n=8, calibrated=True, seed=0):
    """A gt file and an answers file with top-k dumps; the gt file's lines
    end in trailing commas, as some reference splits do."""
    rng = np.random.default_rng(seed)
    gt, gen = tmp_path / "gt.json", tmp_path / "gen.jsonl"
    with open(gt, "w") as f_gt, open(gen, "w") as f_gen:
        for i in range(n):
            f_gt.write(json.dumps({"question_id": i, "label": ["yes", "no"][i % 2]}) + ",\n")
            rec = {"question_id": i, "text": ["Yes.", "no", "maybe"][i % 3]}
            for name in ("naive", "none", "unk") if calibrated else ("naive",):
                p = rng.random(3)
                rec[name] = {"Yes": float(p[0]), "no ": float(p[1]), "the": float(p[2])}
            if i == 3:
                rec["naive"] = {"the": 0.5}  # neither class in the top-k: uniform fallback
            f_gen.write(json.dumps(rec) + "\n")
    return str(gt), str(gen)


POPE_SCORER_CASES = {
    "score_pope": lambda m, gt, gen: m.score_pope(gt, gen),
    "calibrated_individual": lambda m, gt, gen: m.score_pope_calibrated(gt, gen),
    "calibrated_all_identity": lambda m, gt, gen: m.score_pope_calibrated(
        gt, gen, calibrate_mode="all", mode="identity_W", settings=("naive", "none_unk", "unk")),
    "calibrated_confidence_window": lambda m, gt, gen: m.score_pope_calibrated(
        gt, gen, confidence_low=0.4, confidence_high=0.9, ece_bins=5),
    "report": lambda m, gt, gen: m.format_calibrated_report(m.score_pope_calibrated(gt, gen)),
}


@pytest.mark.parametrize("case", list(POPE_SCORER_CASES) + ["misaligned", "missing_dumps"])
def test_pope_scorer_identical(case, tmp_path):
    from llava_align_tpu.evals import pope as jpope
    from llava_align_tpu_torch.evals import pope as tpope

    gt_path, gen_path = _pope_files(tmp_path, calibrated=case != "missing_dumps")
    outs = []
    for m in (jpope, tpope):
        gt, gen = m.load_jsonl(gt_path), m.load_jsonl(gen_path)
        if case == "misaligned":
            gen = gen[1:] + gen[:1]
        try:
            fn = POPE_SCORER_CASES.get(case, POPE_SCORER_CASES["calibrated_individual"])
            outs.append(("ok", fn(m, gt, gen)))
        except ValueError as e:
            outs.append(("ValueError", str(e)))
    assert _same(outs[0], outs[1]), outs
    assert outs[0][0] == ("ValueError" if case in ("misaligned", "missing_dumps") else "ok")
    assert tpope.BASE_SETTINGS == jpope.BASE_SETTINGS and tpope.COMBO_SETTINGS == jpope.COMBO_SETTINGS


@pytest.mark.parametrize("num_workers,batch_size,prefetch", [(1, 1, 1), (3, 2, 4), (4, 3, 2)])
def test_prefetch_loader_identical(num_workers, batch_size, prefetch):
    """Order-preserving batches of transformed rows, the same from both
    copies, and a worker's exception raised in the consumer."""
    from llava_align_tpu.framework import data as jdata
    from llava_align_tpu_torch.framework import data as tdata

    rows = list(range(11))
    outs = []
    for m in (jdata, tdata):
        ds = m.ListDataset(rows, transform=lambda r: (r, r * r))
        loader = m.PrefetchLoader(ds, batch_size=batch_size, num_workers=num_workers, prefetch=prefetch,
                                  collate=lambda b: [x for x, _ in b])
        outs.append((len(ds), ds[4], len(loader), list(loader)))

        def bad(r):
            if r == 5:
                raise KeyError(r)
            return r

        with pytest.raises(KeyError):
            list(m.PrefetchLoader(m.ListDataset(rows, transform=bad), num_workers=num_workers))
    assert outs[0] == outs[1]
    assert [x for b in outs[1][3] for x in b] == rows


def _runner_helper_cases(tmp_path):
    import argparse

    qf = tmp_path / "q.jsonl"
    qf.write_text("".join(json.dumps({"question_id": i, "text": f"q{i}"}) + ("," if i % 2 else "") + "\n"
                          for i in range(7)) + "\n")
    ns = argparse.Namespace(question_file=str(qf), num_chunks=3, chunk_idx=2, temperature=0.0,
                            max_new_tokens=9, top_k=5, use_dd=True, cd_alpha=0.5, seed=3)
    return {
        "split_list": lambda m: [m.split_list(list(range(n)), k) for n in (1, 6, 7) for k in (1, 3, 4)],
        "get_chunk": lambda m: [m.get_chunk(list(range(6)), 4, k, allow_out_of_range=True) for k in range(5)],
        "get_chunk_out_of_range": lambda m: m.get_chunk(list(range(6)), 4, 3),
        "load_questions": lambda m: [m.load_questions(str(qf)), m.load_questions(str(qf), 3, 1)],
        "load_questions_for": lambda m: m.load_questions_for(ns),
        "postprocess_answer": lambda m: [m.postprocess_answer(t, s) for t in (" Yes</s> no", "no ###", " x ")
                                         for s in ("</s>", "###", "")],
        "make_generation_config": lambda m: [dataclasses.asdict(m.make_generation_config(ns)),
                                             dataclasses.asdict(m.make_generation_config(
                                                 ns, use_dd=False, max_new_tokens=1))],
    }


@pytest.mark.parametrize("case", ["split_list", "get_chunk", "get_chunk_out_of_range", "load_questions",
                                  "load_questions_for", "postprocess_answer", "make_generation_config"])
def test_runner_helpers_identical(case, tmp_path):
    outs = []
    for m in (jcommon, tcommon):
        try:
            outs.append(("ok", _runner_helper_cases(tmp_path)[case](m)))
        except IndexError as e:
            outs.append(("IndexError", str(e)))
    assert _same(outs[0], outs[1]), outs


def test_answer_file_and_merge_identical(tmp_path):
    """AnswerFile: fresh write, resume that skips done (id, prompt) keys and
    tolerates a torn line, append; merge_chunk_files of per-rank parts, and
    its refusal when a part is missing."""
    results = []
    for tag, m in (("j", jcommon), ("t", tcommon)):
        path = tmp_path / tag / "ans.jsonl"
        f = m.AnswerFile(str(path))
        f.write({"question_id": 1, "prompt": "a"})
        f.write({"question_id": 2, "prompt": "b"})
        f.close()
        with open(path, "a") as raw:
            raw.write('{"question_id": 3, "pro')  # a torn last line
        f = m.AnswerFile(str(path), resume=True)
        done = [f.is_done(1), f.is_done(1, "a"), f.is_done(1, "b"), f.is_done(3), f.is_done(2, "b")]
        f.write({"question_id": 4, "prompt": "c"})
        f.close()
        root = tmp_path / tag / "merged.jsonl"
        for r in range(2):
            (tmp_path / tag / f"merged.rank{r}-of-2.jsonl").write_text(f"part {r}\n")
        m.merge_chunk_files(str(root), 2)
        with pytest.raises(FileNotFoundError):
            m.merge_chunk_files(str(root), 3)
        results.append((done, path.read_text(), root.read_text()))
    assert results[0] == results[1]


# ---------------------------------------------------------------------------
# the VCD / checkpoint / MME / MMMU slice's copies
# ---------------------------------------------------------------------------

VERBATIM_COPIES = [
    ("ops.noise", "diffusion_schedule"),
    *[("evals.mme", n) for n in (
        "parse_pred_ans", "compute_metric", "score_task_lines", "score_results_dir", "score_sweep_dirs",
        "calibrated_predictions", "convert_calibrated_answers_to_category_txt",
        "convert_answers_to_category_txt")],
    *[("evals.mmmu", n) for n in (
        "parse_multi_choice_response", "check_is_number", "normalize_str", "extract_numbers",
        "parse_open_response", "eval_multi_choice", "eval_open", "evaluate", "calculate_ins_level_acc",
        "calibrate_choice_probs", "choice_label_dict", "sweep_predict", "settings_sweep", "results_table")],
    # the Qwen-VL slice
    ("ops.image", "qwen_preprocess_pil"),
    *[("models.qwen_generation_utils", n) for n in (
        "_encode", "make_context", "decode_tokens", "stop_words_ids", "pad_batch")],
    *[("models.qwen_tokenizer", n) for n in ("load_tiktoken_bpe", "bpe_encode")],
    # the InstructBLIP slice: the caption task and what it imports
    *[("framework.tasks", n) for n in ("save_result", "BaseTask", "CaptionTask", "_coerce_id")],
    *[("framework.logger", n) for n in ("SmoothedValue", "MetricLogger")],
    ("framework.registry", "Registry"),
    # LLaVA's last runners: the judge pipeline
    *[("evals.gpt_review", n) for n in (
        "openai_judge", "parse_score", "build_review_content", "run_review", "summarize_reviews")],
    # training: the config helpers, the caption data path, the CLI's tokenizer and batching
    *[("framework.config", n) for n in ("_parse_value", "set_dot", "get_dot", "merge")],
    *[("framework.datasets", n) for n in (
        "_load_annotations", "_load_image", "BaseAnnotationDataset", "CaptionDataset", "CaptionEvalDataset",
        "CaptionBuilder", "_named_builder")],
    *[("framework.processors", n) for n in ("_normalize", "BlipImageEvalProcessor")],
    *[("runners.common", n) for n in ("mock_tokenize", "resolve_tokenizer")],
    ("runners.train", "_batches"),
    ("train.trainer", "build_train_batch"),
    # the utility tail
    ("utils.moderation", "violates_moderation"),
    *[("utils.checkpoint_tools", n) for n in ("_np", "merge_lora", "apply_projector_only", "make_delta",
                                              "apply_delta")],
    ("framework.tasks", "PopeTask"),
    ("models.llava", "text_only_plan"),
    ("decoding.engine", "branch_token_ids"),
    # the LAVIS zoo's data path, processors, tasks and tokenizer
    *[("framework.datasets", n) for n in (
        "ImageTextPairDataset", "RetrievalDataset", "RetrievalEvalDataset", "MultimodalClassificationDataset",
        "RetrievalBuilder", "ImageTextPairBuilder", "MultimodalClassificationBuilder")],
    *[("framework.processors", n) for n in (
        "BlipImageTrainProcessor", "_resize_short_edge", "_center_crop", "Blip2ImageTrainProcessor",
        "ClipImageTrainProcessor", "ClipImageEvalProcessor", "BlipCaptionProcessor", "BlipQuestionProcessor")],
    *[("framework.tasks", n) for n in ("MultimodalClassificationTask", "ImageTextPretrainTask", "RetrievalTask")],
    *[("framework.randaugment", n) for n in (
        "identity", "autocontrast", "equalize", "solarize", "posterize", "color", "contrast", "brightness",
        "_smooth3x3", "sharpness", "_warp_affine", "rotate", "shear_x", "shear_y", "translate_x", "translate_y",
        "cutout", "_enhance_args", "_shear_args", "_translate_args", "_rotate_args", "_solarize_args",
        "_posterize_args", "_none_args", "RandomAugment", "VideoRandomAugment")],
    *[("models.clip_tokenizer", n) for n in ("bytes_to_unicode", "_clean", "ClipTokenizer")],
    # the evaluation tasks, the VQA / NLVR / video / dialogue / ImageNet data and the video and GPT processors
    *[("framework.tasks", n) for n in (
        "_vqa_process_punct", "vqa_normalize", "VQATask", "GQATask", "AOKVQATask", "VQARCTask", "GQARCTask",
        "DialogueTask")],
    *[("framework.datasets", n) for n in (
        "VQADataset", "VQAEvalDataset", "NLVRDataset", "VQABuilder", "NLVRBuilder", "VideoQADataset",
        "VideoRetrievalDataset", "VideoCaptionDataset", "VideoCaptionEvalDataset", "VideoQABuilder",
        "VideoRetrievalBuilder", "VideoCaptionBuilder", "_expand_dialog_turns", "AVSDDialDataset",
        "AVSDDialEvalDataset", "AVSDDialBuilder", "ImageFolderDataset", "ImageNetBuilder",
        "build_datasets_for_model")],
    *[("framework.processors", n) for n in (
        "AlproVideoEvalProcessor", "AlproVideoTrainProcessor", "pad_sequences", "GPTDialogueProcessor",
        "GPTVideoFeatureProcessor")],
    # PnP-VQA, Img2Prompt and BLIP-Diffusion: their pure parts, data path and task; the rotating logger
    ("models.pnp_vqa", "prepare_qa_input"),
    *[("models.img2prompt", n) for n in (
        "HeuristicExtractor", "answer_extraction", "create_context_prompt", "create_task_prompt",
        "prompts_construction")],
    *[("models.blip_diffusion", n) for n in ("SchedulerConfig", "ddim_timesteps", "build_prompt")],
    *[("framework.processors", n) for n in ("BlipDiffusionInputImageProcessor", "BlipDiffusionTargetImageProcessor")],
    *[("framework.datasets", n) for n in (
        "BaseDatasetBuilder", "SubjectDrivenTextToImageDataset", "BlipDiffusionFinetuneBuilder")],
    ("framework.tasks", "TextToImageGenerationTask"),
    ("framework.logger", "build_logger"),
    # whole-module copies: every function and class the original defines
    *[(m, n) for m in ("models.ptp", "framework.download")
      for n, obj in vars(importlib.import_module("llava_align_tpu." + m)).items()
      if (inspect.isfunction(obj) or inspect.isclass(obj)) and obj.__module__ == "llava_align_tpu." + m],
]


@pytest.mark.parametrize("module,name", VERBATIM_COPIES, ids=[f"{m}.{n}" for m, n in VERBATIM_COPIES])
def test_verbatim_copy_keeps_the_original_source(module, name):
    """Each copied function's source is the original's, with
    llava_align_tpu. imports read as llava_align_tpu_torch. ones."""
    want = inspect.getsource(getattr(importlib.import_module("llava_align_tpu." + module), name))
    got = inspect.getsource(getattr(importlib.import_module("llava_align_tpu_torch." + module), name))
    assert got == want.replace("llava_align_tpu.", "llava_align_tpu_torch.")


def test_copied_constants_identical():
    from llava_align_tpu.evals import mme as jmme
    from llava_align_tpu.evals import mmmu as jmmmu
    from llava_align_tpu.ops import noise as jnoise
    from llava_align_tpu_torch.evals import mme as tmme
    from llava_align_tpu_torch.evals import mmmu as tmmmu
    from llava_align_tpu_torch.ops import noise as tnoise

    assert tmme.EVAL_TYPE_DICT == jmme.EVAL_TYPE_DICT and tmme.LABEL_MAP == jmme.LABEL_MAP
    for name in ("SWEEP_SETTINGS", "_SWEEP_COMBOS", "DOMAIN_CAT2SUB_CAT", "CAT_SHORT2LONG"):
        assert getattr(tmmmu, name) == getattr(jmmmu, name), name
    # the parsers' random fallback: seeded as in the JAX package
    assert "\n_rng = random.Random(42)\n" in inspect.getsource(tmmmu)
    assert "\n_rng = random.Random(42)\n" in inspect.getsource(jmmmu)
    for got, want in zip(tnoise.diffusion_schedule(), jnoise.diffusion_schedule()):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    from llava_align_tpu.framework import download as jdl
    from llava_align_tpu.models import img2prompt as ji
    from llava_align_tpu.models import ptp as jptp
    from llava_align_tpu_torch.framework import download as tdl
    from llava_align_tpu_torch.models import img2prompt as ti
    from llava_align_tpu_torch.models import ptp as tptp

    assert ti.OPEN_POS == ji.OPEN_POS and ti._STOPWORDS == ji._STOPWORDS and tptp.MAX_NUM_WORDS == jptp.MAX_NUM_WORDS
    assert [vars(e) for e in tdl.MANIFEST] == [vars(e) for e in jdl.MANIFEST] and len(tdl.MANIFEST) == 16


@pytest.mark.parametrize("path", ["liuhaotian/llava-v1.5-7b", "/ckpt/llava-v1.5-13b/", "llava-v1.5-7b",
                                  "/runs/llava/checkpoint-1200", "/runs/llava/checkpoint-1200/", "x"])
def test_get_model_name_from_path_identical(path):
    assert ttok.get_model_name_from_path(path) == jtok.get_model_name_from_path(path)


# ---------------------------------------------------------------------------
# the Qwen-VL slice's copies: the tokenizer (behaviour, on a rank table built
# here), make_context and the stop-word helpers, qwen_preprocess_pil
# ---------------------------------------------------------------------------

QWEN_CORPUS = [
    "Is there a dog in the image? Answer:",
    "None Is there a dog in the image? Answer:",
    "the theater is in there, and the thing",
    "  leading   spaces\n\nand newlines\n",
    "don't it's we're I'll they'd I'm you've",
    "numbers 123 456789 3.14 unicode: café naïve 你好世界 ☃",
    "<img>COCO_val2014_000000000042.jpg</img>Is there a car in the image? Answer:",
    "<|im_start|>user\n<img>a/b.png</img>hi<|im_end|>\n<|extra_7|>",
    "",
]


@pytest.fixture(scope="module")
def qwen_tokenizers(tmp_path_factory):
    """The JAX package's QwenTokenizer and the port's copy, both from one
    qwen.tiktoken-format rank file written here (every byte plus a few
    stacked merges, as in a trained BPE)."""
    import base64

    from llava_align_tpu.models.qwen_tokenizer import QwenTokenizer as JTok
    from llava_align_tpu_torch.models.qwen_tokenizer import QwenTokenizer as TTok

    ranks = {bytes([i]): i for i in range(256)}
    for m in (b"th", b"he", b"in", b"er", b"an", b" t", b" a", b"re", b"the", b" th", b" the", b"ing",
              b"is", b" is", b"An", b"swer", b"Answer", b" Answer", b"im", b"age", b" image", b"jp", b"jpg"):
        ranks.setdefault(m, len(ranks))
    path = tmp_path_factory.mktemp("qwen_tok") / "qwen.tiktoken"
    path.write_bytes(b"".join(base64.b64encode(k) + b" " + str(v).encode() + b"\n" for k, v in ranks.items()))
    return JTok(str(path)), TTok(str(path))


def test_qwen_tokenizer_identical(qwen_tokenizers):
    j, t = qwen_tokenizers
    for attr in ("eod_id", "im_start_id", "im_end_id", "img_start_id", "img_end_id", "img_pad_id",
                 "eos_token_id", "vocab_size", "special_tokens", "IMAGE_ST"):
        assert getattr(t, attr) == getattr(j, attr), attr
    for text in QWEN_CORPUS:
        ids = j.encode(text)
        assert t.encode(text) == ids and t(text).input_ids == j(text).input_ids, text
        for skip in (False, True):
            assert t.decode(ids, skip_special_tokens=skip) == j.decode(ids, skip_special_tokens=skip), text
        assert t.encode(text, allowed_special=set()) == j.encode(text, allowed_special=set()), text
        assert t.convert_ids_to_tokens(ids) == j.convert_ids_to_tokens(ids)
    span = t.encode("<img>x.png</img>")
    assert len(span) == 258 and span[0] == t.img_start_id and span[-1] == t.img_end_id
    for m in (j, t):
        with pytest.raises(ValueError, match="disallowed"):
            m.encode("<|endoftext|>", allowed_special=set(), disallowed_special="all")


def test_qwen_tokenizer_names_missing_regex(qwen_tokenizers, monkeypatch):
    """The port's module imports without `regex` (the card machine has
    none); constructing a tokenizer then raises a clear ImportError."""
    import sys

    from llava_align_tpu_torch.models.qwen_tokenizer import QwenTokenizer

    monkeypatch.setitem(sys.modules, "regex", None)
    with pytest.raises(ImportError, match="regex"):
        QwenTokenizer(mergeable_ranks=qwen_tokenizers[1].mergeable_ranks)


@pytest.mark.parametrize("history", [None, [("What is it?", "A dog."), ("And?", None)]], ids=["single", "history"])
def test_qwen_make_context_identical(qwen_tokenizers, history):
    from llava_align_tpu.models import qwen_generation_utils as jgu
    from llava_align_tpu_torch.models import qwen_generation_utils as tgu

    j, t = qwen_tokenizers
    query = "<img>img/0.jpg</img>Is there a dog in the image?"
    for fmt in ("chatml", "raw"):
        want = jgu.make_context(j, query, history=history, system="You are a helpful assistant.",
                                chat_format=fmt)
        assert tgu.make_context(t, query, history=history, system="You are a helpful assistant.",
                                chat_format=fmt) == want
    assert tgu.stop_words_ids(t) == jgu.stop_words_ids(j)
    ids = j.encode("Yes, a dog.<|im_end|>trailing")
    assert tgu.decode_tokens(ids, t, stop_words=["dog"]) == jgu.decode_tokens(ids, j, stop_words=["dog"])
    assert tgu.pad_batch([[1, 2], [3]], 0) == jgu.pad_batch([[1, 2], [3]], 0)
    assert tgu.pad_batch([[1, 2], [3]], 9, "right") == jgu.pad_batch([[1, 2], [3]], 9, "right")


@pytest.mark.parametrize("size", [(448, 448), (500, 333), (120, 260)])
def test_qwen_preprocess_pil_identical(size):
    from PIL import Image

    from llava_align_tpu.ops.image import qwen_preprocess_pil as jpre
    from llava_align_tpu_torch.ops.image import qwen_preprocess_pil as tpre

    raw = np.random.default_rng(size[0]).integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)
    for image_size in (448, 56):
        got, want = tpre(Image.fromarray(raw), image_size), jpre(Image.fromarray(raw), image_size)
        assert got.dtype == want.dtype == np.float32 and got.shape == (3, image_size, image_size)
        np.testing.assert_array_equal(got, want)


def test_qwen_runner_synthetic_image_identical(tmp_path):
    """The port's --synthetic-images stand-in (normalized without PIL) is
    the JAX runner's (through qwen_preprocess_pil) exactly; an image file
    goes through qwen_preprocess_pil on both sides."""
    import argparse

    from PIL import Image

    from llava_align_tpu.models.qwen_vl import QwenVLConfig as JCfgQ
    from llava_align_tpu.runners import qwen_pope as jqp
    from llava_align_tpu_torch.models.qwen_vl import QwenVLConfig as TCfgQ
    from llava_align_tpu_torch.runners import qwen_pope as tqp

    Image.fromarray(np.random.default_rng(3).integers(0, 256, (90, 70, 3), dtype=np.uint8)).save(tmp_path / "f.png")
    args = argparse.Namespace(image_folder=str(tmp_path), synthetic_images=True)
    for jc, tc in ((JCfgQ(), TCfgQ()), (JCfgQ.tiny(), TCfgQ.tiny())):
        for name in ("COCO_val2014_000000000042.jpg", "f.png"):
            np.testing.assert_array_equal(tqp._load_image(args, name, tc), jqp._load_image(args, name, jc))


def test_caption_task_copy_behaves_as_jax(tmp_path):
    """CaptionTask's evaluation loop and after_evaluation (save_result,
    deduplicated on image_id, ids coerced) write the same file in both
    packages; both registries name the same tasks; MetricLogger averages
    alike."""
    from llava_align_tpu.framework import logger as jlog
    from llava_align_tpu.framework import tasks as jtasks
    from llava_align_tpu.framework.registry import registry as jreg
    from llava_align_tpu_torch.framework import logger as tlog
    from llava_align_tpu_torch.framework import tasks as ttasks
    from llava_align_tpu_torch.framework.registry import registry as treg

    def generate_fn(params, sample, **kw):
        return [f"{sample['image']} b{kw['num_beams']} {kw['max_length']}-{kw['min_length']}"]

    samples = [{"image_id": ["7"], "image": "a"}, {"image_id": "cat_1", "image": "b"},
               {"image_id": ["7"], "image": "c"}]
    texts = []
    for tasks, d in ((jtasks, tmp_path / "j"), (ttasks, tmp_path / "t")):
        task = tasks.CaptionTask(generate_fn=generate_fn, num_beams=5, max_len=30, min_len=8, result_dir=str(d))
        results = task.evaluation(None, samples, log_freq=1)
        metrics = task.after_evaluation(results, split_name="val", epoch=0)
        texts.append((results, metrics, (d / "val_epoch0.json").read_text()))
        assert tasks.BaseTask.setup_task({"task_args": {"x": 1}}).cfg == {"x": 1}
    assert texts[0] == texts[1]
    assert '"image_id": 7' in texts[1][2] and texts[1][2].count('"image_id": 7') == 1
    assert treg.list("task") == ["aok_vqa", "base", "captioning", "dialogue", "gqa", "gqa_reading_comprehension",
                                 "image_text_pretrain", "multimodal_classification", "pope", "retrieval",
                                 "text-to-image-generation", "vqa", "vqa_reading_comprehension"] and treg is not jreg
    assert set(treg.list("task")) == set(jreg.list("task"))
    assert treg.get_task_class("captioning") is ttasks.CaptionTask
    assert treg.get_task_class("pope") is ttasks.PopeTask
    avgs = []
    for log in (jlog, tlog):
        m = log.MetricLogger()
        for v in (1.0, 2.0, 6.0):
            m.update(loss=v)
        avgs.append((m.global_avg(), m.loss.median, m.loss.avg, str(m)))
    assert avgs[0] == avgs[1] and avgs[1][0] == {"loss": 3.0}


def test_config_copy_behaves_as_jax(tmp_path):
    """framework/config.Config (yaml imported where a file is read): the
    same tree, dot-list overrides and sections as the JAX package's."""
    from llava_align_tpu.framework.config import Config as JConfig
    from llava_align_tpu_torch.framework.config import Config as TConfig

    path = tmp_path / "c.yaml"
    path.write_text("run:\n  task: captioning\n  init_lr: 1.0e-4\nmodel:\n  arch: llava\n"
                    "datasets:\n  coco_caption: {synthetic_images: true}\n")
    opts = ["run.device=cpu", "run.max_epoch=3", "model.size=tiny", 'run.betas=[0.9, 0.95]', "a.b.c={\"x\": 1}"]
    j = JConfig(str(path), options=opts, defaults={"run": {"seed": 7}})
    c = TConfig(str(path), options=opts, defaults={"run": {"seed": 7}})
    assert c.to_dict() == j.to_dict() and c.pretty() == j.pretty()
    assert (c.run_cfg, c.model_cfg, c.datasets_cfg) == (j.run_cfg, j.model_cfg, j.datasets_cfg)
    assert c.get("a.b.c.x") == j.get("a.b.c.x") == 1 and c.get("run.nope", 5) == 5
    with pytest.raises(ValueError):
        TConfig(str(path), options=["no_equals_sign"])
    with pytest.raises(ValueError, match="missing"):
        c.validate(["run.task", "run.nope"])
