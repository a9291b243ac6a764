"""The evaluation slice's data path in the port against the JAX package's,
on the CPU: the VQA, GQA, A-OKVQA, reading-comprehension and dialogue
tasks give the same metrics and result files; the VQA, NLVR, video
(QA / retrieval / caption), AVSD dialogue and ImageNet builders the same
samples (and AVSD's collated batches); the ALPRO video processors the same
arrays from frame arrays and frame directories (seeded for training); the
GPT processors the same token streams; and the TimeSformer, ALPRO, GPT-2
and GPT-dialogue converters the same leaves, exactly, from a state dict
built here. (The copies' sources are held in tests/test_torch_copies.py.)
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

from lavis_ref import GptMockTokenizer, leaves
from llava_align_tpu.framework import datasets as jd
from llava_align_tpu.framework import processors as jp
from llava_align_tpu.framework import tasks as jt
from llava_align_tpu.framework.registry import registry as jreg
from llava_align_tpu_torch.framework import datasets as td
from llava_align_tpu_torch.framework import processors as tp
from llava_align_tpu_torch.framework import tasks as tt
from llava_align_tpu_torch.framework.registry import registry as treg


def same(got, want, where=""):
    """Exact equality of nested dicts / lists / arrays, array dtypes too."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (where, got.keys(), want.keys())
        for k in want:
            same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (where, type(got))
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, (where, got, want)


def test_eval_tables_identical():
    for name in ("_VQA_PUNCT", "_VQA_MANUAL", "_VQA_ARTICLES", "_VQA_CONTRACTIONS"):
        assert getattr(tt, name) == getattr(jt, name), name
    assert tt._VQA_PERIOD.pattern == jt._VQA_PERIOD.pattern and tt._VQA_COMMA.pattern == jt._VQA_COMMA.pattern
    assert tp.GPT_SPECIAL_TOKENS == jp.GPT_SPECIAL_TOKENS
    assert tp.GPT_SPECIAL_TOKENS_DICT == jp.GPT_SPECIAL_TOKENS_DICT
    for ans in ("Two dogs.", "it's 3,000!", "an apple, the (red) one", "None", "dont  know", "1.5 m"):
        assert tt.vqa_normalize(ans) == jt.vqa_normalize(ans)


def test_vqa_soft_accuracy_three_of_ten_is_point_nine(tmp_path):
    """The official leave-one-out rule: a prediction that 3 of 10 humans
    gave scores 0.9, not 1.0 — in both packages."""
    gts = ["dog"] * 3 + ["cat"] * 7
    rows = [{"question_id": 1, "answer": "dog", "gt_answers": gts}]
    for mod in (tt, jt):
        m = mod.VQATask(result_dir=str(tmp_path / mod.__name__)).after_evaluation([dict(r) for r in rows])
        assert m["accuracy"] == pytest.approx(90.0) and m["n"] == 1


def _answer_fn(params, sample, **kw):
    return ["dog", "two", "a cat", "yes"][int(str(sample["question_id"])[-1]) % 4]


def _rc_fn(params, sample, **kw):
    return _answer_fn(params, sample), f"caption {sample['question_id']}", np.full((2, 2), float(
        str(sample["question_id"])[-1]))


TASK_CASES = {
    "vqa": (lambda mod: mod.VQATask(generate_fn=_answer_fn), [
        {"question_id": i, "gt_answers": ["dog"] * 3 + ["two"] * 2 + ["a cat"] * 5} for i in range(5)]),
    "gqa": (lambda mod: mod.GQATask(generate_fn=_answer_fn), [
        {"question_id": f"q{i}", "answer": ["dog", "2", "cat", "no"][i % 4]} for i in range(5)]),
    "gqa_leaderboard": (lambda mod: mod.GQATask(generate_fn=_answer_fn), [
        {"question_id": f"q{i}"} for i in range(3)]),
    "aok_vqa": (lambda mod: mod.AOKVQATask(generate_fn=_answer_fn), [
        {"question_id": f"a{i}", "direct_answers": ["dog", "dog", "two", "a cat", "dog"]} for i in range(5)]),
    "vqa_rc": (lambda mod: mod.VQARCTask(predict_answers_fn=_rc_fn, num_captions=3, top_k=5), [
        {"question_id": i} for i in range(4)]),
    "gqa_rc": (lambda mod: mod.GQARCTask(predict_answers_fn=_rc_fn), [
        {"question_id": i, "answer": ["dog", "two", "cat", "yes"][i % 4]} for i in range(4)]),
    "gqa_rc_rank": (lambda mod: mod.GQARCTask(predict_answers_fn=_rc_fn, inference_method="rank"), [
        {"question_id": i, "answer": ["dog", "two", "a cat", "yes"][i % 4]} for i in range(4)]),
    "dialogue": (lambda mod: mod.DialogueTask(loss_fn=lambda p, s: 0.5 * s["question_id"]), [
        {"question_id": i} for i in range(4)]),
}


@pytest.mark.parametrize("case", sorted(TASK_CASES))
def test_eval_task_matches_jax(case, tmp_path):
    make, samples = TASK_CASES[case]
    out = {}
    for mod in (tt, jt):
        task = make(mod)
        task.result_dir = str(tmp_path / mod.__name__)
        results = task.evaluation(None, iter(samples))
        metrics = task.after_evaluation(results, split_name="val")
        files = {}
        for f in sorted(os.listdir(task.result_dir)) if os.path.isdir(task.result_dir) else []:
            path = os.path.join(task.result_dir, f)
            files[f] = dict(np.load(path)) if f.endswith(".npz") else json.load(open(path))
        out[mod] = (metrics, files)
    same(out[tt], out[jt], case)
    assert out[tt][0] != {} or case.endswith("leaderboard")


# ---------------------------------------------------------------------------
# datasets and builders
# ---------------------------------------------------------------------------


def _png(path, seed, size=(20, 16)):
    Image.fromarray(np.random.default_rng(seed).integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)).save(path)


def _dump(path, rows):
    with open(path, "w") as f:
        json.dump(rows, f)
    return str(path)


def _data_root(root):
    """Annotation files, images, frame directories, .npy videos and AVSD
    feature files under `root`."""
    for i in range(3):
        _png(root / f"img{i}.png", i)
    (root / "frames").mkdir()
    for i in range(5):
        _png(root / "frames" / f"{i:03d}.jpg", 10 + i, (24, 24))
    np.save(root / "clip.npy", np.random.default_rng(5).integers(0, 256, (6, 20, 20, 3), dtype=np.uint8))
    for sub, dim in (("i3d_rgb", 5), ("vggish", 3)):
        (root / "fts" / sub).mkdir(parents=True)
        for v, n in (("vidA", 7), ("vidB", 5)):
            np.save(root / "fts" / sub / f"{v}.npy",
                    np.random.default_rng(len(v) + n + dim).standard_normal((n + dim % 2, dim)).astype(np.float32))
    for split in ("train", "val"):
        for c in ("cat", "dog"):
            (root / "inet" / split / c).mkdir(parents=True)
            for i in range(2):
                _png(root / "inet" / split / c / f"{i}.png", 20 + i + len(c) + len(split))
    ann = {
        "vqa": _dump(root / "vqa.json", [
            {"image": "img0.png", "question": "What is it?", "answer": ["dog", "dog", "cat"], "question_id": 7},
            {"image": "img1.png", "question": "How many?", "answer": ["two"], "question_id": 8},
            {"image": "missing.png", "question": "Colour?", "answer": ["red", "blue"], "question_id": 9}]),
        "answers": _dump(root / "answers.json", ["dog", "cat", "two", "red"]),
        "nlvr": _dump(root / "nlvr.json", [
            {"images": ["img0.png", "img1.png"], "sentence": "Both show dogs.", "label": "True"},
            {"images": ["img2.png", "img0.png"], "sentence": "None do.", "label": False}]),
        "video_qa": _dump(root / "video_qa.json", [
            {"video": "frames", "question": "what moves?", "answer": "dog"},
            {"video": "clip.npy", "question": "who?", "answer": "cat", "question_id": 3},
            {"video": "absent.mp4", "question": "where?", "answer": "two"}]),
        "video_ret": _dump(root / "video_ret.json", [
            {"video": "frames", "caption": ["a dog runs", "a running dog"], "image_id": 0},
            {"video": "clip.npy", "caption": "a cat sits", "image_id": 1},
            {"video": "absent.mp4", "caption": ["two birds"], "image_id": 2}]),
        "video_cap": _dump(root / "video_cap.json", [
            {"video": "frames", "caption": "a dog runs", "image_id": "v0"},
            {"video": "clip.npy", "caption": "a cat sits", "image_id": "v1"},
            {"video": "frames", "caption": "dog again", "image_id": "v0"}]),
        "avsd": _dump(root / "avsd.json", {"dialogs": [
            {"image_id": "vidA", "caption": "a man walks", "summary": "he walks in",
             "dialog": [{"question": "who is there", "answer": "a man"},
                        {"question": "what does he do", "answer": "he walks"},
                        {"question": "is it day", "answer": "yes it is"}]},
            {"image_id": "vidB", "caption": "a dog sleeps", "summary": "it sleeps",
             "dialog": [{"question": "any sound", "answer": "no"},
                        {"question": "what animal", "answer": "a dog"}]}]}),
    }
    return ann


def _video_procs(mod, reg):
    return {"train": reg.get_processor_class("alpro_video_train")(image_size=16, n_frms=4, seed=3),
            "eval": reg.get_processor_class("alpro_video_eval")(image_size=16, n_frms=3)}


def _image_procs(mod, reg):
    p = reg.get_processor_class("blip_image_eval")(image_size=16)
    return {"train": p, "eval": p}


def _gpt_procs(mod, reg):
    tok = GptMockTokenizer()
    return ({"train": reg.get_processor_class("gpt_video_ft")(tokenizer=tok),
             "eval": reg.get_processor_class("gpt_video_ft")(tokenizer=tok)},
            {"train": reg.get_processor_class("gpt_dialogue")(max_turns=1, tokenizer=tok),
             "eval": reg.get_processor_class("gpt_dialogue")(tokenizer=tok)})


BUILDER_CASES = {
    # name: (builder, ann key, split names, processors, extra config of the eval splits)
    "vqa": ("coco_vqa", "vqa", ("train", "val"), _image_procs, {"answer_list_path": "answers"}),
    "nlvr": ("nlvr", "nlvr", ("train", "test"), _image_procs, {}),
    "video_qa": ("msrvtt_qa", "video_qa", ("train", "test"), _video_procs, {"answer_list": ["dog", "cat", "two"]}),
    "video_qa_open": ("msvd_qa", "video_qa", ("train", "test"), _video_procs, {}),
    "video_retrieval": ("msrvtt_retrieval", "video_ret", ("test",), _video_procs, {}),
    "video_caption": ("msvd_caption", "video_cap", ("train", "val"), _video_procs, {}),
    "avsd": ("avsd_dialogue", "avsd", ("train", "val"), None, {}),
    "imagenet": ("imagenet", None, ("train", "val"), _image_procs, {}),
}


@pytest.mark.parametrize("case", sorted(BUILDER_CASES))
def test_builder_samples_match_jax(case, tmp_path):
    name, key, splits, procs, extra = BUILDER_CASES[case]
    ann = _data_root(tmp_path)
    built = {}
    for mod, reg in ((td, treg), (jd, jreg)):
        if procs is None:
            vis, txt = _gpt_procs(mod, reg)
            info = {"ann_paths": [ann[key]], "vis_root": str(tmp_path / "fts")}
        else:
            vis, txt = procs(mod, reg), None
            info = ({"vis_root": str(tmp_path / "inet")} if key is None else
                    {"ann_paths": [ann[key]], "vis_root": str(tmp_path)})
        ex = {k: (ann[v] if k.endswith("_path") else v) for k, v in extra.items()}
        build_info = {s: dict(info, **({} if s == "train" else ex)) for s in splits}
        builder = reg.get_builder_class(name)(build_info=build_info, vis_processors=vis, text_processors=txt,
                                              synthetic_images=True)
        sets = builder.build()
        got = {}
        for s, ds in sets.items():
            rows = [ds[i] for i in range(len(ds))]
            got[s] = {"rows": rows, "n": len(ds)}
            for attr in ("answer_list", "text", "txt2img", "img2txt", "img_ids", "classes"):
                if hasattr(ds, attr):
                    got[s][attr] = getattr(ds, attr)
            if case == "avsd":
                got[s]["batch"] = ds.collater(rows)
        built[mod] = got
    same(built[td], built[jd], case)
    assert all(v["n"] > 0 for v in built[td].values())


def test_build_datasets_for_model_video_branch_matches_jax(tmp_path):
    """A model whose cfg has a video tower (ALPRO) gets the video eval
    processor at its size and frame count; an image model the image one."""
    ann = _data_root(tmp_path)
    video = types.SimpleNamespace(cfg=types.SimpleNamespace(video=types.SimpleNamespace(image_size=16, num_frames=2)))
    image = types.SimpleNamespace(cfg=types.SimpleNamespace(vision=types.SimpleNamespace(image_size=16)))
    cfgs = {"v": {"builder": "video_retrieval", "synthetic_images": True,
                  "build_info": {"test": {"ann_paths": [ann["video_ret"]], "vis_root": str(tmp_path)}}},
            "i": {"builder": "vqa", "text_processors": {"eval": "blip_question"},
                  "build_info": {"val": {"ann_paths": [ann["vqa"]], "vis_root": str(tmp_path)}},
                  "synthetic_images": True}}
    out = {}
    for mod, tasks in ((td, tt), (jd, jt)):
        sets = {**mod.build_datasets_for_model(tasks.BaseTask(), video, {"v": cfgs["v"]}),
                **mod.build_datasets_for_model(tasks.BaseTask(), image, {"i": cfgs["i"]})}
        out[mod] = {k: [ds[i] for i in range(len(ds))] for k, splits in sets.items() for ds in splits.values()}
    same(out[td], out[jd])
    assert out[td]["v"][0]["video"].shape == (3, 2, 16, 16)


# ---------------------------------------------------------------------------
# processors
# ---------------------------------------------------------------------------


def test_video_processors_match_jax(tmp_path):
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    for i in range(7):
        _png(frames_dir / f"{i:02d}.png", 30 + i, (26, 18))
    arr = np.random.default_rng(1).integers(0, 256, (9, 18, 22, 3), dtype=np.uint8)
    for video in (arr, str(frames_dir), arr[:2]):
        got = tp.AlproVideoEvalProcessor(image_size=12, n_frms=4)(video)
        np.testing.assert_array_equal(got, jp.AlproVideoEvalProcessor(image_size=12, n_frms=4)(video))
        assert got.shape == (3, 4, 12, 12) and got.dtype == np.float32
        for seed in (0, 1):
            got = tp.AlproVideoTrainProcessor(image_size=12, n_frms=4, seed=seed)
            want = jp.AlproVideoTrainProcessor(image_size=12, n_frms=4, seed=seed)
            for _ in range(2):  # the draws advance alike
                np.testing.assert_array_equal(got(video), want(video))


def test_video_file_needs_cv2(tmp_path, monkeypatch):
    """A video file is decoded with cv2, imported where it is read: without
    cv2 both packages raise ImportError (no fallback)."""
    path = tmp_path / "clip.mp4"
    path.write_bytes(b"\x00" * 64)
    monkeypatch.setitem(sys.modules, "cv2", None)
    for mod in (tp, jp):
        with pytest.raises(ImportError):
            mod.AlproVideoEvalProcessor(image_size=12, n_frms=2)(str(path))


def test_gpt_processors_match_jax(tmp_path):
    tok = GptMockTokenizer()
    ann = {"caption": "a man walks", "summary": "in the park", "question": "is it day", "answer": "yes it is",
           "dialog": [{"question": "who", "answer": "a man"}, {"question": "where now", "answer": "outside"}]}
    for kw in ({}, {"max_turns": 1}, {"use_caption": False}):
        same(tp.GPTDialogueProcessor(tokenizer=tok, **kw)(ann), jp.GPTDialogueProcessor(tokenizer=tok, **kw)(ann))
    seqs = [np.arange(3), np.arange(5), np.arange(1)]
    same(tp.pad_sequences(seqs, -1), jp.pad_sequences(seqs, -1))
    (tmp_path / "i3d_rgb").mkdir()
    (tmp_path / "vggish").mkdir()
    np.save(tmp_path / "i3d_rgb" / "v.npy", np.random.default_rng(0).standard_normal((6, 4)))
    np.save(tmp_path / "vggish" / "v.npy", np.random.default_rng(1).standard_normal((5, 2)))
    t, j = tp.GPTVideoFeatureProcessor(tokenizer=tok), jp.GPTVideoFeatureProcessor(tokenizer=tok)
    same(t(str(tmp_path), "v"), j(str(tmp_path), "v"))
    fts = [t(str(tmp_path), "v")["video_fts"], np.ones((2, 6), np.float32)]
    same(t.get_attention_mask(t.padding(fts)), j.get_attention_mask(j.padding(fts)))
    for cls in (tp.GPTDialogueProcessor, tp.GPTVideoFeatureProcessor):
        with pytest.raises(ValueError, match="tokenizer="):
            cls()


# ---------------------------------------------------------------------------
# converters
# ---------------------------------------------------------------------------


def _bert_sd(rng, prefix, L, D, F, V, P):
    sd = {prefix + "embeddings.word_embeddings.weight": rng.standard_normal((V, D)),
          prefix + "embeddings.position_embeddings.weight": rng.standard_normal((P, D)),
          prefix + "embeddings.token_type_embeddings.weight": rng.standard_normal((2, D)),
          prefix + "embeddings.LayerNorm.weight": rng.standard_normal(D),
          prefix + "embeddings.LayerNorm.bias": rng.standard_normal(D)}
    for i in range(L):
        b = f"{prefix}encoder.layer.{i}."
        for name, (o, n) in {"attention.self.query": (D, D), "attention.self.key": (D, D),
                             "attention.self.value": (D, D), "attention.output.dense": (D, D),
                             "intermediate.dense": (F, D), "output.dense": (D, F)}.items():
            sd[b + name + ".weight"], sd[b + name + ".bias"] = rng.standard_normal((o, n)), rng.standard_normal(o)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[b + name + ".weight"], sd[b + name + ".bias"] = rng.standard_normal(D), rng.standard_normal(D)
    return sd


def _timesformer_sd(rng, c, prefix="visual_encoder.model."):
    D, F, P = c.hidden_size, c.ffn_dim, c.patch_size
    sd = {prefix + "cls_token": rng.standard_normal((1, 1, D)),
          prefix + "pos_embed": rng.standard_normal((1, c.num_patches + 1, D)),
          prefix + "time_embed": rng.standard_normal((1, c.num_frames, D)),
          prefix + "patch_embed.proj.weight": rng.standard_normal((D, 3, P, P)),
          prefix + "patch_embed.proj.bias": rng.standard_normal(D),
          prefix + "norm.weight": rng.standard_normal(D), prefix + "norm.bias": rng.standard_normal(D)}
    for i in range(c.num_layers):
        b = f"{prefix}blocks.{i}."
        for name, (o, n) in {"temporal_attn.qkv": (3 * D, D), "temporal_attn.proj": (D, D), "temporal_fc": (D, D),
                             "attn.qkv": (3 * D, D), "attn.proj": (D, D), "mlp.fc1": (F, D),
                             "mlp.fc2": (D, F)}.items():
            sd[b + name + ".weight"], sd[b + name + ".bias"] = rng.standard_normal((o, n)), rng.standard_normal(o)
        for name in ("temporal_norm1", "norm1", "norm2"):
            sd[b + name + ".weight"], sd[b + name + ".bias"] = rng.standard_normal(D), rng.standard_normal(D)
    return sd


def _gpt_sd(rng, c, Fv):
    D, F, p = c.hidden_size, c.ffn_dim, "transformer."
    sd = {p + "wte.weight": rng.standard_normal((c.vocab_size, D)),
          p + "wpe.weight": rng.standard_normal((c.max_position_embeddings, D)),
          p + "ln_f.weight": rng.standard_normal(D), p + "ln_f.bias": rng.standard_normal(D),
          "video_ff.weight": rng.standard_normal((D, Fv)), "video_ff.bias": rng.standard_normal(D),
          "video_ff_out.weight": rng.standard_normal((Fv, D)), "video_ff_out.bias": rng.standard_normal(Fv)}
    for i in range(c.num_layers):
        b = f"{p}h.{i}."
        for name, (n, o) in {"attn.c_attn": (D, 3 * D), "attn.c_proj": (D, D), "mlp.c_fc": (D, F),
                             "mlp.c_proj": (F, D)}.items():  # Conv1D: [in, out]
            sd[b + name + ".weight"], sd[b + name + ".bias"] = rng.standard_normal((n, o)), rng.standard_normal(o)
        for name in ("ln_1", "ln_2"):
            sd[b + name + ".weight"], sd[b + name + ".bias"] = rng.standard_normal(D), rng.standard_normal(D)
    return sd


def _convert_cases():
    from llava_align_tpu.models import alpro as ja
    from llava_align_tpu.models import gpt2 as jg
    from llava_align_tpu.utils import hf_convert as jh
    from llava_align_tpu_torch.models import alpro as ta
    from llava_align_tpu_torch.models import gpt2 as tg
    from llava_align_tpu_torch.utils import hf_convert as th

    rng = np.random.default_rng(0)
    jac, tac = ja.AlproConfig.tiny(num_classes=3), ta.AlproConfig.tiny(num_classes=3)
    tx = tac.text
    alpro = {**_timesformer_sd(rng, tac.video),
             **_bert_sd(rng, "text_encoder.bert.", tx.num_layers, tx.hidden_size, tx.intermediate_size,
                        tx.vocab_size, tx.max_position_embeddings)}
    D, E = tx.hidden_size, tac.embed_dim
    heads = {"vision_proj.weight": rng.standard_normal((E, tac.video.hidden_size)), "vision_proj.bias":
             rng.standard_normal(E), "text_proj.weight": rng.standard_normal((E, D)),
             "text_proj.bias": rng.standard_normal(E), "itm_head.weight": rng.standard_normal((2, D)),
             "itm_head.bias": rng.standard_normal(2), "temp": np.array([0.05]),
             "classifier.0.weight": rng.standard_normal((2 * D, D)), "classifier.0.bias": rng.standard_normal(2 * D),
             "classifier.2.weight": rng.standard_normal((3, 2 * D)), "classifier.2.bias": rng.standard_normal(3)}
    jgc, tgc = jg.GptDialogueConfig.tiny(), tg.GptDialogueConfig.tiny()
    gpt = _gpt_sd(rng, tgc.gpt, tgc.len_video_ft)
    return {
        "timesformer": (alpro, lambda sd: jh.convert_timesformer(sd, jac.video),
                        lambda sd: th.convert_timesformer(sd, tac.video, device="cpu")),
        "alpro_retrieval": ({**alpro, **heads}, lambda sd: jh.convert_alpro(sd, jac, "retrieval"),
                            lambda sd: th.convert_alpro(sd, tac, "retrieval", device="cpu")),
        "alpro_retrieval_no_heads": (alpro, lambda sd: jh.convert_alpro(sd, jac, "retrieval"),
                                     lambda sd: th.convert_alpro(sd, tac, "retrieval", device="cpu")),
        "alpro_qa": ({**alpro, **heads}, lambda sd: jh.convert_alpro(sd, jac, "qa"),
                     lambda sd: th.convert_alpro(sd, tac, "qa", device="cpu")),
        "gpt2": (gpt, lambda sd: jh.convert_gpt2(sd, jgc.gpt), lambda sd: th.convert_gpt2(sd, tgc.gpt, device="cpu")),
        "gpt_dialogue": (gpt, lambda sd: jh.convert_gpt_dialogue(sd, jgc),
                         lambda sd: th.convert_gpt_dialogue(sd, tgc, device="cpu")),
    }


@pytest.mark.parametrize("case", ["timesformer", "alpro_retrieval", "alpro_retrieval_no_heads", "alpro_qa", "gpt2",
                                  "gpt_dialogue"])
def test_converter_matches_jax_leaf_exact(case):
    sd, jconv, tconv = _convert_cases()[case]
    sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}
    want = jconv(sd)
    got = tconv({k: torch.from_numpy(v) for k, v in sd.items()})
    import jax

    assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda x: np.zeros(()), got))
    w, g = leaves(jax.device_get(want)), leaves(got)
    assert len(w) == len(g)
    for i, (a, b) in enumerate(zip(g, w)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32, (case, i)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{case} leaf {i}")


def test_gpt_preprocess_needs_a_tokenizer():
    """The zoo's gpt family preprocess is the GPT processors, which the
    port builds only with a tokenizer."""
    from llava_align_tpu_torch.framework import model_zoo

    assert model_zoo._preprocess_family("gpt_dialogue")["text"]["eval"] == "gpt_dialogue"
    assert model_zoo._preprocess_family("alpro_qa")["vis"]["eval"] == "alpro_video_eval"
    vis, _ = model_zoo.load_preprocess({"vis_processor": {"eval": {"name": "gpt_video_ft",
                                                                   "tokenizer": GptMockTokenizer()}}})
    assert isinstance(vis["eval"], tp.GPTVideoFeatureProcessor)
    with pytest.raises(ValueError, match="tokenizer="):
        model_zoo.load_preprocess({"text_processor": {"eval": {"name": "gpt_dialogue"}}})
