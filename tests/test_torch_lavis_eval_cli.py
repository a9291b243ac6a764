"""The port's evaluation CLI (llava_align_tpu_torch/runners/evaluate.main,
`--options run.device=cpu`) against the JAX package's CLI on the CPU, on
the same trees: each zoo entry's tiny tree is the port's own init, as
numpy, swapped in for the JAX zoo's init (as
tests/test_torch_lavis_train_cli.py does).

Held, metrics line against metrics line:
- `retrieval` over 4 synthetic images x 2 captions with the re-rank of the
  top 2 (albef_retrieval, clip) and over 4 synthetic videos (the
  video_retrieval builder, alpro_retrieval): every recall exact;
- `multimodal_classification` (albef_classification, 4 rows): accuracy and
  n exact;
- `vqa` rank over a 5-answer list, 3 candidates (albef_vqa, blip_vqa):
  the answers, the VQAv2 accuracy and n exact;
- `dialogue` (gpt_dialogue on 2 AVSD dialogs, the GPT processors built on
  a mock tokenizer): the mean loss within 1e-6. The JAX CLI leaves
  DialogueTask's loss_fn unset (its run raises there), so its side is
  DialogueTask.after_evaluation over the JAX dialogue_forward of each
  sample, collated as the port's CLI collates it.
The JAX CLI runs go side by side in threads, their jits compiled with
tests/lavis_ref.FAST_COMPILE, and the towers their model functions call
(vit_forward, med_forward, med_logits, the answer losses, TimeSformer's
forward_features, CLIP's encoders) jitted whole:
the same functions, compiled once per shape instead of op by op.
"""

import functools
import json
import os
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
import yaml

from lavis_ref import GptMockTokenizer, fast_jit, jit_eager, np_tree
from llava_align_tpu.framework import datasets as jd
from llava_align_tpu.framework import processors as jp
from llava_align_tpu.framework import tasks as jt
from llava_align_tpu.framework.registry import registry as jreg
from llava_align_tpu.runners import evaluate as jeval
from llava_align_tpu_torch.framework import processors as tp
from llava_align_tpu_torch.framework.registry import registry as treg
from llava_align_tpu_torch.runners import evaluate as teval

CAPTIONS = ["a dog on a couch", "a red bicycle", "two cats asleep", "a man with a kite", "dog again here",
            "bike once more", "cats in the sun", "kite over a beach"]
ANSWERS = ["dog", "cat", "two", "red", "kite"]
CASES = {  # name: (arch, task, builder, split, extra run config)
    "albef_retrieval": ("albef_retrieval", "retrieval", "retrieval", "test", {"k_test": 2}),
    "clip": ("clip", "retrieval", "retrieval", "test", {"k_test": 2}),
    "alpro_retrieval": ("alpro_retrieval", "retrieval", "video_retrieval", "test", {"k_test": 2}),
    "albef_classification": ("albef_classification", "multimodal_classification", "multimodal_classification",
                             "test", {}),
    "albef_vqa": ("albef_vqa", "vqa", "vqa", "val", {"num_ans_candidates": 3}),
    "blip_vqa": ("blip_vqa", "vqa", "vqa", "val", {"num_ans_candidates": 3}),
    "gpt_dialogue": ("gpt_dialogue", "dialogue", "avsd_dialogue", "val", {}),
}


def _write(root, case: str) -> str:
    arch, task, builder, split, run = CASES[case]
    ann = os.path.join(root, f"{case}.json")
    info = {"ann_paths": [ann]}
    ds = {"builder": builder, "synthetic_images": True}
    model = {"arch": arch, "model_path": None}
    if builder in ("retrieval", "video_retrieval"):
        key = "video" if builder == "video_retrieval" else "image"
        rows = [{key: f"{key}{i}.jpg", "caption": CAPTIONS[2 * i: 2 * i + 2], "image_id": i} for i in range(4)]
    elif task == "multimodal_classification":
        rows = [{"image": f"{i}.jpg", "sentence": CAPTIONS[i], "label": i % 2} for i in range(4)]
        model["num_classes"] = 2
    elif task == "vqa":
        rows = [{"image": f"q{i}.jpg", "question": f"what is in picture {i}?", "question_id": i,
                 "answer": [ANSWERS[i % 5]] * 3 + [ANSWERS[(i + 1) % 5]] * 7} for i in range(4)]
        info["answer_list_path"] = os.path.join(root, "answers.json")
        run = {**run, "task_args": {"result_dir": os.path.join(root, "results")}}
        with open(info["answer_list_path"], "w") as f:
            json.dump(ANSWERS, f)
    else:
        rows = {"dialogs": [{"image_id": v, "caption": "a man walks in", "summary": "he walks",
                             "dialog": [{"question": "who is there", "answer": "a man"},
                                        {"question": q, "answer": a}]}
                            for v, q, a in (("vidA", "what does he do", "he walks"),
                                            ("vidB", "is it day", "yes it is"))]}
        info["vis_root"] = os.path.join(root, "fts")
        ds.update(vis_processors={"eval": "gpt_video_ft"}, text_processors={"eval": "gpt_dialogue"})
        rng = np.random.default_rng(0)
        for sub, dim in (("i3d_rgb", 5), ("vggish", 3)):
            os.makedirs(os.path.join(root, "fts", sub))
            for v in ("vidA", "vidB"):
                np.save(os.path.join(root, "fts", sub, f"{v}.npy"), rng.standard_normal((4, dim)).astype(np.float32))
    with open(ann, "w") as f:
        json.dump(rows, f)
    ds["build_info"] = {split: info}
    cfg = {"run": {"task": task, "split": split, **run}, "model": model, "datasets": {"tiny": ds}}
    path = os.path.join(root, f"{case}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _port_trees_for_jax(monkeypatch) -> None:
    """Each JAX zoo init builds the port's tiny tree (as the port's zoo
    draws it on the CPU, seed 0), as numpy."""
    from llava_align_tpu.models import albef as ja
    from llava_align_tpu.models import alpro as jal
    from llava_align_tpu.models import blip_variants as jbv
    from llava_align_tpu.models import clip as jc
    from llava_align_tpu.models import gpt2 as jg
    from llava_align_tpu_torch.models import albef as ta
    from llava_align_tpu_torch.models import alpro as tal
    from llava_align_tpu_torch.models import blip as tb
    from llava_align_tpu_torch.models import blip_variants as tbv
    from llava_align_tpu_torch.models import clip as tc
    from llava_align_tpu_torch.models import gpt2 as tg

    monkeypatch.setattr(ja, "init", lambda key, cfg, variant="retrieval": np_tree(ta.init(
        ta.AlbefConfig.tiny(num_classes=cfg.num_classes), variant=variant, device="cpu")))
    monkeypatch.setattr(jal, "init", lambda key, cfg, variant="retrieval": np_tree(tal.init(
        tal.AlproConfig.tiny(num_classes=cfg.num_classes), variant=variant, device="cpu")))
    monkeypatch.setattr(jc, "init", lambda key, cfg: np_tree(tc.init(tc.ClipConfig.tiny(), device="cpu")))
    monkeypatch.setattr(jbv, "init_vqa", lambda key, cfg: np_tree(tbv.init_vqa(tb.BlipConfig.tiny(), device="cpu")))
    monkeypatch.setattr(jg, "dialogue_init", lambda key, cfg: np_tree(tg.dialogue_init(
        tg.GptDialogueConfig.tiny(), device="cpu")))


def _jit_towers(monkeypatch) -> None:
    """The towers called eagerly by the JAX models' host loops, jitted
    (inside another jit they are traced as they are)."""
    from llava_align_tpu.models import albef as ja
    from llava_align_tpu.models import alpro as jal
    from llava_align_tpu.models import blip_variants as jbv
    from llava_align_tpu.models import clip as jc

    jit = jit_eager
    for mod in (ja, jbv, jal):
        monkeypatch.setattr(mod, "med_forward", jit(mod.med_forward, "causal", "mode"))
    for mod in (ja, jbv):
        monkeypatch.setattr(mod, "vit_forward", jit(mod.vit_forward))
        monkeypatch.setattr(mod, "med_logits", jit(mod.med_logits, static_argnums=()))
        monkeypatch.setattr(mod, "_lm_loss_per_sample", jit(mod._lm_loss_per_sample, static_argnums=(2,)))
    monkeypatch.setattr(jal, "forward_features", jit(jal.forward_features, "pool_frames"))
    for name in ("encode_image", "encode_text"):
        monkeypatch.setattr(jc, name, jit(getattr(jc, name)))


def _jax_dialogue_loss(monkeypatch) -> None:
    """The JAX DialogueTask's per-sample loss, as the port's CLI supplies
    it: the sample collated as a batch of one, then dialogue_forward."""
    from llava_align_tpu.models import gpt2 as jg

    tok = GptMockTokenizer()
    collate = functools.partial(jd.AVSDDialDataset.collater, types.SimpleNamespace(
        text_processor=jp.GPTDialogueProcessor(tokenizer=tok), vis_processor=jp.GPTVideoFeatureProcessor(tokenizer=tok)))
    loss = jax.jit(lambda p, b: jg.dialogue_forward(p, jg.GptDialogueConfig.tiny(), **b)["loss"])
    keys = ("input_ids", "video_fts", "attn_mask", "token_type_ids", "labels")
    monkeypatch.setattr(jt.DialogueTask, "valid_step", lambda self, params, sample: [float(loss(
        params, {k: v for k, v in collate([sample]).items() if k in keys}))])


def _gpt_processors(monkeypatch) -> None:
    """gpt_dialogue / gpt_video_ft by name, built on the mock tokenizer, in
    both registries."""
    tok = GptMockTokenizer()
    for reg, mod in ((jreg, jp), (treg, tp)):
        monkeypatch.setitem(reg._groups["processor"], "gpt_dialogue",
                            functools.partial(mod.GPTDialogueProcessor, tokenizer=tok))
        monkeypatch.setitem(reg._groups["processor"], "gpt_video_ft",
                            functools.partial(mod.GPTVideoFeatureProcessor, tokenizer=tok))


def _line(metrics) -> dict:
    return {k: (float(v) if isinstance(v, (int, float, np.floating)) else v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """case → (the port CLI's metrics line, the JAX CLI's)."""
    root = tmp_path_factory.mktemp("eval_cli")
    for case in CASES:
        (root / case).mkdir()
    paths = {case: _write(str(root / case), case) for case in CASES}
    with pytest.MonkeyPatch.context() as mp:
        _port_trees_for_jax(mp)
        _jit_towers(mp)
        _jax_dialogue_loss(mp)
        _gpt_processors(mp)
        with fast_jit(), ThreadPoolExecutor(len(CASES)) as pool:
            jax_runs = pool.map(lambda p: jeval.main(["--cfg-path", p, "--options"]), paths.values())
            port = {case: _line(teval.main(["--cfg-path", path, "--options", "run.device=cpu"]))
                    for case, path in paths.items()}
            want = {case: _line(m) for case, m in zip(paths, jax_runs)}
    return port, want


@pytest.mark.parametrize("case", list(CASES))
def test_eval_cli_line_matches_jax(case, runs):
    port, want = runs
    got, exp = port[case], want[case]
    assert got.keys() == exp.keys(), (got, exp)
    if case == "gpt_dialogue":
        assert got["n"] == exp["n"] == 2
        np.testing.assert_allclose(got["agg_metrics"], exp["agg_metrics"], rtol=1e-6, atol=0)
    else:
        assert got == exp
    if CASES[case][1] == "vqa":
        assert got["n"] == 4


def test_eval_cli_prints_one_line_per_dataset(runs, tmp_path, capsys):
    """The printed line: {dataset, split, **metrics}, as the JAX CLI's."""
    path = _write(str(tmp_path), "clip")
    capsys.readouterr()
    teval.main(["--cfg-path", path, "--options", "run.device=cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert (line.pop("dataset"), line.pop("split")) == ("tiny", "test") and line == runs[1]["clip"]
    assert torch.get_default_device().type == "cpu"
