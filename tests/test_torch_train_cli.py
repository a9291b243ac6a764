"""The port's config CLI (llava_align_tpu_torch/runners/train.main) against
the JAX package's, on the CPU: the same captioning YAML (a coco_caption
train split of 6 rows over 3 synthetic images, batch 2, 2 epochs, the
registered linear_warmup_cosine_lr with a warm-up step, clip and the
decay mask), `--options run.device=cpu` on the port's side.

- on `model: {arch: llava, size: tiny}`, both zoos' LlavaModel on the JAX
  zoo's tiny params (carried into the port by swapping where its
  LlavaModel draws random params, as tests/test_torch_sampling.py swaps
  sample_token): fp32 per-epoch losses within 1e-4;
- on a tiny HF checkpoint (tests/ckpt_fixture.build_tiny_llava_checkpoint),
  which both zoos load in bf16: per-epoch losses within 2e-2;
- a resume from checkpoint_last (run.resume_ckpt_path) trains the third
  epoch to the loss an uninterrupted 3-epoch run has there, exactly;
- a zoo arch without a train step is refused, as the JAX CLI refuses it;
  the copied pieces the CLI reaches (the caption dataset, its processor,
  _batches) give the JAX package's batches;
- utils/checkpoint_io round-trips a tree and its sidecar, and each zoo
  entry builds its tiny tree and an engine.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from ckpt_fixture import VD, VF, build_tiny_llava_checkpoint, small_vision_config
from llava_align_tpu.config import LlavaConfig as JLlavaConfig
from llava_align_tpu.framework.runner import Runner as JRunner
from llava_align_tpu.runners import train as jtrain
from llava_align_tpu_torch.config import ClipVisionConfig as TClip
from llava_align_tpu_torch.framework.optims import tree_leaves
from llava_align_tpu_torch.framework.runner import Runner as TRunner
from llava_align_tpu_torch.runners import train as ttrain
from llava_align_tpu_torch.utils import hf_convert as thf
from llava_align_tpu_torch.utils import synthetic as tsynthetic
from llava_align_tpu_torch.utils.jax_params import from_jax_params

CAPTIONS = ["a dog on a mat", "two cats sleeping", "a red car parked outside",
            "people walking in a park", "a bowl of fruit", "an old brick house"]


def _write_cfg(root, model: dict, **run) -> str:
    ann = os.path.join(root, "ann.json")
    with open(ann, "w") as f:
        json.dump([{"image": f"img_{i % 3}.jpg", "caption": c, "image_id": i % 3}
                   for i, c in enumerate(CAPTIONS)], f)
    cfg = {
        "model": {"arch": "llava", **model},
        "datasets": {"coco_caption": {"build_info": {"train": {"ann_paths": [ann], "vis_root": root}},
                                      "synthetic_images": True}},
        "run": {"task": "captioning", "batch_size_train": 2, "max_epoch": 2, "init_lr": 1e-3,
                "min_lr": 1e-5, "warmup_steps": 1, "log_freq": 100,
                "output_dir": os.path.join(root, "out"), **run},
    }
    path = os.path.join(root, "train.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _epoch_losses(monkeypatch, runner_cls) -> list:
    losses = []
    orig = runner_cls.train_epoch

    def recording(self, epoch):
        stats = orig(self, epoch)
        losses.append(stats["loss"])
        return stats

    monkeypatch.setattr(runner_cls, "train_epoch", recording)
    return losses


@pytest.fixture(scope="module")
def jax_tiny_init():
    """The JAX zoo's tiny LLaVA params (llava.init at PRNGKey(0)), drawn
    once: a wrapper of llava.init hands them back when the JAX zoo asks
    again, and jax_tiny_params gives them to the port's zoo."""
    from llava_align_tpu.models import llava

    orig = llava.init
    params = orig(jax.random.PRNGKey(0), JLlavaConfig.tiny())

    def init(key, cfg):
        if cfg == JLlavaConfig.tiny() and bool((key == jax.random.PRNGKey(0)).all()):
            return params
        return orig(key, cfg)

    return llava, init, jax.device_get(params)


@pytest.fixture
def jax_tiny_params(jax_tiny_init, monkeypatch):
    llava, init, params = jax_tiny_init
    monkeypatch.setattr(llava, "init", init)
    monkeypatch.setattr(tsynthetic, "build_random_llava_params",
                        lambda cfg, device=None, **kw: from_jax_params(params, device=device))
    return params


def _run_both(monkeypatch, cfg_path, *options):
    j_losses = _epoch_losses(monkeypatch, JRunner)
    jtrain.main(["--cfg-path", cfg_path, "--options", *options])
    t_losses = _epoch_losses(monkeypatch, TRunner)
    ttrain.main(["--cfg-path", cfg_path, "--options", "run.device=cpu",
                 "run.output_dir=" + os.path.join(os.path.dirname(cfg_path), "out_port"), *options])
    return j_losses, t_losses


def test_main_tiny_matches_jax(tmp_path, monkeypatch, jax_tiny_params):
    j_losses, t_losses = _run_both(monkeypatch, _write_cfg(str(tmp_path), {"size": "tiny"}))
    assert len(j_losses) == len(t_losses) == 2
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    assert (tmp_path / "out_port" / "checkpoint_last" / "state.pt").is_file()


def test_main_checkpoint_matches_jax(tmp_path, monkeypatch):
    ckpt = str(tmp_path / "ckpt")
    build_tiny_llava_checkpoint(ckpt, vision_layers=2, image_size=28)
    orig = thf.config_from_hf

    def small_cfg(hf, dtype=torch.bfloat16):
        cfg = orig(hf, dtype)
        vision = TClip(image_size=28, patch_size=14, hidden_size=VD, intermediate_size=VF, num_layers=2,
                       num_heads=4, select_layer=cfg.vision.select_layer,
                       select_feature=cfg.vision.select_feature, dtype=dtype)
        return dataclasses.replace(cfg, vision=vision)

    monkeypatch.setattr(thf, "config_from_hf", small_cfg)
    with small_vision_config(vision_layers=2, image_size=28):
        j_losses, t_losses = _run_both(monkeypatch, _write_cfg(str(tmp_path), {"model_path": ckpt}))
    assert len(j_losses) == len(t_losses) == 2 and np.all(np.isfinite(t_losses))
    np.testing.assert_allclose(t_losses, j_losses, rtol=2e-2)


def test_resume_continues_the_run(tmp_path, monkeypatch, jax_tiny_params):
    """2 epochs, then a resume from checkpoint_last to max_epoch 3, give the
    per-epoch losses of one 3-epoch run exactly (constant_lr: the schedule
    does not depend on max_epoch)."""
    cfg_path = _write_cfg(str(tmp_path), {"size": "tiny"}, lr_sched="constant_lr")
    losses = _epoch_losses(monkeypatch, TRunner)

    def main(out, epochs, *extra):
        ttrain.main(["--cfg-path", cfg_path, "--options", "run.device=cpu", f"run.max_epoch={epochs}",
                     "run.output_dir=" + str(tmp_path / out), *extra])

    main("whole", 3)
    main("two", 2)
    main("two", 3, "run.resume_ckpt_path=" + str(tmp_path / "two" / "checkpoint_last"))
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert losses[3:] == losses[:3]
    state = torch.load(tmp_path / "two" / "checkpoint_last" / "state.pt", weights_only=True)
    assert state["epoch"] == 2 and state["iters"] == 9 and state["opt_state"]["count"] == 9


@pytest.mark.parametrize("arch", ["albef_pretrain", "albef_vqa", "blip_retrieval", "clip_feature_extractor"])
def test_unported_arch_is_refused(arch, tmp_path):
    """A zoo arch without a config-driven train step (none in the JAX CLI
    either) is refused after the model is built, with the JAX CLI's
    ValueError; the LAVIS archs the JAX CLI trains are held in
    tests/test_torch_lavis_train_cli.py."""
    with pytest.raises(ValueError) as want:
        jtrain._make_train_step(arch, None, None)
    cfg_path = _write_cfg(str(tmp_path), {"arch": arch})
    with pytest.raises(ValueError) as got:
        ttrain.main(["--cfg-path", cfg_path, "--options", "run.device=cpu"])
    assert str(got.value) == str(want.value)


def test_caption_batches_match_jax(tmp_path):
    """The port's dataset, processor, _batches and prep give the JAX
    package's batch, array for array."""
    from llava_align_tpu.framework.datasets import build_datasets_for_model as jbuild
    from llava_align_tpu.framework.registry import registry as jreg
    from llava_align_tpu.runners.common import mock_tokenize as jtok
    from llava_align_tpu_torch.config import LlavaConfig
    from llava_align_tpu_torch.framework.datasets import build_datasets_for_model as tbuild
    from llava_align_tpu_torch.framework.registry import registry as treg
    from llava_align_tpu_torch.runners.common import mock_tokenize as ttok

    cfg = yaml.safe_load(open(_write_cfg(str(tmp_path), {"size": "tiny"})))

    class Model:  # what build_datasets_for_model reads of a model
        cfg = LlavaConfig.tiny()

    jsets = jbuild(jreg.get_task_class("captioning")(), Model, cfg["datasets"])
    tsets = tbuild(treg.get_task_class("captioning")(), Model, cfg["datasets"])
    for epoch in (0, 1):
        jb = list(jtrain._batches(jsets["coco_caption"]["train"], 4, tokenize=jtok, epoch=epoch))
        tb = list(ttrain._batches(tsets["coco_caption"]["train"], 4, tokenize=ttok, epoch=epoch))
        assert len(jb) == len(tb) == 1  # 6 rows at batch 4: the trailing partial batch is dropped
        for k in jb[0]:
            np.testing.assert_array_equal(np.asarray(tb[0][k]), np.asarray(jb[0][k]), err_msg=k)
    class JModel:
        cfg = JLlavaConfig.tiny()

    _, _, jprep = jtrain._make_train_step("llava", JModel, None)
    _, _, tprep = ttrain._make_train_step("llava", Model, None, device="cpu")
    want, got = jprep(jb[0]), tprep(tb[0])
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_checkpoint_io_roundtrip(tmp_path):
    """utils/checkpoint_io: params and the .meta.json sidecar at the JAX
    module's paths; load onto a target's dtypes, and without one as saved."""
    from llava_align_tpu_torch.utils.checkpoint_io import load_params, save_params

    params = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3), "b": [torch.ones(2, dtype=torch.bfloat16)]}
    path = save_params(str(tmp_path / "sub" / "params"), params, meta={"step": 3})
    assert os.path.isfile(path) and os.path.isfile(path + ".meta.json")
    got, meta = load_params(path)
    assert meta == {"step": 3} and torch.equal(got["a"], params["a"]) and torch.equal(got["b"][0], params["b"][0])
    target = {"a": torch.zeros(2, 3, dtype=torch.bfloat16), "b": [torch.zeros(2, dtype=torch.float32)]}
    got, _ = load_params(path, target=target)
    assert got["a"].dtype == torch.bfloat16 and got["b"][0].dtype == torch.float32
    assert load_params(save_params(str(tmp_path / "p2"), params))[1] is None


@pytest.mark.parametrize("arch", ["llava", "llava_mpt", "qwen_vl", "blip2_vicuna_instruct"])
def test_zoo_entries_build_and_make_engines(arch):
    """Each registered zoo entry builds its tiny random tree on the named
    device and hands it to a DecodeEngine with its family's adapter."""
    from llava_align_tpu_torch.config import GenerationConfig
    from llava_align_tpu_torch.decoding.engine import DecodeEngine
    from llava_align_tpu_torch.framework.registry import registry

    model = registry.get_task_class("base")().build_model({"arch": arch, "device": "cpu"})
    assert model.arch == arch and all(x.device.type == "cpu" for x in tree_leaves(model.params))
    assert isinstance(model.make_engine(GenerationConfig(max_new_tokens=2)), DecodeEngine)
