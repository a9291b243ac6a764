"""The port's config CLI (llava_align_tpu_torch/runners/train.main) on the
LAVIS archs against the JAX package's CLI, on the CPU: albef_retrieval
(a retrieval YAML: 4 caption rows over 4 synthetic images, image ids
0..3), albef_classification and blip_classification (a
multimodal_classification YAML, labels 0/1) and clip (the retrieval YAML),
batch 4, 2 epochs of one step, fp32, `--options run.device=cpu` on the
port's side.

Both CLIs build each arch's tiny zoo entry on the same params: the JAX
zoo's init is swapped for the port's tree as numpy (the port's own init,
seeded), and ALBEF's queue state likewise. ALBEF's hard negatives are the
JAX CLI's draws: the port's sampler is swapped for jax.random.categorical
on the JAX CLI's key sequence (PRNGKey(2), split per step, then split for
the image and the text draw), fed the port's mining weights. The
gradients each optimizer receives are recorded (jax.debug.callback inside
the JAX step; the port's AdamW.step wrapped).

Held: the per-epoch losses within 1e-4, and the first step's gradient of
each loss (ALBEF's retrieval_train_step, the two classification_loss's,
CLIP's contrastive_loss) leaf by leaf within 1e-5 of the largest. Under
`run.amp=True` (bf16 compute on fp32 masters) the port's losses are held
within 2e-2 of the same JAX fp32 run, which runs once per arch (the JAX
CLI cannot run the ViT archs under amp: its vit_forward casts the pixels
to the config's fp32 and the patch conv then meets bf16 weights; the amp
step itself is held to JAX's retrieval_train_step in
tests/test_torch_lavis_albef_pretrain.py). The JAX runner's orbax
checkpoint is skipped (the port's is checked to exist), and the JAX CLI's
jitted step compiles with tests/lavis_ref.FAST_COMPILE (the same numbers,
a shorter compile). This file holds albef_retrieval;
tests/test_torch_lavis_train_cli_rest.py the two classification archs and
clip, each in fp32 and under amp, on the same helpers.
"""

import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import torch
import yaml

from lavis_ref import fast_jit
from llava_align_tpu.framework import optims as joptims
from llava_align_tpu.framework.runner import Runner as JRunner
from llava_align_tpu.runners import train as jtrain
from llava_align_tpu_torch.framework import optims as toptims
from llava_align_tpu_torch.framework.runner import Runner as TRunner
from llava_align_tpu_torch.runners import train as ttrain

ROWS = [("a dog on a couch", 0), ("a red bicycle", 1), ("dog again here", 0), ("bike once more", 1)]


def _write_cfg(root: str, arch: str) -> str:
    if arch in ("albef_classification", "blip_classification"):
        ann = [{"image": f"{i}.jpg", "sentence": s, "label": lab} for i, (s, lab) in enumerate(ROWS)]
        task, builder, model = "multimodal_classification", "multimodal_classification", {"num_classes": 2}
    else:
        ann = [{"image": f"{i}.jpg", "caption": s, "image_id": i} for i, (s, _) in enumerate(ROWS)]
        task, builder, model = "retrieval", "retrieval", {}
    path = os.path.join(root, "ann.json")
    with open(path, "w") as f:
        json.dump(ann, f)
    cfg = {
        "run": {"task": task, "max_epoch": 2, "batch_size_train": 4, "init_lr": 1e-3, "warmup_steps": 1,
                "log_freq": 100, "output_dir": os.path.join(root, "out")},
        "model": {"arch": arch, "model_path": None, **model},
        "datasets": {"tiny": {"builder": builder, "synthetic_images": True,
                              "build_info": {"train": {"ann_paths": [path]}}}},
    }
    cfg_path = os.path.join(root, "train.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    return cfg_path


def _epoch_losses(monkeypatch, runner_cls) -> list:
    losses = []
    orig = runner_cls.train_epoch

    def recording(self, epoch):
        stats = orig(self, epoch)
        losses.append(stats["loss"])
        return stats

    monkeypatch.setattr(runner_cls, "train_epoch", recording)
    return losses


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.numpy()


def _port_params_for_jax(monkeypatch, arch: str) -> None:
    """The JAX zoo's entry for `arch` builds the port's tiny tree (as the
    port's zoo draws it on the CPU), and ALBEF's queue is the port CLI's."""
    if arch.startswith("albef"):
        from llava_align_tpu.models import albef as jmod
        from llava_align_tpu_torch.models import albef as tmod

        def init(key, cfg, variant="retrieval"):
            tcfg = tmod.AlbefConfig.tiny(num_classes=cfg.num_classes)
            return _np_tree(tmod.init(tcfg, variant=variant, device="cpu"))

        def init_queue_state(cfg, key):
            g = torch.Generator().manual_seed(1)
            return _np_tree(tmod.init_queue_state(tmod.AlbefConfig.tiny(), g, device="cpu"))

        monkeypatch.setattr(jmod, "init", init)
        monkeypatch.setattr(jmod, "init_queue_state", init_queue_state)
    elif arch == "blip_classification":
        from llava_align_tpu.models import blip_variants as jmod
        from llava_align_tpu_torch.models import blip as tblip
        from llava_align_tpu_torch.models import blip_variants as tmod

        def init_classification(key, cfg, num_classes):
            return _np_tree(tmod.init_classification(tblip.BlipConfig.tiny(), num_classes, device="cpu"))

        monkeypatch.setattr(jmod, "init_classification", init_classification)
    else:
        from llava_align_tpu.models import clip as jmod
        from llava_align_tpu_torch.models import clip as tmod

        monkeypatch.setattr(jmod, "init", lambda key, cfg: _np_tree(tmod.init(tmod.ClipConfig.tiny(), device="cpu")))


def _jax_albef_draws(monkeypatch) -> None:
    """The port's ALBEF hard negatives become the JAX CLI's draws."""
    from llava_align_tpu.models import albef as jalbef
    from llava_align_tpu_torch.models import albef as talbef

    keys = []
    state = {"rng": jax.random.PRNGKey(2)}

    def sample(generator, weights):
        if not keys:  # a new step: the CLI's split, then retrieval_train_step's
            state["rng"], sub = jax.random.split(state["rng"])
            keys.extend(jax.random.split(sub))
        w = weights.detach().cpu().numpy()
        return torch.from_numpy(np.asarray(jalbef.sample_hard_negative_indices(keys.pop(0), w)).astype(np.int64))

    monkeypatch.setattr(talbef, "sample_hard_negative_indices", sample)


def _record_port_grads(monkeypatch) -> list:
    """Per port optimizer call, the gradient leaves in tree_leaves order."""
    grads, build = [], toptims.build_optimizer

    def recording(*a, **kw):
        tx = build(*a, **kw)
        step = tx.step

        def recording_step(params, g, state):
            grads.append([x.detach().clone().numpy() for x in g])
            return step(params, g, state)

        tx.step = recording_step
        return tx

    monkeypatch.setattr(toptims, "build_optimizer", recording)
    return grads


def jax_cli_runs(archs, root, monkeypatch) -> dict:
    """arch → the JAX CLI's fp32 run on the port's params: (its epoch
    losses, the first step's gradient leaves in tree_leaves order, sorted
    keys as the port's). The archs run in threads side by side (XLA
    compiles without the GIL), each jax.jit compiling with FAST_COMPILE;
    the JAX runner's checkpoint is skipped."""
    local = threading.local()  # the running arch's records
    build, train_epoch = joptims.build_optimizer, JRunner.train_epoch

    def recording_build(*a, **kw):
        tx, grads = build(*a, **kw), local.grads

        def update(g, state, params=None):
            jax.debug.callback(lambda g: grads.append([np.asarray(x) for x in jax.tree_util.tree_leaves(g)]), g)
            return tx.update(g, state, params)

        return tx._replace(update=update)

    def recording_epoch(self, epoch):
        stats = train_epoch(self, epoch)
        local.losses.append(stats["loss"])
        return stats

    def run(arch):
        local.grads, local.losses = [], []
        d = os.path.join(str(root), arch)
        os.makedirs(d)
        jtrain.main(["--cfg-path", _write_cfg(d, arch), "--options"])
        assert len(local.losses) == len(local.grads) == 2, arch
        return local.losses, local.grads[0]

    for arch in archs:
        _port_params_for_jax(monkeypatch, arch)
    with monkeypatch.context() as m:
        m.setattr(joptims, "build_optimizer", recording_build)
        m.setattr(JRunner, "train_epoch", recording_epoch)
        m.setattr(JRunner, "save_checkpoint", lambda self, name, epoch: None)
        with fast_jit(), ThreadPoolExecutor(len(archs)) as pool:
            return dict(zip(archs, pool.map(run, archs)))


def check_arch_matches_jax_cli(arch, tmp_path, monkeypatch, j_run, amp: bool = False):
    """The port CLI's run of `arch` (under amp where asked) against j_run,
    the JAX CLI's fp32 run (jax_cli_runs)."""
    j_losses, j_grad = j_run
    cfg_path = _write_cfg(str(tmp_path), arch)
    if arch == "albef_retrieval":
        _jax_albef_draws(monkeypatch)
    t_grads = _record_port_grads(monkeypatch)
    t_losses = _epoch_losses(monkeypatch, TRunner)
    options = ["run.amp=True"] if amp else []
    stats = ttrain.main(["--cfg-path", cfg_path, "--options", "run.device=cpu", *options,
                         "run.output_dir=" + str(tmp_path / "out_port")])
    assert len(t_losses) == 2 and np.isfinite(stats["loss"])
    np.testing.assert_allclose(t_losses, j_losses, rtol=2e-2 if amp else 1e-4)
    assert len(t_grads) == 2 and len(t_grads[0]) == len(j_grad)
    if amp:  # bf16 compute on fp32 masters: the gradients reach the optimizer in fp32
        assert all(g.dtype == np.float32 for g in t_grads[0])
        return
    scale = max(float(np.abs(g).max()) for g in j_grad)
    for i, (want, got) in enumerate(zip(j_grad, t_grads[0])):
        np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0, err_msg=f"{arch} grad leaf {i}")
    assert (tmp_path / "out_port" / "checkpoint_last" / "state.pt").is_file()


def test_lavis_arch_matches_jax_cli(tmp_path, monkeypatch):
    j_run = jax_cli_runs(["albef_retrieval"], tmp_path / "jax", monkeypatch)["albef_retrieval"]
    check_arch_matches_jax_cli("albef_retrieval", tmp_path, monkeypatch, j_run)
