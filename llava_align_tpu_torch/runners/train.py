"""Config-driven training entry point (the LAVIS `train.py` surface; torch
twin of llava_align_tpu/runners/train.py).

    python -m llava_align_tpu_torch.runners.train --cfg-path train.yaml \
        [--options run.device=cpu run.max_epoch=2 ...]

LAVIS drives training from a YAML config through its registries — task,
model arch, dataset builders, runner (lavis/runners/runner_base.py
RunnerBase.train). This CLI assembles the same loop on framework/: builds
the task/model/datasets from the config, constructs the family's train
step, and hands it to framework.runner.Runner (epoch loop, best-checkpoint
save, resume).

Arches (the families with functional training losses, as in the JAX CLI):
  * albef_retrieval: ITC (momentum queues + distillation) + ITM with hard
    negatives; the momentum tree, the queue state and the negatives'
    generator state ride in the runner's opt_state slot ({"opt",
    "m_params", "queue", "rng"}), keeping Runner's (params, opt_state,
    batch) contract and its checkpoints;
  * albef_classification / blip_classification: fused-cls cross-entropy;
  * clip: the symmetric InfoNCE;
  * llava: the multimodal next-token LM over spliced image + caption
    sequences (train/trainer.py multimodal_lm_loss).

The device is run.device (the GPU when unset). Text tokenization: pass
`run.tokenizer_path` (a local BERT vocab file, needs transformers) for
real checkpoints; without it the deterministic crc32 mock is used (offline
smoke). Batches are reshuffled every epoch with a seeded permutation.
run.resume_ckpt_path resumes from a checkpoint_<name> directory (LAVIS's
run-config key).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import Dict, Iterable

import numpy as np
import torch

from llava_align_tpu_torch.runners.common import resolve_tokenizer



def _batches(dataset, batch_size: int, *, tokenize, epoch: int = 0,
             drop_last: bool = True):
    """Seeded per-epoch shuffle (contrastive losses need fresh in-batch
    negative sets each epoch); a trailing partial batch is dropped only when
    at least one full batch was produced — a dataset smaller than
    batch_size still yields its single partial batch."""
    rng = np.random.default_rng(epoch)
    idx = rng.permutation(len(dataset))
    yielded = False
    for lo in range(0, len(idx), batch_size):
        rows = [dataset[int(i)] for i in idx[lo : lo + batch_size]]
        if drop_last and len(rows) < batch_size and yielded:
            return
        batch = dataset.collater(rows)
        if "text_input" in batch:
            ids, mask = tokenize(batch["text_input"])
            batch["text_ids"], batch["text_mask"] = ids, mask
        yielded = True
        yield batch


def _tensors(batch, device, keys):
    """The collated batch's `keys` as tensors on `device` (ids and labels
    as numpy arrays first, as the JAX prep's jnp.asarray reads them)."""
    return {k: torch.from_numpy(np.asarray(batch[k])).to(device) for k in keys}


def _make_train_step(arch: str, model, tx, amp: bool = False, device=None):
    """(step, init_state, prep) for `arch`: step(params, opt_state, batch)
    updates in place and returns (params, opt_state, loss); init_state
    makes the optimizer state; prep turns a collated caption batch into the
    step's tensors on `device`. amp=True runs forward/backward in bfloat16
    with fp32 master weights (framework.optims.amp_cast, the reference's
    `amp: True` run knob)."""
    from llava_align_tpu_torch.framework.optims import amp_cast
    from llava_align_tpu_torch.train.trainer import compute_config, grad_step

    cast = amp_cast if amp else (lambda p: p)
    cfg = model.cfg
    # the LAVIS archs compute in bf16 under amp, pixels included (torch does
    # not promote a bf16 x fp32 product as JAX does)
    compute_cfg = compute_config(cfg, torch.bfloat16) if amp else cfg

    if arch == "albef_retrieval":
        from llava_align_tpu_torch.framework.optims import tree_leaves, tree_map
        from llava_align_tpu_torch.models import albef

        momentum = 0.995

        def init_state(params):
            dev = tree_leaves(params)[0].device
            queue = albef.init_queue_state(cfg, torch.Generator(device=dev).manual_seed(1), device=dev)
            return {"opt": tx.init(params), "m_params": tree_map(lambda _, x: x.detach().clone(), params),
                    "queue": queue, "rng": torch.Generator(device=dev).manual_seed(2).get_state()}

        def albef_step(params, ext, batch):
            gen = torch.Generator(device=batch["image"].device)
            gen.set_state(ext["rng"])
            m_params, out = ext["m_params"], {}
            # Under amp the EMA runs on the fp32 masters here (torch AMP:
            # autocast covers compute, not the parameter EMA) and the loss
            # takes its bf16 cast with an inner momentum of 1.0, so that the
            # loss sees the updated tree unchanged; without amp the update is
            # the step's own (the same math either way).
            if amp:
                albef.momentum_update(params, m_params, momentum)

            def loss_of(p, b):
                losses, _, out["queue"] = albef.retrieval_train_step(
                    cast(p), cast(m_params) if amp else m_params, ext["queue"], compute_cfg, gen,
                    b["image"].to(compute_cfg.vision.dtype), b["text_ids"], b["text_mask"], b["image_id"],
                    momentum=1.0 if amp else momentum)
                return losses["loss"]

            params, _, loss = grad_step(loss_of, tx)(params, ext["opt"], batch)
            return params, dict(ext, queue=out["queue"], rng=gen.get_state()), loss

        def prep(batch):
            return _tensors(batch, device, ("image", "text_ids", "text_mask", "image_id"))

        return albef_step, init_state, prep

    if arch in ("albef_classification", "blip_classification"):
        if arch == "albef_classification":
            from llava_align_tpu_torch.models.albef import classification_loss as loss_mod
        else:
            from llava_align_tpu_torch.models.blip_variants import classification_loss as loss_mod

        def loss_of(params, batch):
            pixels = batch["image"].to(compute_cfg.vision.dtype)
            return loss_mod(cast(params), compute_cfg, pixels, batch["text_ids"], batch["text_mask"],
                            batch["label"])[0]

        def prep(batch):
            return _tensors(batch, device, ("image", "text_ids", "text_mask", "label"))

        return grad_step(loss_of, tx), tx.init, prep

    if arch == "clip":
        from llava_align_tpu_torch.models import clip as clip_mod

        def loss_of(params, batch):
            pixels = batch["image"].to(compute_cfg.vision.dtype)
            return clip_mod.contrastive_loss(cast(params), compute_cfg, pixels, batch["text_ids"])["loss"]

        def prep(batch):
            return _tensors(batch, device, ("image", "text_ids"))

        return grad_step(loss_of, tx), tx.init, prep

    if arch == "llava":
        from llava_align_tpu_torch.constants import IMAGE_TOKEN_INDEX
        from llava_align_tpu_torch.train import trainer

        step = trainer.make_train_step(cfg, tx, amp=amp)

        def init_state(params):
            return tx.init(params)

        def prep(batch):
            # caption rows → "<image> caption" LM sequences
            # (reference llava pretraining objective; llava_arch.py splice)
            samples = []
            for ids_row, img in zip(batch["text_ids"], batch["image"]):
                toks = [int(t) for t in np.asarray(ids_row).tolist() if t != 0]
                samples.append({
                    "input_ids": np.asarray(
                        [IMAGE_TOKEN_INDEX] + toks, np.int32
                    ),
                    "images": np.asarray(img),
                })
            max_txt = max(len(s["input_ids"]) for s in samples)
            # bucket to multiples of 16, as the JAX package does to keep its
            # compiled step count small: the same padding, so the same loss
            pad_to = cfg.num_image_tokens + ((max_txt + 15) // 16) * 16
            return trainer.batch_to_device(trainer.build_train_batch(cfg, samples, pad_to), device)

        return step, init_state, prep

    raise ValueError(
        f"no config-driven train step for arch {arch!r}; supported: "
        "albef_retrieval, albef_classification, blip_classification, clip, "
        "llava"
    )


def main(argv=None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cfg-path", required=True)
    ap.add_argument("--options", nargs="*", default=[])
    args = ap.parse_args(argv)

    import llava_align_tpu_torch  # noqa: F401
    from llava_align_tpu_torch.framework.config import Config
    from llava_align_tpu_torch.framework.registry import registry
    from llava_align_tpu_torch.framework.runner import Runner, RunnerConfig
    from llava_align_tpu_torch.utils.synthetic import resolve_device

    cfg = Config(args.cfg_path, options=args.options)
    run_cfg = cfg.run_cfg
    arch = cfg.model_cfg.get("arch")
    device = resolve_device(run_cfg.get("device"))
    task_cls = registry.get_task_class(run_cfg.get("task", "base"))
    task = task_cls.setup_task(run_cfg)
    model = task.build_model({"device": device, **cfg.model_cfg})

    from llava_align_tpu_torch.framework.datasets import build_datasets_for_model

    datasets = build_datasets_for_model(task, model, cfg.datasets_cfg)
    train_sets = [
        splits["train"] for splits in datasets.values() if "train" in splits
    ]
    if not train_sets:
        raise KeyError("no configured dataset has a 'train' split")

    lr = float(run_cfg.get("init_lr", 1e-4))
    batch_size = int(run_cfg.get("batch_size_train", 4))
    max_epoch = int(run_cfg.get("max_epoch", 1))
    iters_per_epoch = max(1, sum(len(ds) for ds in train_sets) // max(batch_size, 1))
    # reference optimizer assembly (runner_base.py:96-112 + base_model
    # get_optimizer_params): AdamW with the bias/norm no-decay split, lr
    # schedule by registered name with the run-config knob names
    from llava_align_tpu_torch.framework.optims import build_optimizer

    tx = build_optimizer(
        lr_sched=run_cfg.get("lr_sched", "linear_warmup_cosine_lr"),
        weight_decay=float(run_cfg.get("weight_decay", 0.05)),
        beta2=float(run_cfg.get("beta2", 0.999)),
        max_grad_norm=float(run_cfg.get("max_grad_norm", 1.0)),
        init_lr=lr,
        min_lr=float(run_cfg.get("min_lr", 0.0)),
        warmup_steps=int(run_cfg.get("warmup_steps", 0)),
        warmup_start_lr=float(run_cfg.get("warmup_lr", -1.0)),
        max_steps=iters_per_epoch * max_epoch,
        steps_per_epoch=iters_per_epoch,
        decay_rate=float(run_cfg.get("lr_decay_rate", 1.0)),
        accum_grad_iters=int(run_cfg.get("accum_grad_iters", 1)),
    )
    amp = bool(run_cfg.get("amp", False))
    step, init_state, prep = _make_train_step(arch, model, tx, amp=amp, device=device)

    vocab = getattr(getattr(model.cfg, "text", None), "vocab_size", 64) or 64
    tokenize = resolve_tokenizer(run_cfg, vocab)

    def loader_fn(epoch: int) -> Iterable:
        import itertools

        return (
            prep(b)
            for b in itertools.chain.from_iterable(
                _batches(ds, batch_size, tokenize=tokenize, epoch=epoch)
                for ds in train_sets
            )
        )

    runner = Runner(
        RunnerConfig(
            max_epoch=max_epoch,
            output_dir=run_cfg.get("output_dir", "output/train"),
            log_freq=int(run_cfg.get("log_freq", 10)),
            resume_ckpt_path=run_cfg.get("resume_ckpt_path"),
        ),
        train_step=step,
        params=model.params,
        opt_state=init_state(model.params),
        train_loader_fn=loader_fn,
    )
    stats = runner.train()
    print(json.dumps({k: float(v) for k, v in stats.items()}))
    return stats


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    main()
