"""Training loop core (torch twin of llava_align_tpu/train/trainer.py; a
capability mirror of the vendored LAVIS trainer: RunnerBase.train
runner_base.py:348-411, BaseTask._train_inner_loop base_task.py:158-251).

Functional core: `multimodal_lm_loss` (next-token CE with IGNORE_INDEX over
spliced multimodal sequences) + `make_train_step` (autograd, then the
optimizer of framework/optims.AdamW in place on the param tree).
`build_train_batch` is a copy of the JAX package's (numpy, on the host).

Under autograd no CUDA kernel of the port is reached: the causal prefill
takes `mha` (causal_attention's 'auto' rule under grad, as the JAX package
takes mha_xla off the TPU), and a float tree sends every linear to
torch.matmul. The kernels have no backward and raise if handed a tensor
that needs one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from llava_align_tpu_torch.config import LlavaConfig
from llava_align_tpu_torch.constants import IGNORE_INDEX
from llava_align_tpu_torch.framework.optims import (
    AdamW,
    amp_cast,
    tree_leaves,
    warmup_cosine_decay_schedule,
)
from llava_align_tpu_torch.models import llama, llava

Params = Dict[str, Any]


@dataclasses.dataclass
class TrainState:
    params: Params
    opt_state: Any
    step: int = 0


def make_optimizer(
    lr: float = 1e-5,
    *,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    min_lr: float = 0.0,
    weight_decay: float = 0.05,
    beta2: float = 0.999,
    schedule: str = "warmup_cosine",
    max_grad_norm: Optional[float] = 1.0,
    accum_steps: int = 1,
) -> AdamW:
    """AdamW + warmup-cosine (LAVIS LinearWarmupCosineLRScheduler
    capability): the JAX package's optax chain (warmup_cosine_decay_schedule
    from 0 to lr, clip_by_global_norm, adamw decaying every leaf,
    MultiSteps when accum_steps > 1) as framework.optims.AdamW."""
    if schedule == "warmup_cosine":
        sched = warmup_cosine_decay_schedule(
            init_value=0.0,
            peak_value=lr,
            warmup_steps=warmup_steps,
            decay_steps=max(total_steps, warmup_steps + 1),
            end_value=min_lr,
        )
    elif schedule == "constant":
        sched = lr
    else:
        raise ValueError(schedule)
    return AdamW(sched, b2=beta2, weight_decay=weight_decay,
                 max_grad_norm=max_grad_norm or None, accum_steps=accum_steps)


def multimodal_lm_loss(
    params: Params,
    cfg: LlavaConfig,
    batch: Dict[str, torch.Tensor],
    *,
    attn_impl: str = "auto",
    tp_mesh=None,
) -> torch.Tensor:
    """Next-token cross entropy over spliced multimodal sequences (a 0-d fp32
    tensor).

    batch keys (all [B, ...] tensors on the params' device, built with
    build_train_batch on the host):
        tokens      [B, S] sentinel-free token ids
        tok_gather  [B, S], img_gather [B, S], is_image [B, S]
        labels      [B, S] target ids, IGNORE_INDEX at image/pad positions
        images      [B, 3, H, W]
    tp_mesh: a mesh whose 'model' axis the tree is sharded over
    (parallel/sharding.llava_param_shardings); the collectives carry the
    gradients (parallel/comm), and the loss is whole on every rank.
    """
    nll, count = lm_loss_parts(params, cfg, batch, attn_impl=attn_impl, tp_mesh=tp_mesh)
    return nll / count.clamp(min=1)


def lm_loss_parts(params: Params, cfg: LlavaConfig, batch: Dict[str, torch.Tensor], *,
                  attn_impl: str = "auto", tp_mesh=None):
    """(the summed next-token nll, the number of target tokens) of the
    batch: multimodal_lm_loss is their quotient; a data-parallel step
    divides its chunk's sum by the whole batch's count."""
    group = None
    if tp_mesh is not None:
        from llava_align_tpu_torch.parallel.mesh import axis_group, axis_size

        group = axis_group(tp_mesh, "model") if axis_size(tp_mesh, "model") > 1 else None
    feats = llava.encode_images(params, cfg, batch["images"], tp_mesh)
    embeds = llava.splice_embeds(
        params, cfg,
        batch["tokens"], batch["tok_gather"], batch["img_gather"],
        batch["is_image"], feats, group,
    )
    B, S, _ = embeds.shape
    positions = torch.arange(S, device=embeds.device).expand(B, S)
    hidden, _ = llama.forward(params["llama"], cfg.text, embeds, positions, attn_impl=attn_impl,
                              tp_mesh=tp_mesh)
    logits = llama.logits_from_hidden(params["llama"], hidden, group, cfg.text.vocab_size)  # [B, S, V] fp32

    shift_logits = logits[:, :-1]
    shift_labels = batch["labels"][:, 1:].long()
    valid = shift_labels != IGNORE_INDEX
    safe_labels = torch.where(valid, shift_labels, 0)
    logp = torch.log_softmax(shift_logits, dim=-1)
    nll = -torch.gather(logp, -1, safe_labels[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum(), valid.sum()


def compute_config(cfg: LlavaConfig, dtype: torch.dtype) -> LlavaConfig:
    """cfg with its text and vision towers computing in `dtype`."""
    return dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, dtype=dtype),
        vision=dataclasses.replace(cfg.vision, dtype=dtype),
    )


def trainable_leaves(params: Params) -> list:
    """The tree's leaves in tree_leaves order, each set to require grad
    (float leaves only: a quantized tree does not train)."""
    leaves = tree_leaves(params)
    for x in leaves:
        if not x.is_floating_point():
            raise TypeError(f"training takes a float tree, got a {x.dtype} leaf")
        if not x.requires_grad:
            x.requires_grad_(True)
    return leaves


def make_train_step(
    cfg: LlavaConfig,
    optimizer: AdamW,
    *,
    attn_impl: str = "auto",
    amp: bool = False,
    mesh=None,
) -> Callable:
    """Returns step(params, opt_state, batch) -> (params, opt_state, loss).

    The step differentiates multimodal_lm_loss with torch.autograd.grad,
    then optimizer.step updates the param leaves and opt_state IN PLACE
    (the same objects come back) and the gradients are freed; loss is a
    detached 0-d tensor. Leaves the loss does not reach get zero gradients,
    as under jax.grad. amp=True is the JAX package's amp: inside the loss,
    framework.optims.amp_cast casts the fp32 leaves to bf16 and the model
    computes in bf16 (torch does not promote a bf16 x fp32 matmul as JAX
    does), while the optimizer updates the fp32 masters with the fp32
    gradients that come back through the cast.

    mesh: a ('data', 'model') mesh, one process per rank, as the JAX
    package's GSPMD step runs over one (trainer.py:126-140). params are then
    this rank's shards (parallel/sharding.shard_params with
    train_shardings(cfg, params, model size)), and batch the whole batch on
    every rank: the step
    takes its 'data' chunk of the rows, divides its summed nll by the whole
    batch's target count, and sums the gradients over 'data' (the mean of
    the whole batch, as one device computes it). Split leaves keep their
    shard's gradient; the optimizer's global norm counts each split leaf's
    squared norm summed over 'model' once and each replicated leaf once
    (AdamW.norm_sync, set here on `optimizer`). The loss, gradients and
    stepped params are the unsharded step's."""
    loss_cfg = compute_config(cfg, torch.bfloat16) if amp else cfg
    cast = amp_cast if amp else (lambda p: p)
    data = model = 1
    if mesh is not None:
        from llava_align_tpu_torch.parallel import comm
        from llava_align_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size

        data, model = axis_size(mesh, "data"), axis_size(mesh, "model")
        data_group = axis_group(mesh, "data") if data > 1 else None

    def step(params, opt_state, batch):
        leaves = trainable_leaves(params)
        if model > 1 and optimizer.norm_sync is None:
            optimizer.norm_sync = _norm_sync(train_shardings(cfg, params, model), mesh, leaves[0].device)
        if data > 1:
            B = next(iter(batch.values())).shape[0]
            size = -(-B // data)
            lo = min(axis_rank(mesh, "data") * size, B)
            batch = {k: v[lo : lo + size] for k, v in batch.items()}
        with torch.enable_grad():
            nll, count = lm_loss_parts(cast(params), loss_cfg, batch, attn_impl=attn_impl, tp_mesh=mesh)
            if data > 1:
                count = comm.all_reduce_(count.clone(), data_group)
            loss = nll / count.clamp(min=1)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
        loss = loss.detach()
        if data > 1:
            for g in grads:
                comm.all_reduce_(g, data_group)
            loss = comm.all_reduce_(loss.clone(), data_group)
        optimizer.step(params, grads, opt_state)
        del grads
        return params, opt_state, loss

    return step


def train_shardings(cfg: LlavaConfig, params: Params, model: int = 1) -> Params:
    """The spec tree of a training tree (float LLaVA) over a 'model' axis
    of size `model`: parallel/sharding's llava_param_shardings completed
    over the tree."""
    from llava_align_tpu_torch.parallel.sharding import complete_shardings, llava_param_shardings

    return complete_shardings(params, llava_param_shardings(cfg, params, model))


def _norm_sync(specs: Params, mesh, device) -> Callable:
    """AdamW.norm_sync for a tree sharded by `specs` over 'model': the
    split leaves' squared norms summed over the group, the replicated ones
    (equal on every rank) kept once."""
    from llava_align_tpu_torch.parallel import comm
    from llava_align_tpu_torch.parallel.mesh import axis_group
    from llava_align_tpu_torch.parallel.sharding import split_leaves

    group = axis_group(mesh, "model")
    mask = torch.tensor(split_leaves(specs), device=device)

    def sync(sq: torch.Tensor) -> torch.Tensor:
        part = comm.all_reduce_(torch.where(mask, sq, torch.zeros_like(sq)), group)
        return torch.where(mask, part, sq)

    return sync


def build_train_batch(
    cfg: LlavaConfig,
    samples,
    pad_to: int,
):
    """Host-side collation: list of (input_ids_with_sentinel, target_mask_fn?)
    → batch dict. `samples` is a list of dicts {input_ids, images} where
    labels default to the input ids (standard LM objective) with IGNORE at
    image and pad positions."""
    import numpy as np

    B = len(samples)
    S = pad_to
    tokens = np.zeros((B, S), np.int32)
    tok_g = np.zeros((B, S), np.int32)
    img_g = np.zeros((B, S), np.int32)
    is_img = np.zeros((B, S), bool)
    labels = np.full((B, S), IGNORE_INDEX, np.int32)
    images = np.stack([s["images"] for s in samples])
    for b, s in enumerate(samples):
        plan = llava.plan_splice(s["input_ids"], cfg.num_image_tokens, pad_to)
        tokens[b, : len(plan.tokens)] = plan.tokens
        tok_g[b] = plan.tok_gather
        img_g[b] = plan.img_gather
        is_img[b] = plan.is_image
        lab = np.where(
            plan.is_image, IGNORE_INDEX, plan.tokens[np.minimum(plan.tok_gather, len(plan.tokens) - 1)]
        )
        lab[plan.length :] = IGNORE_INDEX
        labels[b] = lab
    return {
        "tokens": tokens,
        "tok_gather": tok_g,
        "img_gather": img_g,
        "is_image": is_img,
        "labels": labels,
        "images": images,
    }


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """build_train_batch's numpy dict as tensors on `device`."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
