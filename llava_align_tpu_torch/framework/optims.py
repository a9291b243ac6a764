"""LR schedules registered by name, the weight-decay mask, AdamW and the
bf16 cast of mixed-precision training (torch twin of
llava_align_tpu/framework/optims.py).

The JAX package builds its optimizer from optax: clip_by_global_norm, then
adamw (scale_by_adam, add_decayed_weights under a mask, the negated
learning rate of the schedule), wrapped in MultiSteps when gradients
accumulate. `AdamW` below computes the same chain in plain torch, op for op:

  * the clip scales by `t / g_norm * max_norm` only when g_norm >= max_norm
    (not torch's clip_grad_norm_, which multiplies by max_norm / (norm +
    1e-6) every step);
  * Adam's bias correction divides by 1 - b^(count + 1); eps lies outside
    the square root (eps_root 0); the moments take each leaf's dtype;
  * weight decay adds wd * param to the Adam direction of the leaves the
    mask selects, then the whole update is scaled by -lr(count), where
    count is the number of updates applied BEFORE this one (a warm-up from
    0 makes the first update zero);
  * accumulation keeps the running mean acc += (g - acc) / (mini_step + 1),
    and applies the inner chain (advancing count) only every k-th call.

Each foreach op below is one op of optax's chain and rounds to the leaf's
dtype where the compiled optax update rounds: on bf16 leaves the constants
are bf16 values (JAX's weak typing), the products and sums of each moment
round one by one (no fused alpha/addcmul), the squared norms of the clip
accumulate in fp32 and round per leaf, and divisions are true divisions.
So bf16 params and moments equal optax's bit for bit. Updates are in place
(torch._foreach_* under torch.no_grad()), in chunks of leaves of one device
and dtype, so the extra memory is one chunk's temporary, never a second
copy of the tree.

Capability parity: reference lavis/common/optims.py:14-135 —
LinearWarmupStepLRScheduler, LinearWarmupCosineLRScheduler, ConstantLR.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from llava_align_tpu_torch.framework.registry import registry

Schedule = Callable[[int], float]

# leaves of one device and dtype are updated together, up to this many
# elements per foreach call (one leaf larger than this is a chunk alone)
CHUNK_ELEMENTS = 1 << 28


@registry.register_lr_scheduler("linear_warmup_cosine_lr")
def linear_warmup_cosine_lr(
    init_lr: float,
    min_lr: float = 0.0,
    warmup_steps: int = 0,
    warmup_start_lr: float = -1.0,
    max_steps: int = 10_000,
    **_,
) -> Schedule:
    warmup_start_lr = warmup_start_lr if warmup_start_lr >= 0 else init_lr

    def schedule(step):
        step = np.float32(step)
        warm = warmup_start_lr + (init_lr - warmup_start_lr) * step / max(warmup_steps, 1)
        progress = np.clip(step / max(max_steps, 1), 0.0, 1.0)
        cosine = min_lr + 0.5 * (init_lr - min_lr) * (1.0 + np.cos(np.pi * progress))
        return float(np.float32(warm if step < warmup_steps else cosine))

    return schedule


@registry.register_lr_scheduler("linear_warmup_step_lr")
def linear_warmup_step_lr(
    init_lr: float,
    min_lr: float = 0.0,
    warmup_steps: int = 0,
    warmup_start_lr: float = -1.0,
    decay_rate: float = 1.0,
    steps_per_epoch: int = 1000,
    **_,
) -> Schedule:
    warmup_start_lr = warmup_start_lr if warmup_start_lr >= 0 else init_lr

    def schedule(step):
        step = np.float32(step)
        warm = warmup_start_lr + (init_lr - warmup_start_lr) * step / max(warmup_steps, 1)
        epoch = np.floor(step / steps_per_epoch)
        stepped = np.maximum(init_lr * (decay_rate**epoch), min_lr)
        return float(np.float32(warm if step < warmup_steps else stepped))

    return schedule


@registry.register_lr_scheduler("constant_lr")
def constant_lr(init_lr: float, warmup_steps: int = 0, warmup_start_lr: float = -1.0, **_) -> Schedule:
    # -1 sentinel → warm up from init_lr, like the reference ConstantLRScheduler
    warmup_start_lr = warmup_start_lr if warmup_start_lr >= 0 else init_lr

    def schedule(step):
        step = np.float32(step)
        warm = warmup_start_lr + (init_lr - warmup_start_lr) * step / max(warmup_steps, 1)
        return float(np.float32(warm if warmup_steps and step < warmup_steps else init_lr))

    return schedule


# ---------------------------------------------------------------------------
# trees: nested dicts (keys in sorted order, as JAX flattens them) and lists
# ---------------------------------------------------------------------------


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, path: tuple = ()):
    """fn(path, leaf) over the tree, keeping its structure; path is the
    tuple of dict keys and list indices down to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def decay_mask(params):
    """Weight-decay split of the reference optimizer
    (lavis/models/base_model.py:107-120 get_optimizer_params): NO decay for
    params with ndim < 2 (every bias / LayerNorm scale) or whose name
    contains bias/ln/bn/norm; decay for the 2-D+ matrices. Returns a bool
    tree of the params' structure. Stacked norms [L, D] are 2-D and escape
    decay by their names only (attn_norm, ln1, ...)."""
    no_decay = ("bias", "ln", "bn", "norm")

    def f(path, x):
        if x.dim() < 2:
            return False
        return not any(t in str(k).lower() for k in path for t in no_decay)

    return tree_map(f, params)


def amp_cast(params):
    """The JAX package's amp_cast: every fp32 leaf with ndim >= 1 cast to
    bfloat16 (0-d knobs, non-float and low-precision leaves unchanged).
    Called inside the differentiated function, so the gradients arrive in
    fp32 on the fp32 masters through the cast's backward. It is not
    torch.autocast, whose per-op policy computes something else."""

    def cast(_, x):
        if x.dtype == torch.float32 and x.dim() >= 1:
            return x.to(torch.bfloat16)
        return x

    return tree_map(cast, params)


def _chunks(idx: List[int], leaves: List[torch.Tensor]) -> List[List[int]]:
    """Indices of `leaves` grouped by (device, dtype), each group cut into
    runs of at most CHUNK_ELEMENTS elements."""
    groups: Dict[tuple, List[int]] = {}
    for i in idx:
        groups.setdefault((leaves[i].device, leaves[i].dtype), []).append(i)
    out = []
    for members in groups.values():
        run, n = [], 0
        for i in members:
            if run and n + leaves[i].numel() > CHUNK_ELEMENTS:
                out.append(run)
                run, n = [], 0
            run.append(i)
            n += leaves[i].numel()
        out.append(run)
    return out


def _pick(xs: List[Any], ids: List[int]) -> List[Any]:
    return [xs[i] for i in ids]


class AdamW:
    """optax's chain(clip_by_global_norm(max_grad_norm), adamw(learning_rate,
    b1, b2, eps, weight_decay, mask)), wrapped in MultiSteps(accum_steps)
    when accum_steps > 1, on a tree of float tensors, in place.

    learning_rate: a float or a schedule count -> float.
    mask: None (decay every leaf), a bool tree, or a callable params -> bool
    tree (decay_mask).
    State (a dict, torch.save-able): count (applied updates), mu and nu
    (trees of the params' structure, each leaf in its param's dtype), and
    with accumulation acc (the running mean of the gradients) and
    mini_step."""

    def __init__(
        self,
        learning_rate: Union[float, Schedule],
        *,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 1e-4,
        mask: Any = None,
        max_grad_norm: Optional[float] = None,
        accum_steps: int = 1,
    ):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.mask = mask
        self.max_grad_norm = max_grad_norm
        self.accum_steps = int(accum_steps or 1)
        # per-leaf fp32 squared norms [n] -> their values over the whole
        # tree; the trainer sets it when the leaves are sharded
        self.norm_sync: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def init(self, params) -> Dict[str, Any]:
        for x in tree_leaves(params):
            if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
                raise TypeError(f"AdamW takes a tree of float tensors, got a {type(x).__name__} "
                                f"{getattr(x, 'dtype', '')} leaf")

        def zeros(_, x):
            return torch.zeros_like(x, requires_grad=False)

        state = {"count": 0, "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}
        if self.accum_steps > 1:
            state["acc"] = tree_map(zeros, params)
            state["mini_step"] = 0
        return state

    def _decayed(self, params) -> List[bool]:
        if self.mask is None:
            return [True] * len(tree_leaves(params))
        mask = self.mask(params) if callable(self.mask) else self.mask
        return [bool(m) for m in tree_leaves(mask)]

    @torch.no_grad()
    def step(self, params, grads, state: Dict[str, Any]) -> None:
        """Apply one call of the chain: params and state are updated in
        place. grads is a tree of the params' structure or a list in
        tree_leaves(params) order; its tensors are used as scratch space
        (they hold no gradient afterwards)."""
        P = tree_leaves(params)
        G = list(grads) if isinstance(grads, (list, tuple)) else tree_leaves(grads)
        if len(G) != len(P):
            raise ValueError(f"{len(G)} gradients for {len(P)} params")
        every = list(range(len(P)))
        if self.accum_steps > 1:
            A, n = tree_leaves(state["acc"]), int(state["mini_step"])
            for c in _chunks(every, P):
                d = torch._foreach_sub(_pick(G, c), _pick(A, c))
                torch._foreach_div_(d, _divisor(n + 1, A[c[0]].dtype, A[c[0]].device))
                torch._foreach_add_(_pick(A, c), d)
                del d
            if n < self.accum_steps - 1:
                state["mini_step"] = n + 1
                return
            G = A  # the mean of the k gradients; zeroed once applied
        chunks = _chunks(every, P)
        if self.max_grad_norm:
            self._clip(G, chunks)
        count = int(state["count"])
        lr = self.lr(count)
        b1, b2 = np.float32(self.b1), np.float32(self.b2)
        bc1 = float(np.float32(1.0) - b1 ** np.float32(count + 1))
        bc2 = float(np.float32(1.0) - b2 ** np.float32(count + 1))
        M, N = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        decayed = self._decayed(params)
        for c in chunks:
            Pc, Gc, Mc, Nc = _pick(P, c), _pick(G, c), _pick(M, c), _pick(N, c)
            dt, dev = Pc[0].dtype, Pc[0].device

            def k(x):
                return _as_dtype(x, dt)

            # mu = (1 - b1) * g + b1 * mu
            upd = torch._foreach_mul(Gc, k(1.0 - self.b1))
            torch._foreach_mul_(Mc, k(self.b1))
            torch._foreach_add_(Mc, upd)
            # nu = (1 - b2) * g^2 + b2 * nu (b2 rounds to 1.0 in bf16)
            torch._foreach_mul_(Gc, Gc)
            torch._foreach_mul_(Gc, k(1.0 - self.b2))
            if k(self.b2) != 1.0:
                torch._foreach_mul_(Nc, k(self.b2))
            torch._foreach_add_(Nc, Gc)
            # upd = (mu / bc1) / (sqrt(nu / bc2) + eps); the spent gradient
            # buffers hold the denominator
            torch._foreach_copy_(upd, Mc)
            torch._foreach_div_(upd, _divisor(bc1, dt, dev))
            torch._foreach_copy_(Gc, Nc)
            torch._foreach_div_(Gc, _divisor(bc2, dt, dev))
            torch._foreach_sqrt_(Gc)
            torch._foreach_add_(Gc, k(self.eps))
            torch._foreach_div_(upd, Gc)
            dc = [j for j, i in enumerate(c) if decayed[i]]
            if dc and self.weight_decay:
                wd = _pick(Gc, dc)
                torch._foreach_copy_(wd, _pick(Pc, dc))
                torch._foreach_mul_(wd, k(self.weight_decay))
                torch._foreach_add_(_pick(upd, dc), wd)
            torch._foreach_mul_(upd, k(-lr))
            torch._foreach_add_(Pc, upd)
            del upd
        state["count"] = count + 1
        if self.accum_steps > 1:
            torch._foreach_zero_(G)
            state["mini_step"] = 0

    def global_norm(self, G: List[torch.Tensor], chunks: Optional[List[List[int]]] = None) -> torch.Tensor:
        """optax.global_norm of the leaves G (a 0-d tensor in their promoted
        dtype): as jnp.sum does, each leaf's sum of squares accumulates in
        fp32 and rounds to the leaf's dtype; the leaves' sums add up in tree
        order, each partial sum in the promoted dtype. norm_sync (set for a
        sharded tree) maps the per-leaf fp32 sums to their values over the
        whole tree first."""
        chunks = chunks if chunks is not None else _chunks(list(range(len(G))), G)
        sq = [None] * len(G)
        for c in chunks:
            for i, n in zip(c, torch._foreach_norm(_pick(G, c), 2, dtype=torch.float32)):
                sq[i] = n
        sq = torch.stack([n.to(sq[0].device) for n in sq]).square()
        if self.norm_sync is not None:
            sq = self.norm_sync(sq)
        total = None
        for i, g in enumerate(G):
            s = sq[i].to(g.dtype)
            total = s if total is None else total + s
        return total.sqrt()

    def _clip(self, G: List[torch.Tensor], chunks: List[List[int]]) -> None:
        """optax.clip_by_global_norm: G /= g_norm, G *= max_norm where
        g_norm >= max_norm (global_norm), on the device (no host sync)."""
        g_norm = self.global_norm(G, chunks)
        keep = g_norm < _as_dtype(self.max_grad_norm, g_norm.dtype)
        one = torch.ones_like(g_norm)
        for c in chunks:
            Gc = _pick(G, c)
            dt, dev = Gc[0].dtype, Gc[0].device
            # where(keep, g, g / g_norm * max_norm): dividing and multiplying
            # by 1 leaves a kept g as it was
            torch._foreach_div_(Gc, torch.where(keep, one, g_norm).to(dev, dt))
            mx = _as_dtype(self.max_grad_norm, dt)
            if mx != 1.0:
                torch._foreach_mul_(Gc, torch.where(keep, one, torch.full_like(g_norm, mx)).to(dev, dt))


def _as_dtype(x: float, dtype: torch.dtype) -> float:
    """x rounded to `dtype`, as a Python float: a JAX Python scalar takes
    the dtype of the array it meets (weak typing), so optax's constants
    (b1, 1 - b1, eps, weight decay, -lr) are bf16 values on bf16 leaves."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def _divisor(x: float, dtype: torch.dtype, device) -> torch.Tensor:
    """x rounded to `dtype`, as a 0-d fp32 tensor on `device`: a tensor
    divisor keeps the division true on the GPU, where torch multiplies by
    the reciprocal of a Python scalar divisor."""
    return torch.tensor(_as_dtype(x, dtype), dtype=torch.float32, device=device)


def build_optimizer(
    lr_sched: str = "linear_warmup_cosine_lr",
    weight_decay: float = 0.05,
    beta2: float = 0.999,
    max_grad_norm: float = 1.0,
    accum_grad_iters: int = 1,
    **sched_kwargs,
) -> AdamW:
    """AdamW + named LR schedule with the reference's decay split applied
    via mask (biases/norm params are not decayed). `max_grad_norm=0`
    disables clipping (the reference clips only where run configs say so).

    `accum_grad_iters` reproduces the reference's gradient accumulation
    (base_task.py:223,232: each backward contributes loss/k and the
    optimizer steps every k iterations): the running MEAN of the k
    gradients, the inner chain applied once per k calls, as the JAX
    package's optax.MultiSteps."""
    sched_fn = registry.get_lr_scheduler_class(lr_sched)
    if sched_fn is None:
        raise KeyError(f"unknown lr scheduler {lr_sched}")
    schedule = sched_fn(**sched_kwargs)
    return AdamW(
        schedule, b2=beta2, weight_decay=weight_decay, mask=decay_mask,
        max_grad_norm=max_grad_norm or None,
        accum_steps=int(accum_grad_iters) if accum_grad_iters and int(accum_grad_iters) > 1 else 1,
    )


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule (exponent 1): linear from
    init_value to peak_value over warmup_steps, then cosine decay to
    end_value at decay_steps, in float32."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError(f"the cosine decay needs decay_steps > warmup_steps, got {decay_steps}, {warmup_steps}")

    def schedule(count):
        count = np.float32(count)
        if count < warmup_steps:
            frac = np.float32(1) - np.clip(count, 0, warmup_steps) / np.float32(warmup_steps)
            return float(np.float32((init_value - peak_value) * frac + peak_value))
        t = np.minimum(count - np.float32(warmup_steps), np.float32(span))
        cosine = 0.5 * (1 + np.cos(np.float32(math.pi) * t / np.float32(span)))
        return float(np.float32(peak_value * ((1 - alpha) * cosine + alpha)))

    return schedule
