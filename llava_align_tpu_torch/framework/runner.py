"""Training runner: epoch loop with eval, best-metric checkpointing, resume
(torch twin of llava_align_tpu/framework/runner.py; the loops are the
original's, the checkpoints torch.save files).

Capability parity: reference lavis/runners/runner_base.py —
train (:348-411: per-epoch train + eval + best-ckpt save + resume),
train_epoch (:424-438), eval_epoch (:440-473), _save/_load_checkpoint
(:356-357,390,398).

A checkpoint is the directory `checkpoint_<name>` under output_dir, as in
the JAX package (there an orbax tree), holding one torch.save file,
CHECKPOINT_FILE, of the same state keys: params, opt_state, epoch, iters,
best_metric. A resume loads the tensors onto the device of the runner's
current params and reads weights only.

Under a mesh (Runner(..., mesh=, specs=), the training step's
parallel/sharding specs) params and the optimizer's trees are this rank's
shards: a save gathers them whole, and only rank 0 writes the file; a
resume reads the whole state on every rank and keeps its shard.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from llava_align_tpu_torch.framework.logger import MetricLogger
from llava_align_tpu_torch.framework.optims import tree_leaves
from llava_align_tpu_torch.framework.registry import registry

CHECKPOINT_FILE = "state.pt"


@dataclasses.dataclass
class RunnerConfig:
    max_epoch: int = 1
    output_dir: str = "output/train"
    evaluate_every: int = 1
    log_freq: int = 50
    resume_ckpt_path: Optional[str] = None
    best_metric_key: str = "agg_metrics"
    save_last: bool = True
    # iteration-based mode (reference runner_iter.py capability): when set,
    # each "epoch" is `iters_per_inner_epoch` steps drawn from a (possibly
    # infinite) loader and max_epoch counts inner epochs.
    iters_per_inner_epoch: Optional[int] = None


@registry.register_runner("runner_base")
class Runner:
    """Drives a train_step over epochs of batches.

    train_step: (params, opt_state, batch) -> (params, opt_state, loss)
    train_loader_fn: epoch -> iterable of device-ready batches
    eval_fn: params -> dict of metrics (higher best_metric_key = better)

    The reference's iteration-based RunnerIter (runner_iter.py) is this same
    class with cfg.iters_per_inner_epoch set; `runner_iter` is registered as
    an alias below so configs naming either runner resolve.
    """

    def __init__(
        self,
        cfg: RunnerConfig,
        train_step: Callable,
        params: Any,
        opt_state: Any,
        train_loader_fn: Callable[[int], Iterable],
        eval_fn: Optional[Callable[[Any], Dict[str, float]]] = None,
        *,
        mesh=None,
        specs: Any = None,
    ):
        self.cfg = cfg
        self.mesh, self.specs = mesh, specs
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.train_loader_fn = train_loader_fn
        self.eval_fn = eval_fn
        self.start_epoch = 0
        self.best_metric = -np.inf
        # global batch counter (reference runner_iter.py:49-85 persists
        # start_iters in the checkpoint for iteration-granular resume)
        self.global_step = 0
        self._batches = None  # persistent iterator (iteration mode)
        os.makedirs(cfg.output_dir, exist_ok=True)

    # -- checkpointing -------------------------------------------------------

    def _device(self):
        for x in tree_leaves(self.params):
            if isinstance(x, torch.Tensor):
                return x.device
        return torch.device("cpu")

    def _map_state(self, fn):
        """(params, opt_state) with fn(tree, specs) applied to the params
        and to the optimizer's trees of the params' structure."""
        trees = {k: fn(v, self.specs) if k in ("mu", "nu", "acc") else v
                 for k, v in self.opt_state.items()} if isinstance(self.opt_state, dict) else self.opt_state
        return fn(self.params, self.specs), trees

    def save_checkpoint(self, name: str, epoch: int) -> str:
        from llava_align_tpu_torch.parallel.dist import barrier, get_rank

        path = os.path.abspath(os.path.join(self.cfg.output_dir, f"checkpoint_{name}"))
        params, opt_state = self.params, self.opt_state
        if self.mesh is not None:
            from llava_align_tpu_torch.parallel.sharding import unshard_params

            params, opt_state = self._map_state(lambda t, sp: unshard_params(t, sp, self.mesh))
        if get_rank() == 0:
            state = {
                "params": params,
                "opt_state": opt_state,
                "epoch": epoch,
                "iters": int(self.global_step),
                "best_metric": float(self.best_metric),
            }
            os.makedirs(path, exist_ok=True)
            tmp = os.path.join(path, CHECKPOINT_FILE + ".tmp")
            torch.save(state, tmp)
            os.replace(tmp, os.path.join(path, CHECKPOINT_FILE))
            logging.info("saved checkpoint %s", path)
        if self.mesh is not None:
            barrier()
        return path

    def load_checkpoint(self, path: str) -> None:
        state = torch.load(os.path.join(os.path.abspath(path), CHECKPOINT_FILE),
                           map_location=self._device(), weights_only=True)
        self.params = state["params"]
        self.opt_state = state["opt_state"]
        if self.mesh is not None:
            from llava_align_tpu_torch.parallel.sharding import shard_params

            self.params, self.opt_state = self._map_state(lambda t, sp: shard_params(t, sp, self.mesh))
        self.start_epoch = int(state["epoch"]) + 1
        self.global_step = int(state.get("iters", 0))
        self.best_metric = float(state.get("best_metric", -np.inf))
        logging.info(
            "resumed from %s at epoch %d (iter %d)",
            path, self.start_epoch, self.global_step,
        )

    # -- loops ---------------------------------------------------------------

    def _batch_stream(self):
        """Persistent cycling batch iterator for iteration mode (reference
        runner_iter.py keeps one IterLoader across inner epochs instead of
        re-creating the loader, so batches continue where they left off)."""
        epoch = 0
        while True:
            it = iter(self.train_loader_fn(epoch))
            empty = True
            for batch in it:
                empty = False
                yield batch
            if empty:
                raise RuntimeError("train loader yielded no batches")
            epoch += 1

    def _fast_forward(self, n_batches: int) -> None:
        """Skip already-trained batches after an iteration-granular resume
        (reference runner_iter.py:49-85 start_iters semantics: the loader is
        deterministic, so skipping reproduces the original data order)."""
        if self._batches is None:
            self._batches = self._batch_stream()
        logging.info("fast-forwarding train loader by %d batches", n_batches)
        for _ in range(n_batches):
            next(self._batches)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        metrics = MetricLogger()
        if self.cfg.iters_per_inner_epoch:
            import itertools

            if self._batches is None:
                self._batches = self._batch_stream()
            loader = itertools.islice(self._batches, self.cfg.iters_per_inner_epoch)
        else:
            loader = self.train_loader_fn(epoch)
        for batch in metrics.log_every(
            loader, self.cfg.log_freq, header=f"Train epoch {epoch}"
        ):
            self.params, self.opt_state, loss = self.train_step(
                self.params, self.opt_state, batch
            )
            self.global_step += 1
            metrics.update(loss=float(loss))
        return metrics.global_avg()

    def train(self) -> Dict[str, float]:
        if self.cfg.resume_ckpt_path:
            self.load_checkpoint(self.cfg.resume_ckpt_path)
            if self.cfg.iters_per_inner_epoch and self.global_step:
                self._fast_forward(self.global_step)
        stats: Dict[str, float] = {}
        for epoch in range(self.start_epoch, self.cfg.max_epoch):
            stats = self.train_epoch(epoch)
            logging.info("epoch %d train stats: %s", epoch, stats)
            if self.eval_fn is not None and (epoch + 1) % self.cfg.evaluate_every == 0:
                eval_stats = self.eval_fn(self.params)
                logging.info("epoch %d eval stats: %s", epoch, eval_stats)
                metric = eval_stats.get(self.cfg.best_metric_key, -np.inf)
                if metric > self.best_metric:
                    self.best_metric = metric
                    self.save_checkpoint("best", epoch)
                stats.update({f"eval_{k}": v for k, v in eval_stats.items()})
            if self.cfg.save_last:
                self.save_checkpoint("last", epoch)
        return stats


# Iteration-based runner alias (reference lavis/runners/runner_iter.py
# registers "runner_iter"): the epoch Runner already implements its
# capability through cfg.iters_per_inner_epoch (persistent batch stream +
# iteration-granular resume), so the name maps to the same class.
registry.register_runner("runner_iter")(Runner)
