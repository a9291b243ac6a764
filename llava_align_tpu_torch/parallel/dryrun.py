"""Multi-rank dry run (the twin of the JAX package's
__graft_entry__.dryrun_multichip): n ranks over torch.distributed, a
('data', 'model') mesh (data = 2 when n is even and >= 4), and on it

  * one TP x DP train step of a tiny fp32 LLaVA (finite loss, equal to the
    unsharded step's);
  * dual-VDD `generate`, `generate_batch` and `generate_batch_prefix` on
    the sharded engine, each token-exact against the unsharded engine;
  * the int8 TP case with intermediate = 160 * model (not lane-aligned per
    shard: the engine must pad gateup/down and run the TP kernels), and
    the W8A8 product under TP bit-identical to one device's (column and
    row), then the act-quant engine's grouped path.

    python -m llava_align_tpu_torch.parallel.dryrun --n 2                # ranks on the GPU(s)
    python -m llava_align_tpu_torch.parallel.dryrun --n 4 --device cpu   # gloo ranks on the CPU

On the CPU the ranks use gloo with one thread each; on the GPU each rank
takes its own card, or all share one (gloo: parallel/dist's rule). Any
rank's failure fails the run. `spawn` is the launcher the tests and the
card smoke run use too.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import tempfile
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, world: int, port: int, device: str, out_dir: str, args: tuple):
    from llava_align_tpu_torch.parallel.dist import init_distributed_mode

    if device == "cpu":
        torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    init_distributed_mode(device=device)
    try:
        result = fn(rank, world, device, *args)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


class Ranks:
    """Ranks started by `start`: join() waits for them and returns each
    rank's result, in rank order; a rank that raises, or a run past the
    timeout, raises there, and every rank is stopped."""

    def __init__(self, fn: Callable, world: int, args: tuple, device: str, timeout: float):
        self.world = world
        self._dir = tempfile.TemporaryDirectory()
        self._ctx = mp.start_processes(_rank_main, args=(fn, world, free_port(), device, self._dir.name, args),
                                       nprocs=world, join=False, start_method="spawn")
        self._deadline = time.monotonic() + timeout
        self._timeout = timeout

    def join(self) -> List[Any]:
        try:
            while not self._ctx.join(timeout=max(1.0, min(5.0, self._deadline - time.monotonic()))):
                if time.monotonic() > self._deadline:
                    raise TimeoutError(f"{self.world} ranks still running after {self._timeout:.0f} s")
            results = []
            for r in range(self.world):
                with open(os.path.join(self._dir.name, f"rank{r}.json")) as f:
                    results.append(json.load(f))
            return results
        finally:
            self.stop()

    def stop(self) -> None:
        for p in self._ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
        self._dir.cleanup()


def start(fn: Callable, world: int, args: tuple = (), *, device: str = "cuda", timeout: float = 600.0) -> Ranks:
    """Start fn(rank, world, device, *args) in `world` spawned processes
    joined in one process group (MASTER_ADDR 127.0.0.1, a free port) on
    `device` ('cuda', the default, or 'cpu') and return at once; fn is a
    module-level function returning something JSON-able. The caller may
    work meanwhile, then Ranks.join() (or stop())."""
    return Ranks(fn, world, args, device, timeout)


def spawn(fn: Callable, world: int, args: tuple = (), *, device: str = "cuda", timeout: float = 600.0) -> List[Any]:
    """start(...).join(): run the ranks and return each rank's result, in
    rank order."""
    return start(fn, world, args, device=device, timeout=timeout).join()


def mesh_shape(n: int):
    """(data, model) as the JAX dryrun lays n devices out."""
    data = 2 if n % 2 == 0 and n >= 4 else 1
    return data, n // data


def tiny_config(model: int):
    """The JAX dryrun's tiny config: every sharded dim divisible by the
    model axis."""
    from llava_align_tpu_torch.config import ClipVisionConfig, LlamaConfig, LlavaConfig

    text = LlamaConfig(vocab_size=32 * model, hidden_size=16 * model, intermediate_size=32 * model,
                       num_layers=2, num_heads=2 * model, num_kv_heads=model, head_dim=8,
                       dtype=torch.float32)
    vision = ClipVisionConfig(image_size=28, patch_size=14, hidden_size=8 * model,
                              intermediate_size=16 * model, num_layers=2, num_heads=model,
                              dtype=torch.float32)
    return LlavaConfig(text=text, vision=vision, mm_projector_type="mlp2x_gelu")


def _dryrun_rank(rank: int, world: int, device: str) -> dict:
    from llava_align_tpu_torch.config import GenerationConfig, LlamaConfig, LlavaConfig
    from llava_align_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from llava_align_tpu_torch.decoding.engine import DecodeEngine
    from llava_align_tpu_torch.framework.optims import tree_leaves
    from llava_align_tpu_torch.ops import quant
    from llava_align_tpu_torch.parallel.dist import rank_device
    from llava_align_tpu_torch.parallel.mesh import axis_group, axis_rank, make_mesh
    from llava_align_tpu_torch.parallel.sharding import shard_params, unshard_params
    from llava_align_tpu_torch.train import trainer
    from llava_align_tpu_torch.utils.synthetic import build_random_llava_params

    dev = rank_device(device)
    data, model = mesh_shape(world)
    mesh = make_mesh(model=model, data=data)
    cfg = tiny_config(model)

    # ---- one TP x DP train step against the unsharded step
    full = build_random_llava_params(cfg, device=dev)
    ref = build_random_llava_params(cfg, device=dev)
    specs = trainer.train_shardings(cfg, full, model)
    params = shard_params(full, specs, mesh)
    B, H = 2 * data, cfg.vision.image_size
    rng = np.random.default_rng(0)
    ids = [1, 5, IMAGE_TOKEN_INDEX, 7, 8, 9]
    samples = [{"input_ids": ids, "images": rng.normal(size=(3, H, H)).astype(np.float32)} for _ in range(B)]
    batch = trainer.batch_to_device(trainer.build_train_batch(cfg, samples, pad_to=16), dev)
    losses, stepped = [], []
    for tree in (params, ref):
        opt = trainer.make_optimizer(lr=1e-4, warmup_steps=2, total_steps=10)
        step = trainer.make_train_step(cfg, opt, attn_impl="xla", mesh=mesh if tree is params else None)
        tree, _, loss = step(tree, opt.init(tree), batch)
        losses.append(float(loss))
        stepped.append({k: v for k, v in tree.items()})
    assert np.isfinite(losses[0]), losses
    assert abs(losses[0] - losses[1]) <= 1e-6 * max(1.0, abs(losses[1])), losses
    with torch.no_grad():
        got = unshard_params(stepped[0], specs, mesh)
        param_err = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(got), tree_leaves(stepped[1])))

    # ---- dual-VDD decoding on the sharded engine, token-exact against one device
    gen = GenerationConfig(max_new_tokens=3, do_sample=False, eos_token_id=-1, use_dd=True,
                           use_dd_unk=True, cd_alpha=1.0, cd_beta=0.1)
    full = build_random_llava_params(cfg, device=dev)
    engine = DecodeEngine(full, cfg, gen, attn_impl="xla", bucket=8, mesh=mesh)
    ref_engine = DecodeEngine(full, cfg, gen, attn_impl="xla", bucket=8)
    img = samples[0]["images"]
    out, want = engine.generate(ids, img), ref_engine.generate(ids, img)
    assert out.num_generated == 3 and out.token_ids == want.token_ids, (out.token_ids, want.token_ids)
    batch_q = [(ids, img)] * (2 * data)
    for o, r in zip(engine.generate_batch(batch_q), ref_engine.generate_batch(batch_q)):
        assert o.token_ids == r.token_ids, ("generate_batch", o.token_ids, r.token_ids)
    sfx = [[7, 8, 9], [7, 11, 13], [17, 19]]
    pre = [1, 5, IMAGE_TOKEN_INDEX, 6]
    g_ref = ref_engine.generate_batch([(pre + s, img) for s in sfx])
    for o, r in zip(engine.generate_batch_prefix(pre, sfx, img), g_ref):
        assert o.token_ids == r.token_ids, ("generate_batch_prefix", o.token_ids, r.token_ids)

    # ---- int8 TP with the 7B alignment profile: the engine must lane-pad
    q_text = LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=160 * model, num_layers=2,
                         num_heads=model, num_kv_heads=model, head_dim=128, dtype=torch.float32)
    q_cfg = LlavaConfig(text=q_text, vision=cfg.vision, mm_projector_type="mlp2x_gelu")
    q_params = build_random_llava_params(q_cfg, quant="int8", device=dev, seed=2)
    q_gen = dataclasses.replace(gen, max_new_tokens=2)
    q_eng = DecodeEngine(q_params, q_cfg, q_gen, attn_impl="xla", bucket=8, mesh=mesh)
    assert model == 1 or q_eng._int8_tp, "int8 TP path did not activate"
    q_ref = DecodeEngine(q_params, q_cfg, q_gen, attn_impl="xla", bucket=8)
    q_out = q_eng.generate(ids, img)
    assert q_out.num_generated == 2 and q_out.token_ids == q_ref.generate(ids, img).token_ids

    # ---- W8A8 under TP: bit-identical to one device's W8A8
    qrng = np.random.default_rng(3)
    L, D_w, O_w = 2, 128 * model, 128 * model
    wq = {"q": torch.from_numpy(qrng.integers(-127, 127, size=(L, O_w, D_w), dtype=np.int8)).to(dev),
          "s": torch.from_numpy(qrng.random((L, O_w)).astype(np.float32) * 0.02 + 1e-3).to(dev)}
    h_act = torch.from_numpy(qrng.normal(size=(quant.W8A8_MIN_ROWS, D_w)).astype(np.float32)).to(dev)
    w8_ref = quant.int8_matmul_w8a8(h_act, wq["q"][1], wq["s"][1])
    group, r = axis_group(mesh, "model"), axis_rank(mesh, "model")
    o_l, d_l = O_w // model, D_w // model
    col = quant.int8_matmul_stacked_tp(
        h_act, {"q": wq["q"][:, r * o_l:(r + 1) * o_l].contiguous(), "s": wq["s"][:, r * o_l:(r + 1) * o_l]
                .contiguous()}, 1, group, "column", act_quant=True)
    assert torch.equal(col, w8_ref[:, r * o_l:(r + 1) * o_l]), "sharded W8A8 (column) != one device"
    row = quant.int8_matmul_stacked_tp(
        h_act[:, r * d_l:(r + 1) * d_l].contiguous(),
        {"q": wq["q"][:, :, r * d_l:(r + 1) * d_l].contiguous(), "s": wq["s"]}, 1, group, "row",
        act_quant=True)
    assert torch.equal(row, w8_ref), "sharded W8A8 (row) != one device"
    aq_eng = DecodeEngine(q_params, q_cfg, q_gen, attn_impl="xla", bucket=8, mesh=mesh, act_quant=True)
    assert all(o.num_generated == 2 for o in aq_eng.generate_batch_prefix(pre, sfx, img))
    return {"data": data, "model": model, "loss": losses[0], "loss_ref": losses[1],
            "param_err": param_err, "tokens": out.token_ids}


def dryrun_multichip(n: int, device: str = "cuda", timeout: float = 900.0) -> dict:
    """Run the dry run on n ranks; returns rank 0's summary."""
    results = spawn(_dryrun_rank, n, device=device, timeout=timeout)
    r = results[0]
    print(f"dryrun_multichip ok: mesh=(data={r['data']}, model={r['model']}) devices={n} "
          f"loss={r['loss']:.4f} (unsharded {r['loss_ref']:.4f}, params within {r['param_err']:.2e}) "
          f"vdd_decode_tokens={r['tokens']}")
    return r


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=4, help="ranks (processes)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the ranks run (default: the GPU)")
    p.add_argument("--timeout", type=float, default=900.0)
    a = p.parse_args(argv)
    dryrun_multichip(a.n, a.device, a.timeout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
