"""The port's optimizer pieces (llava_align_tpu_torch/framework/optims.py,
train/trainer.make_optimizer, utils/jax_params.from_jax_opt_state) and its
Runner (framework/runner.py) against the JAX package's, on the CPU.

- the three registered LR schedules and make_optimizer's warmup-cosine, at
  steps 0-20: within 1e-6 relative of the JAX ones (both compute in fp32);
- decay_mask leaf for leaf on LlavaConfig.tiny's tree (stacked norms are
  2-D and escape decay by name only) and on a tree of every name rule;
- build_optimizer over 5 steps of the same gradients (numpy, from a seed)
  against the optax chain, with the clip triggered and not, without a
  clip, and under MultiSteps (accum_grad_iters=2): params and the whole
  state (count, mu, nu, acc, mini_step, read from optax through
  from_jax_opt_state) within 1e-6; and a resume from JAX's state after 2
  steps that goes on for 3 more, equal to JAX's 5;
- Runner: train, eval, best and last checkpoints, resume, iteration mode
  and iteration-granular resume, as tests/test_framework.py holds the JAX
  Runner.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llava_align_tpu.config import LlavaConfig as JConfig
from llava_align_tpu.framework import optims as joptims
from llava_align_tpu.models import llava as jllava
from llava_align_tpu.train import trainer as jtrainer
from llava_align_tpu_torch.framework import optims as toptims
from llava_align_tpu_torch.framework.runner import Runner, RunnerConfig
from llava_align_tpu_torch.train import trainer as ttrainer
from llava_align_tpu_torch.utils.jax_params import from_jax_opt_state, from_jax_params

SCHEDULES = [
    ("linear_warmup_cosine_lr", dict(init_lr=1e-3, min_lr=1e-5, warmup_steps=5, warmup_start_lr=1e-6, max_steps=20)),
    ("linear_warmup_cosine_lr", dict(init_lr=2e-4, warmup_steps=0, max_steps=13)),
    ("linear_warmup_step_lr", dict(init_lr=1e-3, min_lr=1e-4, warmup_steps=3, decay_rate=0.5, steps_per_epoch=4)),
    ("linear_warmup_step_lr", dict(init_lr=1e-3, warmup_steps=0, warmup_start_lr=0.0, steps_per_epoch=7)),
    ("constant_lr", dict(init_lr=3e-4, warmup_steps=4, warmup_start_lr=0.0)),
    ("constant_lr", dict(init_lr=3e-4)),
]


@pytest.mark.parametrize("name,kw", SCHEDULES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(SCHEDULES)])
def test_registered_schedules_match_jax(name, kw):
    want = joptims.registry.get_lr_scheduler_class(name)(**kw)
    got = toptims.registry.get_lr_scheduler_class(name)(**kw)
    for step in range(21):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-12, err_msg=f"step {step}")


@pytest.mark.parametrize("warmup,total,min_lr", [(5, 20, 0.0), (0, 12, 1e-5), (3, 3, 0.0)])
def test_make_optimizer_schedule_matches_optax(warmup, total, min_lr):
    want = optax.warmup_cosine_decay_schedule(0.0, 1e-3, warmup, max(total, warmup + 1), min_lr)
    got = ttrainer.make_optimizer(1e-3, warmup_steps=warmup, total_steps=total, min_lr=min_lr)
    for step in range(21):
        np.testing.assert_allclose(got.lr(step), float(want(step)), rtol=1e-6, atol=1e-12, err_msg=f"step {step}")


def _numpy_tree(tree):
    return {k: _numpy_tree(v) for k, v in tree.items()} if isinstance(tree, dict) else (
        [_numpy_tree(v) for v in tree] if isinstance(tree, list) else tree.numpy())


@pytest.fixture(scope="module")
def llava_tree():
    """A LlavaConfig.tiny fp32 param tree as numpy: the port's random
    builder (no JAX compile), checked to have llava.init's structure and
    shapes."""
    from llava_align_tpu_torch.config import LlavaConfig as TConfig
    from llava_align_tpu_torch.utils.synthetic import build_random_llava_params

    tree = _numpy_tree(build_random_llava_params(TConfig.tiny(vocab_size=64), device="cpu"))
    shapes = jax.eval_shape(lambda k: jllava.init(k, JConfig.tiny(vocab_size=64)), jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(tree)
    assert [s.shape for s in jax.tree_util.tree_leaves(shapes)] == [x.shape for x in jax.tree_util.tree_leaves(tree)]
    return tree


@pytest.fixture(scope="module")
def tiny_tree(llava_tree):
    """A cut of it with a leaf of each decay class (a decayed stack, a
    stacked norm, a stacked bias, a 1-D leaf, a list): the optimizer's
    eager optax runs stay short."""
    L, V = llava_tree["llama"], llava_tree["vision"]
    return {"llama": {"layers": {k: L["layers"][k] for k in ("attn_norm", "down", "q")},
                      "lm_head": L["lm_head"], "final_norm": L["final_norm"]},
            "vision": {"cls": V["cls"], "layers": {"ln1": V["layers"]["ln1"], "q": V["layers"]["q"]}},
            "projector": llava_tree["projector"]}


def test_decay_mask_leaf_for_leaf(llava_tree):
    want = jax.tree_util.tree_leaves_with_path(joptims.decay_mask(llava_tree))
    got = toptims.tree_leaves(toptims.decay_mask(from_jax_params(llava_tree, device="cpu")))
    assert len(want) == len(got)
    for (path, w), g in zip(want, got):
        assert bool(w) == g, jax.tree_util.keystr(path)
    # every rule fires somewhere: a decayed matrix, a 2-D stacked norm and bias
    mask = toptims.decay_mask(from_jax_params(llava_tree, device="cpu"))
    assert mask["llama"]["layers"]["q"] and mask["vision"]["patch_embed"]
    assert not mask["llama"]["layers"]["attn_norm"] and not mask["vision"]["layers"]["q"]["bias"]
    assert not mask["vision"]["layers"]["ln1"]["scale"] and not mask["vision"]["cls"]


def test_decay_mask_name_rules():
    tree = {"w": np.ones((4, 4), np.float32), "bias": np.ones((4,), np.float32),
            "ln": {"scale": np.ones((4,), np.float32), "bias": np.zeros((4,), np.float32)},
            "norm_proj": {"kernel": np.ones((4, 4), np.float32)}, "emb": np.ones((8, 4), np.float32),
            "bn_stack": np.ones((2, 3, 4), np.float32), "stack": [np.ones((2, 4), np.float32)]}
    want = joptims.decay_mask(jax.tree_util.tree_map(jnp.asarray, tree))
    got = toptims.decay_mask(from_jax_params(tree, device="cpu"))
    assert jax.tree_util.tree_leaves(want) == toptims.tree_leaves(got)
    assert got["w"] and got["emb"] and got["stack"][0] and not got["norm_proj"]["kernel"] and not got["bn_stack"]


def _grads(tree, rng, scale):
    return jax.tree_util.tree_map(lambda x: (rng.normal(size=x.shape) * scale).astype(x.dtype), tree)


def _run_optax(tx, params, grads_seq, state=None):
    @jax.jit
    def step(params, state, g):
        updates, state = tx.update(g, state, params)
        return optax.apply_updates(params, updates), state

    params = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(params) if state is None else state
    for g in grads_seq:
        params, state = step(params, state, g)
    return jax.device_get(params), jax.device_get(state)


def _run_port(opt, params, grads_seq, state=None):
    params = from_jax_params(params, device="cpu")
    state = opt.init(params) if state is None else state
    for g in grads_seq:
        opt.step(params, from_jax_params(g, device="cpu"), state)
    return params, state


def _close(got, want, what, tol=1e-6):
    """got: a port tree; want: a JAX tree or a list of its leaves."""
    got = toptims.tree_leaves(got)
    want = want if isinstance(want, list) else jax.tree_util.tree_leaves(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol, atol=tol, err_msg=what)


# (build_optimizer kwargs, gradient scale): the cut tree's gradients of
# scale 0.05 have a global norm ~5 (the clip at 1.0 fires), of 0.001 ~0.1
OPT_CASES = {
    "clip_triggered": (dict(max_grad_norm=1.0), 0.05),
    "clip_not_triggered": (dict(max_grad_norm=1.0), 0.001),
    "no_clip": (dict(max_grad_norm=0.0), 0.05),
    "multisteps": (dict(max_grad_norm=1.0, accum_grad_iters=2), 0.05),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_build_optimizer_matches_optax(case, tiny_tree):
    kw, scale = OPT_CASES[case]
    sched = dict(lr_sched="linear_warmup_cosine_lr", init_lr=1e-2, min_lr=1e-4, warmup_steps=2,
                 max_steps=10, weight_decay=0.05)
    rng = np.random.default_rng(3)
    grads_seq = [_grads(tiny_tree, rng, scale) for _ in range(5)]
    tx = joptims.build_optimizer(**sched, **kw)
    opt = toptims.build_optimizer(**sched, **kw)
    want_p, want_s = _run_optax(tx, tiny_tree, grads_seq)
    got_p, got_s = _run_port(opt, tiny_tree, grads_seq)
    _close(got_p, want_p, f"{case} params")
    carried = from_jax_opt_state(want_s, device="cpu")
    assert got_s["count"] == carried["count"] == (2 if "accum_grad_iters" in kw else 5)
    assert got_s.get("mini_step") == carried.get("mini_step")
    for k in ("mu", "nu") + (("acc",) if "accum_grad_iters" in kw else ()):
        _close(got_s[k], [x.numpy() for x in toptims.tree_leaves(carried[k])], f"{case} {k}")
    # the clip fired (or not) as the case says: the update differs from the unclipped one
    if case.startswith("clip"):
        free_p, _ = _run_port(toptims.build_optimizer(**sched, max_grad_norm=0.0), tiny_tree, grads_seq)
        diff = max(float((a - b).abs().max()) for a, b in zip(toptims.tree_leaves(got_p),
                                                             toptims.tree_leaves(free_p)))
        assert (diff > 1e-6) == (case == "clip_triggered"), diff


@pytest.mark.parametrize("accum", [1, 2])
def test_resume_from_jax_state(accum, tiny_tree):
    """Two optax steps, the state carried over by from_jax_opt_state, three
    more steps in the port == five optax steps."""
    sched = dict(lr_sched="linear_warmup_cosine_lr", init_lr=1e-2, warmup_steps=1, max_steps=8)
    rng = np.random.default_rng(5)
    grads_seq = [_grads(tiny_tree, rng, 0.05) for _ in range(5)]
    tx = joptims.build_optimizer(**sched, accum_grad_iters=accum)
    mid_p, mid_s = _run_optax(tx, tiny_tree, grads_seq[:2])
    want_p, _ = _run_optax(tx, tiny_tree, grads_seq)
    opt = toptims.build_optimizer(**sched, accum_grad_iters=accum)
    got_p, _ = _run_port(opt, mid_p, grads_seq[2:], state=from_jax_opt_state(mid_s, device="cpu"))
    _close(got_p, want_p, f"resume accum={accum}")


def test_amp_cast_matches_jax(tiny_tree):
    tree = dict(tiny_tree, temp=np.float32(0.07), ids=np.arange(3, dtype=np.int32))
    want = joptims.amp_cast(jax.tree_util.tree_map(jnp.asarray, tree))
    got = toptims.amp_cast(from_jax_params(tree, device="cpu"))
    for w, g in zip(jax.tree_util.tree_leaves(want), toptims.tree_leaves(got)):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), (g.dtype, w.dtype)


# ---------------------------------------------------------------------------
# Runner (tests/test_framework.py's toy problems, in torch)
# ---------------------------------------------------------------------------


def _sgd_step(lr):
    def step(w, opt_state, batch):
        with torch.enable_grad():
            w = w.detach().requires_grad_(True)
            loss = (w - batch) ** 2
            (g,) = torch.autograd.grad(loss, w)
        return (w - lr * g).detach(), opt_state, loss.detach()

    return step


def test_runner_train_eval_resume(tmp_path):
    evals = []

    def eval_fn(w):
        m = -float((w - 3.0) ** 2)
        evals.append(m)
        return {"agg_metrics": m}

    step = _sgd_step(0.1)
    w0 = torch.tensor(0.0)
    cfg = RunnerConfig(max_epoch=3, output_dir=str(tmp_path / "run"), log_freq=100)
    runner = Runner(cfg, step, w0, {}, lambda e: [torch.tensor(3.0)] * 20, eval_fn)
    runner.train()
    assert abs(float(runner.params) - 3.0) < 1e-2
    assert (tmp_path / "run" / "checkpoint_best").is_dir()
    assert (tmp_path / "run" / "checkpoint_last").is_dir()
    assert evals == sorted(evals)  # each epoch better: best saved every epoch

    cfg2 = RunnerConfig(max_epoch=3, output_dir=str(tmp_path / "run"),
                        resume_ckpt_path=str(tmp_path / "run" / "checkpoint_last"))
    runner2 = Runner(cfg2, step, w0, {}, lambda e: [], eval_fn)
    runner2.train()
    assert runner2.start_epoch == 3 and runner2.global_step == 60
    assert abs(float(runner2.params) - 3.0) < 1e-2
    assert runner2.best_metric == max(evals)


def test_runner_iteration_mode(tmp_path):
    cfg = RunnerConfig(max_epoch=2, iters_per_inner_epoch=15, output_dir=str(tmp_path / "it"), log_freq=100)
    r = Runner(cfg, _sgd_step(0.2), torch.tensor(0.0), {},
               lambda e: itertools.repeat(torch.tensor(5.0)), None)
    r.train()
    assert abs(float(r.params) - 5.0) < 1e-2 and r.global_step == 30


def test_runner_iteration_granular_resume(tmp_path):
    def step(w, opt_state, batch):
        return w, opt_state, batch  # "loss" echoes the batch value

    consumed = []

    def loader(epoch):
        for i in range(10):
            v = torch.tensor(float(100 * epoch + i))
            consumed.append(float(v))
            yield v

    cfg = RunnerConfig(max_epoch=1, iters_per_inner_epoch=5, output_dir=str(tmp_path / "itr"), log_freq=100)
    r = Runner(cfg, step, torch.tensor(0.0), {}, loader, None)
    r.train()
    assert r.global_step == 5 and consumed == [0.0, 1.0, 2.0, 3.0, 4.0]

    consumed.clear()
    cfg2 = RunnerConfig(max_epoch=2, iters_per_inner_epoch=5, output_dir=str(tmp_path / "itr"), log_freq=100,
                        resume_ckpt_path=str(tmp_path / "itr" / "checkpoint_last"))
    r2 = Runner(cfg2, step, torch.tensor(0.0), {}, loader, None)
    r2.train()
    assert r2.global_step == 10
    assert consumed == [float(i) for i in range(10)]


def test_runner_checkpoint_holds_adamw_state(tmp_path, tiny_tree):
    """checkpoint_last keeps params and the AdamW state (count, mu, nu,
    acc, mini_step) and a resume restores them exactly."""
    opt = toptims.build_optimizer(init_lr=1e-2, max_steps=4, accum_grad_iters=2)
    params = from_jax_params(tiny_tree, device="cpu")
    rng = np.random.default_rng(0)
    grads = [from_jax_params(_grads(tiny_tree, rng, 0.05), device="cpu") for _ in range(3)]

    def step(p, s, g):
        opt.step(p, g, s)
        return p, s, torch.tensor(0.0)

    r = Runner(RunnerConfig(max_epoch=1, output_dir=str(tmp_path / "ck"), log_freq=100),
               step, params, opt.init(params), lambda e: grads, None)
    r.train()
    r2 = Runner(RunnerConfig(max_epoch=1, output_dir=str(tmp_path / "ck"),
                             resume_ckpt_path=str(tmp_path / "ck" / "checkpoint_last")),
                step, from_jax_params(tiny_tree, device="cpu"), opt.init(params), lambda e: [], None)
    r2.train()
    assert r2.opt_state["count"] == 1 and r2.opt_state["mini_step"] == 1
    for k in ("mu", "nu", "acc"):
        for a, b in zip(toptims.tree_leaves(r.opt_state[k]), toptims.tree_leaves(r2.opt_state[k])):
            assert torch.equal(a, b), k
    for a, b in zip(toptims.tree_leaves(r.params), toptims.tree_leaves(r2.params)):
        assert torch.equal(a, b)


# bf16 leaves of three shapes (two decayed matrices, one 1-D
# leaf that is not decayed), lr 1e-4, wd 0.05: every op of optax's chain
# rounds to bf16 where the compiled update rounds, so after 3 steps the
# params and both moments equal optax's bit for bit
BF16_SHAPES = {"w1": (256, 512), "w2": (512, 128), "b": (512,)}


@pytest.mark.parametrize("max_grad_norm", [1.0, 0.0], ids=["clip", "no_clip"])
def test_build_optimizer_bf16_matches_optax_bitwise(max_grad_norm):
    rng = np.random.default_rng(11)
    bf16 = jnp.bfloat16
    tree = {k: np.asarray(jnp.asarray(rng.normal(size=s) * 0.05, bf16)) for k, s in BF16_SHAPES.items()}
    # gradients of scale 0.01 have a global norm ~4.4: the clip at 1.0 fires
    grads_seq = [{k: np.asarray(jnp.asarray(rng.normal(size=s) * 0.01, bf16)) for k, s in BF16_SHAPES.items()}
                 for _ in range(3)]
    sched = dict(lr_sched="constant_lr", init_lr=1e-4, weight_decay=0.05, max_grad_norm=max_grad_norm)
    want_p, want_s = _run_optax(joptims.build_optimizer(**sched), tree, grads_seq)
    got_p, got_s = _run_port(toptims.build_optimizer(**sched), tree, grads_seq)
    carried = from_jax_opt_state(want_s, device="cpu")
    for what, got, want in (("params", got_p, from_jax_params(want_p, device="cpu")),
                            ("mu", got_s["mu"], carried["mu"]), ("nu", got_s["nu"], carried["nu"])):
        for g, w in zip(toptims.tree_leaves(got), toptims.tree_leaves(want)):
            assert g.dtype == w.dtype == torch.bfloat16, what
            diff = (g.float() != w.float())
            assert not diff.any(), f"{what}: {int(diff.sum())} of {diff.numel()} elements differ"
