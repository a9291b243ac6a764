"""Helpers of the LAVIS zoo's port tests (tests/test_torch_lavis_*.py,
tests/test_torch_blip2_losses.py): the JAX references as compiled
programs, and trees carried between the packages.

A reference program is compiled with XLA's backend optimizations off
(optimization level 0, LLVM's expensive passes skipped): the same fp32
numbers, a compile a fraction shorter. The options go to that one
compile, so no other program of the test process is touched. Several
small programs compile faster than one program that holds them all, and a
module's programs are traced one after another and compiled side by side
(run_all: XLA's compile does not hold the GIL).
"""

import contextlib
import functools
import zlib
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch on one intra-op thread for the module (import it into a test
    module and request it, or use it autouse there): the tiny port
    programs gain nothing from threads, and beside the suite's other
    workers a thread per core spins at each small op (the port's PnP-VQA
    pipeline took 3-5 s on eight threads of a busy host, 0.03 s on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_all(programs: dict) -> dict:
    """{name: fn(*args)} for programs {name: (fn, *args)}: each one jitted
    JAX program compiled with FAST_COMPILE (traced in turn, compiled in
    threads side by side), its outputs as numpy."""
    lowered = {k: (jax.jit(fn).lower(*args), args) for k, (fn, *args) in programs.items()}
    with ThreadPoolExecutor(len(lowered)) as pool:
        compiled = dict(zip(lowered, pool.map(lambda la: la[0].compile(FAST_COMPILE), lowered.values())))
    return {k: jax.device_get(compiled[k](*args)) for k, (_, args) in lowered.items()}


@contextlib.contextmanager
def fast_jit():
    """Inside, every jax.jit made compiles with FAST_COMPILE (for the JAX
    package's own loops and CLI, which jit their steps themselves), and a
    function made again from the same code over equal closure values (the
    JAX loops jit a fresh lambda each call, e.g. t5.generate_greedy's step)
    reuses the first one's jitted function, so equal shapes compile once
    (the same code, closure values and defaults: the same function)."""
    jit = jax.jit
    made = {}

    def fast(fun=None, **kw):
        kw.setdefault("compiler_options", FAST_COMPILE)
        if fun is None:
            return functools.partial(fast, **kw)
        try:
            key = (fun.__code__, tuple(c.cell_contents for c in fun.__closure__ or ()), fun.__defaults__,
                   tuple(sorted((fun.__kwdefaults__ or {}).items())), repr(sorted(kw.items())))
            hash(key)
        except (AttributeError, TypeError, ValueError):  # no code object, or an unhashable closure value
            return jit(fun, **kw)
        if key not in made:
            made[key] = jit(fun, **kw)
        return made[key]

    jax.jit = fast
    try:
        yield
    finally:
        jax.jit = jit


def jit_eager(fn, *static_names, static_argnums=(1,)):
    """fn jitted with FAST_COMPILE (its config argument static), for a JAX
    function that the JAX package's host loops call eagerly, op by op: one
    compile a shape in place of one a primitive. Inside another jit it is
    traced as it is."""
    jitted = jax.jit(fn, static_argnums=static_argnums, static_argnames=static_names, compiler_options=FAST_COMPILE)

    def call(*args, **kw):
        traced = any(isinstance(x, jax.core.Tracer) for x in jax.tree_util.tree_leaves((args, kw)))
        return (fn if traced else jitted)(*args, **kw)

    return call


def run(fn, *args):
    """fn(*args) as one jitted JAX program compiled with FAST_COMPILE, its
    outputs as numpy."""
    return run_all({0: (fn, *args)})[0]


def recording_draws(module, fn):
    """fn as a program that also returns the hard-negative draws of
    module.sample_hard_negative_indices, recorded while it traces (in the
    order drawn), for the port's `neg_idx` seam or its sampler."""
    def traced(*args):
        draws = []
        orig = module.sample_hard_negative_indices

        def recording(key, w):
            d = orig(key, w)
            draws.append(d)
            return d

        module.sample_hard_negative_indices = recording
        try:
            return fn(*args), draws
        finally:
            module.sample_hard_negative_indices = orig

    return traced


def np_tree(tree):
    """A tree of tensors (dicts, lists, None) as numpy copies."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [np_tree(v) for v in tree]
    return None if tree is None else tree.detach().cpu().numpy().copy()


def leaves(tree) -> list:
    """Leaves in jax.tree_util's order: dict keys sorted, lists in order,
    None skipped."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [] if tree is None else [tree]


def close(got, want, what: str, rtol: float = 0.0, atol: float = 1e-5) -> None:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def grads_close(grads, want_tree, what: str) -> None:
    """Port gradients (in leaves() order; None = unreached, zero) against
    the JAX gradient tree, each leaf within 1e-5 of the largest."""
    want = leaves(want_tree)
    assert len(want) == len(grads), (len(want), len(grads))
    scale = max(float(np.abs(w).max()) for w in want)
    for i, (g, w) in enumerate(zip(grads, want)):
        got = np.zeros_like(w) if g is None else g.detach().numpy()
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-5 * scale, err_msg=f"{what} gradient leaf {i}")


def port_grads(loss_fn, tree):
    """(loss_fn(tree), its loss's gradients in leaves() order) by autograd;
    the loss is the output, its "loss" entry, or that of its first item."""
    xs = leaves(tree)
    for x in xs:
        x.requires_grad_(True)
    out = loss_fn(tree)
    loss = out[0] if isinstance(out, tuple) else out
    loss = loss["loss"] if isinstance(loss, dict) else loss
    return out, torch.autograd.grad(loss, xs, allow_unused=True)


class GptMockTokenizer:
    """What the GPT processors need of a tokenizer, offline: the special
    tokens (framework/processors.GPT_SPECIAL_TOKENS) are ids 0-6, "<pad>"
    the last; a word is a crc32 id in [7, vocab)."""

    SPECIAL = ["<bos>", "<eos>", "<speaker1>", "<speaker2>", "<cap>", "<video>", "<pad>"]
    pad_token_id = 6

    def __init__(self, vocab: int = 64):
        self.vocab = vocab

    def encode(self, text: str) -> list:
        return [zlib.crc32(w.encode()) % (self.vocab - 7) + 7 for w in text.split()]

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            return self.SPECIAL.index(tokens)
        return [self.SPECIAL.index(t) for t in tokens]
