"""The port's training core (llava_align_tpu_torch/train/trainer.py and the
autograd path through models/llama, llava, clip_vit) against the JAX
package's, on LlavaConfig.tiny fp32 trees carried over by from_jax_params,
on the CPU.

- build_train_batch: exact;
- multimodal_lm_loss: within 1e-6 of JAX's (attn_impl="xla"); every
  gradient leaf within 1e-5 of its largest element of jax.grad's (a leaf
  whose gradient is rounding noise or zero on both sides, below 1e-6 of
  the tree's largest, must stay so: the CLIP key bias, see below, and the
  post-LN, which select_layer -2 never runs);
- three make_train_step steps (warm-up 1, clip on, weight decay): losses
  within 1e-6 relative, params within 1e-5 — except elements whose
  gradient is float rounding noise (RMS below 1e-6 of the tree's largest,
  read from JAX's own second moment; here the CLIP key bias, whose exact
  gradient is zero: softmax ignores a constant added to a query's logits),
  which Adam's sign-like step turns into +-lr: those within 2*lr*steps;
- amp=True: losses within 2e-2 relative, params within 2*lr*steps;
- gradient accumulation k=2 over two half batches equals one step on the
  whole batch (as tests/test_runner.py holds the JAX trainer; the noise
  elements within 2*lr);
- under autograd the causal prefill takes mha, and llama.forward's
  unbound layers compute what indexing does.
"""

import jax
import numpy as np
import pytest
import torch

from llava_align_tpu.config import LlavaConfig as JConfig
from llava_align_tpu.constants import IMAGE_TOKEN_INDEX
from llava_align_tpu.train import trainer as jtrainer
from llava_align_tpu_torch.config import LlavaConfig as TConfig
from llava_align_tpu_torch.framework.optims import tree_leaves
from llava_align_tpu_torch.models import llama as tllama
from llava_align_tpu_torch.ops import attention as tattn
from llava_align_tpu_torch.train import trainer as ttrainer
from llava_align_tpu_torch.utils.jax_params import from_jax_params
from llava_align_tpu_torch.utils.synthetic import build_random_llava_params

LR = 1e-4
STEPS = 3


def _samples(cfg, n=4, seed=0):
    H = cfg.vision.image_size
    rng = np.random.default_rng(seed)
    return [{"input_ids": [1, 5, IMAGE_TOKEN_INDEX, 7 + i, 8, 9 + (i % 3), 11][: 5 + i % 3],
             "images": rng.normal(size=(3, H, H)).astype(np.float32)} for i in range(n)]


def _numpy_tree(tree):
    return {k: _numpy_tree(v) for k, v in tree.items()} if isinstance(tree, dict) else (
        [_numpy_tree(v) for v in tree] if isinstance(tree, list) else tree.numpy())


@pytest.fixture(scope="module")
def setup():
    """Both configs, a random tiny fp32 tree as numpy (drawn by the port's
    builder, which has llava.init's tree and scales: no JAX compile), the
    samples and JAX's batch."""
    jcfg, tcfg = JConfig.tiny(vocab_size=64), TConfig.tiny(vocab_size=64)
    params = _numpy_tree(build_random_llava_params(tcfg, device="cpu"))
    samples = _samples(jcfg)
    return jcfg, tcfg, params, samples, jtrainer.build_train_batch(jcfg, samples, pad_to=16)


def _port(params):
    return from_jax_params(params, device="cpu")


def _tbatch(tcfg, samples, pad_to=16):
    return ttrainer.batch_to_device(ttrainer.build_train_batch(tcfg, samples, pad_to), "cpu")


def test_build_train_batch_exact(setup):
    jcfg, tcfg, _, samples, want = setup
    for pad_to in (16, 21):
        want = jtrainer.build_train_batch(jcfg, samples, pad_to)
        got = ttrainer.build_train_batch(tcfg, samples, pad_to)
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k


def test_loss_and_grads_match_jax(setup):
    jcfg, tcfg, params, samples, batch = setup
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtrainer.multimodal_lm_loss(p, jcfg, batch, attn_impl="xla")))(params)
    tp = _port(params)
    leaves = ttrainer.trainable_leaves(tp)
    loss = ttrainer.multimodal_lm_loss(tp, tcfg, _tbatch(tcfg, samples))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-6 * abs(float(jloss))
    want = jax.tree_util.tree_leaves_with_path(jax.device_get(jgrads))
    assert len(want) == len(grads)
    floor = 1e-6 * max(np.abs(w).max() for _, w in want)
    noise = set()
    for (path, w), g in zip(want, grads):
        g = np.zeros_like(w) if g is None else g.numpy()
        scale = np.abs(w).max()
        if scale < floor:  # rounding noise or zero on both sides
            noise.add(jax.tree_util.keystr(path))
            assert np.abs(g).max() < floor, jax.tree_util.keystr(path)
        else:
            assert np.abs(g - w).max() <= 1e-5 * scale, (jax.tree_util.keystr(path), np.abs(g - w).max(), scale)
    # the CLIP key bias (exactly zero in exact arithmetic) and the post-LN,
    # which select_layer -2 never runs
    assert noise == {"['vision']['layers']['k']['bias']", "['vision']['post_ln']['bias']",
                     "['vision']['post_ln']['scale']"}, noise


def _jax_steps(jcfg, params, opt, batch, amp=False, steps=STEPS):
    step = jtrainer.make_train_step(jcfg, opt, attn_impl="xla", donate=False, amp=amp)
    p, s, losses = params, opt.init(params), []
    for _ in range(steps):
        p, s, loss = step(p, s, batch)
        losses.append(float(loss))
    return jax.device_get(p), jax.device_get(s), losses


def _port_steps(tcfg, params, opt, batch, amp=False, steps=STEPS):
    step = ttrainer.make_train_step(tcfg, opt, amp=amp)
    p = _port(params)
    s, losses = opt.init(p), []
    for _ in range(steps):
        p, s, loss = step(p, s, batch)
        losses.append(float(loss))
    return p, s, losses


def _noise_elements(nu_leaves):
    """Per leaf, the elements whose gradient RMS (from Adam's nu) is not
    zero but below 1e-6 of the tree's largest: float rounding noise, which
    Adam's sign-like step turns into up to +-lr."""
    rms = [np.sqrt(np.asarray(n, np.float64)) for n in nu_leaves]
    top = max(r.max() for r in rms)
    return [(r > 0) & (r < 1e-6 * top) for r in rms]


def _jax_nu(jstate):
    adam = next(x for x in jax.tree_util.tree_leaves(jstate, is_leaf=lambda n: hasattr(n, "nu"))
                if hasattr(x, "nu"))
    return jax.tree_util.tree_leaves(adam.nu)


def test_three_steps_match_jax(setup):
    jcfg, tcfg, params, samples, batch = setup
    kw = dict(lr=LR, warmup_steps=1, total_steps=10, weight_decay=0.05, max_grad_norm=1.0)
    want_p, want_s, want_l = _jax_steps(jcfg, params, jtrainer.make_optimizer(**kw), batch)
    got_p, got_s, got_l = _port_steps(tcfg, params, ttrainer.make_optimizer(**kw), _tbatch(tcfg, samples))
    np.testing.assert_allclose(got_l, want_l, rtol=1e-6)
    assert want_l[2] < want_l[0]  # the model moved (the first update is zero: warm-up from 0)
    assert got_s["count"] == STEPS
    noise = _noise_elements(_jax_nu(want_s))
    n_noise = 0
    for (path, w), g, nz in zip(jax.tree_util.tree_leaves_with_path(want_p), tree_leaves(got_p), noise):
        d = np.abs(g.detach().numpy() - w)
        n_noise += int(nz.sum())
        assert d[~nz].max(initial=0) <= 1e-5, (jax.tree_util.keystr(path), d[~nz].max())
        assert d[nz].max(initial=0) <= 2 * LR * STEPS, jax.tree_util.keystr(path)
    n_all = sum(x.size for x in jax.tree_util.tree_leaves(want_p))
    assert n_noise < 1e-3 * n_all, (n_noise, n_all)


def test_amp_steps_match_jax(setup):
    jcfg, tcfg, params, samples, batch = setup
    kw = dict(lr=LR, warmup_steps=0, total_steps=10, max_grad_norm=1.0)
    want_p, _, want_l = _jax_steps(jcfg, params, jtrainer.make_optimizer(**kw), batch, amp=True)
    got_p, _, got_l = _port_steps(tcfg, params, ttrainer.make_optimizer(**kw), _tbatch(tcfg, samples), amp=True)
    np.testing.assert_allclose(got_l, want_l, rtol=2e-2)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want_p), tree_leaves(got_p)):
        assert g.dtype == torch.float32  # the fp32 masters
        assert np.abs(g.detach().numpy() - w).max() <= 2 * LR * STEPS, jax.tree_util.keystr(path)


def test_grad_accumulation_matches_big_batch(setup):
    """The mean of the two half batches' gradients is the whole batch's
    only when the halves hold as many label tokens (the loss divides by its
    batch's count): the samples of tests/test_runner.py's JAX twin, all of
    one length."""
    _, tcfg, params, _, _ = setup
    H = tcfg.vision.image_size
    rng = np.random.default_rng(0)
    samples = [{"input_ids": [1, 5, IMAGE_TOKEN_INDEX, 7 + i, 8, 9],
                "images": rng.normal(size=(3, H, H)).astype(np.float32)} for i in range(4)]
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=10, schedule="constant")
    opt = ttrainer.make_optimizer(**kw)
    p_big, s_big, _ = _port_steps(tcfg, params, opt, _tbatch(tcfg, samples), steps=1)

    opt2 = ttrainer.make_optimizer(**kw, accum_steps=2)
    step2 = ttrainer.make_train_step(tcfg, opt2)
    p_acc = _port(params)
    s2 = opt2.init(p_acc)
    p_acc, s2, _ = step2(p_acc, s2, _tbatch(tcfg, samples[:2]))
    for a, b in zip(tree_leaves(p_acc), tree_leaves(_port(params))):  # the first micro-step changes nothing
        assert torch.equal(a.detach(), b)
    assert s2["count"] == 0 and s2["mini_step"] == 1
    p_acc, s2, _ = step2(p_acc, s2, _tbatch(tcfg, samples[2:]))
    assert s2["count"] == 1 and s2["mini_step"] == 0
    noise = _noise_elements([n.numpy() for n in tree_leaves(s_big["nu"])])
    for a, b, nz in zip(tree_leaves(p_acc), tree_leaves(p_big), noise):
        a, b = a.detach().numpy(), b.detach().numpy()
        np.testing.assert_allclose(a[~nz], b[~nz], atol=2e-5, rtol=1e-4)
        assert np.abs(a[nz] - b[nz]).max(initial=0) <= 2 * 1e-3
    n_all = sum(x.numel() for x in tree_leaves(p_big))
    assert sum(int(nz.sum()) for nz in noise) < 1e-3 * n_all


def test_autograd_takes_mha_and_unbound_layers(setup, monkeypatch):
    """Under grad, causal_attention('auto') takes mha where it would take
    K3 (whose wrapper is swapped here for one that raises), and
    llama.forward over unbind views equals the no-grad forward exactly."""
    _, tcfg, params, _, _ = setup
    assert tattn.causal_attention_impl(128, 32, 32, torch.bfloat16) == "pallas"
    assert tattn.causal_attention_impl(128, 32, 32, torch.bfloat16, needs_grad=True) == "xla"

    def no_kernel(*a, **k):
        raise AssertionError("flash_attention reached")

    monkeypatch.setattr(tattn, "flash_attention", no_kernel)
    q = torch.randn(1, 9, 2, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), pytest.raises(AssertionError, match="reached"):
        tattn.causal_attention(q, q, q)  # Dh 64 without grad: K3
    qg = q.clone().requires_grad_(True)
    out = tattn.causal_attention(qg, qg, qg)
    (g,) = torch.autograd.grad(out.square().sum(), [qg])
    assert g.abs().sum() > 0
    torch.testing.assert_close(out.detach(), tattn.mha(q, q, q, causal=True), rtol=0, atol=0)

    tp = _port(params)["llama"]
    S = 9
    emb = torch.randn(2, S, tcfg.text.hidden_size, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(S).expand(2, S)
    with torch.no_grad():
        want, _ = tllama.forward(tp, tcfg.text, emb, pos)
    ttrainer.trainable_leaves(tp)
    got, _ = tllama.forward(tp, tcfg.text, emb, pos)
    assert torch.equal(got.detach(), want)
    (g,) = torch.autograd.grad(got.square().sum(), [tp["layers"]["q"]])
    assert g.shape == tp["layers"]["q"].shape and bool((g.abs().sum(dim=(1, 2)) > 0).all())
