"""Port parity for the OPT and MPT decoders and the LLaVA-MPT adapter:
llava_align_tpu_torch against the JAX package on the tiny configs, the JAX
params carried over (utils/jax_params), fp32 on the CPU.

- opt.forward and mpt.forward, prefill into a cache then decode steps,
  hidden states within 1e-5 (MPT in MHA and MQA, with qk_ln, clip_qkv and a
  prefix mask); the tied heads' logits too;
- OPT's learned-position gather past its table (bucket pads and decode
  positions beyond max_position_embeddings + 2) and at negative indices,
  exactly as a JAX gather normalizes them;
- LLaVA-MPT through DecodeEngine.generate and generate_batch: greedy, dual
  VDD and VCD (one numpy eps injected into both engines' noise), tokens
  exact and first-step top probabilities within 1e-5; act_quant and
  kv_quant warned and ignored with the same tokens; generate_batch_groups
  refused as in JAX;
- the configs, and the port's random trees against the JAX inits.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llava_align_tpu.config import GenerationConfig as JGen
from llava_align_tpu.constants import IMAGE_TOKEN_INDEX
from llava_align_tpu.decoding import engine as jengine_mod
from llava_align_tpu.decoding.adapters import LlavaMptAdapter as JAdapter
from llava_align_tpu.decoding.engine import DecodeEngine as JEngine
from llava_align_tpu.models import llava_mpt as jlm
from llava_align_tpu.models import mpt as jmpt
from llava_align_tpu.models import opt as jopt
from llava_align_tpu.ops import noise as jnoise
from llava_align_tpu_torch.config import GenerationConfig as TGen
from llava_align_tpu_torch.decoding import engine as tengine_mod
from llava_align_tpu_torch.decoding.adapters import LlavaMptAdapter as TAdapter
from llava_align_tpu_torch.decoding.engine import DecodeEngine as TEngine
from llava_align_tpu_torch.models import llava_mpt as tlm
from llava_align_tpu_torch.models import mpt as tmpt
from llava_align_tpu_torch.models import opt as topt
from llava_align_tpu_torch.ops import noise as tnoise
from llava_align_tpu_torch.utils import synthetic
from llava_align_tpu_torch.utils.jax_params import from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False

TOL = 1e-5
EOS = 2
S = IMAGE_TOKEN_INDEX


def perturb(tree, seed):
    """Every float leaf + N(0, 0.1): biases and norms that are no no-op.
    Device arrays, so that the JAX functions index them as JAX does."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a)), jnp.float32), tree)


def close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def run_steps(fwd_j, fwd_t, init_j, init_t, embeds: np.ndarray, steps: np.ndarray, prefill_len, **kw):
    """Prefill `embeds` [B, S, D] into a cache, then one decode step per
    column of steps [B, n, D] at each row's length; the hidden states of
    every call compared."""
    B, Sq, _ = embeds.shape
    n = steps.shape[1]
    pos = np.broadcast_to(np.arange(Sq), (B, Sq)).astype(np.int32)
    jc, tc = init_j(B, Sq + n), init_t(B, Sq + n)
    hj, jc = fwd_j(jnp.asarray(embeds), jnp.asarray(pos), jc, jnp.zeros((B,), jnp.int32), **kw)
    ht, tc = fwd_t(torch.from_numpy(embeds), torch.from_numpy(pos), tc, torch.zeros((B,), dtype=torch.long),
                   **{k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()})
    close(ht, hj)
    lengths = np.asarray(prefill_len, np.int32)
    for i in range(n):
        e = steps[:, i : i + 1]
        hj, jc = fwd_j(jnp.asarray(e), jnp.asarray(lengths[:, None]), jc, jnp.asarray(lengths))
        ht, tc = fwd_t(torch.from_numpy(e), torch.from_numpy(lengths[:, None]), tc, torch.from_numpy(lengths))
        close(ht, hj)
        lengths = lengths + 1
    return ht, hj


# ---------------------------------------------------------------------------
# OPT
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def opt_trees():
    jcfg = jopt.OptConfig.tiny(vocab_size=97)
    jp = perturb(jax.device_get(jopt.init(jax.random.PRNGKey(0), jcfg)), 1)
    return jcfg, topt.OptConfig.tiny(vocab_size=97), jp, from_jax_params(jp, device="cpu")


@pytest.mark.parametrize("seq", [9, 137], ids=["short", "past_table"])
def test_opt_forward_prefill_and_decode_vs_jax(opt_trees, seq):
    """past_table: a 137-row prefill and decode positions up to 139 read
    the 130-row position table at up to 141: clamped, as JAX clamps."""
    jcfg, tcfg, jp, tp = opt_trees
    rng = np.random.default_rng(2)
    D = jcfg.hidden_size
    embeds = rng.standard_normal((2, seq, D)).astype(np.float32)
    steps = rng.standard_normal((2, 3, D)).astype(np.float32)
    ht, hj = run_steps(
        lambda *a: jopt.forward(jp, jcfg, *a, attn_impl="xla"), lambda *a: topt.forward(tp, tcfg, *a),
        lambda b, n: jopt.init_cache(jcfg, b, n), lambda b, n: topt.init_cache(tcfg, b, n, device="cpu"),
        embeds, steps, [seq - 2, seq])
    close(topt.logits_from_hidden(tp, ht), jopt.logits_from_hidden(jp, hj))


def test_opt_position_gather_matches_jax_index_rules():
    table = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    idx = np.array([[-12, -10, -3, -1, 0, 4, 9, 10, 11, 300]], np.int32)
    want = np.asarray(jnp.asarray(table)[jnp.asarray(idx)])
    got = topt.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# MPT
# ---------------------------------------------------------------------------

MPT_CASES = {  # config changes, with a prefix mask
    "mha": ({}, False),
    "mqa": ({"multiquery": True}, False),
    "qk_ln": ({"qk_ln": True}, False),
    "mqa_qk_ln_clip": ({"multiquery": True, "qk_ln": True, "clip_qkv": 0.5}, False),
    "prefix_lm": ({}, True),
}


@pytest.mark.parametrize("case", list(MPT_CASES))
def test_mpt_forward_prefill_and_decode_vs_jax(case):
    changes, prefix = MPT_CASES[case]
    jcfg = dataclasses.replace(jmpt.MptConfig.tiny(vocab_size=97), **changes)
    tcfg = dataclasses.replace(tmpt.MptConfig.tiny(vocab_size=97), **changes)
    jp = perturb(jax.device_get(jmpt.init(jax.random.PRNGKey(3), jcfg)), 4)
    tp = from_jax_params(jp, device="cpu")
    rng = np.random.default_rng(5)
    D, Sq = jcfg.d_model, 11
    embeds = rng.standard_normal((2, Sq, D)).astype(np.float32)
    steps = rng.standard_normal((2, 2, D)).astype(np.float32)
    kw = {}
    if prefix:
        kw["prefix_mask"] = np.arange(Sq)[None, :] < np.array([[4], [7]])
    ht, hj = run_steps(
        lambda *a, **k: jmpt.forward(jp, jcfg, *a, **k), lambda *a, **k: tmpt.forward(tp, tcfg, *a, **k),
        lambda b, n: jmpt.init_cache(jcfg, b, n), lambda b, n: tmpt.init_cache(tcfg, b, n, device="cpu"),
        embeds, steps, [Sq - 3, Sq], **kw)
    close(tmpt.logits_from_hidden(tp, ht), jmpt.logits_from_hidden(jp, hj))
    np.testing.assert_array_equal(tmpt.alibi_slopes(12), jmpt.alibi_slopes(12))


# ---------------------------------------------------------------------------
# LLaVA-MPT through the engine
# ---------------------------------------------------------------------------

JCFG, TCFG = jlm.LlavaMptConfig.tiny(vocab_size=211), tlm.LlavaMptConfig.tiny(vocab_size=211)
H = JCFG.vision.image_size
PROMPTS = ([1, 17, 23, S, 31, 37, 41], [1, 19, S, 29, 31], [1, 5, S, 7, 9, 11, 13, 15, 17])
LAYOUTS = {
    "greedy": {},
    "dual_vdd": {"use_dd": True, "use_dd_unk": True},
    "vcd": {"use_cd": True},
}


def _gen(cls, **kw):
    return cls(max_new_tokens=5, do_sample=False, eos_token_id=EOS, cd_alpha=1.0, cd_beta=0.1,
               noise_step=500, **kw)


@pytest.fixture(scope="module")
def mpt_trees():
    jp = perturb(jax.device_get(jlm.init(jax.random.PRNGKey(6), JCFG)), 7)
    return jp, from_jax_params(jp, device="cpu")


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(8)
    return [rng.integers(0, 256, (3, H, H), dtype=np.uint8) for _ in range(3)]


@pytest.fixture
def inject(monkeypatch):
    """inject(eps_jax, eps_port): both engines' diffusion noise from numpy
    eps (the JAX engine noises every image slot, the port the slots a row
    takes)."""

    def set_eps(eps_jax, eps_port):
        def jax_noise(images, rng, noise_step):
            sqrt_ab, sqrt_1m_ab = (jnp.asarray(a) for a in jnoise.diffusion_schedule())
            out = sqrt_ab[noise_step] * images.astype(jnp.float32) + sqrt_1m_ab[noise_step] * jnp.asarray(eps_jax)
            return out.astype(images.dtype)

        def port_noise(images, noise_step, generator=None):
            return tnoise.add_diffusion_noise(images, noise_step, eps=torch.from_numpy(eps_port))

        monkeypatch.setattr(jengine_mod, "add_diffusion_noise", jax_noise)
        monkeypatch.setattr(tengine_mod, "add_diffusion_noise", port_noise)

    return set_eps


def assert_match(got, want):
    got, want = (x if isinstance(x, list) else [x] for x in (got, want))
    assert len(got) == len(want) and want
    for o, r in zip(got, want):
        assert o.token_ids == r.token_ids
        assert (o.num_generated, o.prompt_length) == (r.num_generated, r.prompt_length)
        np.testing.assert_allclose(o.first_scores_top_probs, r.first_scores_top_probs, rtol=0, atol=1e-5)
        assert o.first_scores_top_ids[0] == r.first_scores_top_ids[0]


def _eps(n):
    return np.random.default_rng(9).standard_normal((n, 3, H, H)).astype(np.float32)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("entry", ["generate", "generate_batch"])
def test_llava_mpt_engine_token_exact_vs_jax(mpt_trees, images, inject, entry, layout):
    """generate_batch: Q = 3, question 1 without an image (its cd row has
    no image positions)."""
    jp, tp = mpt_trees
    flags = LAYOUTS[layout]
    jeng = JEngine(jp, JCFG, _gen(JGen, **flags), adapter=JAdapter(JCFG), attn_impl="xla", bucket=8)
    teng = TEngine(tp, TCFG, _gen(TGen, **flags), adapter=TAdapter(TCFG), bucket=8)
    if entry == "generate":
        inject(_eps(1), _eps(1))
        assert_match(teng.generate(PROMPTS[0], images[0]), jeng.generate(PROMPTS[0], images[0]))
    else:
        eps = _eps(3)
        inject(eps, eps[[0, 2]])
        batch = [(PROMPTS[0], images[0]), (PROMPTS[1], None), (PROMPTS[2], images[2])]
        assert_match(teng.generate_batch(batch), jeng.generate_batch(batch))


def test_llava_mpt_quant_modes_warned_and_ignored(mpt_trees, images, caplog):
    _, tp = mpt_trees
    gen = _gen(TGen, use_dd=True, use_dd_unk=True)
    want = TEngine(tp, TCFG, gen, adapter=TAdapter(TCFG), bucket=8).generate(PROMPTS[0], images[0])
    with caplog.at_level(logging.WARNING):
        eng = TEngine(tp, TCFG, gen, adapter=TAdapter(TCFG), bucket=8, act_quant=True, kv_quant="int8")
    assert "act_quant requested" in caplog.text and "kv_quant requested" in caplog.text
    assert not (eng.adapter.act_quant or eng.adapter.kv_quant)
    assert eng.generate(PROMPTS[0], images[0]).token_ids == want.token_ids
    with pytest.raises(ValueError, match="no shared-prefix forward"):
        eng.generate_batch_groups([(PROMPTS[0][:4], [PROMPTS[0][4:]], images[0])])


def test_llava_mpt_adapter_matches_jax(mpt_trees, images):
    jp, tp = mpt_trees
    ja, ta = JAdapter(JCFG), TAdapter(TCFG)
    for kind in ("main", "cd", "unk", "none"):
        assert ta.branch_token_ids(PROMPTS[0], kind) == ja.branch_token_ids(PROMPTS[0], kind)
    assert (ta.num_image_tokens, ta.image_size, ta.num_kv_heads) == (ja.num_image_tokens, ja.image_size,
                                                                      ja.num_kv_heads)
    for flag in ("supports_shared_prefix", "supports_act_quant", "supports_kv_quant"):
        assert getattr(ta, flag) is getattr(ja, flag) is False, flag
    pix = (images[0].astype(np.float32)[None] / 255.0 - 0.5)
    close(ta.encode_images(tp, torch.from_numpy(pix)), ja.encode_images(jp, jnp.asarray(pix)))


# ---------------------------------------------------------------------------
# configs and random trees
# ---------------------------------------------------------------------------


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _leaves(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _leaves(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _same_tree(got, want):
    want, got = _leaves(want), _leaves(got)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == np.shape(w) and got[k].dtype == torch.float32, k
        if k.endswith(("/scale", "/b", "/bias")):
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)  # ones and zeros


@pytest.mark.parametrize("family", ["opt", "mpt", "mpt_mqa_qk_ln", "llava_mpt"])
def test_random_trees_match_jax_init(family):
    key = jax.random.PRNGKey(0)
    if family == "opt":
        want = jopt.init(key, jopt.OptConfig.tiny())
        got = synthetic.build_random_opt_params(topt.OptConfig.tiny(), device="cpu")
    elif family == "llava_mpt":
        want = jlm.init(key, jlm.LlavaMptConfig.tiny())
        got = tlm.init(tlm.LlavaMptConfig.tiny(), device="cpu")
    else:
        kw = {} if family == "mpt" else {"multiquery": True, "qk_ln": True}
        want = jmpt.init(key, dataclasses.replace(jmpt.MptConfig.tiny(), **kw))
        got = synthetic.build_random_mpt_params(dataclasses.replace(tmpt.MptConfig.tiny(), **kw), device="cpu")
    _same_tree(got, jax.device_get(want))


def test_configs_match_jax():
    for jc, tc in ((jopt.OptConfig.opt_2_7b(), topt.OptConfig.opt_2_7b()), (jopt.OptConfig.tiny(), topt.OptConfig.tiny()),
                   (jmpt.MptConfig.mpt_7b(), tmpt.MptConfig.mpt_7b()), (jmpt.MptConfig.tiny(), tmpt.MptConfig.tiny())):
        j, t = dataclasses.asdict(jc), dataclasses.asdict(tc)
        j.pop("dtype"), t.pop("dtype")
        assert j == t
    full = tlm.LlavaMptConfig()
    assert (full.text.head_dim, full.text.ffn_dim, full.text.hidden_size, full.num_image_tokens) == (128, 16384, 4096, 576)
    assert topt.OptConfig.opt_2_7b().head_dim == 80
