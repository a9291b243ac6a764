"""Port parity for VCD (use_cd) and `generate`'s other inputs: greedy
DecodeEngine decodes of llava_align_tpu_torch are token-exact against the
JAX DecodeEngine on LlavaConfig.tiny, for the fp32 tree and its int8-fused
and int4-fused quantizations, with use_cd alone and with use_cd + use_dd +
use_dd_unk, through `generate`, `generate_batch` (Q = 3, one question
without an image) and `generate_batch_groups` (G = 2 x Qg = 3).

The diffusion noise is the one thing the two engines draw differently
(jax.random against a torch.Generator), so both are given one eps made with
numpy: each engine's module attribute `add_diffusion_noise` is replaced by
the schedule applied to that eps (the JAX engine noises every image slot of
a batch, zero placeholders included; the port only the images a row takes,
so it is given those slots' eps).

Also `generate`'s explicit branch_ids, precomputed_feats and an anyres
[3, 3, H, W] stack, each against the JAX engine. first_scores_top_probs
agree within 1e-5: fp32 on both sides, softmax of fused logits whose
inputs differ by ~1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavis_ref import one_torch_thread  # noqa: F401 (a fixture)
from llava_align_tpu.config import GenerationConfig as JGen
from llava_align_tpu.config import LlavaConfig as JCfg
from llava_align_tpu.constants import IMAGE_TOKEN_INDEX
from llava_align_tpu.decoding import engine as jengine_mod
from llava_align_tpu.decoding.engine import DecodeEngine as JEngine
from llava_align_tpu.models import llava as jllava
from llava_align_tpu.ops import noise as jnoise
from llava_align_tpu.ops.quant import quantize_llama_params
from llava_align_tpu_torch.config import GenerationConfig as TGen
from llava_align_tpu_torch.config import LlavaConfig as TCfg
from llava_align_tpu_torch.decoding import engine as tengine_mod
from llava_align_tpu_torch.decoding.engine import DecodeEngine as TEngine
from llava_align_tpu_torch.ops import noise as tnoise
from llava_align_tpu_torch.utils.jax_params import from_jax_params

# torch on one thread: the tiny models gain nothing from more, and a thread
# per core spins at every small op (tests/lavis_ref.one_torch_thread)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EOS = 2
S = IMAGE_TOKEN_INDEX
JCFG, TCFG = JCfg.tiny(vocab_size=211), TCfg.tiny(vocab_size=211)
H = JCFG.vision.image_size
IDS = [1, 40, 50, S, 60, 70, 80]
# the second question has its sentinel but no image
PROMPTS = ([1, 17, 23, S, 31, 37, 41], [1, 19, S, 29, 31], [1, 5, S, 7, 9, 11, 13, 15, 17])
PREFIXES = ([1, 17, 23, S, 31, 37], [1, 19, S, 29, 31, 59, 61])
SUFFIXES = ([[41, 43, 53], [41, 47, 53, 59], [61, 67]], [[103, 107], [109, 113, 127], [131]])
LAYOUTS = {"cd": {"use_cd": True}, "cd_dual": {"use_cd": True, "use_dd": True, "use_dd_unk": True}}
TREES = ["fp32", "int8_fused", "int4_fused"]
NOISE_STEP = 500


def _gen(cls, max_new=5, **kw):
    return cls(max_new_tokens=max_new, do_sample=False, eos_token_id=EOS, cd_alpha=1.0,
               cd_beta=0.1, noise_step=NOISE_STEP, **kw)


@pytest.fixture(scope="module")
def trees():
    jp = jax.device_get(jllava.init(jax.random.PRNGKey(0), JCFG))
    out = {"fp32": (jp, from_jax_params(jp, device="cpu"))}
    for name, bits in (("int8_fused", 8), ("int4_fused", 4)):
        jq = dict(jp, llama=jax.device_get(quantize_llama_params(jp["llama"], fuse=True, bits=bits)))
        out[name] = (jq, from_jax_params(jq, device="cpu"))
    return out


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 256, (3, H, H), dtype=np.uint8) for _ in range(3)]


def _eps(n, seed=5):
    return np.random.default_rng(seed).standard_normal((n, 3, H, H)).astype(np.float32)


@pytest.fixture
def inject(monkeypatch):
    """inject(eps_jax, eps_port): both engines' noise from the given eps."""

    def set_eps(eps_jax, eps_port):
        def jax_noise(images, rng, noise_step):
            assert images.shape == eps_jax.shape, (images.shape, eps_jax.shape)
            sqrt_ab, sqrt_1m_ab = (jnp.asarray(a) for a in jnoise.diffusion_schedule())
            t = jnp.asarray(noise_step, jnp.int32)
            out = sqrt_ab[t] * images.astype(jnp.float32) + sqrt_1m_ab[t] * jnp.asarray(eps_jax)
            return out.astype(images.dtype)

        def port_noise(images, noise_step, generator=None):
            return tnoise.add_diffusion_noise(images, noise_step, eps=torch.from_numpy(eps_port))

        monkeypatch.setattr(jengine_mod, "add_diffusion_noise", jax_noise)
        monkeypatch.setattr(tengine_mod, "add_diffusion_noise", port_noise)

    return set_eps


def _engines(trees, tree, layout, **kw):
    jp, tp = trees[tree]
    flags = LAYOUTS[layout]
    return (JEngine(jp, JCFG, _gen(JGen, **flags), attn_impl="xla", bucket=8, **kw),
            TEngine(tp, TCFG, _gen(TGen, **flags), bucket=8, **kw))


def _assert_match(got, want):
    got, want = (x if isinstance(x, list) else [x] for x in (got, want))
    assert len(got) == len(want) and want
    for o, r in zip(got, want):
        assert o.token_ids == r.token_ids
        assert o.num_generated == r.num_generated
        assert o.prompt_length == r.prompt_length
        np.testing.assert_allclose(o.first_scores_top_probs, r.first_scores_top_probs, rtol=0, atol=1e-5)
        assert o.first_scores_top_ids[0] == r.first_scores_top_ids[0]


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("tree", TREES)
def test_generate_vcd_token_exact_vs_jax(trees, images, inject, tree, layout):
    eps = _eps(1)
    inject(eps, eps)
    jeng, teng = _engines(trees, tree, layout)
    assert teng.kinds == ["main", "cd"] + (["none"] if layout == "cd_dual" else [])
    _assert_match(teng.generate(IDS, images[0]), jeng.generate(IDS, images[0]))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("tree", TREES)
def test_generate_batch_vcd_token_exact_vs_jax(trees, images, inject, tree, layout):
    """Q = 3; question 1 has no image, so its cd row has no image positions
    and the JAX engine's zero placeholder is normalized-space zeros."""
    eps = _eps(3)
    inject(eps, eps[[0, 2]])
    batch = [(PROMPTS[0], images[0]), (PROMPTS[1], None), (PROMPTS[2], images[2])]
    jeng, teng = _engines(trees, tree, layout)
    _assert_match(teng.generate_batch(batch), jeng.generate_batch(batch))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("tree", TREES)
def test_generate_batch_groups_vcd_token_exact_vs_jax(trees, images, inject, tree, layout):
    """G = 2 groups x Qg = 3: each group's noised image prefills its own
    prefix segment; the cd rows read it."""
    eps = _eps(2)
    inject(eps, eps)
    groups = [(p, s, im) for p, s, im in zip(PREFIXES, SUFFIXES, images)]
    jeng, teng = _engines(trees, tree, layout)
    got = teng.generate_batch_groups(groups)
    assert len(got) == 6
    _assert_match(got, jeng.generate_batch_groups(groups))
    # and against the port's own generate, question by question
    inject(eps[:1], eps[:1])
    refs = [teng.generate(PREFIXES[0] + s, images[0]) for s in SUFFIXES[0]]
    for o, r in zip(got[:3], refs):
        assert o.token_ids == r.token_ids
        np.testing.assert_allclose(o.first_scores_top_probs, r.first_scores_top_probs, rtol=0, atol=1e-5)


def test_groups_without_an_image_are_refused_under_vcd(trees, images):
    _, teng = _engines(trees, "fp32", "cd")
    with pytest.raises(ValueError, match="use_cd groups need an image"):
        teng.generate_batch_groups([(PREFIXES[0], SUFFIXES[0], images[0]),
                                    (PREFIXES[1], SUFFIXES[1], None)])
    with pytest.raises(ValueError, match="use_cd groups need an image"):
        teng.generate_batch_prefix(PREFIXES[0], SUFFIXES[0], None)


def test_vcd_sampled_reproducible_under_one_seed(trees, images):
    """Sampled VCD: the noise and the samples come from one generator, so
    one seed gives one answer; another seed draws other noise."""
    tp = trees["fp32"][1]
    gen = TGen(max_new_tokens=8, do_sample=True, temperature=0.9, top_k=20, use_cd=True,
               cd_alpha=1.0, cd_beta=0.1, eos_token_id=10**9)
    engine = TEngine(tp, TCFG, gen, bucket=8)
    outs = [engine.generate(IDS, images[0], generator=torch.Generator().manual_seed(s)) for s in (7, 7)]
    assert outs[0].token_ids == outs[1].token_ids and len(outs[0].token_ids) == 8
    np.testing.assert_array_equal(outs[0].first_scores_top_probs, outs[1].first_scores_top_probs)
    other = engine.generate(IDS, images[0], generator=torch.Generator().manual_seed(8))
    assert not np.array_equal(other.first_scores_top_probs, outs[0].first_scores_top_probs)


# ---------------------------------------------------------------------------
# generate's other inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["dual", "cd_dual"])
def test_generate_branch_ids_vs_jax(trees, images, inject, layout):
    """Explicit token ids for the text branches (the MMMU runner's 'unk'
    ids, qwen's retokenized prompts)."""
    flags = {"use_dd": True, "use_dd_unk": True, **({"use_cd": True} if layout == "cd_dual" else {})}
    eps = _eps(1)
    inject(eps, eps)
    jp, tp = trees["fp32"]
    bids = {"unk": [1, 40, 50, 0, 0, 60, 70, 80], "none": [1, 50, 60, 70, 80]}
    if layout == "dual":
        bids["unk"] = [1, 40, 50, 9, 60, 70, 80]
    want = JEngine(jp, JCFG, _gen(JGen, **flags), attn_impl="xla", bucket=8).generate(
        IDS, images[0], branch_ids=bids)
    got = TEngine(tp, TCFG, _gen(TGen, **flags), bucket=8).generate(IDS, images[0], branch_ids=bids)
    _assert_match(got, want)
    plain = TEngine(tp, TCFG, _gen(TGen, **flags), bucket=8).generate(IDS, images[0])
    assert not np.array_equal(plain.first_scores_top_probs, got.first_scores_top_probs)


@pytest.mark.parametrize("layout", ["dual", "cd"])
@pytest.mark.parametrize("tree", ["fp32", "int8_fused"])
def test_generate_precomputed_feats_vs_jax(trees, tree, layout):
    """[n_srcs, N, D] features in place of the vision tower (row 1 is the
    cd row's); N need not be num_image_tokens."""
    flags = {"dual": {"use_dd": True, "use_dd_unk": True}, "cd": {"use_cd": True}}[layout]
    jp, tp = trees[tree]
    feats = np.random.default_rng(3).standard_normal((2, 6, JCFG.text.hidden_size)).astype(np.float32)
    want = JEngine(jp, JCFG, _gen(JGen, **flags), attn_impl="xla", bucket=8).generate(
        IDS, None, precomputed_feats=feats)
    engine = TEngine(tp, TCFG, _gen(TGen, **flags), bucket=8)

    def no_encode(*a, **k):
        raise AssertionError("the vision tower ran beside precomputed features")

    engine.adapter.encode_images = no_encode
    got = engine.generate(IDS, None, precomputed_feats=feats)
    _assert_match(got, want)
    assert got.prompt_length == len(IDS) - 1 + 6
    if layout == "cd":
        with pytest.raises(ValueError, match="2 rows"):
            engine.generate(IDS, None, precomputed_feats=feats[:1])


@pytest.mark.parametrize("layout", ["dual", "cd_dual"])
def test_generate_anyres_stack_vs_jax(trees, inject, layout):
    """A [3, 3, H, W] grid stack: three grids' features in one run of
    3 * num_image_tokens (and, under use_cd, three noised grids)."""
    flags = {"use_dd": True, "use_dd_unk": True, **({"use_cd": True} if layout == "cd_dual" else {})}
    eps = _eps(3)
    inject(eps, eps)
    jp, tp = trees["fp32"]
    stack = np.random.default_rng(4).standard_normal((3, 3, H, H)).astype(np.float32)
    want = JEngine(jp, JCFG, _gen(JGen, **flags), attn_impl="xla", bucket=8).generate(IDS, stack)
    got = TEngine(tp, TCFG, _gen(TGen, **flags), bucket=8).generate(IDS, stack)
    _assert_match(got, want)
    assert got.prompt_length == len(IDS) - 1 + 3 * TCFG.num_image_tokens
