"""Port parity for the InstructBLIP adapter and the engine on its features
(mirrors tests/test_instructblip_engine.py against the JAX package): the
Q-Former streams come from instructblip.encode in each package on the same
params and inputs, and greedy DecodeEngine.generate with precomputed_feats
is token-exact against the JAX engine, first-step top probabilities within
1e-5 (fp32 both sides), in the plain, VCD and 'none' (use_dd) cases and
for a text-only prompt with dummy features (the POPE runner's 'none'
score). For VCD the noised image's stream is encoded in each package from
one numpy eps (the noise is the one thing the two draw differently), and
the engines get [main, cd] feature rows, the contrast working on
embeddings. Also the adapter's branch ids, its refusals and its splice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llava_align_tpu.config import GenerationConfig as JGen
from llava_align_tpu.constants import IMAGE_TOKEN_INDEX
from llava_align_tpu.decoding.adapters import InstructBlipAdapter as JAdapter
from llava_align_tpu.decoding.engine import DecodeEngine as JEngine
from llava_align_tpu.models import instructblip as jblip
from llava_align_tpu.models import llava as jllava
from llava_align_tpu.ops import noise as jnoise
from llava_align_tpu_torch.config import GenerationConfig as TGen
from llava_align_tpu_torch.decoding.adapters import InstructBlipAdapter as TAdapter
from llava_align_tpu_torch.decoding.engine import DecodeEngine as TEngine
from llava_align_tpu_torch.models import instructblip as tblip
from llava_align_tpu_torch.ops import noise as tnoise
from llava_align_tpu_torch.utils.jax_params import from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False

JCFG, TCFG = jblip.InstructBlipConfig.tiny(vocab_size=128), tblip.InstructBlipConfig.tiny(vocab_size=128)
EOS = 2
IDS = [IMAGE_TOKEN_INDEX, 1, 40, 50, 60]
NOISE_STEP = 500


@pytest.fixture(scope="module")
def setup():
    jp = jax.device_get(jblip.init(jax.random.PRNGKey(0), JCFG))
    tp = from_jax_params(jp, device="cpu")
    rng = np.random.default_rng(1)
    image = rng.standard_normal((1, 3, 28, 28)).astype(np.float32)
    eps = rng.standard_normal((1, 3, 28, 28)).astype(np.float32)
    qtext = np.array([[5, 6, 7, 8]], np.int32)
    sqrt_ab, sqrt_1m_ab = jnoise.diffusion_schedule()
    j_noised = jnp.asarray(sqrt_ab[NOISE_STEP] * image + sqrt_1m_ab[NOISE_STEP] * eps)
    t_noised = tnoise.add_diffusion_noise(torch.from_numpy(image), NOISE_STEP, eps=torch.from_numpy(eps))
    jencode = jax.jit(lambda p, img: jblip.encode(p, JCFG, img, jnp.asarray(qtext)))
    jfeats = np.concatenate([np.asarray(jencode(jp, jnp.asarray(image))), np.asarray(jencode(jp, j_noised))])
    with torch.inference_mode():
        tfeats = torch.cat([tblip.encode(tp, TCFG, torch.from_numpy(image), torch.from_numpy(qtext)),
                            tblip.encode(tp, TCFG, t_noised, torch.from_numpy(qtext))])
    np.testing.assert_allclose(tfeats.numpy(), jfeats, rtol=1e-5, atol=1e-5)
    return jp, tp, jfeats, tfeats


CASES = {  # (GenerationConfig flags, feature rows, prompt)
    "plain": ({}, 1, IDS),
    "vcd": ({"use_cd": True, "cd_alpha": 1.0, "cd_beta": 0.1}, 2, IDS),
    "none": ({"use_dd": True, "cd_alpha": 1.0, "cd_beta": 0.1}, 1, IDS),
    "text_only": ({}, 0, IDS[1:]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_generate_precomputed_feats_token_exact_vs_jax(setup, case):
    jp, tp, jfeats, tfeats = setup
    flags, rows, ids = CASES[case]
    if rows:
        jf, tf = jfeats[:rows], tfeats[:rows]
    else:  # the dummy features of a prompt without a sentinel
        jf = tf = np.zeros((1, 1, JCFG.text.hidden_size), np.float32)
    kw = dict(max_new_tokens=5, do_sample=False, eos_token_id=EOS, **flags)
    want = JEngine(jp, JCFG, JGen(**kw), adapter=JAdapter(JCFG), attn_impl="xla", bucket=8).generate(
        ids, None, precomputed_feats=jf)
    teng = TEngine(tp, TCFG, TGen(**kw), adapter=TAdapter(TCFG), bucket=8)
    got = teng.generate(ids, None, precomputed_feats=tf)
    assert teng.kinds == {"plain": ["main"], "vcd": ["main", "cd"], "none": ["main", "none"],
                          "text_only": ["main"]}[case]
    assert got.token_ids == want.token_ids
    assert got.num_generated == want.num_generated and got.prompt_length == want.prompt_length
    np.testing.assert_allclose(got.first_scores_top_probs, want.first_scores_top_probs, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.first_scores_top_ids[:3], want.first_scores_top_ids[:3])


def test_vcd_needs_the_cd_features(setup):
    _, tp, _, tfeats = setup
    gen = TGen(max_new_tokens=2, do_sample=False, eos_token_id=EOS, use_cd=True)
    with pytest.raises(ValueError, match="2 rows"):
        TEngine(tp, TCFG, gen, adapter=TAdapter(TCFG), bucket=8).generate(IDS, None, precomputed_feats=tfeats[:1])


def test_adapter_matches_jax(setup):
    jp, tp, jfeats, tfeats = setup
    ja, ta = JAdapter(JCFG), TAdapter(TCFG)
    for kind in ("main", "cd", "none"):
        assert ta.branch_token_ids(IDS, kind) == ja.branch_token_ids(IDS, kind)
    assert ta.branch_token_ids(IDS, "none") == [1, 40, 50, 60]
    for a in (ja, ta):
        with pytest.raises(ValueError, match="does not define branch 'unk'"):
            a.branch_token_ids(IDS, "unk")
    with pytest.raises(NotImplementedError, match="precomputed_feats"):
        ta.encode_images(tp, torch.zeros((1, 3, 28, 28)))
    assert (ta.num_image_tokens, ta.image_size, ta.num_kv_heads) == (ja.num_image_tokens, ja.image_size,
                                                                      ja.num_kv_heads)
    plan = jllava.plan_splice(IDS, JCFG.num_query_tokens, 16)
    arrs = [np.asarray(x)[None] for x in (plan.tokens, plan.tok_gather, plan.img_gather, plan.is_image)]
    want = ja.splice_embeds(jp, *(jnp.asarray(a) for a in arrs), jnp.asarray(jfeats[:1]))
    got = ta.splice_embeds(tp, *(torch.from_numpy(a) for a in arrs), torch.from_numpy(jfeats[:1]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))  # gathers only
