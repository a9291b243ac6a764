"""Port parity: greedy DecodeEngine.generate of llava_align_tpu_torch is
token-exact against the JAX DecodeEngine, for every VDD branch layout in
branch_kinds, on the fp32 tiny params and on their int8-fused quantization.

first_scores_top_probs agree within 1e-5: fp32 on both sides, softmax of
fused logits whose inputs differ by ~1e-7. The sampled path cannot match
jax.random token for token; it is checked for reproducibility under one
torch.Generator seed.
"""

import jax
import numpy as np
import pytest
import torch

from llava_align_tpu.config import GenerationConfig as JGen
from llava_align_tpu.config import LlavaConfig as JCfg
from llava_align_tpu.constants import IMAGE_TOKEN_INDEX
from llava_align_tpu.decoding.engine import DecodeEngine as JEngine
from llava_align_tpu.models import llava as jllava
from llava_align_tpu.ops.quant import quantize_llama_params
from llava_align_tpu_torch.config import GenerationConfig as TGen
from llava_align_tpu_torch.config import LlavaConfig as TCfg
from llava_align_tpu_torch.decoding.engine import DecodeEngine as TEngine
from llava_align_tpu_torch.decoding.engine import branch_kinds
from llava_align_tpu_torch.utils.jax_params import from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

JCFG, TCFG = JCfg.tiny(vocab_size=97), TCfg.tiny(vocab_size=97)
IDS = [1, 40, 50, IMAGE_TOKEN_INDEX, 60, 70, 80]
LAYOUTS = {
    "plain": {},
    "use_dd": {"use_dd": True},
    "use_dd_unk": {"use_dd_unk": True},
    "dual": {"use_dd": True, "use_dd_unk": True},
}


@pytest.fixture(scope="module")
def trees():
    jp = jax.device_get(jllava.init(jax.random.PRNGKey(0), JCFG))
    jq = dict(jp, llama=jax.device_get(quantize_llama_params(jp["llama"], fuse=True)))
    return {"fp32": (jp, from_jax_params(jp, device="cpu")),
            "int8_fused": (jq, from_jax_params(jq, device="cpu"))}


@pytest.fixture(scope="module")
def image():
    H = JCFG.vision.image_size
    return np.random.default_rng(1).integers(0, 256, (3, H, H), dtype=np.uint8)


def _gen(cls, **kw):
    return cls(max_new_tokens=6, do_sample=False, eos_token_id=2, cd_alpha=1.0, cd_beta=0.1, **kw)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("tree", ["fp32", "int8_fused"])
def test_greedy_token_exact_vs_jax(trees, image, tree, layout):
    jp, tp = trees[tree]
    flags = LAYOUTS[layout]
    want = JEngine(jp, JCFG, _gen(JGen, **flags), attn_impl="xla", bucket=16).generate(IDS, image)
    engine = TEngine(tp, TCFG, _gen(TGen, **flags), bucket=16)
    assert engine.kinds == branch_kinds(_gen(TGen, **flags))
    got = engine.generate(IDS, image)
    assert got.token_ids == want.token_ids
    assert got.num_generated == want.num_generated
    assert got.prompt_length == want.prompt_length
    np.testing.assert_allclose(got.first_scores_top_probs, want.first_scores_top_probs,
                               rtol=0, atol=1e-5)
    assert got.first_scores_top_ids[0] == want.first_scores_top_ids[0]


def test_sampled_path_reproducible_under_one_seed(trees, image):
    tp = trees["fp32"][1]
    gen = TGen(max_new_tokens=8, do_sample=True, temperature=0.9, top_k=20, top_p=0.9,
               use_dd=True, use_dd_unk=True, cd_alpha=1.0, cd_beta=0.1, eos_token_id=10**9)
    engine = TEngine(tp, TCFG, gen, bucket=16)
    runs = [engine.generate(IDS, image, generator=torch.Generator().manual_seed(7)).token_ids
            for _ in range(2)]
    assert runs[0] == runs[1] and len(runs[0]) == 8
    # the default generator is seeded from gen.seed
    assert engine.generate(IDS, image).token_ids == engine.generate(IDS, image).token_ids


def test_stop_keyword_truncates(trees, image):
    tp = trees["fp32"][1]
    gen = _gen(TGen, use_dd=True, use_dd_unk=True)
    full = TEngine(tp, TCFG, gen, bucket=16).generate(IDS, image).token_ids
    kw = full[1:3]
    stopped = TEngine(tp, TCFG, gen, bucket=16, stop_keyword_ids=[kw]).generate(IDS, image)
    first = next(i for i in range(2, len(full) + 1) if full[i - 2 : i] == kw)
    assert stopped.token_ids == full[:first]


def test_second_image_sentinel_is_refused(trees, image):
    engine = TEngine(trees["fp32"][1], TCFG, _gen(TGen, use_dd=True), bucket=16)
    with pytest.raises(ValueError):
        engine.generate(IDS + [IMAGE_TOKEN_INDEX], image)
    # with no image, plan_splice drops the sentinels, as in the JAX engine
    assert engine.generate(IDS + [IMAGE_TOKEN_INDEX], None).num_generated >= 1
