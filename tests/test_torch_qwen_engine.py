"""Port parity: llava_align_tpu_torch's DecodeEngine with the QwenVLAdapter
is greedy token-exact against the JAX DecodeEngine with its QwenVLAdapter,
on QwenVLConfig.tiny (seq_length 128, dynamic NTK and log-n on) for the
fp32 tree and its int8-fused quantization, through `generate` (dual VDD,
the 'unk' branch as explicit ids, as the Qwen runners pass it),
`generate_batch` (main + 'none': the lockstep batch takes no explicit ids)
and `generate_batch_groups` (dual VDD, 'unk' ids per question: plain rows
beside the shared 'none' segments). Each entry point runs a short prompt
set, whose cache stays within seq_length, and a long one, whose cache
length passes it: ntk_alpha_for_len > 1 and log-n act at every position
past 128, and the grouped path passes the unshared paths' length.

first_scores_top_probs agree within 1e-5 (fp32 softmaxes of logits that
differ by ~1e-7); the top ids exactly.
"""

import jax
import numpy as np
import pytest
import torch

from lavis_ref import one_torch_thread  # noqa: F401 (a fixture)
from llava_align_tpu.config import GenerationConfig as JGen
from llava_align_tpu.decoding.adapters import QwenVLAdapter as JAdapter
from llava_align_tpu.decoding.engine import DecodeEngine as JEngine
from llava_align_tpu.models import qwen as jqwen
from llava_align_tpu.models import qwen_vl as jqvl
from llava_align_tpu.ops.quant import quantize_qwen_params
from llava_align_tpu_torch.config import GenerationConfig as TGen
from llava_align_tpu_torch.decoding.adapters import QwenVLAdapter as TAdapter
from llava_align_tpu_torch.decoding.engine import DecodeEngine as TEngine
from llava_align_tpu_torch.models import qwen_vl as tqvl
from llava_align_tpu_torch.utils.jax_params import from_jax_params

# torch on one thread: the tiny models gain nothing from more, and a thread
# per core spins at every small op (tests/lavis_ref.one_torch_thread)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

torch.backends.cuda.matmul.allow_tf32 = False

EOS = 2
BUCKET = 64
JCFG, TCFG = jqvl.QwenVLConfig.tiny(), tqvl.QwenVLConfig.tiny()
LENGTHS = {"short": 9, "long": 130}  # text tokens per prompt: caches of 64 + T and 192 + T


def _gen(cls, max_new=5, **kw):
    return cls(max_new_tokens=max_new, do_sample=False, eos_token_id=EOS, cd_alpha=1.0, cd_beta=0.1, **kw)


@pytest.fixture(scope="module")
def trees():
    jp = jax.device_get(jqvl.init(jax.random.PRNGKey(0), JCFG))
    b = np.random.default_rng(11).normal(size=np.shape(jp["qwen"]["layers"]["c_attn_b"])) * 0.1
    jp["qwen"]["layers"]["c_attn_b"] = b.astype(np.float32)
    jq = dict(jp, qwen=jax.device_get(quantize_qwen_params(jp["qwen"], fuse=True)))
    return {"fp32": (jp, from_jax_params(jp, device="cpu")), "int8": (jq, from_jax_params(jq, device="cpu"))}


def _prompts(length: str, n: int, seed: int):
    """n Qwen prompts [<img> span] + text (sentinelized), the later ones
    sharing the first's text but for their last 3 tokens, each with its
    'unk' ids; and n float images."""
    rng = np.random.default_rng(seed)
    span, _ = jqvl.sentinelize_span(jqvl.make_image_span_ids(JCFG), JCFG)
    common = [int(t) for t in rng.integers(3, 400, LENGTHS[length])]
    out = []
    for _ in range(n):
        tail = [int(t) for t in rng.integers(3, 400, 3)]
        ids = span + common + tail
        out.append((ids, {"unk": [int(t) for t in rng.integers(3, 400, 2)] + common + tail}))
    H = JCFG.vision.image_size
    images = [rng.normal(size=(3, H, H)).astype(np.float32) for _ in range(n)]
    return out, images


def _engines(trees, tree, **flags):
    jp, tp = trees[tree]
    jeng = JEngine(jp, JCFG, _gen(JGen, **flags), adapter=JAdapter(JCFG), attn_impl="xla", bucket=BUCKET)
    teng = TEngine(tp, TCFG, _gen(TGen, **flags), adapter=TAdapter(TCFG), bucket=BUCKET)
    return jeng, teng


def _assert_match(got, want):
    assert len(got) == len(want) and want
    for o, r in zip(got, want):
        assert o.token_ids == r.token_ids
        assert o.num_generated == r.num_generated
        assert o.prompt_length == r.prompt_length
        np.testing.assert_allclose(o.first_scores_top_probs, r.first_scores_top_probs, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(o.first_scores_top_ids[:5], r.first_scores_top_ids[:5])


def test_long_prompts_activate_ntk_and_logn():
    """The 'long' prompts' cache length passes seq_length: alpha > 1, and
    their last positions take a log-n scale above 1."""
    (ids, _), = _prompts("long", 1, 0)[0]
    spliced = len(ids) - 1 + JCFG.vision.n_queries
    cache_len = -(-spliced // BUCKET) * BUCKET + 5
    assert spliced > JCFG.text.seq_length
    assert jqwen.ntk_alpha_for_len(JCFG.text, cache_len) > 1
    assert jqwen.ntk_alpha_for_len(JCFG.text, -(-(LENGTHS["short"] + 7) // BUCKET) * BUCKET + 5) == 1


@pytest.mark.parametrize("length", list(LENGTHS))
@pytest.mark.parametrize("tree", ["fp32", "int8"])
def test_generate_token_exact_vs_jax(trees, tree, length):
    jeng, teng = _engines(trees, tree, use_dd=True, use_dd_unk=True)
    prompts, images = _prompts(length, 2, 1)
    want = [jeng.generate(ids, im, branch_ids=b) for (ids, b), im in zip(prompts, images)]
    got = [teng.generate(ids, im, branch_ids=b) for (ids, b), im in zip(prompts, images)]
    _assert_match(got, want)
    # a text-only request (no image): every row is text
    ids, b = prompts[0]
    _assert_match([teng.generate(ids[3:], None, branch_ids=b)], [jeng.generate(ids[3:], None, branch_ids=b)])


@pytest.mark.parametrize("length", list(LENGTHS))
@pytest.mark.parametrize("tree", ["fp32", "int8"])
def test_generate_batch_token_exact_vs_jax(trees, tree, length):
    jeng, teng = _engines(trees, tree, use_dd=True)
    prompts, images = _prompts(length, 3, 2)
    batch = [(ids, im) for (ids, _), im in zip(prompts, images)]
    batch[2] = (batch[2][0][3:], None)  # one question without an image
    _assert_match(teng.generate_batch(batch), jeng.generate_batch(batch))


@pytest.mark.parametrize("length", list(LENGTHS))
@pytest.mark.parametrize("tree", ["fp32", "int8"])
def test_generate_batch_groups_token_exact_vs_jax(trees, tree, length):
    """Two image groups of three questions; the 'none' kind shares one
    segment per group (the second table), 'unk' takes plain rows."""
    jeng, teng = _engines(trees, tree, use_dd=True, use_dd_unk=True)
    groups = []
    for seed in (3, 4):
        prompts, images = _prompts(length, 3, seed)
        ids_list = [ids for ids, _ in prompts]
        p = TEngine.common_token_prefix(ids_list)
        groups.append((ids_list[0][:p], [ids[p:] for ids in ids_list], images[0], [b for _, b in prompts]))
    want = jeng.generate_batch_groups(groups)
    got = teng.generate_batch_groups(groups)
    assert len(got) == 6
    _assert_match(got, want)
    # and against the port's own generate, question by question
    refs = [teng.generate(pre + s, im, branch_ids=b) for pre, sfx, im, bl in groups for s, b in zip(sfx, bl)]
    for o, r in zip(got, refs):
        assert o.token_ids == r.token_ids
        np.testing.assert_allclose(o.first_scores_top_probs, r.first_scores_top_probs, rtol=0, atol=1e-5)


def test_qwen_unk_without_ids_is_refused(trees):
    """'unk' needs the tokenizer's text: without explicit ids the adapter
    refuses it, as the JAX adapter does."""
    _, teng = _engines(trees, "fp32", use_dd=True, use_dd_unk=True)
    (ids, _), = _prompts("short", 1, 5)[0]
    with pytest.raises(ValueError, match="explicit"):
        teng.generate(ids, None)
