"""Port parity: the grouped shared-prefix entry points of
llava_align_tpu_torch's DecodeEngine (generate_batch_prefix,
generate_batch_groups) are greedy token-exact against the JAX DecodeEngine
on LlavaConfig.tiny, for the fp32 tree and its int8-fused and int4-fused
quantizations, with dual-branch VDD and single-branch decoding, at G = 2
groups x Qg = 3 questions; and token-exact against the port's own
`generate` per question.

first_scores_top_probs agree within 1e-5: fp32 on both sides, softmax of
fused logits whose inputs differ by ~1e-7. One JAX engine and one port
engine per (tree, layout) are shared through module-scoped fixtures, so the
JAX side compiles one grouped program per case.
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
from llava_align_tpu_torch.utils.jax_params import from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EOS = 2
JCFG, TCFG = JCfg.tiny(vocab_size=211), TCfg.tiny(vocab_size=211)
PREFIXES = ([1, 17, 23, IMAGE_TOKEN_INDEX, 31, 37], [1, 19, IMAGE_TOKEN_INDEX, 29, 31, 59, 61])
SUFFIXES = ([[41, 43, 53], [41, 47, 53, 59], [61, 67]], [[103, 107], [109, 113, 127], [131]])
LAYOUTS = {"dual": {"use_dd": True, "use_dd_unk": True}, "single": {}}


def _gen(cls, max_new=5, **kw):
    return cls(max_new_tokens=max_new, do_sample=False, eos_token_id=EOS, cd_alpha=1.0,
               cd_beta=0.1, **kw)


@pytest.fixture(scope="module")
def images():
    H = JCFG.vision.image_size
    rng = np.random.default_rng(1)
    return [rng.integers(0, 256, (3, H, H), dtype=np.uint8) for _ in PREFIXES]


@pytest.fixture(scope="module")
def trees():
    jp = jax.device_get(jllava.init(jax.random.PRNGKey(0), JCFG))
    out = {"fp32": (jp, from_jax_params(jp, device="cpu"))}
    for name, bits in (("int8_fused", 8), ("int4_fused", 4)):
        jq = dict(jp, llama=jax.device_get(quantize_llama_params(jp["llama"], fuse=True, bits=bits)))
        out[name] = (jq, from_jax_params(jq, device="cpu"))
    return out


@pytest.fixture(scope="module")
def runs(trees, images):
    """(JAX outputs, port outputs, port engine) of one grouped call per
    (tree, layout), computed once."""
    cache = {}

    def get(tree, layout):
        if (tree, layout) not in cache:
            jp, tp = trees[tree]
            groups = [(p, s, im) for p, s, im in zip(PREFIXES, SUFFIXES, images)]
            flags = LAYOUTS[layout]
            want = JEngine(jp, JCFG, _gen(JGen, **flags), attn_impl="xla",
                           bucket=8).generate_batch_groups(groups)
            engine = TEngine(tp, TCFG, _gen(TGen, **flags), bucket=8)
            cache[tree, layout] = (want, engine.generate_batch_groups(groups), engine)
        return cache[tree, layout]

    return get


def _assert_match(got, want):
    assert len(got) == len(want)
    for o, r in zip(got, want):
        assert o.token_ids == r.token_ids
        assert o.num_generated == r.num_generated
        assert o.prompt_length == r.prompt_length
        np.testing.assert_allclose(o.first_scores_top_probs, r.first_scores_top_probs,
                                   rtol=0, atol=1e-5)
        assert o.first_scores_top_ids[0] == r.first_scores_top_ids[0]


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("tree", ["fp32", "int8_fused", "int4_fused"])
def test_groups_token_exact_vs_jax(runs, tree, layout):
    want, got, _ = runs(tree, layout)
    assert len(got) == 6
    _assert_match(got, want)


@pytest.mark.parametrize("tree", ["fp32", "int4_fused"])
def test_batch_prefix_is_one_group(runs, images, tree):
    """generate_batch_prefix is generate_batch_groups with one group: the
    first group's rows of the two-group call."""
    want, _, engine = runs(tree, "dual")
    got = engine.generate_batch_prefix(PREFIXES[0], SUFFIXES[0], images[0])
    _assert_match(got, want[:3])


@pytest.mark.parametrize("tree", ["fp32", "int8_fused", "int4_fused"])
def test_groups_token_exact_vs_port_generate(runs, images, tree):
    _, got, engine = runs(tree, "dual")
    refs = [engine.generate(p + s, im) for p, sfx, im in zip(PREFIXES, SUFFIXES, images)
            for s in sfx]
    for o, r in zip(got, refs):
        assert o.token_ids == r.token_ids
        assert o.prompt_length == r.prompt_length
        np.testing.assert_allclose(o.first_scores_top_probs, r.first_scores_top_probs,
                                   rtol=0, atol=1e-5)


def test_eos_stops_rows_on_their_own(runs, images):
    """A row that samples EOS stops there while the others go on, as in the
    JAX engine: take row 0's second greedy token as EOS; every row then ends
    at its first such token, the others run the full length."""
    _, got, engine = runs("fp32", "dual")
    eos = got[0].token_ids[1]
    gen = TGen(max_new_tokens=5, do_sample=False, eos_token_id=eos, cd_alpha=1.0, cd_beta=0.1,
               use_dd=True, use_dd_unk=True)
    groups = [(p, s, im) for p, s, im in zip(PREFIXES, SUFFIXES, images)]
    outs = TEngine(engine.params, TCFG, gen, bucket=8).generate_batch_groups(groups)
    lengths = []
    for o, full in zip(outs, got):
        cut = full.token_ids.index(eos) + 1 if eos in full.token_ids else len(full.token_ids)
        assert o.token_ids == full.token_ids[:cut]
        assert o.num_generated == cut
        lengths.append(cut)
    assert lengths[0] <= 2 and len(set(lengths)) > 1


def test_refusals(trees, images):
    """The refusals the JAX tests pin (tests/test_engine_prefix.py): a
    sentinel in a suffix, and groups of different sizes; and, under use_cd,
    a group without an image (it has no noised prefix segment)."""
    tp = trees["fp32"][1]
    engine = TEngine(tp, TCFG, _gen(TGen, use_dd=True, use_dd_unk=True), bucket=8)
    with pytest.raises(ValueError, match="sentinel"):
        engine.generate_batch_prefix(PREFIXES[0], [[IMAGE_TOKEN_INDEX, 5]], images[0])
    with pytest.raises(ValueError, match="same"):
        engine.generate_batch_groups([(PREFIXES[0], SUFFIXES[0][:2], images[0]),
                                      (PREFIXES[0], SUFFIXES[0], images[0])])
    with pytest.raises(ValueError, match="suffix"):
        engine.generate_batch_prefix(PREFIXES[0], [[41], []], images[0])
    with pytest.raises(ValueError, match="anyres"):
        engine.generate_batch_prefix(PREFIXES[0], SUFFIXES[0], np.stack([images[0]] * 2))
    assert engine.generate_batch_groups([]) == []
    with pytest.raises(ValueError, match="need an image"):
        TEngine(tp, TCFG, _gen(TGen, use_cd=True), bucket=8).generate_batch_prefix(
            PREFIXES[0], SUFFIXES[0], None)


def test_explicit_branch_ids_keep_full_prompt_rows(trees, images):
    """Per-question explicit ids for a text kind keep that kind out of the
    shared segments (plain rows); tokens match the JAX engine."""
    jp, tp = trees["fp32"]
    bids = [{"unk": [1, 7, 8] + s} for s in SUFFIXES[0]]
    flags = {"use_dd": True, "use_dd_unk": True}
    want = JEngine(jp, JCFG, _gen(JGen, **flags), attn_impl="xla", bucket=8).generate_batch_prefix(
        PREFIXES[0], SUFFIXES[0], images[0], branch_ids_list=bids)
    got = TEngine(tp, TCFG, _gen(TGen, **flags), bucket=8).generate_batch_prefix(
        PREFIXES[0], SUFFIXES[0], images[0], branch_ids_list=bids)
    _assert_match(got, want)
