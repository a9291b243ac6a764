"""Port parity: the lockstep batch entry point of llava_align_tpu_torch's
DecodeEngine (generate_batch = submit_batch + collect_batch) is greedy
token-exact against the JAX DecodeEngine's generate_batch on
LlavaConfig.tiny, for the fp32 tree and its int8-fused and int4-fused
quantizations, in each branch layout `branch_kinds` gives (plain, use_dd,
use_dd_unk, both), on a batch that mixes images and None; with a stop
keyword that one question hits; and token-exact against the port's own
`generate`, question by question.

first_scores_top_probs agree within 1e-5 and the top ids are equal: fp32
on both sides, softmax of fused logits whose inputs differ by ~1e-7.
"""

import jax
import numpy as np
import pytest

from lavis_ref import one_torch_thread  # noqa: F401 (a fixture)
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

# torch on one thread: the tiny models gain nothing from more, and a thread
# per core spins at every small op (tests/lavis_ref.one_torch_thread)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

EOS = 2
JCFG, TCFG = JCfg.tiny(vocab_size=211), TCfg.tiny(vocab_size=211)
S = IMAGE_TOKEN_INDEX
# three questions of different lengths; the second has its sentinel but no
# image (a text-only row: feats_src -1)
PROMPTS = ([1, 17, 23, S, 31, 37, 41], [1, 19, S, 29, 31], [1, 5, S, 7, 9, 11, 13, 15, 17])
LAYOUTS = {
    "plain": {},
    "use_dd": {"use_dd": True},
    "use_dd_unk": {"use_dd_unk": True},
    "dual": {"use_dd": True, "use_dd_unk": True},
}


def _gen(cls, max_new=5, **kw):
    return cls(max_new_tokens=max_new, do_sample=False, eos_token_id=EOS, cd_alpha=1.0,
               cd_beta=0.1, **kw)


@pytest.fixture(scope="module")
def batch():
    H = JCFG.vision.image_size
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 256, (3, H, H), dtype=np.uint8) for _ in PROMPTS]
    images[1] = None
    return list(zip(PROMPTS, images))


@pytest.fixture(scope="module")
def trees():
    jp = jax.device_get(jllava.init(jax.random.PRNGKey(0), JCFG))
    out = {"fp32": (jp, from_jax_params(jp, device="cpu"))}
    for name, bits in (("int8_fused", 8), ("int4_fused", 4)):
        jq = dict(jp, llama=jax.device_get(quantize_llama_params(jp["llama"], fuse=True, bits=bits)))
        out[name] = (jq, from_jax_params(jq, device="cpu"))
    return out


@pytest.fixture(scope="module")
def runs(trees, batch):
    """(JAX outputs, port outputs, port engine) of one batch call per
    (tree, layout), computed once."""
    cache = {}

    def get(tree, layout):
        if (tree, layout) not in cache:
            jp, tp = trees[tree]
            flags = LAYOUTS[layout]
            want = JEngine(jp, JCFG, _gen(JGen, **flags), attn_impl="xla", bucket=8).generate_batch(batch)
            engine = TEngine(tp, TCFG, _gen(TGen, **flags), bucket=8)
            cache[tree, layout] = (want, engine.generate_batch(batch), engine)
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
        _assert_same_top_ids(o.first_scores_top_ids, r.first_scores_top_ids, r.first_scores_top_probs)


def _assert_same_top_ids(got_ids, want_ids, want_probs, atol=1e-5):
    """The top-k ids equal position by position; where the reference's
    probabilities tie (within atol of each other) the order inside the tie
    is free, and a tie with the last place may bring in an id from past
    the top k."""
    got_ids, want_ids, want_probs = (np.asarray(a) for a in (got_ids, want_ids, want_probs))
    assert got_ids.shape == want_ids.shape
    for i in np.nonzero(got_ids != want_ids)[0]:
        tie = np.abs(want_probs - want_probs[i]) <= atol
        assert got_ids[i] in want_ids[tie] or tie[-1], (i, got_ids, want_ids, want_probs)
    assert len(set(got_ids.tolist())) == len(got_ids)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("tree", ["fp32", "int8_fused", "int4_fused"])
def test_batch_token_exact_vs_jax(runs, tree, layout):
    want, got, _ = runs(tree, layout)
    assert len(got) == len(PROMPTS)
    _assert_match(got, want)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("tree", ["fp32", "int4_fused"])
def test_batch_token_exact_vs_port_generate(runs, batch, tree, layout):
    """Each question of the lockstep call decodes as `generate` decodes it
    alone."""
    _, got, engine = runs(tree, layout)
    for o, (ids, image) in zip(got, batch):
        r = engine.generate(ids, image)
        assert o.token_ids == r.token_ids
        assert o.prompt_length == r.prompt_length
        np.testing.assert_allclose(o.first_scores_top_probs, r.first_scores_top_probs,
                                   rtol=0, atol=1e-5)


def test_stop_keyword_stops_its_question_alone(runs, trees, batch):
    """A two-token stop keyword taken from question 0's greedy answer
    (tokens 3-4) ends question 0 where it first appears while the others
    run on, exactly as in the JAX engine."""
    _, full, _ = runs("fp32", "dual")
    kw = full[0].token_ids[2:4]
    cut = next(n for n in range(2, 5) if full[0].token_ids[n - 2:n] == kw)
    jp, tp = trees["fp32"]
    flags = LAYOUTS["dual"]
    want = JEngine(jp, JCFG, _gen(JGen, **flags), attn_impl="xla", bucket=8,
                   stop_keyword_ids=[kw]).generate_batch(batch)
    got = TEngine(tp, TCFG, _gen(TGen, **flags), bucket=8, stop_keyword_ids=[kw]).generate_batch(batch)
    _assert_match(got, want)
    assert got[0].num_generated == cut and got[0].token_ids == full[0].token_ids[:cut]
    assert any(o.num_generated == 5 for o in got[1:])


def test_text_only_batch_skips_the_vision_tower(runs, trees, monkeypatch):
    """The scoring engine's calls carry no image: no row takes features, so
    the port encodes nothing, and the tokens still equal the JAX engine's
    (which encodes the zero placeholders and uses none of them)."""
    jp, tp = trees["fp32"]
    batch = [(ids, None) for ids in PROMPTS]
    want = JEngine(jp, JCFG, _gen(JGen, max_new=1), attn_impl="xla", bucket=8).generate_batch(batch)
    engine = TEngine(tp, TCFG, _gen(TGen, max_new=1), bucket=8)

    def no_encode(*a, **k):
        raise AssertionError("encode_images called for a text-only batch")

    monkeypatch.setattr(engine.adapter, "encode_images", no_encode)
    _assert_match(engine.generate_batch(batch), want)


def test_batch_refusals_and_empty(trees):
    tp = trees["fp32"][1]
    engine = TEngine(tp, TCFG, _gen(TGen, use_dd=True), bucket=8)
    assert engine.generate_batch([]) == []
    image = np.zeros((3, TCFG.vision.image_size, TCFG.vision.image_size), np.uint8)
    with pytest.raises(ValueError, match="one image"):
        engine.generate_batch([([1, S, 5, S, 6], image)])
    with pytest.raises(ValueError, match="anyres"):
        engine.generate_batch([([1, S, 5], np.stack([image, image]))])
    # VCD is ported: an engine with use_cd packs a cd row beside main
    assert TEngine(tp, TCFG, _gen(TGen, use_cd=True), bucket=8).kinds == ["main", "cd"]
