"""Port parity for BLIP-2: the stage-1 Q-Former paths and model
(models/qformer, models/blip2), the T5 backend's encode / ranking /
generation, and BLIP-2 OPT through the decode engine (Blip2OptAdapter),
llava_align_tpu_torch against the JAX package on the tiny configs, the
JAX params carried over (utils/jax_params), fp32 on the CPU. Floats within
1e-5; tokens, rankings and the nucleus filter exact.

- qformer.forward_text, forward_queries (hidden and every layer's K/V),
  forward_lm (padded), lm_logits and lm_loss_mean;
- blip2.match (itm, itc), extract_features (image, text, multimodal),
  compute_sim_matrix's two score matrices (argsort shortlists on inputs
  without near-ties), greedy generate_caption tokens (min_length held);
- the caption loop's nucleus filter on shared logits, and its top_p draws
  with one table of uniforms injected into both packages' categorical;
- encode_image_queries(_instruct, a 5-D video too), t5_encode_with_prefix
  (few-shot context), t5_candidate_losses and its argsort ranking,
  t5_generate (plain and instruct);
- Blip2OptAdapter: generate greedy, VDD ('none') and VCD on
  precomputed_feats (the noised stream encoded from one numpy eps in both
  packages), generate_batch of text-only prompts, 5-beam generate_beam;
  act_quant / kv_quant warned and ignored; the adapter's flags.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavis_ref import one_torch_thread  # noqa: F401 (a fixture)
from llava_align_tpu.config import GenerationConfig as JGen
from llava_align_tpu.constants import IMAGE_TOKEN_INDEX
from llava_align_tpu.decoding.adapters import Blip2OptAdapter as JAdapter
from llava_align_tpu.decoding.engine import DecodeEngine as JEngine
from llava_align_tpu.models import blip2 as jb2
from llava_align_tpu.models import qformer as jqf
from llava_align_tpu.ops import noise as jnoise
from llava_align_tpu_torch.config import GenerationConfig as TGen
from llava_align_tpu_torch.decoding.adapters import Blip2OptAdapter as TAdapter
from llava_align_tpu_torch.decoding.engine import DecodeEngine as TEngine
from llava_align_tpu_torch.models import blip2 as tb2
from llava_align_tpu_torch.models import qformer as tqf
from llava_align_tpu_torch.ops import noise as tnoise
from llava_align_tpu_torch.utils.jax_params import from_jax_params

# torch on one thread: the tiny models gain nothing from more, and a thread
# per core spins at every small op (tests/lavis_ref.one_torch_thread)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

torch.backends.cuda.matmul.allow_tf32 = False

TOL = 1e-5
EOS = 2


def perturb(tree, seed):
    rng = np.random.default_rng(seed)

    def f(a):
        a = np.asarray(a)
        return jnp.asarray(a + 0.1 * rng.standard_normal(a.shape), jnp.float32) if a.ndim else jnp.asarray(a)

    return jax.tree_util.tree_map(f, tree)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want) -> None:
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# stage 1
# ---------------------------------------------------------------------------

S1J, S1T = jb2.Blip2QformerConfig.tiny(), tb2.Blip2QformerConfig.tiny()
TEXT_IDS = np.array([[101, 7, 8, 9, 102, 0], [101, 5, 6, 200, 8, 102], [101, 11, 12, 102, 0, 0]], np.int32)
TEXT_MASK = (np.arange(6)[None, :] < np.array([[5], [6], [4]])).astype(np.int32)


@pytest.fixture(scope="module")
def stage1():
    jp = perturb(jax.device_get(jb2.init_stage1(jax.random.PRNGKey(0), S1J)), 1)
    rng = np.random.default_rng(2)
    images = rng.standard_normal((3, 3, 28, 28)).astype(np.float32)
    return jp, from_jax_params(jp, device="cpu"), images


def test_qformer_stage1_paths_vs_jax(stage1):
    jp, tp, images = stage1
    jq, tq, cfg = jp["qformer"], tp["qformer"], S1J.qformer
    close(tqf.forward_text(tq, S1T.qformer, t(TEXT_IDS), t(TEXT_MASK)),
          jqf.forward_text(jq, cfg, TEXT_IDS, TEXT_MASK))
    rng = np.random.default_rng(3)
    queries = rng.standard_normal((3, cfg.query_length, cfg.hidden_size)).astype(np.float32)
    image = rng.standard_normal((3, 5, cfg.encoder_width)).astype(np.float32)
    jh, jkv = jqf.forward_queries(jq, cfg, queries, image)
    th, tkv = tqf.forward_queries(tq, S1T.qformer, t(queries), t(image))
    close(th, jh)
    assert len(tkv) == cfg.num_layers
    for (tk, tv), (jk, jv) in zip(tkv, jkv):
        close(tk, jk), close(tv, jv)
    jlm = jqf.forward_lm(jq, cfg, TEXT_IDS, TEXT_MASK, jkv)
    tlm = tqf.forward_lm(tq, S1T.qformer, t(TEXT_IDS), t(TEXT_MASK), tkv)
    close(tlm, jlm)
    jlog, tlog = jqf.lm_logits(jq["head"], jlm), tqf.lm_logits(tq["head"], tlm)
    close(tlog, jlog)
    labels = np.where(TEXT_MASK == 1, np.minimum(TEXT_IDS, cfg.vocab_size - 1), -100)
    close(tqf.lm_loss_mean(tlog, t(labels)), jqf.lm_loss_mean(jlog, labels))


def test_stage1_match_and_features_vs_jax(stage1):
    jp, tp, images = stage1
    for head in ("itm", "itc"):
        close(tb2.match(tp, S1T, t(images), t(TEXT_IDS), t(TEXT_MASK), head),
              jb2.match(jp, S1J, images, TEXT_IDS, TEXT_MASK, head))
    for mode in ("image", "text", "multimodal"):
        want = jb2.extract_features(jp, S1J, images, TEXT_IDS, TEXT_MASK, mode=mode)
        got = tb2.extract_features(tp, S1T, t(images), t(TEXT_IDS), t(TEXT_MASK), mode=mode)
        assert sorted(k for k, v in got.items() if v is not None) == sorted(k for k, v in want.items()
                                                                             if v is not None)
        for k, v in want.items():
            if v is not None:
                close(got[k], v)


def test_stage1_sim_matrix_vs_jax(stage1):
    jp, tp, images = stage1
    ids = np.concatenate([TEXT_IDS, TEXT_IDS[:, ::-1] % 50 + 3])
    mask = np.concatenate([TEXT_MASK, np.ones_like(TEXT_MASK)])
    want = jb2.compute_sim_matrix(jp, S1J, images, ids, mask, k_test=2)
    got = tb2.compute_sim_matrix(tp, S1T, t(images), t(ids), t(mask), k_test=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g == -100.0, w == -100.0)  # the same shortlists
        close(g, w)


def test_generate_caption_greedy_vs_jax(stage1):
    """min_length > 1 is held on the port alone: the JAX loop writes the
    eos mask into a read-only view of its logits there (ValueError)."""
    jp, tp, images = stage1
    base = dict(bos_token_id=101, max_new_tokens=6)
    free = jb2.generate_caption(jp, S1J, images, eos_token_id=10**6, **base)
    eos = int(free[0, 1])  # row 0 stops after two tokens, unless min_length holds it
    want = jb2.generate_caption(jp, S1J, images, eos_token_id=eos, **base)
    got = tb2.generate_caption(tp, S1T, t(images), eos_token_id=eos, **base)
    np.testing.assert_array_equal(got, want)
    assert want[0, 1] == eos
    held = tb2.generate_caption(tp, S1T, t(images), eos_token_id=eos, min_length=4, **base)
    assert not (held[:, :3] == eos).any()


def _jax_nucleus(logits, top_p):
    """The filter lines of the JAX caption loop (blip2.greedy_lm_decode)."""
    order = np.argsort(-logits, axis=-1)
    probs = np.take_along_axis(np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1)), order, axis=-1)
    keep = np.cumsum(probs, axis=-1) - probs < top_p
    keep[:, 0] = True
    filt = np.full_like(logits, -1e30)
    np.put_along_axis(filt, order, np.where(keep, np.take_along_axis(logits, order, -1), -1e30), -1)
    return filt


@pytest.mark.parametrize("top_p", [0.3, 0.9])
def test_nucleus_filter_exact_on_shared_logits(top_p):
    logits = (np.random.default_rng(4).standard_normal((4, 97)) * 3).astype(np.float32)
    np.testing.assert_array_equal(tb2.nucleus_filter(logits, top_p), _jax_nucleus(logits, top_p))


def test_caption_top_p_draws_with_injected_uniforms(stage1, monkeypatch):
    """Both loops' categorical draws become inverse-CDF draws from one
    table of uniforms, one per row, in call order."""
    jp, tp, images = stage1
    table = np.random.default_rng(5).random(64)

    def drawer():
        pos = [0]

        def draw(logits):
            lg = np.asarray(logits, np.float64)
            p = np.exp(lg - lg.max(-1, keepdims=True))
            cdf = np.cumsum(p / p.sum(-1, keepdims=True), -1)
            u = table[pos[0] : pos[0] + lg.shape[0]]
            pos[0] += lg.shape[0]
            return np.minimum((cdf < u[:, None]).sum(-1), lg.shape[1] - 1)

        return draw

    jdraw, tdraw = drawer(), drawer()
    monkeypatch.setattr(jax.random, "categorical", lambda key, logits, axis=-1: jnp.asarray(jdraw(logits)))
    monkeypatch.setattr(tb2, "_categorical", lambda g, logits: torch.from_numpy(tdraw(logits.numpy())))
    kw = dict(bos_token_id=101, eos_token_id=10**6, max_new_tokens=5, top_p=0.9)
    want = jb2.generate_caption(jp, S1J, images, rng=jax.random.PRNGKey(0), **kw)
    got = tb2.generate_caption(tp, S1T, t(images), generator=torch.Generator().manual_seed(0), **kw)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="generator"):
        tb2.generate_caption(tp, S1T, t(images), **kw)


# ---------------------------------------------------------------------------
# the T5 backend
# ---------------------------------------------------------------------------

T5J, T5T = jb2.Blip2T5Config.tiny(vocab_size=61), tb2.Blip2T5Config.tiny(vocab_size=61)


@pytest.fixture(scope="module")
def t5_side():
    jp = perturb(jax.device_get(jb2.init_t5(jax.random.PRNGKey(6), T5J)), 7)
    images = np.random.default_rng(8).standard_normal((2, 3, 28, 28)).astype(np.float32)
    return jp, from_jax_params(jp, device="cpu"), images


QTEXT = np.array([[101, 5, 6, 102], [101, 7, 102, 0]], np.int32)
QMASK = (QTEXT > 0).astype(np.int32)


def test_t5_encode_and_candidate_ranking_vs_jax(t5_side):
    jp, tp, images = t5_side
    jq = jb2.encode_image_queries_instruct(jp, T5J, images, QTEXT, QMASK)
    tq = tb2.encode_image_queries_instruct(tp, T5T, t(images), t(QTEXT), t(QMASK))
    close(tq, jq)
    video = np.stack([images, images[::-1]], axis=2)  # [B, 3, F=2, H, W]
    close(tb2.encode_image_queries_instruct(tp, T5T, t(video), t(QTEXT), t(QMASK)),
          jb2.encode_image_queries_instruct(jp, T5J, video, QTEXT, QMASK))
    close(tb2.encode_image_queries(tp, T5T, t(images)), jb2.encode_image_queries(jp, T5J, images))
    ids = np.array([[5, 9, 13, 1, 0], [7, 8, 1, 0, 0]], np.int32)
    mask = (ids > 0).astype(np.int32)
    few = np.random.default_rng(9).standard_normal((2, 3, T5J.text.d_model)).astype(np.float32)
    jenc, jm = jb2.t5_encode_with_prefix(jp, T5J, jq, ids, mask, few_shot_embeds=few)
    tenc, tm = tb2.t5_encode_with_prefix(tp, T5T, tq, t(ids), t(mask), few_shot_embeds=t(few))
    close(tenc, jenc)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    cands = np.array([[11, 12, 1, 0], [13, 1, 0, 0], [14, 15, 16, 1], [17, 1, 0, 0]], np.int32)
    want = np.asarray(jb2.t5_candidate_losses(jp, T5J, jenc, jm, cands))
    got = tb2.t5_candidate_losses(tp, T5T, tenc, tm, t(cands)).numpy()
    close(got, want)
    gaps = np.diff(np.sort(want, axis=-1), axis=-1)
    assert gaps.min() > 1e-3  # no near-ties: the ranking is well defined
    np.testing.assert_array_equal(np.argsort(got, axis=-1), np.argsort(want, axis=-1))


@pytest.mark.parametrize("instruct", [False, True], ids=["plain", "instruct"])
def test_t5_generate_vs_jax(t5_side, instruct):
    jp, tp, images = t5_side
    prompts = [[5, 9, 13, 1], [7, 8, 1]]
    kw = dict(max_new_tokens=6, eos_token_id=1)
    qj = dict(qformer_text_ids=QTEXT, qformer_text_mask=QMASK) if instruct else {}
    qt = {k: t(v) for k, v in qj.items()}
    want = jb2.t5_generate(jp, T5J, images, prompts, **kw, **qj)
    assert tb2.t5_generate(tp, T5T, t(images), prompts, **kw, **qt) == want


# ---------------------------------------------------------------------------
# BLIP-2 OPT through the engine
# ---------------------------------------------------------------------------

OPJ, OPT_ = jb2.Blip2OptConfig.tiny(vocab_size=97), tb2.Blip2OptConfig.tiny(vocab_size=97)
IDS = [IMAGE_TOKEN_INDEX, 1, 40, 50, 60]
NOISE_STEP = 500


@pytest.fixture(scope="module")
def opt_side():
    jp = perturb(jax.device_get(jb2.init_opt(jax.random.PRNGKey(10), OPJ)), 11)
    tp = from_jax_params(jp, device="cpu")
    rng = np.random.default_rng(12)
    image = rng.standard_normal((1, 3, 28, 28)).astype(np.float32)
    eps = rng.standard_normal((1, 3, 28, 28)).astype(np.float32)
    sqrt_ab, sqrt_1m_ab = jnoise.diffusion_schedule()
    j_noised = jnp.asarray(sqrt_ab[NOISE_STEP] * image + sqrt_1m_ab[NOISE_STEP] * eps)
    t_noised = tnoise.add_diffusion_noise(t(image), NOISE_STEP, eps=t(eps))
    jfeats = np.concatenate([np.asarray(jb2.encode_image_queries(jp, OPJ, image)),
                             np.asarray(jb2.encode_image_queries(jp, OPJ, j_noised))])
    with torch.inference_mode():
        tfeats = torch.cat([tb2.encode_image_queries(tp, OPT_, t(image)), tb2.encode_image_queries(tp, OPT_, t_noised)])
    close(tfeats, jfeats)
    return jp, tp, jfeats, tfeats


OPT_CASES = {"greedy": ({}, 1), "vdd": ({"use_dd": True}, 1), "vcd": ({"use_cd": True}, 2)}


def _gen(cls, **kw):
    return cls(max_new_tokens=5, do_sample=False, eos_token_id=EOS, cd_alpha=1.0, cd_beta=0.1, **kw)


def _match(got, want):
    got, want = (x if isinstance(x, list) else [x] for x in (got, want))
    assert len(got) == len(want) and want
    for o, r in zip(got, want):
        assert o.token_ids == r.token_ids and o.prompt_length == r.prompt_length
        np.testing.assert_allclose(o.first_scores_top_probs, r.first_scores_top_probs, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", list(OPT_CASES))
@pytest.mark.parametrize("entry", ["generate", "generate_batch"])
def test_blip2_opt_engine_token_exact_vs_jax(opt_side, case, entry):
    """generate on the precomputed query stream ([main, cd] rows for VCD).
    generate_batch on text-only prompts (the adapter encodes no image): the
    JAX engine's lockstep batch encodes every image slot, which the adapter
    refuses, so the port's batch is held against JAX's generate question by
    question, given dummy features as the JAX engine needs them for a
    prompt without a sentinel (both prompts pad to one bucket)."""
    jp, tp, jfeats, tfeats = opt_side
    flags, rows = OPT_CASES[case]
    jeng = JEngine(jp, OPJ, _gen(JGen, **flags), adapter=JAdapter(OPJ), attn_impl="xla", bucket=8)
    teng = TEngine(tp, OPT_, _gen(TGen, **flags), adapter=TAdapter(OPT_), bucket=8)
    if entry == "generate":
        _match(teng.generate(IDS, None, precomputed_feats=tfeats[:rows]),
               jeng.generate(IDS, None, precomputed_feats=jfeats[:rows]))
    else:
        batch = [([1, 17, 23, 31], None), ([1, 19, 29, 31, 37, 41, 43], None)]
        dummy = np.zeros((1, 1, OPJ.text.hidden_size), np.float32)
        _match(teng.generate_batch(batch), [jeng.generate(ids, None, precomputed_feats=dummy) for ids, _ in batch])
        with pytest.raises(NotImplementedError, match="precomputed_feats"):
            jeng.generate_batch(batch)


def test_blip2_opt_beam_and_quant_modes_vs_jax(opt_side, caplog):
    jp, tp, jfeats, tfeats = opt_side
    gen = dict(max_new_tokens=8, do_sample=False, eos_token_id=EOS)
    want = JEngine(jp, OPJ, JGen(**gen), adapter=JAdapter(OPJ), attn_impl="xla", bucket=8).generate_beam(
        IDS, precomputed_feats=jfeats[:1], num_beams=5)
    got = TEngine(tp, OPT_, TGen(**gen), adapter=TAdapter(OPT_), bucket=8).generate_beam(
        IDS, precomputed_feats=tfeats[:1], num_beams=5)
    assert got.token_ids == want.token_ids and got.num_generated == want.num_generated
    with caplog.at_level(logging.WARNING):
        eng = TEngine(tp, OPT_, _gen(TGen, use_dd=True), adapter=TAdapter(OPT_), bucket=8, act_quant=True,
                      kv_quant="int8")
    assert "act_quant requested" in caplog.text and "kv_quant requested" in caplog.text
    plain = TEngine(tp, OPT_, _gen(TGen, use_dd=True), adapter=TAdapter(OPT_), bucket=8)
    assert (eng.generate(IDS, None, precomputed_feats=tfeats[:1]).token_ids
            == plain.generate(IDS, None, precomputed_feats=tfeats[:1]).token_ids)
    with pytest.raises(ValueError, match="no shared-prefix forward"):
        eng.generate_batch_groups([([1, 5], [[6, 7]], None)])
    ja, ta = JAdapter(OPJ), TAdapter(OPT_)
    for flag in ("supports_shared_prefix", "supports_act_quant", "supports_kv_quant"):
        assert getattr(ta, flag) is getattr(ja, flag) is False, flag
    assert (ta.num_image_tokens, ta.image_size, ta.num_kv_heads) == (ja.num_image_tokens, ja.image_size,
                                                                      ja.num_kv_heads)


@pytest.mark.parametrize("which", ["opt", "t5", "stage1"])
def test_init_trees_match_jax(which):
    key = jax.random.PRNGKey(0)
    fam = {"opt": (jb2.init_opt, tb2.init_opt, OPJ, OPT_), "t5": (jb2.init_t5, tb2.init_t5, T5J, T5T),
           "stage1": (jb2.init_stage1, tb2.init_stage1, S1J, S1T)}
    jinit, tinit, jc, tc = fam[which]
    want = jax.tree_util.tree_leaves_with_path(jax.device_get(jinit(key, jc)))
    got_tree = tinit(tc, device="cpu")
    assert len(jax.tree_util.tree_leaves(got_tree)) == len(want)
    for path, w in want:
        node = got_tree
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        assert tuple(node.shape) == np.shape(w) and node.dtype == torch.float32, path
    if which == "stage1":
        assert float(got_tree["temp"]) == pytest.approx(0.07) and got_tree["temp"].dim() == 0
        assert got_tree["qformer"]["head"]["decoder"] is got_tree["qformer"]["embeddings"]["word"]
    for part in ("vision", "qformer") + (("text",) if which != "stage1" else ()):
        j, g = dataclasses.asdict(getattr(jc, part)), dataclasses.asdict(getattr(tc, part))
        j.pop("dtype"), g.pop("dtype")
        assert j == g, part
