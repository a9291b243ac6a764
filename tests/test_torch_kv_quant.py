"""Port parity for the int8 KV cache (DecodeEngine kv_quant="int8"), the JAX
package's second opt-in serving mode:

- `kv_quantize_block` codes and scales exactly equal to the JAX package's,
  zero vectors (scale 0, codes 0) and half-way ties included, and
  `kv_dequantize`;
- `decode_attention`, `decode_attention_shared`, `chunk_attention_shared`
  and the grouped functions (the second table's scale planes included) on
  int8 (values, scales) operands, scale-folded as in JAX, within 1e-5
  (fp32, the int8 values widened on both sides);
- greedy tokens exact with kv_quant="int8" through every DecodeEngine entry
  point: LLaVA with dual VDD and with VCD (`generate`, `generate_batch`,
  `generate_batch_groups`), Qwen-VL and InstructBLIP (`generate`), and
  `generate_beam` over an int8 cache with a planted tie, where the beams'
  reorder carries the scale planes with the values. First-step top
  probabilities within KV_TOL_PROBS.
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
from llava_align_tpu.decoding.adapters import InstructBlipAdapter as JBAdapter
from llava_align_tpu.decoding.adapters import QwenVLAdapter as JQAdapter
from llava_align_tpu.decoding.engine import DecodeEngine as JEngine
from llava_align_tpu.models import llama as jllama
from llava_align_tpu.models import llava as jllava
from llava_align_tpu.models import qwen_vl as jqvl
from llava_align_tpu.models.instructblip import InstructBlipConfig as JBCfg
from llava_align_tpu.ops import attention as ja
from llava_align_tpu.ops import noise as jnoise
from llava_align_tpu.ops import quant as jquant
from llava_align_tpu_torch.config import GenerationConfig as TGen
from llava_align_tpu_torch.config import LlavaConfig as TCfg
from llava_align_tpu_torch.decoding import engine as tengine_mod
from llava_align_tpu_torch.decoding.adapters import InstructBlipAdapter as TBAdapter
from llava_align_tpu_torch.decoding.adapters import QwenVLAdapter as TQAdapter
from llava_align_tpu_torch.decoding.engine import DecodeEngine as TEngine
from llava_align_tpu_torch.models import qwen_vl as tqvl
from llava_align_tpu_torch.models.instructblip import InstructBlipConfig as TBCfg
from llava_align_tpu_torch.ops import attention as ta
from llava_align_tpu_torch.ops import noise as tnoise
from llava_align_tpu_torch.ops import quant as tquant
from llava_align_tpu_torch.utils.jax_params import from_jax_params

# torch on one thread: the tiny models gain nothing from more, and a thread
# per core spins at every small op (tests/lavis_ref.one_torch_thread)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

torch.backends.cuda.matmul.allow_tf32 = False

TOL = dict(rtol=1e-5, atol=1e-5)
# first-step top probabilities of the engines: the k/v vectors written to
# the cache differ from the JAX package's in the last bit (XLA against torch
# matmuls), and at a half-way point that flips an int8 code, moving the key
# by one step (XLA and torch round the same, so the codes agree otherwise);
# measured: every case within 1e-5 but the fp32 VCD grouped one, 1.5e-4
KV_TOL_PROBS = 5e-4
K, G_HEADS, DH = 2, 2, 16
H = K * G_HEADS
EOS = 2
S = IMAGE_TOKEN_INDEX


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _q8(x: np.ndarray):
    """One int8 (values, scales) operand for both packages: the JAX
    package's codes, handed to each side."""
    vals, scales = (np.asarray(a) for a in jquant.kv_quantize_block(jnp.asarray(x)))
    return (jnp.asarray(vals), jnp.asarray(scales)), (torch.from_numpy(vals), torch.from_numpy(scales))


def _check(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape,seed", [((3, 7, 2, 16), 0), ((2, 5, 4, 128), 1), ((64, 1, 88), 2)])
def test_kv_quantize_block_exact_vs_jax(shape, seed):
    rng = np.random.default_rng(seed)
    x = _rand(rng, *shape) * np.exp2(rng.integers(-8, 8, size=shape[:-1] + (1,))).astype(np.float32)
    x.reshape(-1, shape[-1])[0] = 0.0  # a zero vector: scale 0, codes 0
    flat = x.reshape(-1, shape[-1])
    flat[1] = 0.0
    flat[1, :4] = (127.0, 2.5, -2.5, 0.5)  # scale 1 exactly: half-way ties
    jv, js = (np.asarray(a) for a in jquant.kv_quantize_block(jnp.asarray(x)))
    tv, ts = tquant.kv_quantize_block(torch.from_numpy(x))
    assert tv.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == shape[:-1] + (1,)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ts.numpy(), js)
    assert not tv.numpy().reshape(-1, shape[-1])[0].any() and ts.numpy().reshape(-1)[0] == 0
    assert list(tv.numpy().reshape(-1, shape[-1])[1, :4]) == [127, 2, -2, 0]
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = tquant.kv_dequantize(tv, ts, dtype).float().numpy()
        want = np.asarray(jquant.kv_dequantize(jnp.asarray(jv), jnp.asarray(js), jdt).astype(jnp.float32))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quant_k,quant_v", [(True, True), (True, False), (False, True)])
def test_decode_attention_int8_vs_jax(quant_k, quant_v):
    rng = np.random.default_rng(3)
    B, Smax = 4, 11
    q = _rand(rng, B, 1, H, DH)
    kc, vc = _rand(rng, B, Smax, K, DH), _rand(rng, B, Smax, K, DH)
    lengths = np.array([0, 4, 10, 7], np.int32)
    jk, tk = _q8(kc) if quant_k else (jnp.asarray(kc), torch.from_numpy(kc))
    jv, tv = _q8(vc) if quant_v else (jnp.asarray(vc), torch.from_numpy(vc))
    want = ja.decode_attention(jnp.asarray(q), jk, jv, jnp.asarray(lengths))
    _check(ta.decode_attention(torch.from_numpy(q), tk, tv, torch.from_numpy(lengths)), want)


@pytest.mark.parametrize("quant_cache", [True, False])
def test_one_prefix_int8_vs_jax(quant_cache):
    """chunk_attention_shared (fp local block, int8 segment) and
    decode_attention_shared (int8 segment, int8 or fp cache)."""
    rng = np.random.default_rng(4)
    B, Sq, P, Smax = 4, 5, 9, 12
    q, k, v = _rand(rng, B, Sq, H, DH), _rand(rng, B, Sq, K, DH), _rand(rng, B, Sq, K, DH)
    (jks, tks), (jvs, tvs) = _q8(_rand(rng, P, K, DH)), _q8(_rand(rng, P, K, DH))
    sh_len = np.array([9, 4, 0, 1], np.int32)
    want = ja.chunk_attention_shared(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jks, jvs,
                                     jnp.asarray(sh_len))
    _check(ta.chunk_attention_shared(*map(torch.from_numpy, (q, k, v)), tks, tvs, torch.from_numpy(sh_len)),
           want)
    q1 = _rand(rng, B, 1, H, DH)
    kc, vc = _rand(rng, B, Smax, K, DH), _rand(rng, B, Smax, K, DH)
    (jkc, tkc), (jvc, tvc) = (_q8(kc), _q8(vc)) if quant_cache else (
        (jnp.asarray(kc), torch.from_numpy(kc)), (jnp.asarray(vc), torch.from_numpy(vc)))
    lengths = np.array([0, 3, 11, 6], np.int32)
    want = ja.decode_attention_shared(jnp.asarray(q1), jkc, jvc, jnp.asarray(lengths), jks, jvs,
                                      jnp.asarray(sh_len))
    got = ta.decode_attention_shared(torch.from_numpy(q1), tkc, tvc, torch.from_numpy(lengths), tks, tvs,
                                     torch.from_numpy(sh_len))
    _check(got, want)


def _tables(rng, second_table):
    G, R, P = 3, 2, 7
    G2, R2, P2 = 2, 3, 5
    j1, t1 = zip(_q8(_rand(rng, G, P, K, DH)), _q8(_rand(rng, G, P, K, DH)))
    two_j, two_t = {}, {}
    if second_table:
        (jk2, tk2), (jv2, tv2) = _q8(_rand(rng, G2, P2, K, DH)), _q8(_rand(rng, G2, P2, K, DH))
        two_j = dict(k_sh2=jk2, v_sh2=jv2, rows_per_prefix2=R2)
        two_t = dict(k_sh2=tk2, v_sh2=tv2, rows_per_prefix2=R2)
    return (G, R, P, G2 * R2 if second_table else 0, P2), j1, t1, two_j, two_t


@pytest.mark.parametrize("second_table", [False, True])
def test_grouped_chunk_int8_vs_jax(second_table):
    rng = np.random.default_rng(5)
    (G, R, P, M2, P2), (jk, jv), (tk, tv), two_j, two_t = _tables(rng, second_table)
    B, Sq = G * R + M2, 4
    q, k, v = _rand(rng, B, Sq, H, DH), _rand(rng, B, Sq, K, DH), _rand(rng, B, Sq, K, DH)
    sh_len = rng.integers(0, P + 1, size=B).astype(np.int32)
    sh_len[G * R:] = rng.integers(0, P2 + 1, size=M2)
    want = ja.chunk_attention_shared_grouped(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jk, jv,
                                             jnp.asarray(sh_len), R, **two_j)
    got = ta.chunk_attention_shared_grouped(*map(torch.from_numpy, (q, k, v)), tk, tv,
                                            torch.from_numpy(sh_len), R, **two_t)
    _check(got, want)


@pytest.mark.parametrize("second_table,plain_rows", [(False, 0), (True, 0), (True, 3), (False, 2)])
def test_grouped_decode_int8_vs_jax(second_table, plain_rows):
    rng = np.random.default_rng(6)
    (G, R, P, M2, P2), (jk, jv), (tk, tv), two_j, two_t = _tables(rng, second_table)
    M1 = G * R
    B, Smax = M1 + M2 + plain_rows, 10
    q = _rand(rng, B, 1, H, DH)
    (jkc, tkc), (jvc, tvc) = _q8(_rand(rng, B, Smax, K, DH)), _q8(_rand(rng, B, Smax, K, DH))
    lengths = rng.integers(0, Smax, size=B).astype(np.int32)
    sh_len = np.zeros((B,), np.int32)
    sh_len[:M1] = rng.integers(0, P + 1, size=M1)
    sh_len[M1:M1 + M2] = rng.integers(1, P2 + 1, size=M2)
    want = ja.decode_attention_shared_grouped(jnp.asarray(q), jkc, jvc, jnp.asarray(lengths), jk, jv,
                                              jnp.asarray(sh_len), R, **two_j)
    got = ta.decode_attention_shared_grouped(torch.from_numpy(q), tkc, tvc, torch.from_numpy(lengths),
                                             tk, tv, torch.from_numpy(sh_len), R, **two_t)
    _check(got, want)


# ---------------------------------------------------------------------------
# DecodeEngine(kv_quant="int8"), greedy, token-exact
# ---------------------------------------------------------------------------

JCFG, TCFG = JCfg.tiny(vocab_size=211), TCfg.tiny(vocab_size=211)
IDS = [1, 40, 50, S, 60, 70, 80]
PROMPTS = ([1, 17, 23, S, 31, 37, 41], [1, 19, S, 29, 31], [1, 5, S, 7, 9, 11, 13, 15, 17])
PREFIXES = ([1, 17, 23, S, 31, 37], [1, 19, S, 29, 31, 59, 61])
SUFFIXES = ([[41, 43, 53], [41, 47, 53, 59], [61, 67]], [[103, 107], [109, 113, 127], [131]])
LAYOUTS = {"dual": {"use_dd": True, "use_dd_unk": True}, "cd": {"use_cd": True}}
NOISE_STEP = 500


def _gen(cls, max_new=5, **kw):
    return cls(max_new_tokens=max_new, do_sample=False, eos_token_id=EOS, cd_alpha=1.0, cd_beta=0.1,
               noise_step=NOISE_STEP, **kw)


def _assert_match(got, want):
    got, want = (x if isinstance(x, list) else [x] for x in (got, want))
    assert len(got) == len(want) and want
    for o, r in zip(got, want):
        assert o.token_ids == r.token_ids
        assert o.num_generated == r.num_generated
        assert o.prompt_length == r.prompt_length
        np.testing.assert_allclose(o.first_scores_top_probs, r.first_scores_top_probs, rtol=0,
                                   atol=KV_TOL_PROBS)
        np.testing.assert_array_equal(o.first_scores_top_ids[:1], r.first_scores_top_ids[:1])


@pytest.fixture(scope="module")
def llava():
    jp = jax.device_get(jllava.init(jax.random.PRNGKey(0), JCFG))
    jq = dict(jp, llama=jax.device_get(jquant.quantize_llama_params(jp["llama"], fuse=True)))
    H_ = JCFG.vision.image_size
    images = [np.random.default_rng(1).integers(0, 256, (3, H_, H_), dtype=np.uint8) for _ in range(3)]
    return {"fp32": (jp, from_jax_params(jp, device="cpu")),
            "int8": (jq, from_jax_params(jq, device="cpu"))}, images


@pytest.fixture
def inject(monkeypatch):
    """inject(eps_jax, eps_port): both engines' diffusion noise from the
    given numpy eps (the one draw the two frameworks make differently)."""

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


def _eps(n):
    H_ = JCFG.vision.image_size
    return np.random.default_rng(5).standard_normal((n, 3, H_, H_)).astype(np.float32)


def _llava_engines(trees, tree, layout):
    jp, tp = trees[tree]
    flags = LAYOUTS[layout]
    return (JEngine(jp, JCFG, _gen(JGen, **flags), attn_impl="xla", bucket=8, kv_quant="int8"),
            TEngine(tp, TCFG, _gen(TGen, **flags), bucket=8, kv_quant="int8"))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("tree", ["fp32", "int8"])
def test_llava_generate_kv_quant_token_exact_vs_jax(llava, inject, tree, layout):
    trees, images = llava
    eps = _eps(1)
    inject(eps, eps)
    jeng, teng = _llava_engines(trees, tree, layout)
    assert "ks" in teng.adapter.init_cache(1, 4, device="cpu")
    _assert_match(teng.generate(IDS, images[0]), jeng.generate(IDS, images[0]))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("tree", ["fp32", "int8"])
def test_llava_generate_batch_kv_quant_token_exact_vs_jax(llava, inject, tree, layout):
    trees, images = llava
    eps = _eps(3)
    inject(eps, eps[[0, 2]])
    batch = [(PROMPTS[0], images[0]), (PROMPTS[1], None), (PROMPTS[2], images[2])]
    jeng, teng = _llava_engines(trees, tree, layout)
    _assert_match(teng.generate_batch(batch), jeng.generate_batch(batch))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("tree", ["fp32", "int8"])
def test_llava_generate_batch_groups_kv_quant_token_exact_vs_jax(llava, inject, tree, layout):
    """G = 2 x Qg = 3: int8 prefix segments (and, dual, the second table's
    int8 text segments) under int8 local caches."""
    trees, images = llava
    eps = _eps(2)
    inject(eps, eps)
    groups = [(p, s, im) for p, s, im in zip(PREFIXES, SUFFIXES, images)]
    jeng, teng = _llava_engines(trees, tree, layout)
    _assert_match(teng.generate_batch_groups(groups), jeng.generate_batch_groups(groups))
    if layout == "dual":  # generate_batch_prefix is one group of it
        _assert_match(teng.generate_batch_prefix(*groups[0]), jeng.generate_batch_prefix(*groups[0]))


@pytest.fixture(scope="module")
def qwen():
    cfg_j, cfg_t = jqvl.QwenVLConfig.tiny(), tqvl.QwenVLConfig.tiny()
    jp = jax.device_get(jqvl.init(jax.random.PRNGKey(0), cfg_j))
    jq = dict(jp, qwen=jax.device_get(jquant.quantize_qwen_params(jp["qwen"], fuse=True)))
    rng = np.random.default_rng(7)
    span, _ = jqvl.sentinelize_span(jqvl.make_image_span_ids(cfg_j), cfg_j)
    common = [int(t) for t in rng.integers(3, 400, 9)]
    prompts = []
    for _ in range(3):
        tail = [int(t) for t in rng.integers(3, 400, 3)]
        prompts.append((span + common + tail, {"unk": [int(t) for t in rng.integers(3, 400, 2)] + common + tail}))
    H_ = cfg_j.vision.image_size
    images = [rng.normal(size=(3, H_, H_)).astype(np.float32) for _ in range(3)]
    return cfg_j, cfg_t, (jq, from_jax_params(jq, device="cpu")), prompts, images


def _qwen_engines(qwen, **flags):
    cfg_j, cfg_t, (jp, tp), _, _ = qwen
    return (JEngine(jp, cfg_j, _gen(JGen, **flags), adapter=JQAdapter(cfg_j), attn_impl="xla", bucket=64,
                    kv_quant="int8"),
            TEngine(tp, cfg_t, _gen(TGen, **flags), adapter=TQAdapter(cfg_t), bucket=64, kv_quant="int8"))


def test_qwen_generate_kv_quant_token_exact_vs_jax(qwen):
    jeng, teng = _qwen_engines(qwen, use_dd=True, use_dd_unk=True)
    prompts, images = qwen[3], qwen[4]
    want = [jeng.generate(ids, im, branch_ids=b) for (ids, b), im in zip(prompts[:2], images)]
    _assert_match([teng.generate(ids, im, branch_ids=b) for (ids, b), im in zip(prompts[:2], images)], want)


def test_qwen_generate_batch_kv_quant_token_exact_vs_jax(qwen):
    jeng, teng = _qwen_engines(qwen, use_dd=True)
    batch = [(ids, im) for (ids, _), im in zip(qwen[3], qwen[4])]
    _assert_match(teng.generate_batch(batch), jeng.generate_batch(batch))


def test_qwen_generate_batch_groups_kv_quant_token_exact_vs_jax(qwen):
    jeng, teng = _qwen_engines(qwen, use_dd=True, use_dd_unk=True)
    prompts, images = qwen[3], qwen[4]
    ids_list = [ids for ids, _ in prompts]
    p = TEngine.common_token_prefix(ids_list)
    group = (ids_list[0][:p], [ids[p:] for ids in ids_list], images[0], [b for _, b in prompts])
    _assert_match(teng.generate_batch_groups([group, group]), jeng.generate_batch_groups([group, group]))


VOCAB = 61
BCFG_J, BCFG_T = JBCfg.tiny(vocab_size=VOCAB), TBCfg.tiny(vocab_size=VOCAB)
TIE = (7, 9)  # the planted tie: equal lm_head and embedding rows


@pytest.fixture(scope="module")
def blip_llama():
    jp = jax.device_get(jllama.init(jax.random.PRNGKey(3), BCFG_J.text))
    a, b = TIE
    tied = dict(jp, embed=np.array(jp["embed"]), lm_head=np.array(jp["lm_head"]))
    tied["lm_head"][a] = tied["lm_head"][b] = 4.0 * tied["lm_head"][b]
    tied["embed"][a] = tied["embed"][b]
    return {name: ({"llama": t}, from_jax_params({"llama": t}, device="cpu"))
            for name, t in (("plain", jp), ("tie", tied))}


def _blip_engines(blip_llama, tree, max_new=8, **flags):
    jp, tp = blip_llama[tree]
    gen = dict(max_new_tokens=max_new, do_sample=False, eos_token_id=EOS, pad_token_id=0, **flags)
    return (JEngine(jp, BCFG_J, JGen(**gen), adapter=JBAdapter(BCFG_J), attn_impl="xla", bucket=8,
                    kv_quant="int8"),
            TEngine(tp, BCFG_T, TGen(**gen), adapter=TBAdapter(BCFG_T), bucket=8, kv_quant="int8"))


@pytest.mark.parametrize("case", ["plain", "none", "vcd"])
def test_instructblip_generate_kv_quant_token_exact_vs_jax(blip_llama, case):
    """Precomputed query features (one numpy array for both sides), as the
    BLIP runners pass them: main alone, main + 'none', main + cd."""
    flags = {"plain": {}, "none": {"use_dd": True}, "vcd": {"use_cd": True}}[case]
    jeng, teng = _blip_engines(blip_llama, "plain", max_new=5, cd_alpha=1.0, cd_beta=0.1, **flags)
    feats = np.random.default_rng(8).normal(size=(2, BCFG_J.num_query_tokens, BCFG_J.text.hidden_size))
    feats = feats.astype(np.float32)[: 2 if case == "vcd" else 1]
    ids = [S, 1, 12, 30, 44]
    _assert_match(teng.generate(ids, None, precomputed_feats=feats), jeng.generate(ids, None, precomputed_feats=feats))


@pytest.mark.parametrize("tree,num_beams", [("plain", 3), ("plain", 5), ("tie", 3), ("tie", 5)])
def test_generate_beam_kv_quant_token_exact_vs_jax(blip_llama, tree, num_beams):
    """Beams over an int8 cache: each step reorders k, v, ks and vs by the
    beams' parents. The tie (tokens 7 and 9 score alike) is decided by the
    order among equal scores, the lower id first."""
    jeng, teng = _blip_engines(blip_llama, tree)
    ids = [1, 12, 30, 44, 51]
    dummy = np.zeros((1, 1, BCFG_J.text.hidden_size), np.float32)
    got = teng.generate_beam(ids, precomputed_feats=dummy, num_beams=num_beams)
    want = jeng.generate_beam(ids, precomputed_feats=dummy, num_beams=num_beams)
    assert got.token_ids == want.token_ids and got.num_generated == want.num_generated
    if tree == "tie":
        assert TIE[0] in got.token_ids and TIE[1] not in got.token_ids
