"""Port parity for W8A8 (act_quant), the JAX package's opt-in throughput
mode: dynamic per-row activation quantization, int8 x int8 → int32, fp32
epilogue (llava_align_tpu/ops/quant.py `_w8a8_row_scale`,
`_w8a8_quantize`, `int8_matmul_w8a8`, and the act_quant branch of
`int8_matmul_stacked_dispatch`).

- the row scales and int8 codes exactly equal to the JAX package's, with
  half-way ties planted (round half to even on both sides) and zero rows;
- `int8_matmul_w8a8` within 1e-6 relative (fp32; torch._int_mm against
  XLA's int8 dot_general, the same exact int32 sums);
- the dispatch at 255 rows (K1's path or the dequant path, as without
  act_quant) and at 256 (the W8A8 product), against the JAX dispatch;
- `llama.forward` / `qwen.forward` with act_quant (a 288-row prefill that
  takes W8A8, then decode steps that keep K1): every W8A8 call of the
  port's forward equal to the JAX product on the same input (identical
  codes, 1e-6 relative), every prefill stack on W8A8 and no decode stack;
  the hidden states against the JAX forward's within FLIP_TOL;
- greedy tokens exact through `generate`, `generate_batch` and
  `generate_batch_groups` with DecodeEngine(act_quant=True) on tiny int8
  LLaVA and Qwen-VL trees, with prompts long enough that prefills reach 256
  rows (the port's W8A8 counter must move in each call); first-step top
  probabilities within FLIP_TOL_PROBS.

Why not 1e-5 end to end: the activations that reach a W8A8 quantizer
differ from the JAX package's in the last bit (rms_norm's reduction and
rsqrt, XLA against torch; about half the elements on a CPU), and a last-bit
difference at a half-way point flips an int8 code, about once in 1e5
activations, moving that row by one quantization step (~1e-2 here). The
weight-only forward, with no quantizer on the activations, stays within
1e-5 (tests/test_torch_models.py). So the product and the routing are held
exactly, and the whole forward within the size of one flip.
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
from llava_align_tpu.decoding.adapters import QwenVLAdapter as JQAdapter
from llava_align_tpu.decoding.engine import DecodeEngine as JEngine
from llava_align_tpu.models import llama as jllama
from llava_align_tpu.models import llava as jllava
from llava_align_tpu.models import qwen as jqwen
from llava_align_tpu.models import qwen_vl as jqvl
from llava_align_tpu.ops import quant as jquant
from llava_align_tpu_torch.config import GenerationConfig as TGen
from llava_align_tpu_torch.config import LlavaConfig as TCfg
from llava_align_tpu_torch.decoding.adapters import QwenVLAdapter as TQAdapter
from llava_align_tpu_torch.decoding.engine import DecodeEngine as TEngine
from llava_align_tpu_torch.models import llama as tllama
from llava_align_tpu_torch.models import qwen as tqwen
from llava_align_tpu_torch.models import qwen_vl as tqvl
from llava_align_tpu_torch.ops import quant as tquant
from llava_align_tpu_torch.utils.jax_params import from_jax_params

# torch on one thread: the tiny models gain nothing from more, and a thread
# per core spins at every small op (tests/lavis_ref.one_torch_thread)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

torch.backends.cuda.matmul.allow_tf32 = False

EOS = 2
S = IMAGE_TOKEN_INDEX
JCFG, TCFG = JCfg.tiny(vocab_size=211), TCfg.tiny(vocab_size=211)
JQCFG, TQCFG = jqvl.QwenVLConfig.tiny(), tqvl.QwenVLConfig.tiny()
FLIP_TOL = 5e-2        # abs, hidden states of the W8A8 forward (one code flip ~2.5e-2 here)
FLIP_TOL_PROBS = 2e-3  # abs, first-step top probabilities under W8A8 (measured <= 8e-4)


def _planted(rows: int, D: int, seed: int) -> np.ndarray:
    """Random fp32 rows whose columns 1-4 sit exactly on half-way points of
    the row's quantization grid (±2.5, ±3.5 steps), and one zero row. Each
    row's absmax is 127 * 2^e (column 0), so its step is exactly 2^e."""
    rng = np.random.default_rng(seed)
    step = np.exp2(rng.integers(-6, 4, size=(rows, 1))).astype(np.float32)
    h = (rng.uniform(-100, 100, (rows, D)) * step).astype(np.float32)
    h[:, 0] = 127 * step[:, 0]
    for col, steps in zip(range(1, 5), (2.5, -2.5, 3.5, -3.5)):
        h[:, col] = steps * step[:, 0]
    h[0] = 0.0
    return h


@pytest.mark.parametrize("rows,D,seed", [(256, 64, 0), (300, 128, 1), (17, 4096, 2)])
def test_w8a8_codes_and_scales_exact_vs_jax(rows, D, seed):
    h = _planted(rows, D, seed)
    hj = jnp.asarray(h)
    ja = jquant._w8a8_row_scale(hj, jnp.max(jnp.abs(hj), axis=-1, keepdims=True))
    ta = tquant.w8a8_row_scale(torch.from_numpy(h).abs().amax(dim=-1, keepdim=True))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    jc = np.asarray(jquant._w8a8_quantize(hj, ja))
    tc = tquant.w8a8_quantize(torch.from_numpy(h), ta).numpy()
    assert tc.dtype == np.int8
    np.testing.assert_array_equal(tc, jc)
    # the ties rounded half to even, the zero row to zeros
    assert {tuple(r) for r in tc[1:, 1:5]} == {(2, -2, 4, -4)}
    assert not tc[0].any()


@pytest.mark.parametrize("lead,O,D", [((256,), 96, 64), ((2, 160), 48, 128), ((640,), 256, 64)])
def test_int8_matmul_w8a8_vs_jax(lead, O, D):
    rng = np.random.default_rng(O + D)
    h = rng.standard_normal(lead + (D,)).astype(np.float32)
    wq = jquant.quantize_weight(jnp.asarray(rng.standard_normal((O, D)).astype(np.float32)))
    q, s = np.asarray(wq["q"]), np.asarray(wq["s"])
    want = np.asarray(jquant.int8_matmul_w8a8(jnp.asarray(h), jnp.asarray(q), jnp.asarray(s)))
    got = tquant.int8_matmul_w8a8(torch.from_numpy(h), torch.from_numpy(q), torch.from_numpy(s))
    assert got.shape == want.shape and got.dtype == torch.float32
    rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert rel <= 1e-6, rel


@pytest.mark.parametrize("O,D", [(96, 64), (64, 96)])  # output-major (K1 to 640) and not
@pytest.mark.parametrize("rows", [255, 256])
def test_dispatch_rows_vs_jax(rows, O, D):
    """At 255 rows act_quant changes nothing; at 256 the W8A8 product takes
    the call (the port's counter moves), equal to the JAX dispatch's."""
    rng = np.random.default_rng(rows)
    L, li = 3, 1
    w = rng.standard_normal((L, O, D)).astype(np.float32)
    jw = jax.device_get(jquant.quantize_weight(jnp.asarray(w)))
    tw = {k: torch.from_numpy(np.asarray(v)) for k, v in jw.items()}
    h = rng.standard_normal((rows, D)).astype(np.float32)
    want = np.asarray(jquant.int8_matmul_stacked_dispatch(jnp.asarray(h), jw, jnp.asarray(li),
                                                          act_quant=True))
    n0 = tquant.int8_matmul_w8a8.launches
    got = tquant.int8_matmul_stacked_dispatch(torch.from_numpy(h), tw, li, act_quant=True)
    took_w8a8 = tquant.int8_matmul_w8a8.launches - n0
    assert took_w8a8 == (rows >= tquant.W8A8_MIN_ROWS == jquant._W8A8_MIN_B)
    plain = tquant.int8_matmul_stacked_dispatch(torch.from_numpy(h), tw, li)
    if rows < tquant.W8A8_MIN_ROWS:
        assert torch.equal(got, plain)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.fixture(scope="module")
def llama_trees():
    jl = jax.device_get(jllama.init(jax.random.PRNGKey(2), JCFG.text))
    jq = jax.device_get(jquant.quantize_llama_params(jl, fuse=True))
    return jq, from_jax_params(jq, device="cpu")


@pytest.fixture(scope="module")
def qwen_trees():
    jp = jax.device_get(jqvl.init(jax.random.PRNGKey(0), JQCFG))
    b = np.random.default_rng(11).normal(size=np.shape(jp["qwen"]["layers"]["c_attn_b"])) * 0.1
    jp["qwen"]["layers"]["c_attn_b"] = b.astype(np.float32)
    jq = dict(jp, qwen=jax.device_get(jquant.quantize_qwen_params(jp["qwen"], fuse=True)))
    return jq, from_jax_params(jq, device="cpu")


def _forward_pair(monkeypatch, jmod, tmod, jp, tp, jc, tc, **kw):
    """A 2 x 144-row prefill (288 rows: W8A8) then three decode steps
    (3 rows: K1), act_quant on both sides. Each W8A8 call of the port is
    held against the JAX product on its own input; hidden states and the
    last rows' logits against the JAX forward's."""
    calls = []
    port_w8a8 = tquant.int8_matmul_w8a8

    def held(h, q, s):
        out = port_w8a8(h, q, s)
        want = np.asarray(jquant.int8_matmul_w8a8(jnp.asarray(h.numpy()), jnp.asarray(q.numpy()),
                                                  jnp.asarray(s.numpy())))
        assert np.abs(out.numpy() - want).max() <= 1e-6 * np.abs(want).max()
        calls.append(h.shape[:-1].numel())
        return out

    held.launches = 0  # the wrapper counts under its module name
    monkeypatch.setattr(tquant, "int8_matmul_w8a8", held)
    rng = np.random.default_rng(5)
    Smax = 160
    jcache, tcache = jmod.init_cache(jc, 3, Smax), tmod.init_cache(tc, 3, Smax)

    def both(embeds, positions, offsets):
        nonlocal jcache
        jh, jcache = jmod.forward(jp, jc, jnp.asarray(embeds), jnp.asarray(positions), jcache,
                                  jnp.asarray(offsets), attn_impl="xla", act_quant=True, **kw)
        th, _ = tmod.forward(tp, tc, torch.from_numpy(embeds), torch.from_numpy(positions), tcache,
                             torch.from_numpy(offsets), act_quant=True, **kw)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=FLIP_TOL)
        tl, jl = tmod.logits_from_hidden(tp, th[:, -1]), jmod.logits_from_hidden(jp, jh[:, -1])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=FLIP_TOL)

    def emb(*shape):
        return rng.normal(size=shape + (jc.hidden_size,)).astype(np.float32)

    both(emb(2, 144), np.tile(np.arange(144, dtype=np.int32), (2, 1)), np.zeros(2, np.int32))
    n_stacks = sum(1 for w in tp["layers"].values() if tquant.is_quantized(w))
    assert calls == [288] * (jc.num_layers * n_stacks)  # every prefill stack took W8A8
    lengths = np.array([144, 100, 0], np.int32)
    for _ in range(3):
        both(emb(3, 1), lengths[:, None], lengths)
        lengths = lengths + 1
    assert len(calls) == jc.num_layers * n_stacks  # decode rows keep K1


def test_llama_forward_act_quant_vs_jax(llama_trees, monkeypatch):
    jp, tp = llama_trees
    _forward_pair(monkeypatch, jllama, tllama, jp, tp, JCFG.text, TCFG.text)


def test_qwen_forward_act_quant_vs_jax(qwen_trees, monkeypatch):
    jp, tp = qwen_trees
    _forward_pair(monkeypatch, jqwen, tqwen, jp["qwen"], tp["qwen"], JQCFG.text, TQCFG.text)


# ---------------------------------------------------------------------------
# DecodeEngine(act_quant=True), greedy, token-exact
# ---------------------------------------------------------------------------


def _gen(cls, max_new=5, **kw):
    return cls(max_new_tokens=max_new, do_sample=False, eos_token_id=EOS, cd_alpha=1.0, cd_beta=0.1, **kw)


def _assert_match(got, want):
    assert len(got) == len(want) and want
    for o, r in zip(got, want):
        assert o.token_ids == r.token_ids
        assert o.num_generated == r.num_generated
        assert o.prompt_length == r.prompt_length
        np.testing.assert_allclose(o.first_scores_top_probs, r.first_scores_top_probs, rtol=0,
                                   atol=FLIP_TOL_PROBS)
        assert o.first_scores_top_ids[0] == r.first_scores_top_ids[0]


def _counted(fn):
    """fn's result, asserting the port's W8A8 product took calls in it."""
    n0 = tquant.int8_matmul_w8a8.launches
    out = fn()
    assert tquant.int8_matmul_w8a8.launches > n0, "no prefill reached the W8A8 rows"
    return out


@pytest.fixture(scope="module")
def llava_int8():
    jp = jax.device_get(jllava.init(jax.random.PRNGKey(0), JCFG))
    jq = dict(jp, llama=jax.device_get(jquant.quantize_llama_params(jp["llama"], fuse=True)))
    return jq, from_jax_params(jq, device="cpu")


def _llava_prompts(n: int, seed: int):
    """n prompts of ~150 tokens sharing all but their last 3 (a 128-bucket
    image row of 256 positions), and n uint8 images."""
    rng = np.random.default_rng(seed)
    head = [1] + [int(t) for t in rng.integers(3, 200, 140)] + [S] + [int(t) for t in rng.integers(3, 200, 4)]
    H = JCFG.vision.image_size
    return ([head + [int(t) for t in rng.integers(3, 200, 3)] for _ in range(n)],
            [rng.integers(0, 256, (3, H, H), dtype=np.uint8) for _ in range(n)])


def _llava_engines(trees):
    jp, tp = trees
    flags = dict(use_dd=True, use_dd_unk=True)
    return (JEngine(jp, JCFG, _gen(JGen, **flags), attn_impl="xla", bucket=128, act_quant=True),
            TEngine(tp, TCFG, _gen(TGen, **flags), bucket=128, act_quant=True))


def test_llava_generate_act_quant_token_exact_vs_jax(llava_int8):
    jeng, teng = _llava_engines(llava_int8)
    prompts, images = _llava_prompts(2, 1)
    want = [jeng.generate(ids, im) for ids, im in zip(prompts, images)]
    _assert_match(_counted(lambda: [teng.generate(ids, im) for ids, im in zip(prompts, images)]), want)


def test_llava_generate_batch_act_quant_token_exact_vs_jax(llava_int8):
    jeng, teng = _llava_engines(llava_int8)
    prompts, images = _llava_prompts(3, 2)
    batch = list(zip(prompts, images))
    _assert_match(_counted(lambda: teng.generate_batch(batch)), jeng.generate_batch(batch))


def test_llava_generate_batch_groups_act_quant_token_exact_vs_jax(llava_int8):
    jeng, teng = _llava_engines(llava_int8)
    groups = []
    for seed in (3, 4):
        prompts, images = _llava_prompts(3, seed)
        p = TEngine.common_token_prefix(prompts)
        groups.append((prompts[0][:p], [ids[p:] for ids in prompts], images[0]))
    _assert_match(_counted(lambda: teng.generate_batch_groups(groups)), jeng.generate_batch_groups(groups))


def _qwen_prompts(n: int, seed: int):
    """n Qwen-VL prompts: the image span then ~130 text tokens (a 64-bucket
    image row of 192 positions), each with its 'unk' ids; n float images."""
    rng = np.random.default_rng(seed)
    span, _ = jqvl.sentinelize_span(jqvl.make_image_span_ids(JQCFG), JQCFG)
    common = [int(t) for t in rng.integers(3, 400, 130)]
    out = []
    for _ in range(n):
        tail = [int(t) for t in rng.integers(3, 400, 3)]
        out.append((span + common + tail, {"unk": [int(t) for t in rng.integers(3, 400, 2)] + common + tail}))
    H = JQCFG.vision.image_size
    return out, [rng.normal(size=(3, H, H)).astype(np.float32) for _ in range(n)]


def _qwen_engines(trees, **flags):
    jp, tp = trees
    return (JEngine(jp, JQCFG, _gen(JGen, **flags), adapter=JQAdapter(JQCFG), attn_impl="xla", bucket=64,
                    act_quant=True),
            TEngine(tp, TQCFG, _gen(TGen, **flags), adapter=TQAdapter(TQCFG), bucket=64, act_quant=True))


def test_qwen_generate_act_quant_token_exact_vs_jax(qwen_trees):
    jeng, teng = _qwen_engines(qwen_trees, use_dd=True, use_dd_unk=True)
    prompts, images = _qwen_prompts(2, 1)
    want = [jeng.generate(ids, im, branch_ids=b) for (ids, b), im in zip(prompts, images)]
    got = _counted(lambda: [teng.generate(ids, im, branch_ids=b) for (ids, b), im in zip(prompts, images)])
    _assert_match(got, want)


def test_qwen_generate_batch_act_quant_token_exact_vs_jax(qwen_trees):
    jeng, teng = _qwen_engines(qwen_trees, use_dd=True)
    prompts, images = _qwen_prompts(3, 2)
    batch = [(ids, im) for (ids, _), im in zip(prompts, images)]
    _assert_match(_counted(lambda: teng.generate_batch(batch)), jeng.generate_batch(batch))


def test_qwen_generate_batch_groups_act_quant_token_exact_vs_jax(qwen_trees):
    jeng, teng = _qwen_engines(qwen_trees, use_dd=True, use_dd_unk=True)
    groups = []
    for seed in (3, 4):
        prompts, images = _qwen_prompts(3, seed)
        ids_list = [ids for ids, _ in prompts]
        p = TEngine.common_token_prefix(ids_list)
        groups.append((ids_list[0][:p], [ids[p:] for ids in ids_list], images[0], [b for _, b in prompts]))
    _assert_match(_counted(lambda: teng.generate_batch_groups(groups)), jeng.generate_batch_groups(groups))


def test_engine_flags_copy_the_adapter_and_refuse_unknown_modes(llava_int8):
    """act_quant / kv_quant set on a copy of the adapter, as the JAX engine
    does; a kv_quant mode other than int8 raises."""
    _, tp = llava_int8
    adapter = TQAdapter(TQCFG)
    eng = TEngine(tp, TCFG, _gen(TGen), adapter=adapter, act_quant=True, kv_quant="int8", device="cpu")
    assert eng.adapter is not adapter and eng.adapter.act_quant and eng.adapter.kv_quant
    assert not adapter.act_quant and not adapter.kv_quant
    with pytest.raises(ValueError, match="kv_quant"):
        TEngine(tp, TCFG, _gen(TGen), kv_quant="int4", device="cpu")
