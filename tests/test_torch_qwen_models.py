"""Port parity for the Qwen-VL modules: llava_align_tpu_torch.models.qwen,
qwen_vit and qwen_vl, ops.quant.quantize_qwen_params and the int8 path,
and utils.synthetic.build_random_qwen_vl_params, against the JAX package,
with the JAX params carried over by from_jax_params and the inputs drawn
from a numpy seed.

Tolerance 1e-5 (relative and absolute), as tests/test_torch_models.py:
fp32 on both sides through a few layers; only reduction orders differ, and
for the int8 tree the kernel path's scale-after-reduction against XLA's
dequantize-first. The decoder runs QwenConfig.tiny (seq_length 128) with
dynamic NTK and log-n on, at positions past 128, so both act.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llava_align_tpu.constants import IMAGE_TOKEN_INDEX
from llava_align_tpu.models import qwen as jqwen
from llava_align_tpu.models import qwen_vit as jvit
from llava_align_tpu.models import qwen_vl as jqvl
from llava_align_tpu.ops.quant import quantize_qwen_params as jquantize
from llava_align_tpu_torch.models import qwen as tqwen
from llava_align_tpu_torch.models import qwen_vit as tvit
from llava_align_tpu_torch.models import qwen_vl as tqvl
from llava_align_tpu_torch.ops.quant import quantize_qwen_params as tquantize
from llava_align_tpu_torch.utils.jax_params import from_jax_params

RTOL, ATOL = 1e-5, 1e-5
JCFG, TCFG = jqvl.QwenVLConfig.tiny(), tqvl.QwenVLConfig.tiny()


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def params():
    jp = jax.device_get(jqvl.init(jax.random.PRNGKey(0), JCFG))
    # a nonzero c_attn_b (init leaves it zero), so the bias add is held too
    b = np.random.default_rng(11).normal(size=np.shape(jp["qwen"]["layers"]["c_attn_b"])) * 0.1
    jp["qwen"]["layers"]["c_attn_b"] = b.astype(np.float32)
    return jp, from_jax_params(jp, device="cpu")


def _decoder(params, quant):
    jq = params[0]["qwen"]
    if quant != "fp32":
        jq = jax.device_get(jquantize(jq, fuse=quant == "int8_fused"))
    return jq, from_jax_params(jq, device="cpu")


def test_configs_and_host_helpers_identical():
    for j, t in ((JCFG, TCFG), (jqvl.QwenVLConfig.qwen_vl_7b(), tqvl.QwenVLConfig.qwen_vl_7b())):
        for jc, tc in ((j.text, t.text), (j.vision, t.vision)):
            jd = {k: v for k, v in dataclasses.asdict(jc).items() if k != "dtype"}
            assert jd == {k: v for k, v in dataclasses.asdict(tc).items() if k != "dtype"}
        assert (j.image_start_id, j.image_end_id, j.image_pad_id) == (
            t.image_start_id, t.image_end_id, t.image_pad_id)
        assert tqvl.make_image_span_ids(t) == jqvl.make_image_span_ids(j)
    assert TCFG.vision.mlp_width == JCFG.vision.mlp_width
    assert tqvl.QwenVLConfig().vision.mlp_width == 8192
    c = TCFG.text
    for n in (1, 64, 128, 129, 200, 256, 257, 600, 5000):
        assert tqwen.ntk_alpha_for_len(c, n) == jqwen.ntk_alpha_for_len(JCFG.text, n), n
    positions = np.arange(0, 400, 7, dtype=np.int32)[None]
    _close(tqwen._logn_scale(c, torch.from_numpy(positions)), jqwen._logn_scale(JCFG.text, jnp.asarray(positions)))
    span = jqvl.make_image_span_ids(JCFG)
    for ids in ([5, 6] + span + [7, 8], span + span + [9], [1, 2, 3]):
        assert tqvl.sentinelize_span(ids, TCFG) == jqvl.sentinelize_span(ids, JCFG)
    with pytest.raises(ValueError, match="unterminated"):
        tqvl.sentinelize_span([1, TCFG.image_start_id, 4], TCFG)


@pytest.mark.parametrize("quant", ["fp32", "int8_fused", "int8_unfused"])
def test_qwen_prefill_then_decode(params, quant):
    """Prefill a 72-row group (> 64 rows: the dequant path for the narrow
    stacks) at cache row 0 and an 8-row group at cache_row_offset 1, then
    four decode steps over all rows at unequal offsets, every call at the
    NTK alpha of a 300-long cache (> seq_length 128) and the decode steps at
    positions past 128 (log-n active); hidden states, logits and the cache
    must match."""
    jq, tq = _decoder(params, quant)
    c, tc = JCFG.text, TCFG.text
    alpha = jqwen.ntk_alpha_for_len(c, 300)
    assert alpha > 1
    rng = np.random.default_rng(4)
    Smax = 300
    jcache = jqwen.init_cache(c, 3, Smax)
    tcache = tqwen.init_cache(tc, 3, Smax)

    def both(embeds, positions, offsets, row_offset):
        nonlocal jcache
        jh, jcache = jqwen.forward(jq, c, jnp.asarray(embeds), jnp.asarray(positions), jcache,
                                   jnp.asarray(offsets), ntk_alpha=alpha, attn_impl="xla",
                                   cache_row_offset=row_offset)
        th, _ = tqwen.forward(tq, tc, torch.from_numpy(embeds), torch.from_numpy(positions), tcache,
                              torch.from_numpy(offsets), ntk_alpha=alpha, cache_row_offset=row_offset)
        _close(th, jh)
        _close(tqwen.logits_from_hidden(tq, th[:, -1]), jqwen.logits_from_hidden(jq, jh[:, -1]))

    def emb(*shape):
        return rng.normal(size=shape + (c.hidden_size,)).astype(np.float32)

    both(emb(1, 72), np.arange(72, dtype=np.int32)[None], np.zeros(1, np.int32), 0)
    both(emb(2, 8), np.tile(np.arange(8, dtype=np.int32), (2, 1)), np.zeros(2, np.int32), 1)
    lengths = np.array([72, 8, 5], np.int32)
    for step in range(4):
        # the cache offsets stay local; the rotary / log-n positions run past 128
        both(emb(3, 1), (lengths + 130 + step)[:, None], lengths, 0)
        lengths = lengths + 1
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])


@pytest.mark.parametrize("grouped", [False, True], ids=["single", "grouped"])
@pytest.mark.parametrize("quant", ["fp32", "int8_fused"])
def test_qwen_shared_segments(params, grouped, quant):
    """A suffix prefill and two decode steps against a read-only prefix
    segment: one prefix for every row, or (grouped, the engine's layout) one
    per block of rows with a second table for the rows after them, and a
    plain row (segment length 0) prefilled on its own and decoded with the
    rest; positions start past 128, at each row's segment length."""
    jq, tq = _decoder(params, quant)
    c, tc = JCFG.text, TCFG.text
    L, H, Dh = c.num_layers, c.num_heads, c.head_dim
    rng = np.random.default_rng(5)
    alpha = jqwen.ntk_alpha_for_len(c, 256)
    S, Smax = 8, 16
    if grouped:
        G, Qg, P, G2, P2 = 2, 2, 140, 1, 132
        B_sh = G * Qg + G2 * Qg  # table-1 rows, then table-2 rows; one plain row after them
        shared = {"k": rng.normal(size=(L, G, P, H, Dh)), "v": rng.normal(size=(L, G, P, H, Dh)),
                  "k2": rng.normal(size=(L, G2, P2, H, Dh)), "v2": rng.normal(size=(L, G2, P2, H, Dh))}
        sh_len = np.array([140, 133, 139, 137, 131, 132, 0], np.int32)
        kw = dict(shared_rows_per_prefix=Qg, shared_rows_per_prefix2=Qg)
    else:
        B_sh, P = 3, 136
        shared = {"k": rng.normal(size=(L, P, H, Dh)), "v": rng.normal(size=(L, P, H, Dh))}
        sh_len = np.array([136, 130, 0], np.int32)
        kw = {}
    B = len(sh_len)
    shared = {k: v.astype(np.float32) for k, v in shared.items()}
    jcache, tcache = jqwen.init_cache(c, B, Smax), tqwen.init_cache(tc, B, Smax)

    def both(embeds, positions, offsets, rows, **seg):
        nonlocal jcache
        if seg:
            jseg = dict(shared_kv={k: jnp.asarray(v) for k, v in shared.items()},
                        shared_len=jnp.asarray(sh_len[rows]), **kw)
            tseg = dict(shared_kv={k: torch.from_numpy(v) for k, v in shared.items()},
                        shared_len=torch.from_numpy(sh_len[rows]), **kw)
        else:
            jseg, tseg = {}, {}
        jh, jcache = jqwen.forward(jq, c, jnp.asarray(embeds), jnp.asarray(positions), jcache,
                                   jnp.asarray(offsets), ntk_alpha=alpha, attn_impl="xla",
                                   cache_row_offset=rows.start, **jseg)
        th, _ = tqwen.forward(tq, tc, torch.from_numpy(embeds), torch.from_numpy(positions), tcache,
                              torch.from_numpy(offsets), ntk_alpha=alpha, cache_row_offset=rows.start, **tseg)
        _close(th, jh)

    def emb(n, s):
        return rng.normal(size=(n, s, c.hidden_size)).astype(np.float32)

    sh_rows = slice(0, B_sh) if grouped else slice(0, B)
    n = sh_rows.stop
    both(emb(n, S), (sh_len[sh_rows, None] + np.arange(S)).astype(np.int32), np.zeros(n, np.int32),
         sh_rows, seg=True)
    if grouped:  # the plain row: its own full prefill, no segment
        both(emb(1, S), np.arange(S, dtype=np.int32)[None], np.zeros(1, np.int32), slice(B_sh, B))
    lengths = np.full((B,), S, np.int32)
    for _ in range(2):
        both(emb(B, 1), (sh_len + lengths)[:, None].astype(np.int32), lengths, slice(0, B), seg=True)
        lengths = lengths + 1
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])


def test_embed_tokens_clips_the_sentinel(params):
    jp, tp = params
    ids = [[IMAGE_TOKEN_INDEX, 5, 511, 900]]
    _close(tqwen.embed_tokens(tp["qwen"], torch.tensor(ids)), jqwen.embed_tokens(jp["qwen"], jnp.asarray(ids)))


def test_qwen_vit_forward(params):
    """The ViT (per-head packed in_proj, Dh 16) and the Resampler (E // 128
    = 1 head at this width) on two images."""
    jp, tp = params
    H = JCFG.vision.image_size
    images = np.random.default_rng(1).normal(size=(2, 3, H, H)).astype(np.float32)
    want = jvit.forward(jp["visual"], JCFG.vision, jnp.asarray(images))
    _close(tvit.forward(tp["visual"], TCFG.vision, torch.from_numpy(images)), want)
    _close(tqvl.encode_images(tp, TCFG, torch.from_numpy(images)), jqvl.encode_images(jp, JCFG, jnp.asarray(images)))


def test_qwen_vit_resampler_heads_and_interpolated_tables():
    """A tree at output_dim 256 (2 Resampler heads of Dh 128) whose position
    tables come from other grids (a 4x4 ViT table and a 3x3 sin-cos table
    interpolated to the 5x5 patch grid), through both forwards."""
    jc = dataclasses.replace(JCFG.vision, image_size=70, output_dim=256, n_queries=9)
    tc = dataclasses.replace(TCFG.vision, image_size=70, output_dim=256, n_queries=9)
    jp = jax.device_get(jvit.init(jax.random.PRNGKey(3), jc))
    rng = np.random.default_rng(6)
    src = rng.normal(size=(16, jc.width)).astype(np.float32)
    for tables in ((src, 25), (jvit.sincos_2d_pos_embed(256, 3), 25), (src, 16)):
        np.testing.assert_array_equal(tvit.interpolate_pos_embed(*tables), jvit.interpolate_pos_embed(*tables))
    np.testing.assert_array_equal(tvit.sincos_2d_pos_embed(256, 3), jvit.sincos_2d_pos_embed(256, 3))
    jp["pos_embed"] = jvit.interpolate_pos_embed(src, jc.num_patches)
    jp["resampler"]["pos_kv"] = jvit.interpolate_pos_embed(jvit.sincos_2d_pos_embed(256, 3), jc.num_patches)
    jp["resampler"]["in_proj"]["b"] = rng.normal(size=np.shape(jp["resampler"]["in_proj"]["b"])).astype(np.float32)
    images = rng.normal(size=(2, 3, 70, 70)).astype(np.float32)
    _close(tvit.forward(from_jax_params(jp, device="cpu"), tc, torch.from_numpy(images)),
           jvit.forward(jp, jc, jnp.asarray(images)))


@pytest.mark.parametrize("fuse", [True, False])
def test_quantize_qwen_params_bit_identical(params, fuse):
    """The port's layer-by-layer quantization gives the JAX tree's leaves
    exactly: int8 codes and fp32 scales of every stack and the lm_head,
    c_attn_b and the norms untouched."""
    jp, tp = params
    want = jax.device_get(jquantize(jp["qwen"], fuse=fuse))
    got = tquantize(tp["qwen"], fuse=fuse)
    flat_w = {jax.tree_util.keystr(p): x for p, x in jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {jax.tree_util.keystr(p): x for p, x in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert flat_g.keys() == flat_w.keys()
    for k, w in flat_w.items():
        g = flat_g[k].numpy()
        assert g.dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_synthetic_qwen_tree_matches_jax_layout(quant):
    """build_random_qwen_vl_params gives the JAX tree's keys, shapes and
    dtypes (qwen_vl.init, + quantize_qwen_params(fuse=True) for int8)."""
    from llava_align_tpu_torch.utils.synthetic import build_random_qwen_vl_params

    jp = jqvl.init(jax.random.PRNGKey(0), JCFG)  # not traceable: numpy position tables
    if quant == "int8":
        jp = dict(jp, qwen=jax.eval_shape(lambda p: jquantize(p, fuse=True), jp["qwen"]))
    tp = build_random_qwen_vl_params(TCFG, quant=quant, device="cpu", seed=0)
    want = {jax.tree_util.keystr(p): (tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for p, x in jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert got == want


def test_qwen_init_cache_on_meta():
    """The cache sizes without memory on the meta device (the POPE runner's
    group-batch budget asks an adapter for one)."""
    from llava_align_tpu_torch.decoding.adapters import QwenVLAdapter

    cache = QwenVLAdapter(tqvl.QwenVLConfig()).init_cache(1, 1, device=torch.device("meta"))
    assert cache["k"].is_meta and cache["k"].shape == (32, 1, 1, 32, 128)
    assert cache["k"].dtype == torch.bfloat16


def test_pope_group_batch_budget_takes_the_qwen_adapter():
    """The POPE runner's group-batch budget sizes a cache through the
    adapter on the meta device; with the QwenVLAdapter it gives a group
    count (1-4), off the card against the 16 GB fallback."""
    from llava_align_tpu_torch.config import GenerationConfig
    from llava_align_tpu_torch.decoding.adapters import QwenVLAdapter
    from llava_align_tpu_torch.decoding.engine import DecodeEngine
    from llava_align_tpu_torch.runners.pope import _auto_group_batch
    from llava_align_tpu_torch.utils.synthetic import build_random_qwen_vl_params

    params = build_random_qwen_vl_params(TCFG, device="cpu")
    engine = DecodeEngine(params, TCFG, GenerationConfig(use_dd=True, use_dd_unk=True),
                          adapter=QwenVLAdapter(TCFG), bucket=64)
    assert engine.device.type == "cpu"
    assert 1 <= _auto_group_batch(engine, 6, 8) <= 4
