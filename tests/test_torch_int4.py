"""Port parity: the int4 part of llava_align_tpu_torch.ops.quant against the
JAX package, on the CPU in fp32.

quantize_weight_int4 keeps the JAX layout (packed int8 [..., D/2, O],
split-half, fp32 group scales [..., D/g, O]), so its bytes and scales are
bit-identical and dequantize_int4 is exact. K4's plain version (what the
CUDA kernel computes) is held to int4_matmul_xla and to the Pallas kernel in
interpret mode on shapes with several D-grid steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llava_align_tpu.ops import quant as jq
from llava_align_tpu_torch.ops import quant as tq
from llava_align_tpu_torch.utils.jax_params import from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# fp32 dot products over D terms summed in other orders (blocked in the
# Pallas kernel and XLA, BLAS on the torch side): a few fp32 ulps of the sum
# of |terms|, ~1e-5 of the outputs' scale
MM_RTOL, MM_ATOL = 1e-5, 1e-4


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("shape,group", [((48, 512), 128), ((3, 40, 256), 128), ((2, 24, 96), 16)])
def test_quantize_weight_int4_bit_identical(shape, group):
    rng = np.random.default_rng(0)
    w = rng.normal(size=shape).astype(np.float32)
    w[..., 0, :group] = 0.0  # an all-zero group takes scale 1.0 on both sides
    w[..., 1, :] = -3.0      # full-scale values land exactly on the -7 code
    jw = jax.device_get(jq.quantize_weight_int4(jnp.asarray(w), group=group))
    tw = tq.quantize_weight_int4(torch.from_numpy(w), group=group)
    assert tw["q4"].dtype == torch.int8 and tw["gs"].dtype == torch.float32
    np.testing.assert_array_equal(_np(tw["q4"]), jw["q4"])
    np.testing.assert_array_equal(_np(tw["gs"]), jw["gs"])
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = tq.dequantize_int4(tw, dtype)
        want = np.asarray(jq.dequantize_int4(jw, jdtype)).astype(np.float32)
        np.testing.assert_array_equal(_np(got.float()), want)
    with pytest.raises(ValueError):
        tq.quantize_weight_int4(torch.zeros((4, 3 * group)), group=group)


def test_int4_auto_group_matches():
    for dims in [(4096, 11008, 4096), (5120, 13824), (64, 128, 64), (96,), (100, 6)]:
        assert tq.int4_auto_group(dims) == jq.int4_auto_group(dims)


def _stack(seed, L, O, D):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(L, O, D)) * 0.05).astype(np.float32)
    wq = jax.device_get(jq.quantize_weight_int4(jnp.asarray(w)))
    return wq, from_jax_params(wq, device="cpu")


@pytest.mark.parametrize("rows", [(3,), (2, 5), (72,), (3, 96)])
def test_plain_and_dispatch_match_xla(rows):
    L, O, D = 3, 96, 512
    wq, tw = _stack(1, L, O, D)
    h = np.random.default_rng(2).normal(size=rows + (D,)).astype(np.float32)
    for li in range(L):
        want = np.asarray(jq.int4_matmul_xla(jnp.asarray(h), jnp.asarray(wq["q4"][li]),
                                             jnp.asarray(wq["gs"][li])))
        got = tq.int4_matmul_stacked_dispatch(torch.from_numpy(h), tw, li)  # CPU → plain
        assert tuple(got.shape) == rows + (O,)
        np.testing.assert_allclose(_np(got), want, rtol=MM_RTOL, atol=MM_ATOL)
        want_d = jax.device_get(jq.int4_matmul_stacked_dispatch(jnp.asarray(h), wq, li))
        np.testing.assert_allclose(_np(got), want_d, rtol=MM_RTOL, atol=MM_ATOL)


@pytest.mark.parametrize("B,li", [(3, 0), (17, 1)])
def test_plain_matches_pallas_interpret_multiblock(B, li):
    """The Pallas kernel in interpret mode (as tests/test_quant.py runs it)
    with several D-grid steps; K4's plain version and the CPU wrapper."""
    L, O, D = 2, 512, 16384
    assert jq._choose_blocks_int4(O, D // 2, jq._round_up(B, 16))[0] < D // 2
    wq, tw = _stack(3, L, O, D)
    h = np.random.default_rng(4).normal(size=(B, D)).astype(np.float32)
    want = np.asarray(jq.int4_matmul_stacked(jnp.asarray(h), jnp.asarray(wq["q4"]),
                                             jnp.asarray(wq["gs"]), li, interpret=True))
    got = tq.int4_matmul_stacked(torch.from_numpy(h), tw["q4"], tw["gs"], li)
    np.testing.assert_allclose(_np(got), want, rtol=MM_RTOL, atol=MM_ATOL)
    np.testing.assert_allclose(_np(tq.int4_matmul_stacked_plain(torch.from_numpy(h), tw["q4"],
                                                                tw["gs"], li)), want,
                               rtol=MM_RTOL, atol=MM_ATOL)


@pytest.mark.parametrize("fuse", [True, False])
def test_quantize_llama_params_int4_tree_bit_exact(fuse):
    from llava_align_tpu.config import LlamaConfig
    from llava_align_tpu.models import llama as jllama

    params = jllama.init(jax.random.PRNGKey(0), LlamaConfig.tiny(vocab_size=97))
    want = jax.device_get(jq.quantize_llama_params(params, fuse=fuse, bits=4))
    got = tq.quantize_llama_params(from_jax_params(jax.device_get(params), device="cpu"),
                                   fuse=fuse, bits=4)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    got_flat = jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(_np, got))[0]
    assert sorted(jax.tree_util.keystr(p) for p, _ in flat) == sorted(
        jax.tree_util.keystr(p) for p, _ in got_flat
    )
    for path, leaf in flat:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(_np(node), np.asarray(leaf), err_msg=jax.tree_util.keystr(path))
    assert tq.is_quantized(got["lm_head"])  # the lm_head stays int8


def test_fused_int4_equals_unfused_parts():
    """Group scales run along the contraction, so quantizing q|k|v (gate|up)
    fused equals quantizing the parts and concatenating along O."""
    from llava_align_tpu_torch.config import LlamaConfig

    cfg = LlamaConfig.tiny(vocab_size=97)
    rng = np.random.default_rng(5)
    L, D, F, QD, KD = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.q_dim, cfg.kv_dim

    def w(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    params = {"layers": {"q": w(L, QD, D), "k": w(L, KD, D), "v": w(L, KD, D), "o": w(L, D, QD),
                         "gate": w(L, F, D), "up": w(L, F, D), "down": w(L, D, F)},
              "lm_head": w(97, D)}
    fused = tq.quantize_llama_params(params, fuse=True, bits=4)["layers"]
    parts = tq.quantize_llama_params(params, fuse=False, bits=4)["layers"]
    for name, names in (("qkv", ("q", "k", "v")), ("gateup", ("gate", "up"))):
        for key in ("q4", "gs"):
            torch.testing.assert_close(fused[name][key],
                                       torch.cat([parts[n][key] for n in names], dim=-1),
                                       rtol=0, atol=0)


def test_from_jax_params_keeps_int4_layout_and_fp32_scales():
    wq, _ = _stack(6, 2, 64, 256)
    tree = {"layers": {"down": wq}, "embed": np.ones((4, 8), np.float32)}
    got = from_jax_params(tree, device="cpu", dtype=torch.bfloat16)
    assert got["embed"].dtype == torch.bfloat16
    assert got["layers"]["down"]["q4"].dtype == torch.int8
    assert got["layers"]["down"]["gs"].dtype == torch.float32  # not rounded to bf16
    np.testing.assert_array_equal(_np(got["layers"]["down"]["q4"]), wq["q4"])
    np.testing.assert_array_equal(_np(got["layers"]["down"]["gs"]), wq["gs"])
