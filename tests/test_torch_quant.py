"""Port parity: llava_align_tpu_torch.ops.quant against the JAX package.

The plain versions of K1/K2 (what the CUDA kernels compute) are held to the
Pallas kernels run in interpret mode at shapes where _choose_blocks returns a
block config (D=512, O=256, as tests/test_quant.py does); the dispatchers to
the JAX CPU path int8_matmul_xla. Everything is fp32 on the CPU.
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

# fp32 dot products of D=512 terms summed in different orders (blocked in
# the Pallas kernel, BLAS on the torch side): a few fp32 ulps of the sum of
# |terms|, i.e. ~1e-5 of the outputs' scale
MM_RTOL, MM_ATOL = 1e-5, 1e-4


def _np(t):
    return t.detach().cpu().numpy()


def test_quantize_weight_matches():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 48, 80)).astype(np.float32)
    w[1, 5] = 0.0  # an all-zero output row takes scale 1.0 on both sides
    jw = jq.quantize_weight(jnp.asarray(w))
    tw = tq.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(_np(tw["q"]), np.asarray(jw["q"]))  # bit-exact
    np.testing.assert_allclose(_np(tw["s"]), np.asarray(jw["s"]), rtol=1e-6, atol=0)
    np.testing.assert_allclose(_np(tq.dequantize(tw, torch.float32)),
                               np.asarray(jq.dequantize(jw, jnp.float32)), rtol=1e-6, atol=0)


@pytest.mark.parametrize("fuse", [True, False])
def test_quantize_llama_params_tree_bit_exact(fuse):
    from llava_align_tpu.config import LlamaConfig
    from llava_align_tpu.models import llama as jllama

    params = jllama.init(jax.random.PRNGKey(0), LlamaConfig.tiny(vocab_size=97))
    want = jax.device_get(jq.quantize_llama_params(params, fuse=fuse))
    got = tq.quantize_llama_params(from_jax_params(jax.device_get(params), device="cpu"), fuse=fuse)

    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert sorted(jax.tree_util.keystr(p) for p, _ in flat_w) == sorted(
        jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(
            jax.tree_util.tree_map(_np, got))[0]
    )
    for path, leaf in flat_w:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(_np(node), np.asarray(leaf), err_msg=jax.tree_util.keystr(path))


def _stack(seed, L, O, D):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(L, O, D)).astype(np.float32)
    wq = jax.device_get(jq.quantize_weight(jnp.asarray(w)))
    return wq, from_jax_params(wq, device="cpu")


# rows at the streaming kernel's n8-tile edges (1, 8, 9, 17) and its bound (64)
@pytest.mark.parametrize("B,li", [(3, 0), (3, 2), (24, 1), (16, 3), (1, 0), (8, 1), (9, 2), (17, 3), (64, 0)])
def test_k1_plain_matches_pallas_interpret(B, li):
    L, O, D = 4, 256, 512
    wq, tw = _stack(1, L, O, D)
    assert jq._choose_blocks(O, D, jq._round_up(B, 16)) is not None
    h = np.random.default_rng(2).normal(size=(B, D)).astype(np.float32)
    want = jq.int8_matmul_stacked(jnp.asarray(h), jnp.asarray(wq["q"]), jnp.asarray(wq["s"]),
                                  jnp.asarray(li, jnp.int32), interpret=True)
    got = tq.int8_matmul_stacked(torch.from_numpy(h), tw["q"], tw["s"], li)  # CPU → plain
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=MM_RTOL, atol=MM_ATOL)


@pytest.mark.parametrize("B", [1, 3, 8, 9, 17, 24, 64])
def test_k2_plain_matches_pallas_interpret(B):
    wq, tw = _stack(3, 1, 256, 512)
    q, s = wq["q"][0], wq["s"][0]
    h = np.random.default_rng(4).normal(size=(B, 512)).astype(np.float32)
    want = jq.int8_matmul_tpu(jnp.asarray(h), jnp.asarray(q), jnp.asarray(s), interpret=True)
    got = tq.int8_matmul_cuda(torch.from_numpy(h), tw["q"][0], tw["s"][0])
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=MM_RTOL, atol=MM_ATOL)


@pytest.mark.parametrize("rows", [(3,), (2, 5), (80,), (3, 128)])  # kernel rows, then dequant rows
def test_dispatchers_match_xla_path(rows):
    L, O, D = 3, 96, 64
    wq, tw = _stack(5, L, O, D)
    h = np.random.default_rng(6).normal(size=rows + (D,)).astype(np.float32)
    for li in range(L):
        want = jq.int8_matmul_xla(jnp.asarray(h), jnp.asarray(wq["q"][li]), jnp.asarray(wq["s"][li]))
        got = tq.int8_matmul_stacked_dispatch(torch.from_numpy(h), tw, li)
        assert tuple(got.shape) == rows + (O,)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=MM_RTOL, atol=MM_ATOL)
    want = jq.int8_matmul(jnp.asarray(h), {"q": jnp.asarray(wq["q"][0]), "s": jnp.asarray(wq["s"][0])})
    got = tq.int8_matmul(torch.from_numpy(h), {"q": tw["q"][0], "s": tw["s"][0]})
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=MM_RTOL, atol=MM_ATOL)


def test_dequant_path_rounds_like_xla():
    """int8_matmul_dequant is the twin of int8_matmul_xla: q*s is rounded to
    the activation dtype BEFORE the matmul (bf16 here), unlike the kernels."""
    wq, tw = _stack(7, 1, 64, 128)
    h = np.random.default_rng(8).normal(size=(70, 128)).astype(np.float32)
    want = jq.int8_matmul_xla(jnp.asarray(h, jnp.bfloat16), jnp.asarray(wq["q"][0]),
                              jnp.asarray(wq["s"][0]))
    got = tq.int8_matmul_dequant(torch.from_numpy(h).to(torch.bfloat16), tw["q"][0], tw["s"][0])
    # one bf16 ulp (2^-7 relative) of the output's scale: the two bf16
    # matmuls accumulate in fp32 in different orders before the final rounding
    scale = np.abs(np.asarray(want, np.float32)).max()
    np.testing.assert_allclose(_np(got.float()), np.asarray(want, np.float32), rtol=0,
                               atol=2.0**-7 * scale)


# ---------------------------------------------------------------------------
# K1/K2's regime rule (no card needed; the streaming kernel's split plan is
# computed in csrc/stream_mma.cuh and checked on the card)
# ---------------------------------------------------------------------------

# each side of the streaming kernel's n8-tile edges and instance bounds
# (8, 16, 32, 64 rows), and the tiled regime's rows
_REGIME_CASES = (
    [(torch.bfloat16, B, "mma") for B in (1, 2, 3, 4, 5, 8, 9, 16, 17, 18, 24, 31, 32, 33, 48, 63, 64)]
    + [(torch.float32, B, "cuda_cores") for B in (1, 2, 3, 4, 5, 8, 9, 16, 17, 18, 24, 31, 32, 33, 48, 63, 64)]
    + [(torch.bfloat16, B, "tiled") for B in (65, 72, 640)]
)


@pytest.mark.parametrize("dtype,rows,regime", _REGIME_CASES)
def test_stream_regime_rule(dtype, rows, regime):
    """bf16 at 1..64 rows runs the tensor-core streaming kernel, fp32 the
    CUDA-core body, bf16 past 64 rows the tiled regime."""
    assert tq.stream_regime(dtype, rows) == regime


def test_stream_regime_refuses_what_no_regime_takes():
    with pytest.raises(TypeError):
        tq.stream_regime(torch.float32, 65)  # the tiled regime takes bf16 only
    for rows in (0, 641):
        with pytest.raises(ValueError):
            tq.stream_regime(torch.bfloat16, rows)
