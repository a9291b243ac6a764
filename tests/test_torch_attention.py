"""Port parity: llava_align_tpu_torch.ops.attention against the JAX package.

K3's plain version (what csrc/flash_attn.cu computes) is held to the Pallas
flash kernel in interpret mode at tests/test_attention.py's shapes; mha and
decode_attention to their XLA twins. fp32 on the CPU throughout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llava_align_tpu.ops import attention as ja
from llava_align_tpu_torch.ops import attention as ta

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# fp32 softmax attention, blockwise online softmax (Pallas) vs one-shot
# softmax (torch): the same bound tests/test_attention.py puts on
# flash-vs-XLA
FLASH_RTOL, FLASH_ATOL = 1e-3, 2e-4
# one-shot fp32 softmax on both sides; only reduction order differs
RTOL, ATOL = 1e-5, 1e-5


def _qkv(seed, B, Sq, Sk, H, K, Dh):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, Dh)).astype(np.float32),
            rng.normal(size=(B, Sk, K, Dh)).astype(np.float32),
            rng.normal(size=(B, Sk, K, Dh)).astype(np.float32))


def test_k3_plain_matches_pallas_interpret():
    q, k, v = _qkv(2, 2, 256, 256, 4, 2, 128)
    want = ja.flash_attention_tpu(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  block_q=128, block_k=128, interpret=True)
    got = ta.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))  # CPU → plain
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FLASH_RTOL, atol=FLASH_ATOL)


@pytest.mark.parametrize("S", [40, 128])  # the kernel takes any S; ragged too
def test_causal_attention_matches_xla(S):
    q, k, v = _qkv(3, 2, S, S, 4, 2, 16)
    want = ja.causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="xla")
    got = ta.causal_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_mha_matches_mha_xla(causal):
    q, k, v = _qkv(4, 2, 9, 9, 4, 2, 16)
    want = ja.mha_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    got = ta.mha(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_decode_attention_per_row_lengths():
    q, kc, vc = _qkv(5, 3, 1, 24, 4, 2, 16)
    rng = np.random.default_rng(6)
    lengths = np.array([20, 3, 11], np.int32)
    # garbage past each row's length must not leak in
    for b, n in enumerate(lengths):
        kc[b, n + 1:] = rng.normal(size=kc[b, n + 1:].shape) * 50
    want = ja.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lengths))
    got = ta.decode_attention(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                              torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
