"""Port parity: the shared-prefix attention of llava_align_tpu_torch.ops.attention
against the JAX package's XLA einsums, fp32 on the CPU, rtol = atol = 1e-5
(fp32 softmax attention over < 100 keys; the two sides only sum in other
orders).

Covered: one shared prefix (chunk and decode), grouped prefixes with G > 1,
the second segment table, plain rows after both spans, and rows with no
shared segment (sh_len = 0); and int8 (values, scales) segments, which the
port once refused and now takes as the JAX package does (the int8 KV
cache's tests are tests/test_torch_kv_quant.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llava_align_tpu.ops import attention as ja
from llava_align_tpu_torch.ops import attention as ta

TOL = dict(rtol=1e-5, atol=1e-5)
K, G_HEADS, DH = 2, 2, 16  # kv heads, query heads per kv head, head dim
H = K * G_HEADS


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _check(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_chunk_and_decode_one_prefix():
    rng = np.random.default_rng(0)
    B, S, P, Smax = 4, 5, 9, 12
    q, k, v = _rand(rng, B, S, H, DH), _rand(rng, B, S, K, DH), _rand(rng, B, S, K, DH)
    k_sh, v_sh = _rand(rng, P, K, DH), _rand(rng, P, K, DH)
    sh_len = np.array([9, 4, 0, 1], np.int32)  # row 2 has no shared segment
    want = ja.chunk_attention_shared(*map(jnp.asarray, (q, k, v, k_sh, v_sh, sh_len)))
    _check(ta.chunk_attention_shared(*_t(q, k, v, k_sh, v_sh, sh_len)), want)

    q1, kc, vc = _rand(rng, B, 1, H, DH), _rand(rng, B, Smax, K, DH), _rand(rng, B, Smax, K, DH)
    lengths = np.array([0, 3, 11, 6], np.int32)
    want = ja.decode_attention_shared(*map(jnp.asarray, (q1, kc, vc, lengths, k_sh, v_sh, sh_len)))
    _check(ta.decode_attention_shared(*_t(q1, kc, vc, lengths, k_sh, v_sh, sh_len)), want)


@pytest.mark.parametrize("second_table", [False, True])
def test_grouped_chunk(second_table):
    rng = np.random.default_rng(1)
    G, R, P, S = 3, 2, 7, 4
    G2, R2, P2 = 2, 3, 5
    M1 = G * R
    B = M1 + (G2 * R2 if second_table else 0)
    q, k, v = _rand(rng, B, S, H, DH), _rand(rng, B, S, K, DH), _rand(rng, B, S, K, DH)
    k_sh, v_sh = _rand(rng, G, P, K, DH), _rand(rng, G, P, K, DH)
    sh_len = rng.integers(0, P + 1, size=B).astype(np.int32)
    sh_len[1] = 0
    two_j, two_t = {}, {}
    if second_table:
        k2, v2 = _rand(rng, G2, P2, K, DH), _rand(rng, G2, P2, K, DH)
        sh_len[M1:] = rng.integers(0, P2 + 1, size=B - M1)
        sh_len[M1] = 0
        two_j = dict(k_sh2=jnp.asarray(k2), v_sh2=jnp.asarray(v2), rows_per_prefix2=R2)
        two_t = dict(k_sh2=torch.from_numpy(k2), v_sh2=torch.from_numpy(v2), rows_per_prefix2=R2)
    want = ja.chunk_attention_shared_grouped(
        *map(jnp.asarray, (q, k, v, k_sh, v_sh, sh_len)), R, **two_j)
    got = ta.chunk_attention_shared_grouped(*_t(q, k, v, k_sh, v_sh, sh_len), R, **two_t)
    _check(got, want)


@pytest.mark.parametrize("second_table,plain_rows", [(False, 0), (True, 0), (True, 3), (False, 2)])
def test_grouped_decode(second_table, plain_rows):
    rng = np.random.default_rng(2)
    G, R, P, Smax = 2, 3, 8, 10
    G2, R2, P2 = 2, 2, 6
    M1 = G * R
    M2 = G2 * R2 if second_table else 0
    B = M1 + M2 + plain_rows
    q = _rand(rng, B, 1, H, DH)
    kc, vc = _rand(rng, B, Smax, K, DH), _rand(rng, B, Smax, K, DH)
    lengths = rng.integers(0, Smax, size=B).astype(np.int32)
    k_sh, v_sh = _rand(rng, G, P, K, DH), _rand(rng, G, P, K, DH)
    sh_len = np.zeros((B,), np.int32)
    sh_len[:M1] = rng.integers(0, P + 1, size=M1)
    sh_len[2] = 0
    two_j, two_t = {}, {}
    if second_table:
        k2, v2 = _rand(rng, G2, P2, K, DH), _rand(rng, G2, P2, K, DH)
        sh_len[M1:M1 + M2] = rng.integers(1, P2 + 1, size=M2)
        two_j = dict(k_sh2=jnp.asarray(k2), v_sh2=jnp.asarray(v2), rows_per_prefix2=R2)
        two_t = dict(k_sh2=torch.from_numpy(k2), v_sh2=torch.from_numpy(v2), rows_per_prefix2=R2)
    want = ja.decode_attention_shared_grouped(
        *map(jnp.asarray, (q, kc, vc, lengths, k_sh, v_sh, sh_len)), R, **two_j)
    got = ta.decode_attention_shared_grouped(*_t(q, kc, vc, lengths, k_sh, v_sh, sh_len), R, **two_t)
    _check(got, want)


@pytest.mark.parametrize("step", ["chunk", "decode"])
def test_int8_segments_are_refused(step):
    """Formerly a refusal: int8 (values, scales) segments now attend as in
    the JAX package, the scales folded into the logits and probabilities."""
    rng = np.random.default_rng(3)
    seg = rng.integers(-127, 128, size=(3, K, DH)).astype(np.int8), rng.random((3, K, 1)).astype(np.float32)
    jseg, tseg = tuple(map(jnp.asarray, seg)), tuple(_t(*seg))
    sh_len = np.array([3], np.int32)
    if step == "chunk":
        q, k, v = _rand(rng, 1, 2, H, DH), _rand(rng, 1, 2, K, DH), _rand(rng, 1, 2, K, DH)
        want = ja.chunk_attention_shared(*map(jnp.asarray, (q, k, v)), jseg, jseg, jnp.asarray(sh_len))
        got = ta.chunk_attention_shared(*_t(q, k, v), tseg, tseg, torch.from_numpy(sh_len))
    else:
        q, kc, vc = _rand(rng, 1, 1, H, DH), _rand(rng, 1, 4, K, DH), _rand(rng, 1, 4, K, DH)
        lengths = np.array([2], np.int32)
        want = ja.decode_attention_shared(*map(jnp.asarray, (q, kc, vc, lengths)), jseg, jseg,
                                          jnp.asarray(sh_len))
        got = ta.decode_attention_shared(*_t(q, kc, vc, lengths), tseg, tseg, torch.from_numpy(sh_len))
    _check(got, want)
