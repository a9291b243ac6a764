"""Port parity: llava_align_tpu_torch.decoding.sampler against the JAX
sampler on the same numpy-seeded logits (fp32, CPU).

The masks are compared exactly (which entries become -inf) and the kept
values to 1e-6 relative: the warpers only divide by the temperature and
select, so the two sides differ at most by one fp32 rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llava_align_tpu.decoding import sampler as js
from llava_align_tpu_torch.decoding import sampler as ts


def _logits(seed, shape=(3, 50)):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    x[:, 7] = x[:, 3]  # ties, which top-k keeps and top-p orders stably
    return x


def _same(got, want):
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    keep = ~np.isneginf(want)
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, None, None), (0.7, None, None), (1.0, 5, None), (1.0, 0, None),
    (1.0, None, 0.8), (1.0, None, 1.0), (0.9, 20, 0.9), (1.3, 3, 0.5),
])
def test_warp_logits(temperature, top_k, top_p):
    x = _logits(0)
    _same(ts.warp_logits(torch.from_numpy(x), temperature, top_k, top_p),
          js.warp_logits(jnp.asarray(x), temperature, top_k, top_p))


@pytest.mark.parametrize("alpha,beta", [(1.0, 0.1), (0.5, 0.2)])
def test_fuse_contrastive_logits(alpha, beta):
    x, cd = _logits(1), _logits(2)
    _same(ts.fuse_contrastive_logits(torch.from_numpy(x), torch.from_numpy(cd), alpha, beta),
          js.fuse_contrastive_logits(jnp.asarray(x), jnp.asarray(cd), alpha, beta))


def test_fuse_calibrate_logits():
    x, cu = np.abs(_logits(3)), _logits(4)
    _same(ts.fuse_calibrate_logits(torch.from_numpy(x), torch.from_numpy(cu), 0.3, 0.5, 2),
          js.fuse_calibrate_logits(jnp.asarray(x), jnp.asarray(cu), 0.3, 0.5, 2))


def test_greedy_takes_the_first_maximum():
    x = _logits(5)
    x[:, 11] = x.max() + 1.0
    x[:, 30] = x.max()  # a tie with column 11: both pick 11
    got = ts.sample_token(None, torch.from_numpy(x), do_sample=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(js.sample_token(None, jnp.asarray(x), False)))


def test_sampling_stays_inside_the_warped_support():
    x = ts.warp_logits(torch.from_numpy(_logits(6)), 1.0, 4, None)
    g = torch.Generator().manual_seed(0)
    draws = torch.stack([ts.sample_token(g, x) for _ in range(200)])
    assert torch.isfinite(x.gather(-1, draws.T)).all()
