"""VCD's diffusion noise (llava_align_tpu_torch/ops/noise.py) against the JAX
package's ops/noise.py: the schedule exactly, and q(x_t | x_0) within 1e-6
(fp32 multiply-adds in both) when the port is given the JAX function's own
standard-normal draw as eps, at t in {0, 500, 999}, for fp32 and bf16
images; the port's draw reproducible under one torch.Generator seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llava_align_tpu.ops import noise as jnoise
from llava_align_tpu_torch.ops import noise as tnoise


def test_diffusion_schedule_identical():
    for got, want in zip(tnoise.diffusion_schedule(), jnoise.diffusion_schedule()):
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)
    assert tnoise.NUM_DIFFUSION_STEPS == jnoise.NUM_DIFFUSION_STEPS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [0, 500, 999])
def test_add_diffusion_noise_matches_jax(t, dtype):
    rng = jax.random.PRNGKey(3)
    x_np = np.random.default_rng(t).standard_normal((2, 3, 28, 28)).astype(np.float32) * 2
    jdt, tdt = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = jnoise.add_diffusion_noise(jnp.asarray(x_np, jdt), rng, t)
    # the draw the JAX function makes inside, reproduced
    eps = np.array(jax.random.normal(rng, x_np.shape, dtype=jnp.float32))
    got = tnoise.add_diffusion_noise(torch.from_numpy(x_np).to(tdt), t, eps=torch.from_numpy(eps))
    assert got.dtype == tdt and tuple(got.shape) == x_np.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0, atol=1e-6)


def test_generator_seed_reproducible():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 28, 28)).astype(np.float32))
    a, b, c = (tnoise.add_diffusion_noise(x, 500, generator=torch.Generator().manual_seed(s)) for s in (7, 7, 8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # noise step 0 keeps the image within the schedule's sqrt(1 - alpha_bar_0)
    near = tnoise.add_diffusion_noise(x, 0, generator=torch.Generator().manual_seed(7))
    assert (near - x).abs().max() < 0.05


def test_numpy_input_and_refusals():
    x = np.random.default_rng(1).standard_normal((3, 4, 4)).astype(np.float32)
    eps = torch.ones((3, 4, 4))
    out = tnoise.add_diffusion_noise(x, 999, eps=eps, device="cpu")
    sqrt_ab, sqrt_1m_ab = tnoise.diffusion_schedule()
    np.testing.assert_allclose(out.numpy(), sqrt_ab[999] * x + sqrt_1m_ab[999], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="noise_step"):
        tnoise.add_diffusion_noise(torch.from_numpy(x), 1000, eps=eps)
    with pytest.raises(ValueError, match="eps"):
        tnoise.add_diffusion_noise(torch.from_numpy(x), 5, eps=torch.ones((3, 4)))
    if not torch.cuda.is_available():  # numpy input goes to the GPU unless device="cpu"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tnoise.add_diffusion_noise(x, 5, eps=eps)
