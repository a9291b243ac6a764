"""Port parity: llava_align_tpu_torch.ops.layers / ops.image against the JAX
package on the same numpy-seeded inputs.

Tolerance: 1e-6 relative (plus 1e-6 absolute for values near zero) — both
sides compute in fp32 on the CPU, and only the order of the few ops inside
each primitive may differ. TF32 is off so no fp32 op on a card would round
to 10 mantissa bits (it does not apply on the CPU, but states the policy).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llava_align_tpu.ops import image as jimage
from llava_align_tpu.ops import layers as jl
from llava_align_tpu_torch.ops import image as timage
from llava_align_tpu_torch.ops import layers as tl

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL, ATOL = 1e-6, 1e-6


def _close(t_out, j_out):
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def arrs():
    rng = np.random.default_rng(0)
    return {
        "x": rng.normal(size=(2, 5, 64)).astype(np.float32),
        "scale": rng.normal(size=(64,)).astype(np.float32),
        "bias": rng.normal(size=(64,)).astype(np.float32),
        "heads": rng.normal(size=(2, 5, 4, 16)).astype(np.float32),
        "pos": rng.integers(0, 600, size=(2, 5)).astype(np.int32),
    }


@pytest.mark.parametrize("name", ["quick_gelu", "silu", "gelu_exact"])
def test_activation(arrs, name):
    x = arrs["x"]
    _close(getattr(tl, name)(torch.from_numpy(x)), getattr(jl, name)(jnp.asarray(x)))


def test_rms_norm(arrs):
    x, s = arrs["x"], arrs["scale"]
    _close(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-5),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5))


def test_layer_norm(arrs):
    x, s, b = arrs["x"], arrs["scale"], arrs["bias"]
    _close(tl.layer_norm(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b), 1e-5),
           jl.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 1e-5))


def test_rope_cos_sin(arrs):
    pos = arrs["pos"]
    tc, ts = tl.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0)
    jc, js = jl.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    _close(tc, jc)
    _close(ts, js)


def test_apply_rope(arrs):
    x, pos = arrs["heads"], arrs["pos"]
    jc, js = jl.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    # same cos/sin on both sides: the rotation itself at 1e-6
    out_t = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(np.array(jc)),
                          torch.from_numpy(np.array(js)))
    _close(out_t, jl.apply_rope(jnp.asarray(x), jc, js))


def test_normalize_device_uint8_and_float():
    rng = np.random.default_rng(1)
    u8 = rng.integers(0, 256, size=(2, 3, 8, 8), dtype=np.uint8)
    _close(timage.normalize_device(torch.from_numpy(u8), torch.float32),
           jimage.normalize_device(jnp.asarray(u8), jnp.float32))
    f = rng.normal(size=(3, 8, 8)).astype(np.float32)
    _close(timage.normalize_device(torch.from_numpy(f), torch.float32),
           jimage.normalize_device(jnp.asarray(f), jnp.float32))
    np.testing.assert_allclose(timage.normalize_host(u8[0]), jimage.normalize_host(u8[0]),
                               rtol=RTOL, atol=ATOL)
