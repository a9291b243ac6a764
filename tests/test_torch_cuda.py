"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip where torch sees no GPU. They are the checks of
chip_smoke.py's kernel phase at small shapes plus the wrappers' refusals:
K1/K2 (int8, both regimes), K3 (flash attention) and K4 (int4, both
regimes).
This file imports no jax, so on the machine with the card it runs without
the repository's conftest (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: bf16 outputs of two fp32 reductions taken in different orders may
land one bf16 ulp apart, <= 2^-7 of the largest output; allow 2^-6.
"""

import pytest
import torch

from llava_align_tpu_torch.ops import attention, quant

TOL = 2.0**-6

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _assert_close(got, want):
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL * want.float().abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B", [1, 3, 5, 16, 33, 64])
def test_int8_stacked_kernel_matches_plain(dev, B, dtype):
    g = torch.Generator(device=dev).manual_seed(B)
    L, O, D = 3, 200, 528  # ragged O (not a multiple of a block's rows), D % 16 == 0
    q = torch.randint(-127, 128, (L, O, D), dtype=torch.int8, device=dev, generator=g)
    s = torch.rand((L, O), device=dev, generator=g) / 100 + 1e-3
    h = torch.randn((B, D), device=dev, generator=g).to(dtype)
    for li in range(L):
        _assert_close(quant.int8_matmul_stacked(h, q, s, li),
                      quant.int8_matmul_stacked_plain(h, q, s, li))
    _assert_close(quant.int8_matmul_cuda(h, q[1], s[1]), quant.int8_matmul_plain(h, q[1], s[1]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,K,Dh", [(1, 640, 8, 8, 128), (2, 77, 4, 2, 64), (1, 1, 2, 1, 128)])
def test_flash_kernel_matches_plain(dev, B, S, H, K, Dh, dtype):
    g = torch.Generator(device=dev).manual_seed(S)
    q = torch.randn((B, S, H, Dh), device=dev, generator=g).to(dtype)
    k = torch.randn((B, S, K, Dh), device=dev, generator=g).to(dtype)
    v = torch.randn((B, S, K, Dh), device=dev, generator=g).to(dtype)
    _assert_close(attention.flash_attention(q, k, v), attention.flash_attention_plain(q, k, v))


@pytest.mark.parametrize("B", [65, 72, 130, 640])
def test_int8_tiled_regime_matches_plain(dev, B):
    """Rows past DECODE_MAX_ROWS: the tensor-core regime of K1 and K2, bf16;
    ragged O and a ragged last row tile."""
    g = torch.Generator(device=dev).manual_seed(B)
    L, O, D = 2, 200, 576
    q = torch.randint(-127, 128, (L, O, D), dtype=torch.int8, device=dev, generator=g)
    s = torch.rand((L, O), device=dev, generator=g) / 100 + 1e-3
    h = torch.randn((B, D), device=dev, generator=g).to(torch.bfloat16)
    for li in range(L):
        _assert_close(quant.int8_matmul_stacked(h, q, s, li),
                      quant.int8_matmul_stacked_plain(h, q, s, li))
    _assert_close(quant.int8_matmul_cuda(h, q[1], s[1]), quant.int8_matmul_plain(h, q[1], s[1]))


def test_int8_lm_head_dispatch_runs_the_kernel_past_decode_rows(dev):
    """The lm_head (O >= D) takes K2 up to STREAM_MAX_ROWS, as the TPU
    package streams it; nothing dequantizes to a dense weight."""
    g = torch.Generator(device=dev).manual_seed(7)
    O, D = 512, 128
    q = torch.randint(-127, 128, (O, D), dtype=torch.int8, device=dev, generator=g)
    s = torch.rand((O,), device=dev, generator=g) / 100 + 1e-3
    h = torch.randn((4, 18, D), device=dev, generator=g).to(torch.bfloat16)
    before = quant.int8_matmul_cuda.launches
    got = quant.int8_matmul(h, {"q": q, "s": s})
    assert quant.int8_matmul_cuda.launches == before + 1
    _assert_close(got.reshape(72, O), quant.int8_matmul_plain(h.reshape(72, D), q, s))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros((2, 64, 64), dtype=torch.int8, device=dev)
    s = torch.ones((2, 64), device=dev)
    h = torch.zeros((641, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        quant.int8_matmul_stacked(h, q, s, 0)  # rows past the kernel's bound
    with pytest.raises(TypeError):  # the tiled regime takes bf16 only
        quant.int8_matmul_stacked(h[:65].float(), q, s, 0)
    with pytest.raises(ValueError):
        quant.int8_matmul_stacked(h[:4, :48].contiguous(), q, s, 0)  # D mismatch
    with pytest.raises(TypeError):
        quant.int8_matmul_stacked(h[:4].half(), q, s, 0)
    x = torch.zeros((1, 8, 2, 32), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        attention.flash_attention(x, x, x)  # Dh=32 not taken


def _int4_stack(dev, L, D, O, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q4 = torch.randint(-128, 128, (L, D // 2, O), dtype=torch.int8, device=dev, generator=g)
    gs = (torch.rand((L, D // 128, O), device=dev, generator=g) + 0.5) / (7.0 * D**0.5)
    return q4, gs


def _int4_rows():
    thr = quant.INT4_SKINNY_MAX_ROWS
    near = {max(thr - 1, 1), max(thr, 1), thr + 1}
    return sorted(near | {1, 3, 18, 72, 130, 300})


@pytest.mark.parametrize("L,D,O", [(3, 512, 384), (2, 768, 400)])  # ragged O; 3 groups per half
def test_int4_kernel_matches_plain_default_dispatch(dev, L, D, O):
    """Rows below, at and above INT4_SKINNY_MAX_ROWS, at layers 0 and L-1."""
    q4, gs = _int4_stack(dev, L, D, O, seed=D)
    for B in _int4_rows():
        h = torch.randn((B, D), device=dev, generator=torch.Generator(device=dev).manual_seed(B))
        h = h.to(torch.bfloat16)
        for li in (0, L - 1):
            _assert_close(quant.int4_matmul_stacked(h, q4, gs, li),
                          quant.int4_matmul_stacked_plain(h, q4, gs, li))


@pytest.mark.parametrize("B", [1, 2, 3, 4, 7, 18, 33, 64])
def test_int4_kernel_each_regime(dev, B):
    """Each regime at its own row counts (the split-K paths of both), bf16;
    the skinny regime (B <= INT4_SKINNY_MAX_ROWS) in fp32 as well."""
    L, D, O = 2, 1024, 640
    q4, gs = _int4_stack(dev, L, D, O, seed=B)
    g = torch.Generator(device=dev).manual_seed(100 + B)
    dtypes = [torch.bfloat16] + ([torch.float32] if B <= quant.INT4_SKINNY_MAX_ROWS else [])
    for dtype in dtypes:
        h = torch.randn((B, D), device=dev, generator=g).to(dtype)
        for li in (0, L - 1):
            _assert_close(quant.int4_matmul_stacked(h, q4, gs, li),
                          quant.int4_matmul_stacked_plain(h, q4, gs, li))


def test_int4_dispatch_runs_the_kernel(dev):
    q4, gs = _int4_stack(dev, 2, 512, 256, seed=1)
    h = torch.randn((2, 5, 512), device=dev).to(torch.bfloat16)
    before = quant.int4_matmul_stacked.launches
    got = quant.int4_matmul_stacked_dispatch(h, {"q4": q4, "gs": gs}, 1)
    assert quant.int4_matmul_stacked.launches == before + 1
    assert got.shape == (2, 5, 256)
    _assert_close(got.reshape(10, 256), quant.int4_matmul_stacked_plain(h.reshape(10, 512), q4, gs, 1))


def test_int4_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q4, gs = _int4_stack(dev, 2, 512, 256, seed=2)
    h = torch.zeros((4, 512), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):  # group 64, not 128
        quant.int4_matmul_stacked(h, q4, torch.ones((2, 8, 256), device=dev), 0)
    with pytest.raises(ValueError):  # D % 256 != 0
        quant.int4_matmul_stacked(torch.zeros((4, 384), dtype=torch.bfloat16, device=dev),
                                  q4[:, :192].contiguous(), gs[:, :3].contiguous(), 0)
    with pytest.raises(ValueError):  # O % 16 != 0
        quant.int4_matmul_stacked(h, q4[..., :200].contiguous(), gs[..., :200].contiguous(), 0)
    with pytest.raises(ValueError):  # mixed devices
        quant.int4_matmul_stacked(h, q4.cpu(), gs, 0)
    with pytest.raises(ValueError):  # not contiguous
        quant.int4_matmul_stacked(torch.zeros((512, 4), dtype=torch.bfloat16, device=dev).t(), q4, gs, 0)
    with pytest.raises(ValueError):  # layer out of range
        quant.int4_matmul_stacked(h, q4, gs, 2)
    with pytest.raises(TypeError):  # the tiled regime (4 rows) takes bf16 only
        quant.int4_matmul_stacked(h.float(), q4, gs, 0)
    with pytest.raises(TypeError):
        quant.int4_matmul_stacked(h.half(), q4, gs, 0)
