"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip where torch sees no GPU. They are the checks of
chip_smoke.py's kernel phase at small shapes plus the wrappers' refusals.
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


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros((2, 64, 64), dtype=torch.int8, device=dev)
    s = torch.ones((2, 64), device=dev)
    h = torch.zeros((65, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        quant.int8_matmul_stacked(h, q, s, 0)  # rows past the kernel's bound
    with pytest.raises(ValueError):
        quant.int8_matmul_stacked(h[:4, :48].contiguous(), q, s, 0)  # D mismatch
    with pytest.raises(TypeError):
        quant.int8_matmul_stacked(h[:4].half(), q, s, 0)
    x = torch.zeros((1, 8, 2, 32), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        attention.flash_attention(x, x, x)  # Dh=32 not taken
