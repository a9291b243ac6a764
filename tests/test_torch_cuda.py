"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip where torch sees no GPU. They are the checks of
chip_smoke.py's kernel phase at small shapes plus the wrappers' refusals:
K1/K2 (int8, each regime: bf16 on the tensor-core streaming kernel at every
row count 1-64, split over a cluster and not, fp32 on the CUDA cores; the
tiled one split over D and not), K3 (flash attention: bf16 on the tensor
cores, fp32 on the CUDA cores; causality, large scores; the Dh = 80
route to mha), K4 (int4, each regime; the wgmma one at prefill rows, split
over D and not), and the kernels of the TPU microbenchmark scripts
(ops/stream_probes: row-major int4 in both scale modes and bf16, on the
same streaming kernel, at the same rows, the smallest D each takes and a
ragged O; repeat2d, which is exact).
This file imports no jax, so on the machine with the card it runs without
the repository's conftest (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: bf16 outputs of two fp32 reductions taken in different orders may
land one bf16 ulp apart, <= 2^-7 of the largest output; allow 2^-6. K3 is
held to that row by row (each output row (b, s, h) against its own largest
element): the first rows attend to one key and are the largest outputs, so
one bound for the whole tensor would be as large as a typical value of the
long rows, and a skipped or mis-masked late key tile would pass under it.
K3's bf16 kernel also rounds the probabilities to bf16 before PV (as every
tensor-core flash kernel does), which stays inside the row bound. The
group-128 int4 streaming kernel rounds each scaled weight to bf16 exactly
as its plain version does, so only the order of the fp32 sums differs there.
"""

import pytest
import torch

from llava_align_tpu_torch.ops import attention, quant
from llava_align_tpu_torch.ops import stream_probes as sp

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


def _assert_rows_close(got, want):
    """Each row over the last dim within TOL of its own largest |want|."""
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs().amax(-1)
    ref = want.float().abs().amax(-1)
    assert bool((diff <= TOL * ref).all()), (diff / ref.clamp_min(1e-30)).max().item()


# the streaming kernels' row counts: each side of every n8 tile edge and of
# the instances' bounds (8, 16, 32, 64 rows), and 5 full n8 tiles of the
# 64-row instance (40)
STREAM_ROWS = [1, 2, 3, 4, 5, 8, 9, 16, 17, 18, 24, 31, 32, 33, 40, 48, 63, 64]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B", STREAM_ROWS)
def test_int8_stacked_kernel_matches_plain(dev, B, dtype):
    """bf16 runs the tensor-core streaming kernel, fp32 the CUDA-core body;
    ragged O (not a multiple of a block's rows), D % 16 == 0 but not a whole
    k-step, and the smallest D (16)."""
    assert quant.stream_regime(dtype, B) == ("mma" if dtype == torch.bfloat16 else "cuda_cores")
    g = torch.Generator(device=dev).manual_seed(B)
    for L, O, D in ((3, 200, 528), (2, 40, 16)):
        q = torch.randint(-127, 128, (L, O, D), dtype=torch.int8, device=dev, generator=g)
        s = torch.rand((L, O), device=dev, generator=g) / 100 + 1e-3
        h = torch.randn((B, D), device=dev, generator=g).to(dtype)
        for li in range(L):
            _assert_close(quant.int8_matmul_stacked(h, q, s, li),
                          quant.int8_matmul_stacked_plain(h, q, s, li))
        _assert_close(quant.int8_matmul_cuda(h, q[1], s[1]), quant.int8_matmul_plain(h, q[1], s[1]))


def _splits(fmt: str, B: int, O: int, D: int) -> int:
    """Blocks per channel tile of the tensor-core streaming kernel's split
    plan (csrc/stream_mma.cuh), for fmt "int8", "int4" or "bf16"."""
    from llava_align_tpu_torch.ops import _kernels

    return _kernels.lib().stream_mma_splits({"int8": 0, "int4": 1, "bf16": 2}[fmt], B, O, D)


def _stream_formats_match_plain(dev, B, O, D, seed):
    """int8, row-major int4 in both scale modes and bf16 at layer 1 of a
    2-layer stack, each against its plain version."""
    g = torch.Generator(device=dev).manual_seed(seed)
    L = 2
    h = torch.randn((B, D), device=dev, generator=g).to(torch.bfloat16)
    q = torch.randint(-127, 128, (L, O, D), dtype=torch.int8, device=dev, generator=g)
    s = torch.rand((L, O), device=dev, generator=g) / 100 + 1e-3
    _assert_close(quant.int8_matmul_stacked(h, q, s, 1), quant.int8_matmul_stacked_plain(h, q, s, 1))
    del q
    for group in (False, True) if D % 256 == 0 else (False,):
        p, s4 = _rowmajor_stack(dev, L, O, D, seed=seed + group, group=group)
        got = sp.int4_rowmajor_matmul_stacked(h, p, s4, 1)
        assert torch.equal(got, sp.int4_rowmajor_matmul_stacked(h, p, s4, 1))  # the splits sum in rank order
        _assert_close(got, sp.int4_rowmajor_matmul_stacked_plain(h, p, s4, 1))
    w = (torch.randn((L, O, D), device=dev, generator=g) * 0.02).to(torch.bfloat16)
    _assert_close(sp.bf16_matmul_stacked(h, w, 1), sp.bf16_matmul_stacked_plain(h, w, 1))


# LLaVA-v1.5-7B's narrow stacks: 32 channel tiles, so K splits over a cluster
@pytest.mark.parametrize("B", [1, 3, 16, 64])
@pytest.mark.parametrize("O,D", [(4096, 4096), (4096, 11008)])
def test_stream_kernels_split_k_full_width(dev, B, O, D):
    """The 7B o and down stacks at full width in every streaming format
    (int8, row-major int4 in both scale modes, bf16), where the plan splits
    K over 4 or 8 blocks and the blocks reach the card's SMs: a lost or
    doubled split moves every output by far more than TOL."""
    for fmt in ("int8", "int4", "bf16"):
        assert _splits(fmt, B, O, D) in (4, 8), fmt
    _stream_formats_match_plain(dev, B, O, D, seed=O + D + B)


def test_stream_plan_leaves_wide_stacks_whole(dev):
    """The 7B gate|up stack (172 channel tiles at 17-64 rows) fills the SMs
    unsplit; a row too short for two splits of 2 k-steps stays whole."""
    for fmt in ("int8", "int4", "bf16"):
        assert _splits(fmt, 64, 22016, 4096) == 1, fmt
        assert _splits(fmt, 3, 200, 32) == 1, fmt
    assert _splits("int8", 65, 4096, 4096) == -1  # past the streaming rows


# ragged splits: a partial last k-step and k-step counts that the splits
# divide unevenly (at D = 2080 int8 walks 17 steps of 128 bytes in 8
# splits, int4 5 steps of 256 in 2 at 3 rows); group int4 at D = 2304
@pytest.mark.parametrize("B", [3, 17, 40, 64])
@pytest.mark.parametrize("O,D", [(200, 2080), (136, 2304)])
def test_stream_kernels_split_k_ragged(dev, B, O, D):
    assert _splits("int8", B, O, D) > 1
    _stream_formats_match_plain(dev, B, O, D, seed=O + D + B)


def _qkv(dev, B, S, H, K, Dh, dtype, seed, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn((B, S, H, Dh), device=dev, generator=g) * scale).to(dtype)
    k = (torch.randn((B, S, K, Dh), device=dev, generator=g) * scale).to(dtype)
    v = torch.randn((B, S, K, Dh), device=dev, generator=g).to(dtype)
    return q, k, v


# K3 in bf16 runs on the tensor cores and rounds P to bf16 before PV, on top
# of the output's own bf16 rounding: both stay within TOL (2^-6) of each
# row's largest output. Lengths around the 64-key tile (1, 63, 64, 65,
# ragged 77) and the model paths' 640 and 896; at scale 5, q and k are
# scaled so the scores reach +-60: the running max moves by large steps
# between key tiles, and the online rescale carries it.
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("H,K", [(8, 8), (4, 2), (40, 40), (32, 8)])
@pytest.mark.parametrize("S,scale", [(S, 1.0) for S in (1, 63, 64, 65, 77, 640, 896)]
                         + [(77, 5.0), (640, 5.0)])
def test_flash_kernel_matches_plain(dev, S, scale, H, K, Dh, B):
    q, k, v = _qkv(dev, B, S, H, K, Dh, torch.bfloat16, seed=S + Dh + H + K + B, scale=scale)
    if scale > 1:
        scores = torch.einsum("bqd,bkd->bqk", q[:, :, 0].float(), k[:, :, 0].float()) / Dh**0.5
        assert scores.abs().max().item() > 60
    _assert_rows_close(attention.flash_attention(q, k, v), attention.flash_attention_plain(q, k, v))


@pytest.mark.parametrize("B,S,H,K,Dh", [(1, 640, 8, 8, 128), (2, 77, 4, 2, 64), (1, 1, 2, 1, 128)])
def test_flash_kernel_fp32_matches_plain(dev, B, S, H, K, Dh):
    """fp32 runs the CUDA-core kernel."""
    q, k, v = _qkv(dev, B, S, H, K, Dh, torch.float32, seed=S)
    _assert_rows_close(attention.flash_attention(q, k, v), attention.flash_attention_plain(q, k, v))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("i", [0, 63, 100, 191])
def test_flash_kernel_is_causal(dev, i, dtype):
    """k and v perturbed at keys > i leave rows <= i bit-identical."""
    q, k, v = _qkv(dev, 2, 200, 8, 4, 128, dtype, seed=i)
    g = torch.Generator(device=dev).manual_seed(1000 + i)
    k2, v2 = k.clone(), v.clone()
    k2[:, i + 1:] += torch.randn(k2[:, i + 1:].shape, device=dev, generator=g).to(dtype) * 8
    v2[:, i + 1:] += torch.randn(v2[:, i + 1:].shape, device=dev, generator=g).to(dtype) * 8
    a = attention.flash_attention(q, k, v)
    b = attention.flash_attention(q, k2, v2)
    torch.cuda.synchronize()
    assert torch.equal(a[:, : i + 1], b[:, : i + 1])
    assert not torch.equal(a[:, i + 1:], b[:, i + 1:])


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


def test_int8_tiled_regime_splits_and_last_layer(dev):
    """The tiled regime with D split over blocks (few tiles, 32 k-steps) and
    without (70 column tiles), at the last layer of a 3-layer stack."""
    from llava_align_tpu_torch.ops import _kernels

    g = torch.Generator(device=dev).manual_seed(11)
    for B, O, D, split in ((130, 400, 2048, True), (65, 70 * 256 - 40, 256, False)):
        L = 3
        q = torch.randint(-127, 128, (L, O, D), dtype=torch.int8, device=dev, generator=g)
        s = torch.rand((L, O), device=dev, generator=g) / 100 + 1e-3
        h = torch.randn((B, D), device=dev, generator=g).to(torch.bfloat16)
        assert (_kernels.lib().int8_mm_workspace(B, O, D) > 0) == split
        _assert_close(quant.int8_matmul_stacked(h, q, s, L - 1), quant.int8_matmul_stacked_plain(h, q, s, L - 1))
        _assert_close(quant.int8_matmul_cuda(h, q[L - 1], s[L - 1]), quant.int8_matmul_plain(h, q[L - 1], s[L - 1]))


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


@pytest.mark.parametrize("B", [1, 2, 3, 4, 7, 18, 32, 33, 64])
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


@pytest.mark.parametrize("B", [130, 640, 3072])
@pytest.mark.parametrize("D,O", [(512, 400), (768, 272)])  # 2 and 3 groups per half; ragged O
def test_int4_wgmma_regime_matches_plain(dev, B, D, O):
    """The wgmma regime at prefill row counts, layers 0 and L-1 (a pointer
    offset into the stack)."""
    L = 3
    q4, gs = _int4_stack(dev, L, D, O, seed=B + D)
    h = torch.randn((B, D), device=dev, generator=torch.Generator(device=dev).manual_seed(B)).to(torch.bfloat16)
    for li in (0, L - 1):
        _assert_close(quant.int4_matmul_stacked(h, q4, gs, li), quant.int4_matmul_stacked_plain(h, q4, gs, li))


@pytest.mark.parametrize("B,O,D,split", [(quant.INT4_WGMMA_MIN_ROWS, 400, 2048, True), (72, 256, 4096, True),
                                         (130, 70 * 256 - 16, 256, False), (640, 256, 4096, True)])
def test_int4_wgmma_regime_splits(dev, B, O, D, split):
    """The wgmma regime with D split over blocks (a few column tiles, up to
    64 k-steps) and without (70 column tiles), at the last layer; from its
    first row count (INT4_WGMMA_MIN_ROWS) on."""
    from llava_align_tpu_torch.ops import _kernels

    L = 2
    q4, gs = _int4_stack(dev, L, D, O, seed=B)
    h = torch.randn((B, D), device=dev, generator=torch.Generator(device=dev).manual_seed(12)).to(torch.bfloat16)
    assert (_kernels.lib().int4_mm_workspace(B, O, D) > 0) == split
    _assert_close(quant.int4_matmul_stacked(h, q4, gs, L - 1), quant.int4_matmul_stacked_plain(h, q4, gs, L - 1))


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


def test_int8_stacked_dispatch_streams_output_major_prefill_rows(dev):
    """An O >= D stack at 65..640 rows takes K1's tiled regime, as the TPU
    package streams it; an O < D stack there takes the dequant path."""
    g = torch.Generator(device=dev).manual_seed(9)
    for O, D, to_k1 in ((384, 256, True), (256, 384, False)):
        q = torch.randint(-127, 128, (2, O, D), dtype=torch.int8, device=dev, generator=g)
        s = torch.rand((2, O), device=dev, generator=g) / 100 + 1e-3
        h = torch.randn((2, 256, D), device=dev, generator=g).to(torch.bfloat16)
        before = quant.int8_matmul_stacked.launches
        got = quant.int8_matmul_stacked_dispatch(h, {"q": q, "s": s}, 1)
        assert quant.int8_matmul_stacked.launches == before + int(to_k1)
        _assert_close(got.reshape(512, O), quant.int8_matmul_stacked_plain(h.reshape(512, D), q, s, 1))


def test_causal_attention_dh80_runs_mha_not_k3(dev):
    """A Dh = 80 bf16 prefill (a shape K3 does not take) goes through
    causal_attention to mha; K3 is not launched."""
    q, k, v = _qkv(dev, 2, 77, 8, 4, 80, torch.bfloat16, seed=80)
    before = attention.flash_attention.launches
    got = attention.causal_attention(q, k, v)
    assert attention.flash_attention.launches == before
    _assert_rows_close(got, attention.mha(q, k, v, causal=True))
    q, k, v = _qkv(dev, 2, 77, 8, 4, 128, torch.bfloat16, seed=128)
    attention.causal_attention(q, k, v)
    assert attention.flash_attention.launches == before + 1


def _rowmajor_stack(dev, L, O, D, seed, group):
    g = torch.Generator(device=dev).manual_seed(seed)
    p = torch.randint(-128, 128, (L, O, D // 2), dtype=torch.int8, device=dev, generator=g)
    shape = (L, O, D // 128) if group else (L, O)
    s = (torch.rand(shape, device=dev, generator=g) + 0.5) / (7.0 * D**0.5)
    return p, s


@pytest.mark.parametrize("group", [False, True])
@pytest.mark.parametrize("B", STREAM_ROWS)
def test_int4_rowmajor_kernel_matches_plain(dev, B, group):
    """Both scale modes, any packed byte (both nibbles sign-extend), ragged
    O, layers 0 and L-1, the smallest D of each mode (32, 256); per-channel
    also at D % 256 != 0."""
    for L, O, D in ((3, 200, 512), (2, 96, 1024), (2, 40, 256)) + (() if group else ((2, 72, 96), (2, 40, 32))):
        p, s = _rowmajor_stack(dev, L, O, D, seed=B + D, group=group)
        h = torch.randn((B, D), device=dev, generator=torch.Generator(device=dev).manual_seed(B))
        h = h.to(torch.bfloat16)
        for li in (0, L - 1):
            _assert_close(sp.int4_rowmajor_matmul_stacked(h, p, s, li),
                          sp.int4_rowmajor_matmul_stacked_plain(h, p, s, li))


@pytest.mark.parametrize("B", STREAM_ROWS)
def test_bf16_stream_kernel_matches_plain(dev, B):
    g = torch.Generator(device=dev).manual_seed(B)
    for L, O, D in ((3, 200, 520), (2, 40, 8)):  # ragged O; D % 8 == 0 only, and the smallest D
        w = torch.randn((L, O, D), device=dev, generator=g).to(torch.bfloat16)
        h = torch.randn((B, D), device=dev, generator=g).to(torch.bfloat16)
        for li in (0, L - 1):
            _assert_close(sp.bf16_matmul_stacked(h, w, li), sp.bf16_matmul_stacked_plain(h, w, li))


def test_repeat2d_kernel_is_exact(dev):
    from llava_align_tpu_torch.scripts import probe_mosaic_ops

    src = probe_mosaic_ops.sources(dev)
    for name in probe_mosaic_ops.OPS:
        got = probe_mosaic_ops.run(name, src)
        torch.cuda.synchronize()
        assert torch.equal(got, probe_mosaic_ops.run(name, src, plain=True)), name
    # a strided source (a column window of a wider tensor), both maps at once
    x = torch.randn((40, 70), device=dev)[:, 3:50]
    args = ((96, 33), ("repeat", 3), ("tile", 11), (2, 5), -1.5)
    assert torch.equal(sp.repeat2d(x, *args), sp.repeat2d_plain(x, *args))


def test_stream_probe_wrappers_refuse_what_the_kernels_do_not_take(dev):
    p, s = _rowmajor_stack(dev, 2, 64, 512, seed=1, group=True)
    h = torch.zeros((4, 512), dtype=torch.bfloat16, device=dev)
    with pytest.raises(TypeError):  # bf16 activations only
        sp.int4_rowmajor_matmul_stacked(h.float(), p, s, 0)
    with pytest.raises(ValueError):  # rows past 64
        sp.int4_rowmajor_matmul_stacked(torch.zeros((65, 512), dtype=torch.bfloat16, device=dev), p, s, 0)
    with pytest.raises(ValueError):  # group 64, not 128
        sp.int4_rowmajor_matmul_stacked(h, p, torch.ones((2, 64, 8), device=dev), 0)
    with pytest.raises(ValueError):  # group mode needs D % 256 == 0
        sp.int4_rowmajor_matmul_stacked(torch.zeros((4, 384), dtype=torch.bfloat16, device=dev),
                                        p[..., :192].contiguous(), s[..., :3].contiguous(), 0)
    with pytest.raises(ValueError):  # not contiguous
        sp.int4_rowmajor_matmul_stacked(torch.zeros((512, 4), dtype=torch.bfloat16, device=dev).t(), p, s, 0)
    with pytest.raises(ValueError):  # mixed devices
        sp.int4_rowmajor_matmul_stacked(h, p.cpu(), s, 0)
    with pytest.raises(ValueError):  # layer out of range
        sp.int4_rowmajor_matmul_stacked(h, p, s, 2)
    w = torch.zeros((2, 64, 512), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):  # fp32 weights
        sp.bf16_matmul_stacked(h, w.float(), 0)
    with pytest.raises(TypeError):
        sp.bf16_matmul_stacked(h.half(), w, 0)
    x = torch.zeros((8, 16), device=dev)
    with pytest.raises(ValueError):  # reads past the source
        sp.repeat2d(x, (8, 32), ("repeat", 1), ("tile", 32))
    with pytest.raises(TypeError):  # fp32 only
        sp.repeat2d(x.double(), (8, 32), ("repeat", 1), ("tile", 16))
    with pytest.raises(TypeError):  # rows must be contiguous
        sp.repeat2d(x.t(), (16, 8), ("repeat", 1), ("tile", 8))
