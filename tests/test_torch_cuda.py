"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip where torch sees no GPU. They are the checks of
chip_smoke.py's kernel phase at small shapes plus the wrappers' refusals:
K1/K2 (int8, each regime: bf16 on the tensor-core streaming kernel at every
row count 1-64, split over a cluster and not, fp32 on the CUDA cores; the
tiled one split over D and not), K3 (flash attention: bf16 on the tensor
cores, fp32 on the CUDA cores; causality, large scores; the Dh = 80
route to mha), K4 (int4, each regime: the streaming kernel at every decode
row count, split over a cluster and not, deterministic; the wgmma one at
prefill rows, split over D and not; the C regime rule against
quant.int4_regime), and the kernels of the TPU microbenchmark scripts
(ops/stream_probes: row-major int4 in both scale modes and bf16, on the
same streaming kernel, at the same rows, the smallest D each takes and a
ragged O; repeat2d, which is exact); K3 at the VCD runner's prefill shapes,
and a VCD `generate` on the card against its plain fp32 run on the CPU;
K2 at Qwen-VL's [151936, 4096] lm_head in both regimes, and the
QwenVLAdapter's `generate` on a 2-layer full-width Qwen-VL against its fp32
run on the CPU; a 5-beam InstructBLIP `generate_beam` (fp32, its prefill on
K3) against the same on the CPU; W8A8 (codes and product) at 256 and 640
rows and the int8-cache decode attention against the CPU, and a sampled
`generate` (W8A8 and the int8 cache on, and off) reproduced under one seed;
a BLIP-2 OPT `generate` whose positions run past OPT's learned position
table, against the CPU; two fp32 train steps of a tiny LLaVA on the card
against the CPU, and the kernels' refusal of an input that requires grad
(causal_attention's 'auto' takes mha under grad); a 2-layer full-width
fp32 forward of each LAVIS family (BLIP ITM, ALBEF's retrieval step, BLIP
classification, CLIP's contrastive loss, BLIP-2 stage 1's pretraining
losses) on the card against the CPU. This file imports no jax, so on the machine with the card it runs without
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

import functools

import pytest
import torch

from llava_align_tpu_torch.ops import attention, quant
from llava_align_tpu_torch.ops import stream_probes as sp
from llava_align_tpu_torch.utils import lavis_cuts

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


# the VCD POPE runner's prefills on LLaVA-v1.5-7B: 6 questions x (main, cd)
# image rows at the 896 bucket (--no-group-by-image --batch-size 6), and 2
# groups x (clean, noised) prefix segments at 768 (--group-by-image)
@pytest.mark.parametrize("B,S", [(12, 896), (4, 768)])
def test_flash_kernel_vcd_shapes_match_plain(dev, B, S):
    q, k, v = _qkv(dev, B, S, 32, 32, 128, torch.bfloat16, seed=B + S)
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
    """Each side of every K4 regime threshold, the grouped path's decode rows
    (18, 72) and prefill-like rows past the streaming kernel."""
    near = set()
    for thr in (quant.INT4_SKINNY_MAX_ROWS, quant.INT4_STREAM_MAX_ROWS):
        near |= {thr - 1, thr, thr + 1}
    return sorted(near | {1, 3, 18, 72, 130, 300})


@pytest.mark.parametrize("L,D,O", [(3, 512, 384), (2, 768, 400)])  # ragged O; 3 groups per half
def test_int4_kernel_matches_plain_default_dispatch(dev, L, D, O):
    """Rows below, at and above each regime threshold, at layers 0 and L-1."""
    q4, gs = _int4_stack(dev, L, D, O, seed=D)
    for B in _int4_rows():
        h = torch.randn((B, D), device=dev, generator=torch.Generator(device=dev).manual_seed(B))
        h = h.to(torch.bfloat16)
        for li in (0, L - 1):
            _assert_close(quant.int4_matmul_stacked(h, q4, gs, li),
                          quant.int4_matmul_stacked_plain(h, q4, gs, li))


@pytest.mark.parametrize("B", [1, 2, 3, 4, 7, 18, 32, 33, 64, quant.INT4_WGMMA_MIN_ROWS])
def test_int4_kernel_each_regime(dev, B):
    """Each regime at its own row counts, bf16 (the streaming kernel's
    cluster split: 3 channel tiles over 16 k-steps); the skinny regime
    (B <= INT4_SKINNY_MAX_ROWS) in fp32 as well, split over D."""
    L, D, O = 2, 1024, 640
    q4, gs = _int4_stack(dev, L, D, O, seed=B)
    g = torch.Generator(device=dev).manual_seed(100 + B)
    dtypes = [torch.bfloat16] + ([torch.float32] if B <= quant.INT4_SKINNY_MAX_ROWS else [])
    for dtype in dtypes:
        h = torch.randn((B, D), device=dev, generator=g).to(dtype)
        for li in (0, L - 1):
            _assert_close(quant.int4_matmul_stacked(h, q4, gs, li),
                          quant.int4_matmul_stacked_plain(h, q4, gs, li))


# the streaming kernel's rows: each side of every n8 tile edge and of its
# instances' bounds (8, 16, 24, 32, 48, 72 rows), the grouped path's 18 and
# 72, and the first row past it (the wgmma regime)
INT4_STREAM_ROWS = [1, 2, 3, 4, 8, 9, 16, 17, 18, 24, 25, 31, 32, 33, 40, 48, 49, 64, 65, 72,
                    quant.INT4_STREAM_MAX_ROWS + 1]


@pytest.mark.parametrize("B", INT4_STREAM_ROWS)
@pytest.mark.parametrize("D,O", [(512, 400), (768, 272)])  # 2 and 3 groups per half; O % 256 != 0
def test_int4_stream_kernel_matches_plain(dev, B, D, O):
    """bf16 at decode rows (the streaming kernel, and the regime on each side
    of it), layers 0 and L-1 (a pointer offset into the stack), a ragged
    channel tile."""
    L = 3
    q4, gs = _int4_stack(dev, L, D, O, seed=B + D)
    h = torch.randn((B, D), device=dev, generator=torch.Generator(device=dev).manual_seed(B)).to(torch.bfloat16)
    for li in (0, L - 1):
        _assert_close(quant.int4_matmul_stacked(h, q4, gs, li), quant.int4_matmul_stacked_plain(h, q4, gs, li))


@pytest.mark.parametrize("B", [3, 18, 72])
@pytest.mark.parametrize("O,D", [(256, 4096), (5120, 13824)])  # one channel tile; the 13B down stack
def test_int4_stream_kernel_cluster_split_deterministic(dev, B, O, D):
    """Narrow stacks split K over a cluster (the plan's blocks per channel
    tile, from the C entry int4_mm_splits); the splits meet in rank order, so
    two calls are bit-identical; no workspace."""
    from llava_align_tpu_torch.ops import _kernels

    assert quant.int4_regime(torch.bfloat16, B) == "stream"
    assert _kernels.lib().int4_mm_splits(B, O, D, 1) > 1
    assert _kernels.lib().int4_mm_workspace(B, O, D, 1) == 0
    L = 2
    q4, gs = _int4_stack(dev, L, D, O, seed=B + O)
    h = torch.randn((B, D), device=dev, generator=torch.Generator(device=dev).manual_seed(7)).to(torch.bfloat16)
    got = quant.int4_matmul_stacked(h, q4, gs, L - 1)
    assert torch.equal(got, quant.int4_matmul_stacked(h, q4, gs, L - 1))
    _assert_close(got, quant.int4_matmul_stacked_plain(h, q4, gs, L - 1))


# int4_regime's rows (tests/test_torch_int4.py)
INT4_REGIME_ROWS = [1, 2, 3, 16, 18, 32, 33, 64, 72, quant.INT4_STREAM_MAX_ROWS + 1, 640, 3072]


@pytest.mark.parametrize("B", INT4_REGIME_ROWS)
def test_int4_regime_c_entry_agrees(dev, B):
    """The rule compiled into csrc/int4_mm.cu (int4_mm_regime) is
    quant.int4_regime, in both dtypes (-1 where int4_regime refuses)."""
    from llava_align_tpu_torch.ops import _kernels

    codes = {"skinny": 0, "stream": 1, "wgmma": 2}
    for dtype in (torch.bfloat16, torch.float32):
        try:
            want = codes[quant.int4_regime(dtype, B)]
        except TypeError:
            want = -1
        assert _kernels.lib().int4_mm_regime(B, 5120, 13824, _kernels.DTYPE_CODE[dtype]) == want


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


@pytest.mark.parametrize("B,O,D,split", [(quant.INT4_WGMMA_MIN_ROWS, 400, 2048, True), (128, 256, 4096, True),
                                         (130, 70 * 256 - 16, 256, False), (640, 256, 4096, True)])
def test_int4_wgmma_regime_splits(dev, B, O, D, split):
    """The wgmma regime with D split over blocks (a few column tiles, up to
    64 k-steps) and without (70 column tiles), at the last layer; from its
    first row count (INT4_WGMMA_MIN_ROWS) on."""
    from llava_align_tpu_torch.ops import _kernels

    L = 2
    q4, gs = _int4_stack(dev, L, D, O, seed=B)
    h = torch.randn((B, D), device=dev, generator=torch.Generator(device=dev).manual_seed(12)).to(torch.bfloat16)
    assert quant.int4_regime(torch.bfloat16, B) == "wgmma"
    assert (_kernels.lib().int4_mm_workspace(B, O, D, 1) > 0) == split
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
    with pytest.raises(TypeError):  # fp32 above the skinny rows (4 rows): no regime takes it
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


# repeat2d's paths, each exact: (source shape, column window start, output
# shape, row map, column map, window offset)
REPEAT2D_PATHS = {
    "float4_tile": ((8, 64), 0, (16, 128), ("tile", 8), ("tile", 16), (0, 4)),
    "float4_tile_period_past_row": ((6, 40), 0, (5, 32), ("repeat", 2), ("tile", 33), (1, 4)),
    "float4_repeat_by_one": ((6, 40), 0, (12, 24), ("repeat", 2), ("repeat", 1), (0, 8)),
    "broadcast_repeat": ((9, 20), 0, (9, 64), ("tile", 9), ("repeat", 4), (0, 3)),
    "broadcast_repeat_8": ((4, 20), 0, (33, 96), ("repeat", 9), ("repeat", 8), (0, 7)),
    "scalar_gather_tile": ((7, 20), 0, (7, 24), ("tile", 7), ("tile", 6), (0, 1)),
    "scalar_gather_repeat": ((7, 20), 0, (14, 24), ("repeat", 2), ("repeat", 3), (0, 2)),
    "scalar_misaligned_source": ((6, 41), 1, (6, 32), ("tile", 6), ("tile", 16), (0, 0)),
    "scalar_tail_tile": ((5, 20), 0, (10, 30), ("tile", 5), ("tile", 7), (0, 2)),
    "scalar_tail_repeat": ((5, 20), 0, (10, 30), ("repeat", 2), ("repeat", 2), (0, 1)),
    "rows_past_the_grid": ((7, 8), 0, (65535 * 256 + 5, 4), ("tile", 7), ("tile", 4), (0, 4)),
}


@pytest.mark.parametrize("path", list(REPEAT2D_PATHS))
def test_repeat2d_kernel_each_path_is_exact(dev, path):
    """The redesigned copy's paths: one float4 of contiguous source elements
    (tile with n % 4 == 0 or a period past the row, repeat by 1), one load
    broadcast to four (repeat with n % 4 == 0), one element a thread (any
    other map, a source not 16-byte aligned, or cols % 4 != 0), and more
    rows than the grid's 65535 row blocks cover (the row loop strides)."""
    src_shape, start, shape, rows, cols, offset = REPEAT2D_PATHS[path]
    g = torch.Generator(device=dev).manual_seed(len(path))
    x = torch.randn(src_shape, device=dev, generator=g)[:, start:]
    for scale in (1.0, -0.75):
        got = sp.repeat2d(x, shape, rows, cols, offset, scale)
        torch.cuda.synchronize()
        assert torch.equal(got, sp.repeat2d_plain(x, shape, rows, cols, offset, scale)), (path, scale)


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


def _to_cpu32(node):
    if isinstance(node, dict):
        return {k: _to_cpu32(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_cpu32(v) for v in node]
    return node.cpu().float() if node.is_floating_point() else node.cpu()


def test_generate_batch_on_card_matches_cpu_fp32(dev):
    """generate_batch on LLaVA-v1.5-7B at full width cut to 2 decoder / 2
    vision layers, int8, dual VDD: the first-step fused scores of a batch
    that mixes images and None, on the card (the kernels, bf16) against the
    same params in fp32 on the CPU (the plain versions), within 5e-2 of the
    largest score where both are finite (chip_smoke's bound for bf16 against
    fp32 over 2 layers); the plausibility cutoff may differ for tokens right
    at it, on at most 1% of the vocabulary."""
    import dataclasses

    import numpy as np

    from llava_align_tpu_torch.config import GenerationConfig, LlavaConfig
    from llava_align_tpu_torch.decoding.engine import DecodeEngine
    from llava_align_tpu_torch.runners.common import MockTokenizer, build_prompt
    from llava_align_tpu_torch.tokenization import tokenizer_image_token
    from llava_align_tpu_torch.utils.synthetic import build_random_llava_params

    full = LlavaConfig.llava_v15_7b()

    def cut(dtype=None):
        text = dataclasses.replace(full.text, num_layers=2, **({"dtype": dtype} if dtype else {}))
        vision = dataclasses.replace(full.vision, num_layers=3, **({"dtype": dtype} if dtype else {}))
        return dataclasses.replace(full, text=text, vision=vision)

    params = build_random_llava_params(cut(), quant="int8", device=dev, seed=5)
    params_cpu = _to_cpu32(params)
    tok = MockTokenizer()
    rng = np.random.default_rng(0)
    batch = [(tokenizer_image_token(build_prompt(f"Is there a {o} in the image?", "llava_v1")[0], tok),
              rng.integers(0, 256, (3, 336, 336), dtype=np.uint8) if o != "car" else None)
             for o in ("dog", "car", "dining table")]
    gen = GenerationConfig(max_new_tokens=1, do_sample=False, use_dd=True, use_dd_unk=True,
                           cd_alpha=1.0, cd_beta=0.1, eos_token_id=10**9)
    with torch.inference_mode():
        got = DecodeEngine(params, cut(), gen).submit_batch(batch)["first_scores"].float().cpu()
        want = DecodeEngine(params_cpu, cut(torch.float32), gen).submit_batch(batch)["first_scores"]
    both = torch.isfinite(got) & torch.isfinite(want)
    assert (torch.isfinite(got) != torch.isfinite(want)).float().mean().item() <= 0.01
    err = (got[both] - want[both]).abs().max().item() / want[both].abs().max().item()
    assert err <= 5e-2, err


def test_vcd_generate_on_card_matches_cpu_fp32(dev, monkeypatch):
    """VCD `generate` (use_cd, cd_alpha 1, cd_beta 0.1, noise step 500) on
    LLaVA-v1.5-7B at full width cut to 2 decoder / 2 vision layers, int8:
    the first-step fused scores on the card against the same params in
    fp32 on the CPU, both given one eps (made with numpy) for the noised
    image, within 5e-2 of the largest score where both are finite; the
    plausibility cutoff may differ on at most 1% of the vocabulary."""
    import dataclasses

    import numpy as np

    from llava_align_tpu_torch.config import GenerationConfig, LlavaConfig
    from llava_align_tpu_torch.decoding import engine as engine_mod
    from llava_align_tpu_torch.decoding.engine import DecodeEngine
    from llava_align_tpu_torch.ops import noise
    from llava_align_tpu_torch.runners.common import MockTokenizer, build_prompt
    from llava_align_tpu_torch.tokenization import tokenizer_image_token
    from llava_align_tpu_torch.utils.synthetic import build_random_llava_params

    full = LlavaConfig.llava_v15_7b()

    def cut(dtype=None):
        text = dataclasses.replace(full.text, num_layers=2, **({"dtype": dtype} if dtype else {}))
        vision = dataclasses.replace(full.vision, num_layers=3, **({"dtype": dtype} if dtype else {}))
        return dataclasses.replace(full, text=text, vision=vision)

    eps = torch.from_numpy(np.random.default_rng(9).standard_normal((1, 3, 336, 336)).astype(np.float32))
    monkeypatch.setattr(engine_mod, "add_diffusion_noise",
                        lambda x, t, generator=None: noise.add_diffusion_noise(x, t, eps=eps))
    params = build_random_llava_params(cut(), quant="int8", device=dev, seed=6)
    params_cpu = _to_cpu32(params)
    ids = tokenizer_image_token(build_prompt("Is there a dog in the image?", "llava_v1")[0], MockTokenizer())
    image = np.random.default_rng(1).integers(0, 256, (3, 336, 336), dtype=np.uint8)
    gen = GenerationConfig(max_new_tokens=1, do_sample=False, use_cd=True, cd_alpha=1.0, cd_beta=0.1,
                           noise_step=500, eos_token_id=10**9)
    with torch.inference_mode():
        got = DecodeEngine(params, cut(), gen).submit_generate(ids, image)["first_scores"].float().cpu()
        want = DecodeEngine(params_cpu, cut(torch.float32), gen).submit_generate(ids, image)["first_scores"]
    both = torch.isfinite(got) & torch.isfinite(want)
    assert (torch.isfinite(got) != torch.isfinite(want)).float().mean().item() <= 0.01
    err = (got[both] - want[both]).abs().max().item() / want[both].abs().max().item()
    assert err <= 5e-2, err


# K2 at Qwen-VL's lm_head: 151936 channels is 1187 x 128, not a multiple of
# the tiled regime's 256-channel tiles; the Qwen paths' decode and prefill
# rows in the streaming regime, and two row counts in the tiled one
QWEN_LM_HEAD = (151936, 4096)
QWEN_LM_HEAD_ROWS = [1, 3, 12, 18, 64, 65, 640]


@pytest.fixture(scope="module")
def qwen_lm_head():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda:0").manual_seed(12)
    O, D = QWEN_LM_HEAD
    q = torch.randint(-127, 128, (O, D), dtype=torch.int8, device="cuda:0", generator=g)
    s = (torch.rand((O,), device="cuda:0", generator=g) + 0.5) / (127.0 * D**0.5)
    return q, s, g


@pytest.mark.parametrize("B", QWEN_LM_HEAD_ROWS)
def test_int8_lm_head_qwen_width_matches_plain(dev, qwen_lm_head, B):
    q, s, g = qwen_lm_head
    h = torch.randn((B, q.shape[1]), device=dev, generator=g).to(torch.bfloat16)
    assert quant.stream_regime(h.dtype, B) == ("mma" if B <= quant.DECODE_MAX_ROWS else "tiled")
    before = quant.int8_matmul_cuda.launches
    got = quant.int8_matmul(h, {"q": q, "s": s})
    assert quant.int8_matmul_cuda.launches == before + 1
    want = quant.int8_matmul_plain(h, q, s)
    _assert_close(got, want)
    # the last channels (the ragged tail past the last 256-channel tile) too
    _assert_close(got[:, -200:], want[:, -200:])


def test_qwen_adapter_generate_on_card_matches_cpu_fp32(dev):
    """DecodeEngine with the QwenVLAdapter on Qwen-VL-7B at full width cut
    to 2 decoder / 2 vision layers, int8 (a nonzero c_attn_b), dual VDD with
    explicit 'unk' ids: the first-step fused scores on the card (K1, K2, K3,
    bf16) against the same params in fp32 on the CPU (the plain versions),
    within 5e-2 of the largest score where both are finite; the
    plausibility cutoff may differ on at most 1% of the vocabulary."""
    import dataclasses

    import numpy as np

    from llava_align_tpu_torch.config import GenerationConfig
    from llava_align_tpu_torch.decoding.adapters import QwenVLAdapter
    from llava_align_tpu_torch.decoding.engine import DecodeEngine
    from llava_align_tpu_torch.models import qwen_vl
    from llava_align_tpu_torch.utils.synthetic import build_random_qwen_vl_params

    full = qwen_vl.QwenVLConfig.qwen_vl_7b()

    def cut(dtype=None):
        text = dataclasses.replace(full.text, num_layers=2, **({"dtype": dtype} if dtype else {}))
        vision = dataclasses.replace(full.vision, num_layers=2, **({"dtype": dtype} if dtype else {}))
        return dataclasses.replace(full, text=text, vision=vision)

    params = build_random_qwen_vl_params(cut(), quant="int8", device=dev, seed=7)
    b = params["qwen"]["layers"]["c_attn_b"]
    b.copy_(torch.randn(b.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(8)) * 0.5)
    params_cpu = _to_cpu32(params)
    rng = np.random.default_rng(2)
    span, _ = qwen_vl.sentinelize_span(qwen_vl.make_image_span_ids(full), full)
    text = [int(t) for t in rng.integers(3, 150000, 12)]
    image = rng.standard_normal((3, 448, 448)).astype(np.float32)
    gen = GenerationConfig(max_new_tokens=1, do_sample=False, use_dd=True, use_dd_unk=True,
                           cd_alpha=1.0, cd_beta=0.1, eos_token_id=10**9)
    launches = quant.int8_matmul_stacked.launches, quant.int8_matmul_cuda.launches, attention.flash_attention.launches
    with torch.inference_mode():
        got = DecodeEngine(params, cut(), gen, adapter=QwenVLAdapter(cut()), bucket=64).submit_generate(
            span + text, image, branch_ids={"unk": [7] + text})["first_scores"].float().cpu()
        assert quant.int8_matmul_stacked.launches > launches[0] and quant.int8_matmul_cuda.launches > launches[1]
        assert attention.flash_attention.launches > launches[2]
        want = DecodeEngine(params_cpu, cut(torch.float32), gen, adapter=QwenVLAdapter(cut(torch.float32)),
                            bucket=64).submit_generate(span + text, image, branch_ids={"unk": [7] + text})[
                                "first_scores"]
    both = torch.isfinite(got) & torch.isfinite(want)
    assert (torch.isfinite(got) != torch.isfinite(want)).float().mean().item() <= 0.01
    err = (got[both] - want[both]).abs().max().item() / want[both].abs().max().item()
    assert err <= 5e-2, err


def test_instructblip_generate_beam_on_card_matches_cpu_fp32(dev):
    """A 5-beam generate_beam (8 tokens, EOS 2, min_new_tokens 3) on a tiny
    fp32 InstructBLIP tree whose decoder has Dh 64, so that its prefill runs
    K3 (fp32, on the CUDA cores): the features from instructblip.encode on
    each side, the tokens of the card run equal to those of the CPU run."""
    import dataclasses

    import numpy as np

    from llava_align_tpu_torch.config import GenerationConfig
    from llava_align_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from llava_align_tpu_torch.decoding.adapters import InstructBlipAdapter
    from llava_align_tpu_torch.decoding.engine import DecodeEngine
    from llava_align_tpu_torch.models import instructblip

    tiny = instructblip.InstructBlipConfig.tiny()
    cfg = dataclasses.replace(tiny, text=dataclasses.replace(tiny.text, hidden_size=128, num_heads=2,
                                                             num_kv_heads=2, head_dim=64))
    params = instructblip.init(cfg, device=dev, seed=4)
    params_cpu = _to_cpu32(params)
    rng = np.random.default_rng(5)
    image = rng.standard_normal((1, 3, 28, 28)).astype(np.float32)
    qtext = rng.integers(3, 128, (1, 6)).astype(np.int32)
    ids = [IMAGE_TOKEN_INDEX, 1] + [int(t) for t in rng.integers(3, 256, 9)]
    gen = GenerationConfig(max_new_tokens=8, do_sample=False, eos_token_id=2, pad_token_id=0)
    out = {}
    launches = attention.flash_attention.launches
    with torch.inference_mode():
        for name, p, device in (("card", params, dev), ("cpu", params_cpu, torch.device("cpu"))):
            feats = instructblip.encode(p, cfg, torch.from_numpy(image).to(device), torch.from_numpy(qtext).to(device))
            eng = DecodeEngine(p, cfg, gen, adapter=InstructBlipAdapter(cfg), bucket=32)
            out[name] = eng.generate_beam(ids, num_beams=5, min_new_tokens=3, precomputed_feats=feats)
            if name == "card":
                assert attention.flash_attention.launches > launches
    assert out["card"].token_ids == out["cpu"].token_ids
    assert len(out["card"].token_ids) >= 3


# ---------------------------------------------------------------------------
# the opt-in serving modes: W8A8 (torch._int_mm, cuBLASLt's int8 GEMM: the
# JAX package computes this product outside Pallas) and the int8 KV cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B", [256, 640])
def test_w8a8_on_card_matches_cpu(dev, B):
    """int8_matmul_w8a8 at one 7B o stack [4096, 4096] on bf16 rows: the
    row scales and int8 codes on the card equal the CPU's (IEEE division,
    round half to even on both), and so the product: exact int32 sums, the
    same fp32 epilogue; held to TOL of the largest output."""
    g = torch.Generator().manual_seed(B)
    h = torch.randn((B, 4096), generator=g).to(torch.bfloat16)
    wq = quant.quantize_weight(torch.randn((4096, 4096), generator=g) * 0.02)
    hf = h.float()
    scale = quant.w8a8_row_scale(hf.abs().amax(-1, keepdim=True))
    scale_dev = quant.w8a8_row_scale(hf.to(dev).abs().amax(-1, keepdim=True))
    assert torch.equal(scale_dev.cpu(), scale)
    assert torch.equal(quant.w8a8_quantize(hf.to(dev), scale_dev).cpu(), quant.w8a8_quantize(hf, scale))
    got = quant.int8_matmul_w8a8(h.to(dev), wq["q"].to(dev), wq["s"].to(dev))
    want = quant.int8_matmul_w8a8(h, wq["q"], wq["s"])
    assert got.dtype == torch.bfloat16
    _assert_close(got.cpu(), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_decode_attention_on_card_matches_cpu(dev, dtype):
    """decode_attention over an int8 (values, scales) cache at a 7B layer's
    heads (32 x 128, 12 rows, 1024 positions, unequal lengths): the card
    against the same operands in fp32 on the CPU, each output row within
    TOL of its own largest element."""
    g = torch.Generator().manual_seed(3)
    B, Smax, H, Dh = 12, 1024, 32, 128
    q = torch.randn((B, 1, H, Dh), generator=g).to(dtype)
    k, ks = quant.kv_quantize_block(torch.randn((B, Smax, H, Dh), generator=g))
    v, vs = quant.kv_quantize_block(torch.randn((B, Smax, H, Dh), generator=g))
    lengths = torch.randint(0, Smax, (B,), generator=g)
    got = attention.decode_attention(q.to(dev), (k.to(dev), ks.to(dev)), (v.to(dev), vs.to(dev)), lengths.to(dev))
    want = attention.decode_attention(q.float(), (k, ks), (v, vs), lengths)
    _assert_rows_close(got.cpu(), want)


def test_sampled_generate_reproduced_under_one_seed_on_card(dev):
    """A sampled `generate` (temperature 0.9, top-k 20, dual VDD) on a tiny
    int8 LLaVA on the card, with W8A8 and the int8 KV cache on: one
    generator seed gives one answer and one set of first-step scores."""
    import dataclasses

    import numpy as np

    from llava_align_tpu_torch.config import GenerationConfig, LlavaConfig
    from llava_align_tpu_torch.decoding.engine import DecodeEngine
    from llava_align_tpu_torch.utils.synthetic import build_random_llava_params

    tiny = LlavaConfig.tiny()  # in bf16: K1's tiled regime (65-640 rows) takes bf16 only
    cfg = dataclasses.replace(tiny, text=dataclasses.replace(tiny.text, dtype=torch.bfloat16),
                              vision=dataclasses.replace(tiny.vision, dtype=torch.bfloat16))
    params = build_random_llava_params(cfg, quant="int8", device=dev, seed=2)
    gen = GenerationConfig(max_new_tokens=8, do_sample=True, temperature=0.9, top_k=20, use_dd=True,
                           use_dd_unk=True, cd_alpha=1.0, cd_beta=0.1, eos_token_id=10**9)
    image = np.random.default_rng(0).integers(0, 256, (3, 28, 28), dtype=np.uint8)
    ids = [1] + list(range(3, 300)) + [-200, 5, 6]  # a 384-position prefill: W8A8 takes it
    for act_quant, kv_quant in ((False, None), (True, "int8")):
        engine = DecodeEngine(params, cfg, gen, act_quant=act_quant, kv_quant=kv_quant)
        n0 = quant.int8_matmul_w8a8.launches
        runs = [engine.generate(ids, image, generator=torch.Generator(device=dev).manual_seed(7))
                for _ in range(2)]
        assert (quant.int8_matmul_w8a8.launches > n0) == act_quant
        assert runs[0].token_ids == runs[1].token_ids and len(runs[0].token_ids) == 8
        np.testing.assert_array_equal(runs[0].first_scores_top_probs, runs[1].first_scores_top_probs)


# ---------------------------------------------------------------------------
# BLIP-2 OPT: the learned-position gather past its table on the card
# ---------------------------------------------------------------------------


def test_blip2_opt_generate_past_position_table_on_card_matches_cpu(dev):
    """A tiny fp32 BLIP-2 OPT `generate` (greedy, 'none' branch) whose
    prompt buckets past OPT's 130-row position table (4 query slots + 133
    ids → a 144-row prefill; decode positions 137-141): positions + 2 index
    past the table, which the port clamps as a JAX gather does (torch
    indexing would assert on the card). Card tokens equal the CPU run's."""
    import numpy as np

    from llava_align_tpu_torch.config import GenerationConfig
    from llava_align_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from llava_align_tpu_torch.decoding.adapters import Blip2OptAdapter
    from llava_align_tpu_torch.decoding.engine import DecodeEngine
    from llava_align_tpu_torch.models import blip2

    cfg = blip2.Blip2OptConfig.tiny()
    params = blip2.init_opt(cfg, device=dev, seed=6)
    params_cpu = _to_cpu32(params)
    rng = np.random.default_rng(7)
    image = rng.standard_normal((1, 3, 28, 28)).astype(np.float32)
    ids = [IMAGE_TOKEN_INDEX, 1] + [int(t) for t in rng.integers(3, 256, 132)]
    gen = GenerationConfig(max_new_tokens=6, do_sample=False, use_dd=True, cd_alpha=1.0, cd_beta=0.1,
                           eos_token_id=10**9)
    out = {}
    with torch.inference_mode():
        for name, p, device in (("card", params, dev), ("cpu", params_cpu, torch.device("cpu"))):
            feats = blip2.encode_image_queries(p, cfg, torch.from_numpy(image).to(device))
            eng = DecodeEngine(p, cfg, gen, adapter=Blip2OptAdapter(cfg), bucket=16)
            out[name] = eng.generate(ids, precomputed_feats=feats)
            torch.cuda.synchronize()
    assert out["card"].prompt_length == len(ids) - 1 + cfg.num_query_tokens > cfg.text.max_position_embeddings
    assert out["card"].token_ids == out["cpu"].token_ids
    np.testing.assert_allclose(out["card"].first_scores_top_probs, out["cpu"].first_scores_top_probs,
                               rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# training: autograd on the card, and the kernels' refusal of grad inputs
# ---------------------------------------------------------------------------


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device, copy=True)


def test_train_step_on_card_matches_cpu(dev):
    """Two make_train_step steps of a tiny fp32 LLaVA (clip on, no warm-up)
    on the card and on the CPU from the same params and batch: losses
    within 1e-5 relative, every param within 2*lr*steps (Adam's sign-like
    step turns rounding noise in a near-zero gradient into up to +-lr), and
    no kernel launched (autograd takes mha and torch.matmul)."""
    import numpy as np

    from llava_align_tpu_torch.config import LlavaConfig
    from llava_align_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from llava_align_tpu_torch.framework.optims import tree_leaves
    from llava_align_tpu_torch.train import trainer
    from llava_align_tpu_torch.utils.synthetic import build_random_llava_params

    cfg = LlavaConfig.tiny(vocab_size=64)
    rng = np.random.default_rng(0)
    H = cfg.vision.image_size
    samples = [{"input_ids": [1, 5, IMAGE_TOKEN_INDEX, 7 + i, 8, 9],
                "images": rng.normal(size=(3, H, H)).astype(np.float32)} for i in range(4)]
    batch = trainer.build_train_batch(cfg, samples, pad_to=16)
    lr, steps = 1e-4, 2
    out = {}
    launches = attention.flash_attention.launches
    cpu_params = build_random_llava_params(cfg, device="cpu", seed=3)
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        params = _to_device(cpu_params, device)
        opt = trainer.make_optimizer(lr, warmup_steps=0, total_steps=10)
        step, state = trainer.make_train_step(cfg, opt), opt.init(params)
        losses = []
        for _ in range(steps):
            params, state, loss = step(params, state, trainer.batch_to_device(batch, device))
            losses.append(float(loss))
        out[name] = (losses, [x.detach().cpu() for x in tree_leaves(params)])
    assert attention.flash_attention.launches == launches
    np.testing.assert_allclose(out["card"][0], out["cpu"][0], rtol=1e-5)
    for a, b in zip(out["card"][1], out["cpu"][1]):
        assert (a - b).abs().max() <= 2 * lr * steps


def test_kernels_refuse_grad_and_auto_attention_differentiates(dev):
    """K3 (flash_attention) and the int8 dispatch (K2 at 4 rows) raise on a
    CUDA input that requires grad; causal_attention(impl="auto") under grad
    takes mha, launches no kernel, and gives q, k and v non-zero grads."""
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(1, 16, 2, 64, generator=g, device=dev, dtype=torch.bfloat16).requires_grad_(True)
               for _ in range(3))
    with pytest.raises(RuntimeError, match="no backward"):
        attention.flash_attention(q, k, v)
    wq = quant.quantize_weight(torch.randn(64, 128, generator=g, device=dev, dtype=torch.bfloat16))
    h = torch.randn(4, 128, generator=g, device=dev, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        quant.int8_matmul(h, wq)
    with torch.no_grad():  # the same calls without a grad run the kernels
        attention.flash_attention(q, k, v)
        quant.int8_matmul(h, wq)
    launches = attention.flash_attention.launches
    out = attention.causal_attention(q, k, v)
    grads = torch.autograd.grad(out.float().square().sum(), [q, k, v])
    assert attention.flash_attention.launches == launches
    assert all(bool(x.abs().sum() > 0) for x in grads)
    with torch.no_grad():
        torch.testing.assert_close(out, attention.mha(q, k, v, causal=True), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the LAVIS zoo's families (no kernel on their paths): a 2-layer full-width
# fp32 forward of each on the card against the CPU
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _lavis_cases():
    return lavis_cuts.cut_cases()


@pytest.mark.parametrize("family", lavis_cuts.NAMES)
def test_lavis_family_on_card_matches_cpu_fp32(dev, family):
    """The family's 2-layer full-width fp32 cut (utils/lavis_cuts, the cases
    of chip_smoke.py's LAVIS reference phase), card against CPU; the cases
    are built once, on the first call that has a card."""
    _, params, fn = _lavis_cases()[family]
    with torch.no_grad():
        want = fn(params, torch.device("cpu"))
        got = fn(lavis_cuts.tree_to(params, dev), dev)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
