"""Port parity: the kernels of the TPU microbenchmark scripts (S1-S7) against
the ports' plain versions, and K1's dispatch against the JAX package's rule.

The TPU scripts run a 7B benchmark at import, so they are never imported:
`_load` parses a script and executes only the named top-level definitions
and assignments (and those inside a top-level `try`), in a namespace where
`pl.pallas_call` runs in interpret mode, as the JAX package's own tests run
its kernels on the CPU. Each case feeds the same numpy inputs, made from a
seed, to the script's Pallas function and to the port's plain version (the
wrapper on a CPU tensor).

Tolerances: fp32 activations 1e-5 rel / 1e-4 abs (fp32 dot products of a
few hundred terms summed in other orders, the K1/K4 bound of
tests/test_torch_quant.py); bf16 activations 2^-6 x max|ref| (two bf16
roundings of the output one ulp apart, and the bf16 rounding of a scaled
weight, doubled: the on-card kernel tolerance); the copies of S7 exact.
"""

import ast
import functools
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from llava_align_tpu.ops import quant as jq
from llava_align_tpu_torch.ops import quant as tq
from llava_align_tpu_torch.ops import stream_probes as sp
from llava_align_tpu_torch.scripts import probe_int4_kernel_bisect, probe_mosaic_ops

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
MM_RTOL, MM_ATOL = 1e-5, 1e-4
BF16_TOL = 2.0**-6
L, O, D, B = 2, 256, 512, 16  # small stacks: one D step for the scripts' block choosers


class _InterpretPallas:
    """`pl` with pallas_call in interpret mode."""

    pallas_call = staticmethod(functools.partial(pl.pallas_call, interpret=True))

    def __getattr__(self, name):
        return getattr(pl, name)


def _defines(node) -> set:
    if isinstance(node, ast.FunctionDef):
        return {node.name}
    if isinstance(node, ast.Assign):
        return {t.id for t in node.targets if isinstance(t, ast.Name)}
    return set()


def _load(script: str, names, **globals_) -> dict:
    """Execute only `names` (top-level defs and assignments, or those in a
    top-level try) of scripts/<script>, in order, with `globals_` set."""
    tree = ast.parse((SCRIPTS / script).read_text())
    body = [n for top in tree.body for n in (top.body if isinstance(top, ast.Try) else [top])
            if _defines(n) & set(names)]
    found = set().union(*(_defines(n) for n in body))
    assert set(names) <= found, f"{script} lacks {set(names) - found}"
    ns = dict(jax=jax, jnp=jnp, np=np, functools=functools, os=os, pl=_InterpretPallas(),
              pltpu=pltpu, _round_up=jq._round_up, **globals_)
    exec(compile(ast.Module(body=body, type_ignores=[]), str(SCRIPTS / script), "exec"), ns)
    return ns


def _h(seed: int, dtype: str, rows: int = B, cols: int = D):
    """(jax array, torch tensor) of the same activations; bf16 rounds alike
    in both (round to nearest even)."""
    h = np.random.default_rng(seed).normal(size=(rows, cols)).astype(np.float32)
    if dtype == "bf16":
        return jnp.asarray(h, jnp.bfloat16), torch.from_numpy(h).to(torch.bfloat16)
    return jnp.asarray(h), torch.from_numpy(h)


def _check(got: torch.Tensor, want, dtype: str) -> None:
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    if dtype == "bf16":
        assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, rtol=MM_RTOL, atol=MM_ATOL)


def _codes(seed: int, shape, low=-8, high=8) -> np.ndarray:
    return np.random.default_rng(seed).integers(low, high, shape).astype(np.int8)


def _scales(seed: int, shape) -> np.ndarray:
    return (np.abs(np.random.default_rng(seed).normal(size=shape)) * 0.05 + 0.01).astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# S1a / S2a: row-major int4, per-channel scales
# ---------------------------------------------------------------------------

_S1A = ("_unpack_i8", "_unpack_i32", "_make_kern4", "_choose_blocks4", "int4_mm", "pack_nibbles")
_S2A = ("unpack_i32", "unpack_i16", "unpack_bf16", "FLAVORS", "_make_kern4", "_choose_blocks4",
        "int4_mm", "pack")


@pytest.mark.parametrize("script,names,pack,flavor,dtype", [
    ("bench_int4_probe.py", _S1A, "pack_nibbles", "i8", "fp32"),
    ("bench_int4_probe.py", _S1A, "pack_nibbles", "i32", "fp32"),
    ("bench_int4_probe.py", _S1A, "pack_nibbles", "i32", "bf16"),
    ("bench_int4_probe2.py", _S2A, "pack", "i32", "fp32"),
    ("bench_int4_probe2.py", _S2A, "pack", "i16", "fp32"),
    ("bench_int4_probe2.py", _S2A, "pack", "bf16", "fp32"),
    ("bench_int4_probe2.py", _S2A, "pack", "i32", "bf16"),
])
def test_rowmajor_int4_per_channel_matches_script(script, names, pack, flavor, dtype):
    ns = _load(script, names)
    q = _codes(1, (L, O, D))
    p = np.asarray(ns[pack](jnp.asarray(q)))
    np.testing.assert_array_equal(tq.pack_int4(_t(q)).numpy(), p)  # same bytes
    np.testing.assert_array_equal(sp.unpack_int4_rowmajor(_t(p)).numpy(), q)
    s = np.random.default_rng(2).normal(size=(L, O)).astype(np.float32) * 0.02
    hj, ht = _h(3, dtype)
    for li in range(L):
        want = ns["int4_mm"](hj, jnp.asarray(p), jnp.asarray(s), li, flavor=flavor)
        _check(sp.int4_rowmajor_matmul_stacked(ht, _t(p), _t(s), li), want, dtype)


# ---------------------------------------------------------------------------
# S1b / S2b: "native int4" (jnp.int4 operand) = K1 on int8 storage
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_native_int4_matches_k1_plain(dtype):
    ns = _load("bench_int4_probe.py", ("_kern_n4", "_choose_blocks4", "int4_native_mm"))
    q = _codes(4, (L, O, D))
    s = np.random.default_rng(5).normal(size=(L, O)).astype(np.float32) * 0.02
    hj, ht = _h(6, dtype)
    for li in range(L):
        want = ns["int4_native_mm"](hj, jnp.asarray(q).astype(jnp.int4), jnp.asarray(s), li)
        _check(tq.int8_matmul_stacked(ht, _t(q), _t(s), li), want, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_native_int4_probe2_matches_k1_plain(dtype):
    """S2b's standalone call, its own grid spec at two D steps."""
    hj, ht = _h(7, dtype)
    ns = _load("bench_int4_probe2.py", ("_kern_n", "grid_spec", "f"),
               B=B, O=O, Dq=D, bO=128, bD=D // 2, h=hj)
    q = _codes(8, (L, O, D))
    s = np.random.default_rng(9).normal(size=(L, O)).astype(np.float32) * 0.02
    for li in range(L):
        want = ns["f"](jnp.asarray([li], jnp.int32), hj, jnp.asarray(q).astype(jnp.int4),
                       jnp.asarray(s).reshape(L, 1, O))
        _check(tq.int8_matmul_stacked(ht, _t(q), _t(s), li), want, dtype)


# ---------------------------------------------------------------------------
# S3: row-major int4, group-128 scales
# ---------------------------------------------------------------------------


# rows at the streaming kernel's n8-tile edges (1, 8, 9, 17) and its bound
# (64), beside the scripts' B = 16
STREAM_ROWS = [1, 8, 9, 17, 64]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_rowmajor_int4_group_matches_script(dtype):
    _rowmajor_int4_group_case(dtype, B)


@pytest.mark.parametrize("rows", STREAM_ROWS)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_rowmajor_int4_group_matches_script_at_rows(dtype, rows):
    _rowmajor_int4_group_case(dtype, rows)


def _rowmajor_int4_group_case(dtype, rows):
    ns = _load("bench_int4_probe3.py", ("G", "_kern_rep", "KERNS", "_choose_blocks4", "int4_mm", "pack"))
    q = _codes(10, (L, O, D))
    p = np.asarray(ns["pack"](jnp.asarray(q)))
    s = _scales(11, (L, O, D // 128))
    hj, ht = _h(12, dtype, rows)
    for li in range(L):
        want = ns["int4_mm"](hj, jnp.asarray(p), jnp.asarray(s), li)
        _check(sp.int4_rowmajor_matmul_stacked(ht, _t(p), _t(s), li), want, dtype)


# ---------------------------------------------------------------------------
# S4: the transposed layout = K4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("unpack,dtype", [("i32", "fp32"), ("bf16", "fp32"), ("i32", "bf16")])
def test_transposed_int4_matches_k4_plain(monkeypatch, unpack, dtype):
    monkeypatch.setenv("UNPACK", unpack)  # read when the kernel is traced
    ns = _load("bench_int4_transposed.py", ("G", "_mk_kern", "_BO_PREF", "_blocks_t", "int4t_mm"))
    q = _codes(13, (L, O, D))
    p_t = tq.pack_int4(_t(q)).transpose(1, 2).contiguous().numpy()  # [L, D/2, O]
    gs = _scales(14, (L, D // 128, O))
    hj, ht = _h(15, dtype)
    for li in range(L):
        want = ns["int4t_mm"](hj, jnp.asarray(p_t), jnp.asarray(gs), li)
        _check(tq.int4_matmul_stacked(ht, _t(p_t), _t(gs), li), want, dtype)


# ---------------------------------------------------------------------------
# S5: bf16 weight streaming
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_bf16_stream_matches_script(dtype):
    _bf16_stream_case(dtype, B)


@pytest.mark.parametrize("rows", STREAM_ROWS)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_bf16_stream_matches_script_at_rows(dtype, rows):
    _bf16_stream_case(dtype, rows)


def _bf16_stream_case(dtype, rows):
    ns = _load("bench_bf16_stream.py", ("_kern", "_choose_blocks_b", "stream_mm"))
    w = torch.from_numpy(np.random.default_rng(16).normal(size=(L, O, D)).astype(np.float32))
    w = w.to(torch.bfloat16)  # the script streams bf16 weights
    wj = jnp.asarray(w.float().numpy(), jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    hj, ht = _h(17, dtype, rows)
    for li in range(L):
        # the script slices its output by the padded h, so it returns its
        # 16-row padding too (rows of zero activations): compare the real rows
        want = ns["stream_mm"](hj, wj, li)[:rows]
        _check(sp.bf16_matmul_stacked(ht, w, li), want, dtype)


# ---------------------------------------------------------------------------
# S6: the bisection variants = the group kernel with host-built scales
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", probe_int4_kernel_bisect.VARIANTS)
def test_bisect_variant_matches_group_kernel(variant):
    Dv, bDp = 1024, 256  # two D steps of two groups each
    Dp, nG = Dv // 2, Dv // 128
    hj, ht = _h(18, "bf16", cols=Dv)
    ns = _load("probe_int4_kernel_bisect.py", ("kern", "f"), variant=variant, G=128, O=O, D=Dv,
               Dp=Dp, B=B, bO=128, bDp=bDp, nkh=Dp // bDp, nG=nG)
    p = _codes(19, (O, Dp), -128, 128)  # any byte: both nibbles sign-extend
    gs = _scales(20, (O, nG))
    want = ns["f"](hj, hj, jnp.asarray(p), jnp.asarray(gs))
    s = probe_int4_kernel_bisect.effective_scales(_t(gs), variant, bDp)
    _check(sp.int4_rowmajor_matmul_stacked(ht, _t(p)[None], s[None], 0), want, "bf16")


# ---------------------------------------------------------------------------
# S7: the scale-broadcast copies, exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(probe_mosaic_ops.OPS))
def test_mosaic_copy_matches_script_exactly(name):
    ns = _load("probe_mosaic_ops.py", ("x", "big", "xt", name))
    _, key, shape, rows, cols, offset, scale = probe_mosaic_ops.OPS[name]
    want = pl.pallas_call(ns[name], out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
                          interpret=True)(ns[key])
    got = sp.repeat2d(_t(np.asarray(ns[key])), shape, rows, cols, offset, scale)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    src = probe_mosaic_ops.sources("cpu")
    np.testing.assert_array_equal(src[key].numpy(), np.asarray(ns[key]))  # the twin's inputs
    torch.testing.assert_close(probe_mosaic_ops.run(name, src), got, rtol=0, atol=0)


def test_repeat2d_refuses_reads_outside_the_source():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError):
        sp.repeat2d(x, (4, 16), ("repeat", 1), ("tile", 16))  # tile period past 8 columns
    with pytest.raises(ValueError):
        sp.repeat2d(x, (9, 8), ("repeat", 2), ("tile", 8))  # row 4 of 4
    with pytest.raises(ValueError):
        sp.repeat2d(x, (4, 4), ("repeat", 1), ("tile", 4), offset=(0, 5))


# ---------------------------------------------------------------------------
# K1's dispatch follows the JAX package's _stream_rows_ok
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,O_,D_,to_k1", [
    ((512,), 12288, 4096, True),      # 7B qkv, text-branch prefill (2 x 256)
    ((2, 256), 22016, 4096, True),    # 7B gate|up, the same rows as [B, S]
    ((512,), 4096, 11008, False),     # 7B down (O < D): dequant past 64 rows
    ((640,), 4096, 4096, True),       # 7B o at the last streamed row count
    ((641,), 4096, 4096, False),
    ((896,), 12288, 4096, False),     # 7B image-row prefill
    ((64,), 4096, 11008, True),       # decode rows stream for every stack
    ((65,), 4096, 11008, False),
    ((3,), 12288, 4096, True),
])
def test_k1_dispatch_follows_the_jax_rule(monkeypatch, rows, O_, D_, to_k1):
    assert jq._stream_rows_ok(int(np.prod(rows)), O_, D_) == to_k1
    calls = []

    def k1(h, q, s, li):
        calls.append(("k1", tuple(h.shape)))
        return torch.zeros((h.shape[0], q.shape[1]))

    def dequant(h, q, s):
        calls.append(("dequant", tuple(h.shape)))
        return torch.zeros((*h.shape[:-1], q.shape[0]))

    monkeypatch.setattr(tq, "int8_matmul_stacked", k1)
    monkeypatch.setattr(tq, "int8_matmul_dequant", dequant)
    q = torch.zeros((), dtype=torch.int8).expand(2, O_, D_)  # shapes only, no storage
    s = torch.zeros((), dtype=torch.float32).expand(2, O_)
    out = tq.int8_matmul_stacked_dispatch(torch.zeros(rows + (D_,)), {"q": q, "s": s}, 1)
    assert tuple(out.shape) == rows + (O_,)
    n = int(np.prod(rows))
    assert calls == ([("k1", (n, D_))] if to_k1 else [("dequant", rows + (D_,))])
