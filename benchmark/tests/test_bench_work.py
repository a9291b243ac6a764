"""The yardstick's arithmetic, worked by hand: operations and bytes of the
port's functions at the cells' shapes, their least times on the card, and
the model FLOPs of one call of each cell."""

import copy
import json

import pytest
import torch

from benchmark.core.cell import Cell, family_of
from benchmark.core.trace import _nbytes
from benchmark.core.traffic import Traffic
from benchmark.core.work import (
    PEAK_BF16_FLOPS, PEAK_BYTES_PER_S, attention_work, bound_seconds, call_flops, linear_work, roofline_share,
)
from benchmark.tests.helpers import REPO


def test_int8_linear_at_36_rows():
    # Qwen-VL-7B's packed q|k|v (12288 x 4096, int8 + fp32 scales) at 36 decode rows
    w = {"q": torch.empty(32, 12288, 4096, dtype=torch.int8, device="meta"),
         "s": torch.empty(32, 12288, dtype=torch.float32, device="meta")}
    assert _nbytes(w, 3) == 12288 * 4096 + 12288 * 4
    ops, nbytes = linear_work(36, 12288, 4096, 2, _nbytes(w, 3), 2)
    assert ops == 3_623_878_656
    assert nbytes == 294_912 + 50_331_648 + 49_152 + 884_736 == 51_560_448
    assert bound_seconds(nbytes, ops) == pytest.approx(51_560_448 / 3.35e12)  # bytes bound: 15.39 us


def test_k3_prefill_at_2x320():
    # llama.attend's prefill of 2 rows x 320 positions, 32 heads of 128, bf16,
    # the keys and values written into the cache
    ops, nbytes = attention_work(2, 320, 32, 32, 128, 2, cache_write=True)
    assert ops == 4 * 32 * 128 * (2 * 320 * 321 // 2) == 1_682_964_480
    assert nbytes == 2 * 320 * 128 * 128 * 2 + 2 * 2 * 320 * 32 * 128 * 2 == 31_457_280
    assert bound_seconds(nbytes, ops) == pytest.approx(31_457_280 / 3.35e12)  # 9.39 us > 1.70 us


def test_k3_with_a_shared_prefix():
    ops, nbytes = attention_work(2, 32, 32, 32, 128, 2, shared_lens=[262, 262], shared_bytes=262 * 32 * 128 * 2 * 2)
    assert ops == 4 * 32 * 128 * (2 * 32 * 33 // 2 + 32 * 524)
    assert nbytes == 2 * 32 * 128 * 128 * 2 + 262 * 32 * 128 * 4


def test_mpt_alibi_at_1x1024():
    ops, nbytes = attention_work(1, 1024, 32, 32, 128, 2)
    assert ops == 8_598_323_200
    assert nbytes == 33_554_432
    assert bound_seconds(nbytes, ops) == pytest.approx(33_554_432 / 3.35e12)  # 10.0 us > 8.69 us


def test_roofline_share():
    assert roofline_share([]) is None
    assert roofline_share([(989e9, 0, 2e-3)]) == pytest.approx(50.0)
    assert roofline_share([(0, 3.35e9, 1e-3), (989e9, 0, 1e-3)]) == pytest.approx(100.0)
    assert PEAK_BF16_FLOPS == 989e12 and PEAK_BYTES_PER_S == 3.35e12


def _cell(name, pool=2):
    cell = Cell.load(name, REPO / "BENCHMARK.json")
    mix = copy.deepcopy(cell.mix)
    mix["pool_calls"] = pool
    fam = family_of(cell.config)
    return fam, Traffic(mix, fam, 99)


def _positions(fam, start, n):
    return sum(fam.position_flops(start + j) for j in range(1, n + 1))


def test_mpt_flops_by_hand():
    fam, tr = _cell("llava_mpt_7b.mmmu_single_vcd")
    A = 32 * 2 * (4 * 4096**2 + 2 * 4096 * 16384)
    assert fam.position_flops(0) == A == 12_884_901_888
    assert fam.position_flops(10) - A == 32 * 4 * 4096 * 10
    assert fam.head_flops() == 2 * 50432 * 4096
    layer = 2 * 577 * (4 * 1024**2 + 2 * 1024 * 4096) + 4 * 577**2 * 1024
    tower = 2 * 576 * 588 * 1024 + 23 * layer + 2 * 576 * (1024 * 4096 + 4096 * 4096)
    assert fam.tower_flops() == tower == 390_193_049_600
    call = tr.calls[0]
    q = call.questions[0]
    n = tr.expanded(q.ids)
    # two towers (the image and its noised copy); main and cd rows: the
    # prompt, the head, one decode step (2 tokens) and its head
    want = 2 * tower + 2 * (_positions(fam, 0, n) + fam.head_flops() + fam.position_flops(n + 1) + fam.head_flops())
    assert call_flops(fam, tr, call, [[1, 2]]) == pytest.approx(want, rel=1e-12)


def test_qwen_flops_by_hand():
    fam, tr = _cell("qwen_vl_7b_int8.pope_grouped")
    A = 32 * 2 * (4 * 4096**2 + 3 * 11008 * 4096)
    assert fam.position_flops(0) == A
    assert fam.position_flops(1) - A == 32 * 4 * 4096
    assert fam.head_flops() == 2 * 151936 * 4096
    W, F, N = 1664, 8192, 1024
    tower = (2 * N * 588 * W + 48 * (2 * N * (4 * W * W + 2 * W * F) + 4 * N * N * W)
             + 2 * (N * W * 4096 + 2 * 256 * 4096**2 + 2 * N * 4096**2) + 4 * 256 * N * 4096 + 2 * 256 * 4096**2)
    assert fam.tower_flops() == tower
    call = tr.calls[0]
    toks = [[7] * 8 for _ in call.questions]
    want = 2 * tower
    for g in range(2):
        qs = call.questions[6 * g: 6 * g + 6]
        prefix, _ = tr.split_group(qs)
        P = tr.expanded(prefix)
        none_p = len(fam.none_ids(prefix))
        want += _positions(fam, 0, P) + _positions(fam, 0, none_p)
        for q in qs:
            for ids, shared in ((q.ids, P), (q.branch_ids["none"], none_p), (q.branch_ids["unk"], 0)):
                n = tr.expanded(ids)
                want += _positions(fam, shared, n - shared) + fam.head_flops()
                want += _positions(fam, n, 7) + 7 * fam.head_flops()
    assert call_flops(fam, tr, call, toks) == pytest.approx(want, rel=1e-12)


def test_benchmark_json_names_readers_and_files():
    from benchmark.core.cell import reader

    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(reader(m["name"]))
    for c in spec["configs"]:
        assert (REPO / c["file"]).exists()
    for w in spec["workloads"]:
        assert (REPO / "benchmark" / "traffic" / f"{w['traffic']}.json").exists()
        assert (REPO / "benchmark" / "limits" / f"{w['name']}.json").exists()


def test_llava_bench_flops_by_hand():
    fam, tr = _cell("qwen_vl_7b_int8.llava_bench_long")
    call = tr.calls[0]
    toks = [[7] * 256 for _ in call.questions]
    # eight towers; each question's main and 'none' rows whole, their heads,
    # and 255 decode steps a row with a head each
    want = 8 * fam.tower_flops()
    for q in call.questions:
        for ids in (q.ids, q.branch_ids["none"]):
            n = tr.expanded(ids)
            want += _positions(fam, 0, n) + fam.head_flops() + _positions(fam, n, 255) + 255 * fam.head_flops()
    assert call_flops(fam, tr, call, toks) == pytest.approx(want, rel=1e-12)


def test_qwen_single_flops_by_hand():
    # the MMMU mix on the Qwen configuration with dual VDD (no cell yet)
    mix = copy.deepcopy(Cell.load("llava_mpt_7b.mmmu_single_vcd", REPO / "BENCHMARK.json").mix)
    mix.update(pool_calls=2, decoding=dict(mix["decoding"], branches=["main", "unk", "none"]))
    fam = family_of(Cell.load("qwen_vl_7b_int8.pope_grouped", REPO / "BENCHMARK.json").config)
    tr = Traffic(mix, fam, 99)
    call = tr.calls[0]
    q = call.questions[0]
    # one tower; main, unk and none rows whole with their heads; one decode
    # step a row (2 tokens) with its head
    want = fam.tower_flops()
    for ids in (q.ids, q.branch_ids["unk"], q.branch_ids["none"]):
        n = tr.expanded(ids)
        want += _positions(fam, 0, n) + 2 * fam.head_flops() + fam.position_flops(n + 1)
    assert call_flops(fam, tr, call, [[3, 4]]) == pytest.approx(want, rel=1e-12)



def _attend_like(q, k, v, li, cache, cache_offset, is_decode, cache_row_offset, attn_impl,
                 shared_kv=None, shared_len=None, shared_rows_per_prefix=None, shared_rows_per_prefix2=0,
                 kv_heads=None):
    return q


def test_attend_span_reads_shared_lengths_after_the_segment():
    # the wrapped segment's attention span reads no device tensor while the
    # segment runs; its segment lengths come from the tensor the call got,
    # kept alive by the span, once the segment has ended
    import inspect

    from benchmark.core.trace import Tracer
    from llava_align_tpu_torch.models import llama

    assert list(inspect.signature(llama.attend).parameters) == list(inspect.signature(_attend_like).parameters)
    tracer = Tracer(object(), wrap=True)
    tracer.running = True  # as inside a segment, without the profiler
    fn = tracer._attend(_attend_like)
    q = torch.zeros(4, 3, 8, 16, dtype=torch.bfloat16)
    k = torch.zeros(4, 3, 2, 16, dtype=torch.bfloat16)
    shared = {"k": torch.zeros(2, 2, 5, 2, 16, dtype=torch.bfloat16)}  # [L, G, P, K, Dh]: two row groups
    fn(q, k, k, 0, None, None, False, 0, "auto", shared_kv=shared, shared_len=torch.tensor([5, 5, 4, 4]),
       shared_rows_per_prefix=2)
    fn(q[:, :1], k[:, :1], k[:, :1], 0, None, None, True, 0, "auto", shared_kv=shared,
       shared_len=torch.tensor([6, 6, 5, 5]), shared_rows_per_prefix=2)
    fn(q, k, k, 0, None, None, False, 0, "auto")
    (kind, ops, nbytes), (kind2, _, _), (_, ops3, bytes3) = tracer.counted_spans()
    assert (kind, kind2) == ("attention", "attention_decode")
    assert (ops, nbytes) == attention_work(4, 3, 8, 2, 16, 2, shared_lens=[5, 5, 4, 4],
                                           shared_bytes=(5 + 4) * 2 * 16 * 2 * 2)
    assert (ops3, bytes3) == attention_work(4, 3, 8, 2, 16, 2)
