"""The traffic generator and the command's refusals: the same seed gives
the same requests and another seed others with the same amount of work;
the lengths, questions per image, branch ids and caps are the mixes'; and
run.py exits non-zero with no result where there is no card."""

import copy
import subprocess
import sys

import numpy as np
import pytest

from benchmark.core.cell import Cell, family_of
from benchmark.core.traffic import Traffic, lengths_grid
from benchmark.reference.common import IMAGE_SENTINEL
from benchmark.tests.helpers import REPO

CELLS = ["qwen_vl_7b_int8.pope_grouped", "llava_mpt_7b.mmmu_single_vcd", "qwen_vl_7b_int8.llava_bench_long"]


def _traffic(name, seed, pool=4):
    cell = Cell.load(name, REPO / "BENCHMARK.json")
    mix = copy.deepcopy(cell.mix)
    mix["pool_calls"] = pool
    return Traffic(mix, family_of(cell.config), seed)


def _flat(tr):
    return [(q.ids, q.branch_ids, q.image) for c in tr.calls for q in c.questions]


@pytest.mark.parametrize("name", CELLS)
def test_seeded(name):
    a, b, c = _traffic(name, 2**40 + 3), _traffic(name, 2**40 + 3), _traffic(name, 2**40 + 4)
    assert _flat(a) == _flat(b) and all(np.array_equal(x, y) for x, y in zip(a.images, b.images))
    assert _flat(a) != _flat(c)
    assert [x.seed for x in a.calls] != [x.seed for x in c.calls]


@pytest.mark.parametrize("name", CELLS)
def test_seeds_change_inputs_not_work(name):
    a, c = _traffic(name, 11, pool=8), _traffic(name, 12, pool=8)
    lens = lambda tr: sorted(len(q.ids) for x in tr.calls for q in x.questions)  # noqa: E731
    assert lens(a) == lens(c)


def test_pope_grouped_shape():
    tr = _traffic("qwen_vl_7b_int8.pope_grouped", 5)
    fam = tr.family
    assert tr.mix["decoding"]["max_new_tokens"] == 8 and tr.branches == ("main", "unk", "none")
    for call in tr.calls:
        assert len(call.questions) == 12 and len(call.images) == 2
        for g in range(2):
            qs = call.questions[6 * g: 6 * g + 6]
            assert {q.image for q in qs} == {call.images[g]}
            prefix, suffixes = tr.split_group(qs)
            assert prefix[:3] == fam.image_block() and IMAGE_SENTINEL in prefix
            assert all(len(s) >= 1 for s in suffixes)
        for q in call.questions:
            body = q.ids[3:-2]
            assert len(body) in (8, 9) and q.ids[:3] == fam.image_block()
            assert q.branch_ids["none"] == body + q.ids[-2:]
            assert q.branch_ids["unk"] == [tr.unk_token] + body + q.ids[-2:]
            assert all(0 <= t < 151643 for t in body)
    assert tr.images[0].shape == (3, 448, 448) and tr.images[0].dtype == np.uint8


def test_mmmu_lengths():
    tr = _traffic("llava_mpt_7b.mmmu_single_vcd", 6, pool=400)
    n = [len(c.questions[0].ids) - 27 - 1 - 1 - 4 for c in tr.calls]
    assert min(n) == 32 and max(n) == 768 and float(np.median(n)) == 128
    assert 152 <= float(np.mean(n)) <= 154  # MMMU's mean question and options in tokens
    pos = [tr.expanded(c.questions[0].ids) for c in tr.calls]
    assert min(pos) == 640 and max(pos) == 1376
    assert tr.branches == ("main", "cd") and tr.mix["decoding"]["max_new_tokens"] == 2
    assert all(c.questions[0].branch_ids["cd"] == c.questions[0].ids for c in tr.calls)


def test_llava_bench_shape():
    tr = _traffic("qwen_vl_7b_int8.llava_bench_long", 7)
    assert tr.mix["decoding"]["max_new_tokens"] == 256 and tr.branches == ("main", "none")
    for call in tr.calls:
        assert len(call.questions) == 8 and len(set(call.images)) == 8
        for q in call.questions:
            assert 12 <= len(q.ids) - 24 - 3 - 1 - 5 <= 40


def test_lengths_grid():
    assert lengths_grid({"dist": "uniform", "min": 6, "max": 14}, 9) == list(range(6, 15))
    t = lengths_grid({"dist": "table", "values": [8, 9], "weights": [65, 15]}, 80)
    assert t == [8] * 65 + [9] * 15
    g = lengths_grid({"dist": "lognormal", "median": 160, "sigma": 0.6, "min": 32, "max": 768}, 1001)
    assert g[500] == 160 and g == sorted(g)


def test_no_card_no_result(tmp_path):
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", str(2**33),
                        "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert r.returncode != 0 and r.stdout == ""
    assert "CUDA" in r.stderr


def test_alone_no_result(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark fails."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True)
    assert r.returncode != 0 and r.stdout == ""
