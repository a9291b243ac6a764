"""Tiny cells for the CPU tests: a cell of BENCHMARK.json with its
configuration swapped for a tiny one of the same family and its mix cut
to tiny lengths."""

import copy
import json
from pathlib import Path

from benchmark.core.cell import Cell

REPO = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
CELLS = {
    "qwen_vl_7b_int8.pope_grouped": "qwen_vl_tiny.json",
    "llava_mpt_7b.mmmu_single_vcd": "llava_mpt_tiny.json",
    "qwen_vl_7b_int8.llava_bench_long": "qwen_vl_tiny.json",
}


def tiny_config(name: str) -> dict:
    return json.loads((DATA / name).read_text())


def tiny_cell(name: str) -> Cell:
    cell = Cell.load(name, REPO / "BENCHMARK.json")
    cell.config = tiny_config(CELLS[name])
    m = copy.deepcopy(cell.mix)
    m["pool_calls"] = 3
    p = m["prompt"]
    p["before_image"] = min(p.get("before_image", 0), 4)
    if p["question"]["dist"] == "lognormal":
        p["question"].update(median=10, min=3, max=30)
        m["pool_calls"] = 24
    m["decoding"]["max_new_tokens"] = min(m["decoding"]["max_new_tokens"], 12)
    m["check"]["questions"] = min(m["check"]["questions"], 24)
    cell.mix = m
    cell.limits = {"max_gap": {"limit": 1e-3}}
    return cell
