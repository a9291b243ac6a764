"""The check fails a broken timed path: each cell's run, driven on the CPU
at a tiny size (the look for a card skipped), comes out correct as it
stands and not correct with a fault planted underneath: a served token
altered where it is sampled, or a decode step that leaves the KV cache
as it was."""

import time

import pytest
import torch

from benchmark.core.cell import execute
from benchmark.tests.helpers import CELLS, tiny_cell


def _run(name):
    return execute(tiny_cell(name), 2**35 + 17, 0.3, False, torch.device("cpu"), time.perf_counter(),
                   log=lambda *a: None)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound(name):
    out = _run(name)
    assert out["correct"] and out["checks"]["max_gap"]["value"] <= 1e-3
    assert list(out)[-1] == "checks" and out["attempted"] > 0


@pytest.mark.parametrize("name", sorted(CELLS))
def test_altered_token(name, monkeypatch):
    from llava_align_tpu_torch.decoding import sampler

    orig = sampler.sample_token

    def altered(g, warped, do_sample=True):
        return (orig(g, warped, do_sample) + 1) % warped.shape[-1]

    monkeypatch.setattr(sampler, "sample_token", altered)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_state_unchanged(name, monkeypatch):
    from llava_align_tpu_torch.models import llama, mpt

    orig = llama._write_cache

    def stale(cache, new, li, offsets, is_decode, row_offset):
        if not is_decode:
            orig(cache, new, li, offsets, is_decode, row_offset)

    monkeypatch.setattr(llama, "_write_cache", stale)
    monkeypatch.setattr(mpt, "_write_cache", stale)
    assert not _run(name)["correct"]
