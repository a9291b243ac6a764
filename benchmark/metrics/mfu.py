"""Model FLOPs of the work the window completed (core/work.call_flops:
tower, prompt positions, decode rows, attention) over the window's wall
time and the card's bf16 dense peak, in %."""

from benchmark.core.work import PEAK_BF16_FLOPS


def read(r):
    return 100.0 * r.model_flops / r.window_s / PEAK_BF16_FLOPS
