"""Prefill attention's share of its roofline: llama.attend's prefill calls
(causal over the block, plus the shared prefix) and MPT's ALiBi attention
at prefill, their operations and bytes from the shapes, over the device
time of the kernels they launched, in %."""

from benchmark.core.work import roofline_share


def read(r):
    if r.trace is None:
        return None
    return roofline_share((ops, b, s) for kind, ops, b, s in r.trace.spans if kind == "attention")
