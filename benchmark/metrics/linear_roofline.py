"""The linears' share of their roofline: the least time of every
llama.linear and logits-head call in the traced segment (its operations
and bytes from its shapes) over the device time of the kernels they
launched, in %."""

from benchmark.core.work import roofline_share


def read(r):
    if r.trace is None:
        return None
    return roofline_share((ops, b, s) for kind, ops, b, s in r.trace.spans if kind == "linear")
