"""Process start to the first timed call: imports, the kernels' build (or
its cache), the weights, the program's quantization and the warm-up."""


def read(r):
    return r.setup_s
