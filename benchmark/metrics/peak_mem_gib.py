"""The caching allocator's peak over the window (max_memory_allocated after
reset_peak_memory_stats), in GiB: weights, KV caches and activations."""


def read(r):
    return r.peak_bytes / 2**30 if r.peak_bytes else None
