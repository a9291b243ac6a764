"""The traced segment: the profiler's device trace, spans the benchmark
opens around the port's functions, and what is read from them.

A traced run replays the same calls twice after its window. The plain
segment runs them under the profiler's device activity alone, with no
host ops recorded and no wrapper but a count of the adapter's forwards:
its busy time over its host-clock window gives the idle share, and its
kernels the breakdown's device ops. The wrapped segment runs them again
with the benchmark's own wrappers standing in for the port's
`models/llama.linear`, `llama.logits_from_hidden`, `llama.attend`,
`models/mpt._alibi_attention` and the adapter's `forward` and
`encode_images`. Each opens a profiler range (`bench.<kind>#<n>`) and
notes the call's shapes; the operations and bytes (core/work) are worked
out once the segment has ended, so nothing waits on the device inside it.
A kernel belongs to the innermost range whose host interval holds its
launch; the kernels' device time is what the rooflines divide by, and the
host's gaps between them give the breakdown's idle gaps. Nothing is
wrapped outside the segments.
"""

from __future__ import annotations

import bisect
import dataclasses
import inspect
import time
from typing import Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark.core.work import attention_work, linear_work

LEAVES = ("linear", "attention")  # the kinds whose work is counted


def _nbytes(x, li=None) -> int:
    """Bytes of a weight as stored: layer li of a stacked tensor, or of each
    tensor of a quantized dict ({'q', 's'}, ...) or of a tuple of layers."""
    if isinstance(x, dict):
        return sum(_nbytes(v, li) for v in x.values())
    if isinstance(x, (list, tuple)):
        return _nbytes(x[li]) if li is not None else sum(_nbytes(v) for v in x)
    if torch.is_tensor(x):
        t = x[li] if li is not None else x
        return t.numel() * t.element_size()
    return 0


@dataclasses.dataclass
class TraceResult:
    busy_s: float      # seconds in which a kernel, copy or fill ran on the device
    window_s: float    # the traced window
    spans: List[list]  # [kind, ops, bytes, device seconds] of each counted call
    device_ops: List[list]
    idle_gaps: List[list]


class Tracer:
    """One traced segment: the profiler runs from the segment's forward
    `start` until forward `stop` or the segment's end. wrap=False is the
    plain segment, wrap=True the wrapped one."""

    def __init__(self, adapter, start: int = 0, stop: Optional[int] = None, wrap: bool = True):
        self.adapter_cls = type(adapter)
        self.start, self.stop, self.wrap = start, stop, wrap
        self.spans: List[list] = []
        self.forwards = 0
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if wrap else [ProfilerActivity.CUDA]
        self.prof = profile(activities=acts)
        self.running = False
        self.done = False
        self.host_s = 0.0  # the segment's host-clock length, between synchronized start and stop
        self._t0 = 0.0
        self._saved = []

    # -- the profiler -------------------------------------------------------
    def _start(self):
        if not self.running and not self.done:
            torch.cuda.synchronize()
            self.prof.start()
            self.running = True
            self._t0 = time.perf_counter()

    def finish(self):
        if self.running:
            torch.cuda.synchronize()
            self.host_s = time.perf_counter() - self._t0
            self.prof.stop()
            self.running = False
        self.done = True

    def span(self, kind: str, work=None):
        """A range of `kind`; work is (ops, bytes), a function giving them
        once the segment has ended, or None (not counted)."""
        self.spans.append([kind, work])
        return record_function(f"bench.{kind}#{len(self.spans) - 1}")

    # -- wrappers -------------------------------------------------------------
    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        self._saved.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def __enter__(self):
        from llava_align_tpu_torch.models import llama, mpt

        self._patch(self.adapter_cls, "forward", self._forward)
        if self.wrap:
            self._patch(llama, "linear", self._linear)
            self._patch(llama, "logits_from_hidden", self._head)
            self._patch(llama, "attend", self._attend)
            self._patch(mpt, "_alibi_attention", self._alibi)
            self._patch(self.adapter_cls, "encode_images", self._vision)
        if self.start == 0:
            self._start()
        return self

    def __exit__(self, *exc):
        self.finish()
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved.clear()

    def _counted(self, kind, orig, work):
        """Run orig in a span of `kind`; work(out, *args, **kw) gives
        (ops, bytes), a function giving them later, or None for a decode
        call (its span is then `<kind>_decode`, not counted)."""
        def wrapped(*a, **k):
            if not self.running:
                return orig(*a, **k)
            i = len(self.spans)
            with self.span(kind):
                out = orig(*a, **k)
            w = work(out, *a, **k)
            if w is None:
                self.spans[i][0] = kind + "_decode"
            self.spans[i][1] = w
            return out
        return wrapped

    def _linear(self, orig):
        def work(out, h, w, li, *a, **k):
            return linear_work(out.numel() // out.shape[-1], out.shape[-1], h.shape[-1], h.element_size(),
                               _nbytes(w, li), out.element_size())
        return self._counted("linear", orig, work)

    def _head(self, orig):
        def work(out, params, hidden, *a, **k):
            return linear_work(out.numel() // out.shape[-1], out.shape[-1], hidden.shape[-1],
                               hidden.element_size(), _nbytes(params["lm_head"]), out.element_size())
        return self._counted("linear", orig, work)

    def _attend(self, orig):
        sig = inspect.signature(orig)
        names = list(sig.parameters)
        defaults = {n: p.default for n, p in sig.parameters.items() if p.default is not inspect.Parameter.empty}

        def work(out, *a, **k):
            p = dict(defaults)
            p.update(zip(names, a))
            p.update(k)
            if p["is_decode"]:
                return None
            q, kk, sh = p["q"], p["k"], p["shared_kv"]
            B, S, H, Dh = q.shape
            K = kk.shape[2]
            esize, cache_write = q.element_size(), p["cache"] is not None
            if sh is None:
                return attention_work(B, S, H, K, Dh, esize, cache_write=cache_write)
            # the segment lengths are read once the segment has ended: the
            # span keeps the tensor alive, so its memory is not reused
            per_key = K * Dh * sh["k"].element_size() * 2  # a key and a value
            seg_rows = []  # the first row of each row group's segment, [L, G, P, K, Dh] tables
            if sh["k"].dim() == 5:
                rows = 0
                for name, rpp in (("k", p["shared_rows_per_prefix"]), ("k2", p["shared_rows_per_prefix2"])):
                    for _ in range(sh[name].shape[1] if name in sh else 0):
                        seg_rows.append(rows)
                        rows += rpp
            else:
                seg_rows = [0]
            lens_t = p["shared_len"]

            def later():
                lens = [int(x) for x in lens_t.tolist()]
                return attention_work(B, S, H, K, Dh, esize, cache_write=cache_write, shared_lens=lens[:B],
                                      shared_bytes=sum(lens[r] for r in seg_rows) * per_key)
            return later
        return self._counted("attention", orig, work)

    def _alibi(self, orig):
        def work(out, q, k, v, *a, **kw):
            if q.shape[1] == 1:
                return None
            B, S, H, Dh = q.shape
            return attention_work(B, S, H, k.shape[2], Dh, q.element_size())
        return self._counted("attention", orig, work)

    def _forward(self, orig):
        def wrapped(adapter, params, embeds, *a, **k):
            n = self.forwards
            self.forwards += 1
            if n == self.start:
                self._start()
            if self.stop is not None and n == self.stop:
                self.finish()
            if not (self.running and self.wrap):
                return orig(adapter, params, embeds, *a, **k)
            with self.span("prefill" if embeds.shape[1] > 1 else "decode"):
                return orig(adapter, params, embeds, *a, **k)
        return wrapped

    def _vision(self, orig):
        def wrapped(*a, **k):
            if not self.running:
                return orig(*a, **k)
            with self.span("vision"):
                return orig(*a, **k)
        return wrapped

    def counted_spans(self) -> List[list]:
        """[kind, ops, bytes] of every span, the deferred work worked out."""
        out = []
        for kind, w in self.spans:
            w = w() if callable(w) else w
            out.append([kind, *(w if w is not None else (0.0, 0.0))])
        return out

    # -- reading the trace ------------------------------------------------------
    def result(self) -> TraceResult:
        """busy_s over the segment's host-clock window, the top device ops,
        and with wrap the counted spans' device time and the idle gaps by
        the innermost range and host op at their start."""
        CUDA = torch.autograd.DeviceType.CUDA
        dev, launch, host, bench = [], {}, [], []
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == CUDA:
                if not name.startswith("bench."):
                    dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), name, e.correlation_id()))
            elif name.startswith("bench."):
                kind, idx = name[6:].rsplit("#", 1)
                bench.append((e.start_ns(), e.start_ns() + e.duration_ns(), kind, int(idx)))
            elif name.startswith("cu") and ("Launch" in name or "Memcpy" in name or "Memset" in name):
                launch[e.correlation_id()] = e.start_ns()
            else:
                host.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        if not dev:
            raise RuntimeError("the traced segment shows no device activity")
        dev.sort()
        bench.sort()
        host.sort()

        # busy time and the gaps between the device's activities
        w0 = min(dev[0][0], bench[0][0] if bench else dev[0][0])
        w1 = max(max(e for _, e, _, _ in dev), max((b[1] for b in bench), default=0))
        busy, gaps, cur_s, cur_e = 0, [], dev[0][0], dev[0][1]
        if dev[0][0] > w0:
            gaps.append((w0, dev[0][0]))
        for s, e, _, _ in dev[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        if w1 > cur_e:
            gaps.append((cur_e, w1))

        by_name: Dict[str, float] = {}
        for s, e, name, _ in dev:
            by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-9
        device_ops = sorted(([n[:120], v] for n, v in by_name.items()), key=lambda x: -x[1])[:10]
        window_s = self.host_s or (w1 - w0) * 1e-9
        if not self.wrap:
            return TraceResult(busy * 1e-9, window_s, [], device_ops, [])

        # device seconds of the counted spans: kernels by their launch's host time
        work = self.counted_spans()
        leaves = [b for b in bench if b[2] in LEAVES]
        starts = [b[0] for b in leaves]
        dev_s = {}
        for s, e, _, corr in dev:
            t = launch.get(corr)
            if t is None:
                continue
            j = bisect.bisect_right(starts, t) - 1
            if j >= 0 and leaves[j][1] >= t:
                dev_s[leaves[j][3]] = dev_s.get(leaves[j][3], 0.0) + (e - s) * 1e-9
        spans = [[work[b[3]][0], work[b[3]][1], work[b[3]][2], dev_s.get(b[3], 0.0)] for b in leaves]

        def innermost(items, ss, t):
            j = bisect.bisect_right(ss, t) - 1
            for i in range(j, max(j - 256, -1), -1):
                if items[i][1] >= t:
                    return items[i]
            return None

        bench_items = [(s, e, k) for s, e, k, _ in bench]
        host_ss, bench_ss = [x[0] for x in host], [x[0] for x in bench_items]
        gap_by: Dict[str, float] = {}
        for s, e in gaps:
            b = innermost(bench_items, bench_ss, s)
            h = innermost(host, host_ss, s)
            label = f"{b[2] if b else 'outside spans'}:{h[2][:60] if h else 'python'}"
            gap_by[label] = gap_by.get(label, 0.0) + (e - s) * 1e-9
        idle_gaps = sorted(([k, v] for k, v in gap_by.items()), key=lambda x: -x[1])[:10]
        return TraceResult(busy * 1e-9, window_s, spans, device_ops, idle_gaps)
