"""One run of one cell: set-up, the measured window, the traced segment,
the check, and the metrics, as BENCHMARK.json and the files it names
describe them. run.py drives it on the card; the tests drive it on the
CPU at tiny sizes."""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import List, Optional

import torch

ROOT = Path(__file__).resolve().parent.parent  # benchmark/
FORBIDDEN = ("jax", "jaxlib", "flax", "llava_align_tpu")


def load_module(path: Path):
    """A file of the benchmark as a module (metric readers, families)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_file_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @staticmethod
    def load(name: str, bench_json: Path) -> "Cell":
        spec = json.loads(bench_json.read_text())
        root = bench_json.parent
        cell = next((w for w in spec["workloads"] if w["name"] == name), None)
        if cell is None:
            raise SystemExit(f"no workload {name!r} in {bench_json}")
        conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
        config = json.loads((root / conf["file"]).read_text())
        mix = json.loads((ROOT / "traffic" / f"{cell['traffic']}.json").read_text())
        lim_path = ROOT / "limits" / f"{name}.json"
        limits = json.loads(lim_path.read_text()) if lim_path.exists() else {}

        def mine(ms):
            return [m for m in ms if name in m.get("workloads", [name])]
        return Cell(name, cell["chips"], config, mix, limits, mine(spec["end_to_end"]), mine(spec["per_layer"]))


def family_of(config: dict):
    return load_module(ROOT / "families" / f"{config['family']}.py").Family(config)


def reader(metric: str):
    """metrics/<name>.py, else metrics/<name up to its first dot>.py."""
    for stem in (metric, metric.split(".")[0]):
        path = ROOT / "metrics" / f"{stem}.py"
        if path.exists():
            return load_module(path).read
    raise SystemExit(f"no reader for metric {metric!r} under {ROOT / 'metrics'}")


@dataclasses.dataclass
class Readings:
    """What a metric reader reads: the window's calls on the host clock,
    the program's own timings, the model FLOPs, memory and the trace."""
    traffic: object
    records: list
    t_start: float
    setup_s: float
    peak_bytes: int
    model_flops: float
    trace: Optional[object] = None

    @property
    def window_s(self) -> float:
        return self.records[-1].t1 - self.t_start

    @property
    def questions(self) -> int:
        return sum(len(r.tokens) for r in self.records)

    @property
    def answer_tokens(self) -> int:
        return sum(len(t) for r in self.records for t in r.tokens)

    def question_seconds(self) -> List[float]:
        """Each question's wall time: its call's, from entry to return."""
        return [r.t1 - r.t0 for r in self.records for _ in r.tokens]


def traced(cell: Cell, driver, adapter, traffic, records, log):
    """The mix's traced calls (the next ones of the pool after the window),
    run once as the plain segment and once as the wrapped one
    (core/trace); the idle share and device ops come from the first, the
    rooflines' spans and the idle gaps from the second."""
    from benchmark.core.trace import TraceResult, Tracer

    tcfg = cell.mix["trace"]
    lo, hi = tcfg.get("forwards", [0, None])
    calls = [traffic.calls[(len(records) + i) % len(traffic.calls)] for i in range(int(tcfg["calls"]))]
    got = {}
    for wrap in (False, True):
        tracer = Tracer(adapter, lo, hi, wrap=wrap)
        walls = []
        with tracer:
            for call in calls:
                t0 = time.perf_counter()
                driver.run_call(call)
                walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        got[wrap] = tracer.result()
        log(f"trace ({'wrapped' if wrap else 'plain'}): calls {[round(w, 4) for w in walls]} s, "
            f"{tracer.forwards} forwards, profiled {tracer.host_s:.4f} s, busy {got[wrap].busy_s:.4f} s, "
            f"{len(got[wrap].spans)} counted calls, read in {time.perf_counter() - t0:.1f} s")
        del tracer
    same = [r.t1 - r.t0 for r in records if r.call in {c.index for c in calls}]
    if same:
        log(f"trace: the same calls untraced in the window {[round(w, 4) for w in same[:8]]} s")
    plain, wrapped = got[False], got[True]
    return TraceResult(plain.busy_s, plain.window_s, wrapped.spans, plain.device_ops, wrapped.idle_gaps)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device, t_process: float,
            log=lambda *a: print(*a, file=sys.stderr, flush=True)) -> dict:
    """Run the cell once; returns the result line's object (without the
    device's name on the CPU)."""
    from benchmark.core.check import run_check
    from benchmark.core.driver import Driver
    from benchmark.core.traffic import Traffic
    from benchmark.core.work import call_flops

    cuda = torch.device(device).type == "cuda"
    family = family_of(cell.config)
    traffic = Traffic(cell.mix, family, seed)
    params, pcfg, adapter = family.build(seed, device)
    driver = Driver(params, pcfg, adapter, family, traffic, device)
    warm = cell.mix.get("warm_max_new_tokens")
    warm_driver = Driver(params, pcfg, adapter, family, traffic, device, warm) if warm else driver
    for call in traffic.warm_calls():
        warm_driver.run_call(call)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_process
    log(f"set-up {setup_s:.3f} s: {len(traffic.warm_calls())} warm-up calls, pool of {len(traffic.calls)}")
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    records, t_start = driver.window(seconds)
    if cuda:
        torch.cuda.synchronize()
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    walls = sorted(r.t1 - r.t0 for r in records)
    log(f"window: {len(records)} calls, {sum(len(r.tokens) for r in records)} questions in "
        f"{records[-1].t1 - t_start:.3f} s; a call {walls[0]:.4f} / {walls[len(walls) // 2]:.4f} / "
        f"{walls[-1]:.4f} s (min / median / max)")
    flops = sum(call_flops(family, traffic, traffic.calls[r.call], r.tokens) for r in records)
    readings = Readings(traffic, records, t_start, setup_s, window_peak, flops)

    if trace:
        readings.trace = traced(cell, driver, adapter, traffic, records, log)

    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules the port must not load are loaded: {found}")

    del driver, warm_driver, params, adapter
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = run_check(cell.config, traffic, records, seed, device)
    log(f"check: {numbers} in {time.perf_counter() - t0:.1f} s")

    checks = {}
    for name, lim in cell.limits.items():
        checks[name] = {"value": numbers[name], "limit": lim["limit"]}
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"])(readings)
        if v is None:
            if "workloads" in m:
                raise SystemExit(f"metric {m['name']} found nothing to read in {cell.name}")
            continue
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    out = {"correct": correct, "attempted": readings.questions, "failed": 0, "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                      "count": 1, "memory_peak_bytes": int(window_peak), "setup_peak_bytes": int(setup_peak)}}
    if readings.trace is not None:
        tr = readings.trace
        out["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    out["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    if not checks:
        log("check: no limits for this cell (benchmark/limits/<cell>.json): not correct")
    return out
