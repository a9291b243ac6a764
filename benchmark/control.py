"""The readings a cell's correctness limit is set from, on the card.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 [--calls N] [--control int4]

For each seed, in one process: the program is built and answers the first
N calls of the cell's traffic (the mix's own load; N defaults to enough
calls to give the run's check sample), and the plain reference reads the
program's widest served-token gap (the lower reading). The control is the
same reference computed with its decoder weights one precision lower
(reference/common.weight_in): at each served position, the gap under the
reference of the token the control puts first (the upper reading).
Prints one JSON line a seed and a summary line.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(CHECKOUT))


def readings(cell, seed: int, calls: int, controls, device) -> dict:
    import torch

    from benchmark.core.cell import family_of
    from benchmark.core.check import control_gaps, reference_logits, sample, served_gaps
    from benchmark.core.driver import Driver
    from benchmark.core.traffic import Traffic
    from benchmark.reference.common import fp32_mode

    family = family_of(cell.config)
    traffic = Traffic(cell.mix, family, seed)
    params, pcfg, adapter = family.build(seed, device)
    driver = Driver(params, pcfg, adapter, family, traffic, device)
    records = [driver.timed_call(traffic.calls[i % len(traffic.calls)]) for i in range(calls)]
    del driver, params, adapter
    gc.collect()
    torch.cuda.empty_cache() if torch.device(device).type == "cuda" else None
    fp32_mode()
    picked = sample(traffic, records, int(cell.mix["check"]["questions"]), seed)
    out = {"seed": seed, "questions": len(picked), "tokens": sum(len(t) for _, _, t in picked)}
    with torch.inference_mode():
        ref = family.reference.Reference(cell.config, seed, device, precision=family.sound_precision)
        logits = reference_logits(ref, traffic, picked, device)
        out["program"] = max(served_gaps(traffic, picked, logits))
        for prec in controls:
            ref.precision = prec
            ctl = reference_logits(ref, traffic, picked, device)
            out[f"control_{prec}"] = max(control_gaps(traffic, picked, logits, ctl))
            del ctl
        del ref, logits
    gc.collect()
    return out


def default_calls(cell) -> int:
    """Calls enough to give a run's check sample."""
    call = cell.mix["call"]
    per_call = call.get("questions") or call["groups"] * call["questions_per_group"]
    return -(-int(cell.mix["check"]["questions"]) // per_call)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--calls", type=int, default=0)
    p.add_argument("--control", default="", help="comma-separated precisions (int8, int4, fp8)")
    p.add_argument("--control-seeds", type=int, default=0, help="read the control on the first N seeds only")
    args = p.parse_args()
    import torch

    from benchmark.core.cell import Cell

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = Cell.load(args.workload, CHECKOUT / "BENCHMARK.json")
    calls = args.calls or default_calls(cell)
    controls = [c for c in args.control.split(",") if c]
    rows = []
    for i, s in enumerate(args.seeds.split(",")):
        t0 = time.perf_counter()
        ctl = controls if not args.control_seeds or i < args.control_seeds else []
        r = readings(cell, int(s), calls, ctl, torch.device("cuda", 0))
        r["seconds"] = round(time.perf_counter() - t0, 1)
        rows.append(r)
        print(json.dumps(r), flush=True)
    summary = {"workload": cell.name, "seeds": len(rows), "program_max": max(r["program"] for r in rows)}
    for c in controls:
        summary[f"control_{c}_min"] = min(r[f"control_{c}"] for r in rows if f"control_{c}" in r)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
