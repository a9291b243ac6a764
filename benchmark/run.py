"""The benchmark of the PyTorch/CUDA port (llava_align_tpu_torch): one run
of one cell on the card it is started on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (BENCHMARK.json `workloads`) names a configuration
(benchmark/configs) and a traffic mix (benchmark/traffic); the metrics it
reports have readers in benchmark/metrics. The last line of standard
output is the result: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), device, and
with --trace 1 the breakdown, then the numbers compared with their limits.
Without a CUDA card, or with fewer cards than the cell asks for, it exits
with 3 and prints no result.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(CHECKOUT))
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(CHECKOUT / "build" / "bench_cache" / sub)
# one process, few threads: the host loops are the program's, not a thread pool's
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()

    import torch

    from benchmark.core.cell import Cell, execute

    torch.set_num_threads(1)
    cell = Cell.load(args.workload, CHECKOUT / "BENCHMARK.json")
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs on the card only", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    out = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_PROCESS)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
