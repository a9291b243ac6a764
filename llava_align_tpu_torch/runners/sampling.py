"""Decoding-configuration sweep runner (the port of
llava_align_tpu/runners/sampling.py, with the same grids, answers-file
names and records).

Capability parity: experiments/eval/sampling/llava_sampling.py:150-194 (and
qwenvl_sampling.py via --model-family qwen) — run the default config, then
sweep temperature 0.05..1.0 (step .05), top-p 0..1 (step .05), and top-k
{1,2,5,10,20,50,100,200,500}; answers-file name is templated on the literal
'setting'. --benchmark mmmu drives the same grid through the MMMU runner
(reference MMMU/run_llava_sampling.py:129-173 and run_qwen_sampling.py).

    python -m llava_align_tpu_torch.runners.sampling --model-path random:tiny --device cpu \\
        --question-file questions.jsonl --answers-file out/answers_setting.jsonl \\
        --use_dd --use_dd_unk --synthetic-images --grid smoke

The GPU unless --device cpu is given; each point runs the family's runner
(runners/pope, qwen_pope, blip_pope or mmmu), which loads the model anew.
"""

from __future__ import annotations

import copy

import numpy as np

from llava_align_tpu_torch.runners import pope

# the reference grids verbatim (llava_sampling.py:164-193)
TEMPERATURE_GRID = [float(np.round(t, 2)) for t in np.arange(0.05, 1.05, 0.05)]
TOP_P_GRID = [float(np.round(p, 2)) for p in np.arange(0, 1.05, 0.05)]
TOP_K_GRID = [1, 2, 5, 10, 20, 50, 100, 200, 500]


def _run_fn(args):
    family = getattr(args, "model_family", "llava")
    if getattr(args, "benchmark", "pope") == "mmmu":
        # mmmu.run dispatches llava/qwen internally on args.model_family
        from llava_align_tpu_torch.runners import mmmu

        return mmmu.run
    if family == "qwen":
        from llava_align_tpu_torch.runners import qwen_pope

        return qwen_pope.run
    if family == "blip":
        from llava_align_tpu_torch.runners import blip_pope

        return blip_pope.run
    return pope.run


def run_sweep(args) -> list:
    """Run every grid point into its answers file; returns the files."""
    if "setting" not in args.answers_file:
        raise ValueError("--answers-file must contain 'setting'")
    answers_template = args.answers_file
    produced = []
    run = _run_fn(args)

    temperature_grid, top_p_grid, top_k_grid = (
        TEMPERATURE_GRID, TOP_P_GRID, TOP_K_GRID)
    if getattr(args, "grid", "full") == "smoke":
        # one point per axis — for shell-driver live checks at tiny scale
        temperature_grid, top_p_grid, top_k_grid = [0.5], [0.5], [5]

    def run_one(a, name):
        a.answers_file = answers_template.replace("setting", name)
        run(a)
        produced.append(a.answers_file)

    base = copy.deepcopy(args)
    base.temperature, base.top_p, base.top_k = 1.0, None, None
    run_one(copy.deepcopy(base), "default")

    if args.use_cd:
        return produced

    for t in temperature_grid:
        a = copy.deepcopy(base)
        a.temperature = t
        run_one(a, f"temp_{t}")

    for top_p in top_p_grid:
        a = copy.deepcopy(base)
        a.top_p = top_p
        run_one(a, f"top_p_{a.top_p}")

    for top_k in top_k_grid:
        a = copy.deepcopy(base)
        a.top_k = top_k
        run_one(a, f"top_k_{top_k}")
    return produced


def build_parser():
    p = pope.build_parser()
    p.add_argument("--model-family", default="llava", choices=["llava", "qwen", "blip"])
    p.add_argument("--benchmark", default="pope", choices=["pope", "mmmu"],
                   help="mmmu = sweep over MMMU samples (run_llava_sampling.py)")
    p.add_argument("--grid", default="full", choices=["full", "smoke"],
                   help="smoke = one grid point per axis (driver live checks)")
    return p


if __name__ == "__main__":
    run_sweep(build_parser().parse_args())
