"""The port's POPE runner end to end against the JAX runner: both runners'
load_model return the same tiny fp32 tree (the JAX one, and its port
conversion), and every answer record the port writes must equal the JAX
runner's: text, ids and prompt exactly, the top-k dicts' keys exactly and
their probabilities (and logits_score) within 1e-5 (fp32 softmaxes of
logits that differ by ~1e-7). Modes, as tests/test_runner.py runs the JAX
runner: plain batched, --calibrate, --group-by-image, --group-by-image
--calibrate (the pipelined submit path), and resume.

VCD (--use_cd, alone and with dual VDD) in both layouts, with each
engine's diffusion noise injected from one numpy eps per image-array shape
(the one draw the two frameworks make differently); and
--image-aspect-ratio anyres on image files the test writes (anyres grid
stacks decode one question at a time through `generate`).

Also: the port's scorer entry prints what scripts/pope/score.sh prints on
the same files, and the runner refuses what the port does not take yet
(--dist auto) and takes --quant w8a8 as the JAX runner does (records within
W8A8_TOL: see tests/test_torch_w8a8.py for why W8A8 is not held to 1e-5).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavis_ref import one_torch_thread  # noqa: F401 (a fixture)
from llava_align_tpu.config import LlavaConfig as JCfg
from llava_align_tpu.decoding import engine as jengine_mod
from llava_align_tpu.models import llava as jllava
from llava_align_tpu.runners import common as jcommon
from llava_align_tpu.runners import pope as jpope
from llava_align_tpu_torch.config import LlavaConfig as TCfg
from llava_align_tpu_torch.decoding import engine as tengine_mod
from llava_align_tpu_torch.evals.pope import load_jsonl
from llava_align_tpu_torch.runners import common as tcommon
from llava_align_tpu_torch.runners import pope as tpope
from llava_align_tpu_torch.utils.jax_params import from_jax_params

# torch on one thread: the tiny models gain nothing from more, and a thread
# per core spins at every small op (tests/lavis_ref.one_torch_thread)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
W8A8_TOL = 2e-3  # the top-k probabilities under --quant w8a8 (int8 code flips)
OBJECTS = ["dog", "car", "person", "chair", "cat", "tree"]


@pytest.fixture(scope="module")
def models():
    jp = jax.device_get(jllava.init(jax.random.PRNGKey(0), JCfg.tiny(vocab_size=512)))
    jm = jcommon.LoadedModel(jcommon.MockTokenizer(), jp, JCfg.tiny(vocab_size=512), "random-tiny")
    tm = tcommon.LoadedModel(tcommon.MockTokenizer(), from_jax_params(jp, device="cpu"),
                             TCfg.tiny(vocab_size=512), "random-tiny")
    return jm, tm


@pytest.fixture(scope="module")
def question_file(tmp_path_factory):
    """POPE-shaped: 2 images x 3 questions, consecutive questions sharing an
    image; the image files do not exist (--synthetic-images)."""
    qf = tmp_path_factory.mktemp("pope_port") / "tiny_POPE_questions.json"
    with open(qf, "w") as f:
        for i in range(6):
            f.write(json.dumps({"question_id": i, "image": f"img_{i // 3}.jpg",
                                "text": f"Is there a {OBJECTS[i]} in the image?",
                                "label": "yes" if i % 2 == 0 else "no"}) + "\n")
    return str(qf)


def _args(mod, question_file, answers_file, **kw):
    args = mod.build_parser().parse_args(
        ["--model-path", "random:tiny", "--question-file", question_file, "--answers-file", answers_file]
    )
    args.synthetic_images = True
    args.max_new_tokens = 4
    args.temperature = 0.0  # greedy
    args.verbose = False
    args.use_dd = args.use_dd_unk = True
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _run_both(models, monkeypatch, question_file, tmp_path, tag, runs=({},)):
    """Run the JAX and the port runner on the same question file with each
    of `runs`' settings in turn (into one answers file each); return both
    answers files' records."""
    jm, tm = models
    monkeypatch.setattr(jpope, "load_model", lambda *a, **k: jm)
    monkeypatch.setattr(tpope, "load_model", lambda *a, **k: tm)
    out = {}
    for name, mod, extra in (("jax", jpope, {}), ("port", tpope, {"device": "cpu"})):
        path = str(tmp_path / f"{tag}_{name}.jsonl")
        for kw in runs:
            mod.run(_args(mod, question_file, path, **extra, **kw))
        out[name] = load_jsonl(path)
    return out["jax"], out["port"]


def _assert_records_match(got, want, tol=TOL):
    assert len(got) == len(want) and want
    for g, w in zip(got, want):
        assert g.keys() == w.keys(), (g.keys(), w.keys())
        for key in w:
            if key in ("naive", "none", "unk"):
                assert g[key].keys() == w[key].keys(), (w["question_id"], key)
                for tok in w[key]:
                    assert abs(g[key][tok] - w[key][tok]) <= tol, (w["question_id"], key, tok)
            elif key == "logits_score":
                assert all(abs(a - b) <= tol for a, b in zip(g[key], w[key]))
            else:
                assert g[key] == w[key], (w["question_id"], key)


MODES = {
    "plain_batched": {"group_by_image": False, "batch_size": 4},
    "calibrate": {"group_by_image": False, "batch_size": 4, "calibrate": True},
    "group_by_image": {"group_by_image": True},
    "group_by_image_calibrate": {"group_by_image": True, "calibrate": True},
}


@pytest.mark.parametrize("mode", list(MODES))
def test_runner_records_equal_jax(models, monkeypatch, question_file, tmp_path, mode):
    want, got = _run_both(models, monkeypatch, question_file, tmp_path, mode, runs=(MODES[mode],))
    _assert_records_match(got, want)
    assert len(got) == 6
    if MODES[mode].get("calibrate"):
        assert all("none" in r and "unk" in r for r in got)


def test_runner_resume_equals_jax(models, monkeypatch, question_file, tmp_path):
    """Two questions, then --resume for the rest: the port's file holds the
    JAX runner's six records, each once."""
    runs = ({"max_questions": 2}, {"resume": True})
    want, got = _run_both(models, monkeypatch, question_file, tmp_path, "resume", runs=runs)
    _assert_records_match(got, want)
    assert [r["question_id"] for r in got] == list(range(6))


def test_scorer_entry_prints_what_score_sh_prints(models, monkeypatch, question_file, tmp_path):
    """The port's `python -m llava_align_tpu_torch.evals.pope` and
    scripts/pope/score.sh on the same files: identical output, plain and
    calibrated reports both."""
    _, tm = models
    monkeypatch.setattr(tpope, "load_model", lambda *a, **k: tm)
    answers = str(tmp_path / "answers.jsonl")
    tpope.run(_args(tpope, question_file, answers, device="cpu", calibrate=True))
    env = dict(os.environ, PYTHONPATH=REPO)
    port = subprocess.run([sys.executable, "-m", "llava_align_tpu_torch.evals.pope", question_file, answers],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    ref = subprocess.run(["bash", os.path.join(REPO, "scripts/pope/score.sh"), question_file, answers],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert ref.returncode == 0 and port.returncode == 0, (ref.stderr[-2000:], port.stderr[-2000:])
    assert "[none_unk]" in port.stdout and port.stdout.startswith("Precision:")
    assert port.stdout == ref.stdout


@pytest.mark.parametrize("case", ["dist_auto", "w8a8"])
def test_runner_refuses_what_is_not_ported(models, monkeypatch, question_file, tmp_path, case):
    """--dist auto, once refused, now runs over torch.distributed
    (tests/test_torch_parallel.py runs two ranks); without a launcher
    environment it answers in one process into the requested file, as the
    JAX runner does without a coordinator, and its records equal a run
    without the flag. --quant w8a8, once refused, now gives the JAX
    runner's records (4 questions a lockstep call: 512 prefill rows, so the
    W8A8 product takes every stack of the image prefill)."""
    if case == "dist_auto":
        for name in ("RANK", "WORLD_SIZE"):
            monkeypatch.delenv(name, raising=False)
        monkeypatch.setattr(tpope, "load_model", lambda *a, **k: models[1])
        paths = {d: str(tmp_path / f"{d}.jsonl") for d in ("auto", "none")}
        for d, path in paths.items():
            assert tpope.run(_args(tpope, question_file, path, device="cpu", dist=d)) == path
        assert load_jsonl(paths["auto"]) == load_jsonl(paths["none"]) and len(load_jsonl(paths["auto"])) == 6
        return
    from llava_align_tpu_torch.ops import quant as tquant

    n0 = tquant.int8_matmul_w8a8.launches
    run = {"quant": "w8a8", "group_by_image": False, "batch_size": 4, "calibrate": True}
    want, got = _run_both(models, monkeypatch, question_file, tmp_path, "w8a8", runs=(run,))
    _assert_records_match(got, want, tol=W8A8_TOL)
    assert len(got) == 6 and tquant.int8_matmul_w8a8.launches > n0


def _shape_eps(shape):
    """One standard-normal eps per image-array shape, the same for both
    runners' engines."""
    return np.random.default_rng(abs(hash(tuple(shape))) % 2**32).standard_normal(shape).astype(np.float32)


@pytest.fixture
def injected_noise(monkeypatch):
    from llava_align_tpu.ops import noise as jnoise
    from llava_align_tpu_torch.ops import noise as tnoise

    def jax_noise(images, rng, noise_step):
        sqrt_ab, sqrt_1m_ab = (jnp.asarray(a) for a in jnoise.diffusion_schedule())
        t = jnp.asarray(noise_step, jnp.int32)
        out = sqrt_ab[t] * images.astype(jnp.float32) + sqrt_1m_ab[t] * jnp.asarray(_shape_eps(images.shape))
        return out.astype(images.dtype)

    def port_noise(images, noise_step, generator=None):
        return tnoise.add_diffusion_noise(images, noise_step,
                                          eps=torch.from_numpy(_shape_eps(tuple(images.shape))))

    monkeypatch.setattr(jengine_mod, "add_diffusion_noise", jax_noise)
    monkeypatch.setattr(tengine_mod, "add_diffusion_noise", port_noise)


VCD_MODES = {
    "vcd_batched": {"use_cd": True, "use_dd": False, "use_dd_unk": False, "group_by_image": False,
                    "batch_size": 4, "calibrate": True},
    "vcd_grouped": {"use_cd": True, "use_dd": False, "use_dd_unk": False, "group_by_image": True},
    "vcd_dual_grouped": {"use_cd": True, "group_by_image": True, "calibrate": True},
    "vcd_dual_batched": {"use_cd": True, "group_by_image": False, "batch_size": 4},
}


@pytest.mark.parametrize("mode", list(VCD_MODES))
def test_runner_vcd_records_equal_jax(models, monkeypatch, question_file, tmp_path, injected_noise, mode):
    want, got = _run_both(models, monkeypatch, question_file, tmp_path, mode, runs=(VCD_MODES[mode],))
    _assert_records_match(got, want)
    assert len(got) == 6


@pytest.fixture(scope="module")
def anyres_files(tmp_path_factory):
    """Two real image files (anyres grids come only from files) of
    different aspect ratios, 3 questions each."""
    from PIL import Image

    root = tmp_path_factory.mktemp("anyres")
    rng = np.random.default_rng(7)
    for i, (w, h) in enumerate(((40, 23), (31, 57))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(root / f"img_{i}.png")
    qf = root / "anyres_POPE_questions.jsonl"
    with open(qf, "w") as f:
        for i in range(6):
            f.write(json.dumps({"question_id": i, "image": f"img_{i // 3}.png",
                                "text": f"Is there a {OBJECTS[i]} in the image?"}) + "\n")
    return str(qf), str(root)


@pytest.mark.parametrize("mode", ["grouped_calibrate", "single"])
def test_runner_anyres_records_equal_jax(models, monkeypatch, anyres_files, tmp_path, mode):
    qf, folder = anyres_files
    stack = tcommon.load_image_tensor(folder, "img_0.png", image_size=28, image_aspect_ratio="anyres")
    assert stack.ndim == 4 and stack.shape[1:] == (3, 28, 28) and stack.shape[0] > 1
    kw = {"image_aspect_ratio": "anyres", "image_folder": folder}
    kw.update({"group_by_image": True, "calibrate": True} if mode == "grouped_calibrate"
              else {"group_by_image": False, "batch_size": 1})
    want, got = _run_both(models, monkeypatch, qf, tmp_path, mode, runs=(kw,))
    _assert_records_match(got, want)
    assert len(got) == 6
