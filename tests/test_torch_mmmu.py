"""The port's MMMU runner and scorers (llava_align_tpu_torch/runners/mmmu.py,
evals/mmmu.py) against the JAX package's, on random:tiny (the JAX tiny fp32
tree and its port conversion) with 4 samples written here (multiple choice
and open, two subjects), image files absent (--synthetic-images), greedy
dual VDD:

- the answer records equal the JAX runner's (ids, texts, choices exactly;
  the top-k dicts' probabilities within 1e-5), without --calibrate (the
  submit/collect path), with --calibrate (the none/unk probes) and with
  --calibrate-best (the noise/zero/one probes; each runner's diffusion
  noise injected from one numpy eps, the one draw the frameworks make
  differently);
- score() per setting, score_sweep, score_sweep_files (with its CSV),
  print_results and each runner's command line print the same, with
  the parsers' `random` choices seeded as in the JAX package;
- the copied parsers and evaluators give equal results.
"""

import contextlib
import io
import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavis_ref import one_torch_thread  # noqa: F401 (a fixture)
from llava_align_tpu.config import LlavaConfig as JCfg
from llava_align_tpu.evals import mmmu as jmmmu_eval
from llava_align_tpu.models import llava as jllava
from llava_align_tpu.runners import common as jcommon
from llava_align_tpu.runners import mmmu as jmmmu
from llava_align_tpu_torch.config import LlavaConfig as TCfg
from llava_align_tpu_torch.evals import mmmu as tmmmu_eval
from llava_align_tpu_torch.evals.pope import load_jsonl
from llava_align_tpu_torch.runners import common as tcommon
from llava_align_tpu_torch.runners import mmmu as tmmmu
from llava_align_tpu_torch.utils.jax_params import from_jax_params

# torch on one thread: the tiny models gain nothing from more, and a thread
# per core spins at every small op (tests/lavis_ref.one_torch_thread)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-5
SAMPLES = [
    {"id": "validation_Math_1", "subject": "Math", "question_type": "multiple-choice", "answer": "B",
     "all_choices": ["A", "B", "C", "D"], "index2ans": {"A": "1", "B": "2", "C": "3", "D": "4"},
     "final_input_prompt": "<image 1> How many dots? (A) 1 (B) 2 (C) 3 (D) 4", "image": "m1.png"},
    {"id": "validation_Math_2", "subject": "Math", "question_type": "open", "answer": "42",
     "final_input_prompt": "<image 1> What is six times seven?", "image": "m2.png"},
    {"id": "validation_Art_1", "subject": "Art", "question_type": "multiple-choice", "answer": ["A", "C"],
     "all_choices": ["A", "B", "C"], "index2ans": {"A": "oil", "B": "ink", "C": "tempera"},
     "final_input_prompt": "<image 1> Which medium? (A) oil (B) ink (C) tempera", "image": "a1.png"},
    {"id": "validation_Art_2", "subject": "Art", "question_type": "open", "answer": ["blue", "azure"],
     "final_input_prompt": "<image 1> What colour is the sky?", "image": "a2.png"},
]


@pytest.fixture(scope="module")
def models():
    jp = jax.device_get(jllava.init(jax.random.PRNGKey(0), JCfg.tiny(vocab_size=512)))
    jm = jcommon.LoadedModel(jcommon.MockTokenizer(), jp, JCfg.tiny(vocab_size=512), "random-tiny")
    tm = tcommon.LoadedModel(tcommon.MockTokenizer(), from_jax_params(jp, device="cpu"),
                             TCfg.tiny(vocab_size=512), "random-tiny")
    return jm, tm


@pytest.fixture(scope="module")
def sample_file(tmp_path_factory):
    qf = tmp_path_factory.mktemp("mmmu") / "mmmu_val.jsonl"
    qf.write_text("".join(json.dumps(s) + "\n" for s in SAMPLES))
    return str(qf)


@pytest.fixture(autouse=True)
def seeded_parsers(monkeypatch):
    """Both parsers' module-level random.Random(42), fresh for each test."""
    monkeypatch.setattr(jmmmu_eval, "_rng", random.Random(42))
    monkeypatch.setattr(tmmmu_eval, "_rng", random.Random(42))


def _args(mod, qf, answers, **kw):
    args = mod.build_parser().parse_args(
        ["--model-path", "random:tiny", "--question-file", qf, "--answers-file", answers])
    args.synthetic_images = True
    args.max_new_tokens = 4
    args.temperature = 0.0
    args.verbose = False
    args.use_dd = args.use_dd_unk = True
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _assert_records_match(got, want):
    assert len(got) == len(want) == len(SAMPLES)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            if key in ("naive", "none", "unk", "noise", "zero", "one"):
                assert g[key].keys() == w[key].keys(), key
                assert all(abs(g[key][t] - w[key][t]) <= TOL for t in w[key]), key
            else:
                assert g[key] == w[key], key


def _run_both(models, monkeypatch, qf, tmp_path, **kw):
    jm, tm = models
    monkeypatch.setattr(jmmmu, "load_model", lambda *a, **k: jm)
    monkeypatch.setattr(tmmmu, "load_model", lambda *a, **k: tm)
    paths = {}
    for name, mod, extra in (("jax", jmmmu, {}), ("port", tmmmu, {"device": "cpu"})):
        paths[name] = str(tmp_path / f"{name}.jsonl")
        assert mod.run(_args(mod, qf, paths[name], **extra, **kw)) == paths[name]
    return paths["jax"], paths["port"]


@pytest.fixture
def injected_noise(monkeypatch):
    """--calibrate-best's step-999 noise from one numpy eps per shape."""
    from llava_align_tpu.ops import noise as jnoise
    from llava_align_tpu_torch.ops import noise as tnoise

    def eps(shape):
        return np.random.default_rng(11).standard_normal(tuple(shape)).astype(np.float32)

    real_j, real_t = jnoise.add_diffusion_noise, tnoise.add_diffusion_noise

    def jax_noise(image, rng, noise_step):
        sqrt_ab, sqrt_1m_ab = (jnp.asarray(a) for a in jnoise.diffusion_schedule())
        out = sqrt_ab[noise_step] * image.astype(jnp.float32) + sqrt_1m_ab[noise_step] * jnp.asarray(eps(image.shape))
        return out.astype(image.dtype)

    def port_noise(image, noise_step, generator=None, **kw):
        return real_t(image, noise_step, eps=torch.from_numpy(eps(image.shape)), **kw)

    monkeypatch.setattr(jnoise, "add_diffusion_noise", jax_noise)
    monkeypatch.setattr(tnoise, "add_diffusion_noise", port_noise)
    return real_j


MODES = {"plain": {}, "calibrate": {"calibrate": True}, "calibrate_best": {"calibrate_best": True}}


@pytest.mark.parametrize("mode", list(MODES))
def test_mmmu_records_equal_jax(models, monkeypatch, sample_file, tmp_path, injected_noise, mode):
    jpath, tpath = _run_both(models, monkeypatch, sample_file, tmp_path, **MODES[mode])
    got, want = load_jsonl(tpath), load_jsonl(jpath)
    _assert_records_match(got, want)
    probes = {"plain": set(), "calibrate": {"none", "unk"},
              "calibrate_best": {"none", "unk", "noise", "zero", "one"}}[mode]
    for r in got:
        assert {k for k in ("none", "unk", "noise", "zero", "one") if k in r} == (
            probes if r["all_choices"] else set())


def test_mmmu_scorers_equal_jax(models, monkeypatch, sample_file, tmp_path, injected_noise):
    """score() per setting, print_results, score_sweep and
    score_sweep_files on one --calibrate-best run's records (copied into
    both packages' answer files, so only the scorers differ)."""
    _, tpath = _run_both(models, monkeypatch, sample_file, tmp_path, calibrate_best=True)
    for setting in ("naive", "none", "unk", "none_unk"):
        monkeypatch.setattr(jmmmu_eval, "_rng", random.Random(42))
        monkeypatch.setattr(tmmmu_eval, "_rng", random.Random(42))
        got, want = tmmmu.score(tpath, setting), jmmmu.score(tpath, setting)
        assert got == want and got["subjects"].keys() == {"Math", "Art"}
        assert tmmmu.print_results(tpath, setting) == jmmmu.print_results(tpath, setting)
    got, want = tmmmu.score_sweep(tpath), jmmmu.score_sweep(tpath)
    assert got == want and len(got["settings"]) == 9
    sweep = tmp_path / "sweep"
    sweep.mkdir()
    for name in ("sample_a.jsonl", "sample_b.jsonl"):
        (sweep / name).write_text(open(tpath).read())
    csvs = [str(tmp_path / "j.csv"), str(tmp_path / "t.csv")]
    want = jmmmu.score_sweep_files(str(sweep), "sample_", "none_unk", csv_path=csvs[0])
    got = tmmmu.score_sweep_files(str(sweep), "sample_", "none_unk", csv_path=csvs[1])
    assert got == want and sorted(got) == ["a", "b"]
    assert open(csvs[0]).read() == open(csvs[1]).read()


def test_mmmu_command_line_prints_what_jax_prints(models, monkeypatch, sample_file, tmp_path):
    """The port's main() and the JAX runner's __main__ block on the same
    flags: run, score with a setting, print the table."""
    jm, tm = models
    monkeypatch.setattr(jmmmu, "load_model", lambda *a, **k: jm)
    monkeypatch.setattr(tmmmu, "load_model", lambda *a, **k: tm)
    flags = ["--model-path", "random:tiny", "--question-file", sample_file, "--synthetic-images",
             "--max_new_tokens", "4", "--temperature", "0", "--use_dd", "--use_dd_unk", "--calibrate",
             "--score-setting", "none_unk", "--print-table"]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        assert tmmmu.main(flags + ["--answers-file", str(tmp_path / "t.jsonl"), "--device", "cpu"]) == 0
    # the JAX runner's __main__ block, as it reads (runners/mmmu.py:437-474)
    a = jmmmu.build_parser().parse_args(flags + ["--answers-file", str(tmp_path / "j.jsonl")])
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        path = jmmmu.run(a)
        res = jmmmu.score(path, a.score_setting)
        print(json.dumps(res, indent=2))
        print(jmmmu_eval.results_table(res["subjects"]))
    assert printed.getvalue() == want.getvalue()
    assert "Overall" in printed.getvalue()


PARSER_CASES = {
    "multi_choice": lambda m: [m.parse_multi_choice_response(r, ["A", "B", "C", "D"],
                                                             {"A": "red", "B": "green", "C": "blue", "D": "gray"})
                               for r in ("(B)", "The answer is C.", "I think it is blue, not red or gray at all",
                                         "A or B", "(A) and then (D)", "nothing", "???", "")],
    "open": lambda m: [sorted(map(str, m.parse_open_response(r)))
                       for r in ("The answer is 42.", "so x = 3,000 and therefore 7", "1.5e3", "Blue.")],
    "evaluate": lambda m: m.evaluate([
        {"id": "1", "question_type": "multiple-choice", "answer": "B", "parsed_pred": "B"},
        {"id": "2", "question_type": "open", "answer": ["42", "forty-two"], "parsed_pred": [42.0]},
        {"id": "3", "question_type": "open", "answer": "blue", "parsed_pred": ["light blue"]},
        {"id": "4", "question_type": "multiple-choice", "answer": ["A", "C"], "parsed_pred": "D"}]),
    "calibrate_choice_probs": lambda m: m.calibrate_choice_probs([0.2, 0.5, 0.3], [[0.1, 0.8, 0.1], [0, 0, 0]]).tolist(),
    "settings_sweep": lambda m: m.settings_sweep([
        {"question_id": "q", "all_choices": ["A", "B"], "text": "A", "naive": {"A": 0.4, "B": 0.6},
         "none": {"B": 0.9}, "unk": {"A": 0.3}, "zero": {"A": 0.2, "B": 0.2}, "noise": {"B": 0.5}},
        {"question_id": "o", "text": "42"}]),
    "results_table": lambda m: m.results_table({"Math": {"acc": 0.5, "num_example": 2},
                                                "Art": {"acc": 1.0, "num_example": 1},
                                                "all": {"acc": 0.25, "num_example": 4}}),
}


@pytest.mark.parametrize("case", list(PARSER_CASES))
def test_mmmu_parsers_identical(case):
    assert PARSER_CASES[case](tmmmu_eval) == PARSER_CASES[case](jmmmu_eval)
    assert tmmmu_eval.SWEEP_SETTINGS == jmmmu_eval.SWEEP_SETTINGS
    assert tmmmu_eval.DOMAIN_CAT2SUB_CAT == jmmmu_eval.DOMAIN_CAT2SUB_CAT
    assert tmmmu_eval.CAT_SHORT2LONG == jmmmu_eval.CAT_SHORT2LONG


def test_mmmu_runner_refuses_qwen(sample_file, tmp_path, monkeypatch):
    """--model-family qwen is ported (tests/test_torch_qwen_runners.py holds
    its records against the JAX runner's), and so is --dist auto, once
    refused on its path: without a launcher environment the run answers in
    one process into the requested file, equal to a run without the flag."""
    for name in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    paths = {d: str(tmp_path / f"{d}.jsonl") for d in ("auto", "none")}
    for d, path in paths.items():
        assert tmmmu.run(_args(tmmmu, sample_file, path, device="cpu", model_family="qwen", dist=d,
                               max_questions=2)) == path
    assert load_jsonl(paths["auto"]) == load_jsonl(paths["none"]) and len(load_jsonl(paths["auto"])) == 2
