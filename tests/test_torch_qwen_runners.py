"""The port's Qwen-VL runners against the JAX package's, on the tiny random
Qwen-VL tree (the JAX one, and its port conversion; each runner's
load_qwen_model patched to return it) with the mock tokenizer and image
files absent (--synthetic-images), greedy dual VDD (the 'unk' branch as
'None {q} Answer:' ids):

- runners/qwen_pope.run: grouped by image (--calibrate, and --quant int8)
  and --no-group-by-image --batch-size 6 (--calibrate): every record equals
  the JAX runner's, texts and ids exactly, the top-k dicts' probabilities
  (and logits_score) within 1e-5;
- runners/mme.run --model-family qwen: the records, the category files and
  the report;
- runners/mmmu.run --model-family qwen (run_qwen), plain (the submit/collect
  path) and --calibrate;
- the refusals: --quant int4 with the JAX runner's reason and --dist auto
  as the port's POPE runner refuses it; --quant w8a8 (once refused) equal
  to the JAX runner's records within W8A8_TOL; load_qwen_model's
  random:* tree and a checkpoint dir without qwen.tiktoken (its tokenizer
  then needs transformers).
"""

import contextlib
import io
import json
import os

import jax
import pytest

from lavis_ref import one_torch_thread  # noqa: F401 (a fixture)
from llava_align_tpu.models import qwen_vl as jqvl
from llava_align_tpu.runners import mme as jmme
from llava_align_tpu.runners import mmmu as jmmmu
from llava_align_tpu.runners import qwen_pope as jqp
from llava_align_tpu_torch.evals.pope import load_jsonl
from llava_align_tpu_torch.models import qwen_vl as tqvl
from llava_align_tpu_torch.runners import mme as tmme
from llava_align_tpu_torch.runners import mmmu as tmmmu
from llava_align_tpu_torch.runners import qwen_pope as tqp
from llava_align_tpu_torch.utils.jax_params import from_jax_params

# torch on one thread: the tiny models gain nothing from more, and a thread
# per core spins at every small op (tests/lavis_ref.one_torch_thread)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-5
W8A8_TOL = 2e-3  # the top-k probabilities under --quant w8a8 (int8 code flips)
OBJECTS = ["dog", "car", "person", "chair", "cat", "tree"]
MMMU_SAMPLES = [
    {"id": "validation_Math_1", "subject": "Math", "question_type": "multiple-choice", "answer": "B",
     "all_choices": ["A", "B", "C", "D"], "index2ans": {"A": "1", "B": "2", "C": "3", "D": "4"},
     "final_input_prompt": "<image 1> How many dots? (A) 1 (B) 2 (C) 3 (D) 4", "image": "m1.png"},
    {"id": "validation_Math_2", "subject": "Math", "question_type": "open", "answer": "42",
     "final_input_prompt": "<image 1> What is six times seven?", "image": "m2.png"},
    {"id": "validation_Art_1", "subject": "Art", "question_type": "multiple-choice", "answer": "C",
     "all_choices": ["A", "B", "C"], "index2ans": {"A": "oil", "B": "ink", "C": "tempera"},
     "final_input_prompt": "<image 1> Which medium? (A) oil (B) ink (C) tempera", "image": "a1.png"},
]


@pytest.fixture(scope="module")
def models():
    cfg = jqvl.QwenVLConfig.tiny()
    jp = jax.device_get(jqvl.init(jax.random.PRNGKey(0), cfg))
    jm = (jqp.QwenMockTokenizer(), jp, cfg, "random-qwen-vl")
    tm = (tqp.QwenMockTokenizer(), from_jax_params(jp, device="cpu"), tqvl.QwenVLConfig.tiny(), "random-qwen-vl")
    return jm, tm


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A POPE question file (2 images x 3 questions), an MME tree (2
    categories x 2 images x 2 questions) with its question file, and MMMU
    samples."""
    root = tmp_path_factory.mktemp("qwen_runners")
    pope = root / "tiny_POPE_questions.jsonl"
    pope.write_text("".join(json.dumps({"question_id": i, "image": f"img_{i // 3}.jpg",
                                        "text": f"Is there a {OBJECTS[i]} in the image?",
                                        "label": "yes" if i % 2 == 0 else "no"}) + "\n" for i in range(6)))
    data, lines = root / "MME_Benchmark", []
    for ci, (cat, nested) in enumerate({"existence": True, "count": False}.items()):
        qa_dir = data / cat / "questions_answers_YN" if nested else data / cat
        qa_dir.mkdir(parents=True)
        if nested:
            (data / cat / "images").mkdir()
        for i in range(2):
            name = f"{ci * 2 + i:06d}"
            qs = [f"Is there a {OBJECTS[ci * 2 + i + j]} in this image? Please answer yes or no." for j in range(2)]
            (qa_dir / f"{name}.txt").write_text(f"{qs[0]}\tYes\n{qs[1]}\tNo\n")
            lines += [{"question_id": f"{cat}/{name}.png", "image": f"{cat}/{name}.png", "text": q,
                       "category": cat} for q in qs]
    mme = root / "llava_mme.jsonl"
    mme.write_text("".join(json.dumps(l) + "\n" for l in lines))
    mmmu = root / "mmmu_val.jsonl"
    mmmu.write_text("".join(json.dumps(s) + "\n" for s in MMMU_SAMPLES))
    return {"pope": str(pope), "mme": str(mme), "mme_root": str(data), "mmmu": str(mmmu)}


def _args(mod, qf, answers, **kw):
    args = mod.build_parser().parse_args(
        ["--model-path", "random:tiny", "--question-file", qf, "--answers-file", answers])
    args.synthetic_images = True
    args.max_new_tokens = 4
    args.temperature = 0.0  # greedy
    args.verbose = False
    args.use_dd = args.use_dd_unk = True
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _patch(models, monkeypatch):
    jm, tm = models
    monkeypatch.setattr(jqp, "load_qwen_model", lambda *a, **k: jm)
    monkeypatch.setattr(tqp, "load_qwen_model", lambda *a, **k: tm)


def _assert_records_match(got, want, n, tol=TOL):
    assert len(got) == len(want) == n
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


POPE_MODES = {
    "grouped_calibrate": {"group_by_image": True, "calibrate": True},
    "grouped_int8": {"group_by_image": True, "quant": "int8"},
    "batch_calibrate": {"group_by_image": False, "batch_size": 6, "calibrate": True},
}


@pytest.mark.parametrize("mode", list(POPE_MODES))
def test_qwen_pope_records_equal_jax(models, monkeypatch, files, tmp_path, mode):
    _patch(models, monkeypatch)
    paths = {}
    for name, mod, extra in (("jax", jqp, {}), ("port", tqp, {"device": "cpu"})):
        paths[name] = str(tmp_path / f"{name}.jsonl")
        mod.run(_args(mod, files["pope"], paths[name], **extra, **POPE_MODES[mode]))
    got, want = load_jsonl(paths["port"]), load_jsonl(paths["jax"])
    _assert_records_match(got, want, 6)
    if POPE_MODES[mode].get("calibrate"):
        assert all("none" in r and "unk" in r for r in got)


def test_qwen_mme_equals_jax(models, monkeypatch, files, tmp_path):
    _patch(models, monkeypatch)
    out = {}
    for name, mod, extra in (("jax", jmme, {}), ("port", tmme, {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        args = _args(mod, files["mme"], str(d / "answers.jsonl"), model_family="qwen", calibrate=True, **extra)
        args.mme_data_root = files["mme_root"]
        with contextlib.redirect_stdout(io.StringIO()):
            report = mod.run(args)
        out[name] = (d, report)
    (jd, jrep), (td, trep) = out["jax"], out["port"]
    _assert_records_match(load_jsonl(str(td / "answers.jsonl")), load_jsonl(str(jd / "answers.jsonl")), 8)
    assert sorted(os.listdir(td / "mme_eval")) == sorted(os.listdir(jd / "mme_eval"))
    for f in os.listdir(jd / "mme_eval"):
        assert (td / "mme_eval" / f).read_text() == (jd / "mme_eval" / f).read_text()
    assert json.dumps(trep, sort_keys=True, default=float) == json.dumps(jrep, sort_keys=True, default=float)


@pytest.mark.parametrize("calibrate", [False, True], ids=["plain", "calibrate"])
def test_qwen_mmmu_equals_jax(models, monkeypatch, files, tmp_path, calibrate):
    _patch(models, monkeypatch)
    paths = {}
    for name, mod, extra in (("jax", jmmmu, {}), ("port", tmmmu, {"device": "cpu"})):
        paths[name] = str(tmp_path / f"{name}.jsonl")
        assert mod.run(_args(mod, files["mmmu"], paths[name], model_family="qwen", calibrate=calibrate,
                             **extra)) == paths[name]
    got, want = load_jsonl(paths["port"]), load_jsonl(paths["jax"])
    _assert_records_match(got, want, len(MMMU_SAMPLES))
    assert all(("none" in r) == (calibrate and bool(r["all_choices"])) for r in got)


@pytest.mark.parametrize("case", ["int4", "w8a8", "dist_auto"])
def test_qwen_pope_refusals(models, monkeypatch, files, tmp_path, case):
    """int4 refused with the JAX runner's reason; --dist auto, once
    refused, runs (in one process without a launcher environment);
    --quant w8a8, once refused, now gives the JAX runner's records (int8
    decoder, W8A8 on the 6-question lockstep prefill's 384 rows; grouped,
    two image groups a call, the JAX runner's W8A8 default). The top-k
    probabilities within W8A8_TOL (tests/test_torch_w8a8.py says why)."""
    answers = str(tmp_path / "a.jsonl")
    if case == "int4":
        with pytest.raises(ValueError) as port_err:
            tqp.run(_args(tqp, files["pope"], answers, device="cpu", quant="int4"))
        with pytest.raises(ValueError) as jax_err:
            jqp.run(_args(jqp, files["pope"], answers, quant="int4"))
        assert str(port_err.value) == str(jax_err.value)
    elif case == "dist_auto":
        # once refused: without a launcher environment, one process
        # answering into the requested file, as a run without the flag
        for name in ("RANK", "WORLD_SIZE"):
            monkeypatch.delenv(name, raising=False)
        plain = str(tmp_path / "plain.jsonl")
        assert tqp.run(_args(tqp, files["pope"], answers, device="cpu", dist="auto")) == answers
        tqp.run(_args(tqp, files["pope"], plain, device="cpu"))
        assert load_jsonl(answers) == load_jsonl(plain)
    else:
        _patch(models, monkeypatch)
        for layout in ({"group_by_image": False, "batch_size": 6}, {"group_by_image": True}):
            paths = {}
            for name, mod, extra in (("jax", jqp, {}), ("port", tqp, {"device": "cpu"})):
                paths[name] = str(tmp_path / f"{name}_{len(layout)}.jsonl")
                mod.run(_args(mod, files["pope"], paths[name], quant="w8a8", calibrate=True, **extra, **layout))
            _assert_records_match(load_jsonl(paths["port"]), load_jsonl(paths["jax"]), 6, tol=W8A8_TOL)


def test_load_qwen_model(tmp_path, monkeypatch):
    """random:* gives the tiny tree with the mock tokenizer (eod 2); a
    checkpoint dir without qwen.tiktoken needs transformers for its
    tokenizer, and says so when it is absent."""
    import sys

    tok, params, cfg, name = tqp.load_qwen_model("random:tiny", device="cpu")
    assert cfg == tqvl.QwenVLConfig.tiny() and name == "random-qwen-vl" and tok.eod_id == 2
    assert params["qwen"]["wte"].shape == (512, 64) and params["qwen"]["wte"].device.type == "cpu"
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        tqp.load_qwen_model(str(tmp_path), device="cpu")
