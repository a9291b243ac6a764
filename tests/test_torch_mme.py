"""The port's MME runner and scorer (llava_align_tpu_torch/runners/mme.py,
evals/mme.py) against the JAX package's, on random:tiny (the JAX tiny fp32
tree and its port conversion) with a question file and an MME_Benchmark-
shaped ground-truth tree written here: 2 categories (one with an images/ +
questions_answers_YN/ layout, one flat) x 2 images x MME's 2 questions,
image files absent (--synthetic-images), greedy dual VDD.

- the answer records equal the JAX runner's: text, ids and prompts exactly,
  the top-k dicts' probabilities within 1e-5 (fp32 softmaxes of logits that
  differ by ~1e-7), in both layouts, --calibrate in one;
- the per-category txt files are byte-equal, and so are the calibrated
  converter's;
- the score reports (dicts) and what each runner prints are equal, for a
  run and for the --score-sweep mode (with its CSV);
- the copied scorer functions give equal results on lines written here.
"""

import contextlib
import io
import json
import os
import shutil

import jax
import pytest

from llava_align_tpu.config import LlavaConfig as JCfg
from llava_align_tpu.evals import mme as jmme_eval
from llava_align_tpu.models import llava as jllava
from llava_align_tpu.runners import common as jcommon
from llava_align_tpu.runners import mme as jmme
from llava_align_tpu.runners import pope as jpope
from llava_align_tpu_torch.config import LlavaConfig as TCfg
from llava_align_tpu_torch.evals import mme as tmme_eval
from llava_align_tpu_torch.evals.pope import load_jsonl
from llava_align_tpu_torch.runners import common as tcommon
from llava_align_tpu_torch.runners import mme as tmme
from llava_align_tpu_torch.runners import pope as tpope
from llava_align_tpu_torch.utils.jax_params import from_jax_params

TOL = 1e-5
CATEGORIES = {"existence": True, "count": False}  # category -> has an images/ dir
OBJECTS = ("dog", "car", "cat", "tree", "bus")


@pytest.fixture(scope="module")
def models():
    jp = jax.device_get(jllava.init(jax.random.PRNGKey(0), JCfg.tiny(vocab_size=512)))
    jm = jcommon.LoadedModel(jcommon.MockTokenizer(), jp, JCfg.tiny(vocab_size=512), "random-tiny")
    tm = tcommon.LoadedModel(tcommon.MockTokenizer(), from_jax_params(jp, device="cpu"),
                             TCfg.tiny(vocab_size=512), "random-tiny")
    return jm, tm


@pytest.fixture(scope="module")
def mme_data(tmp_path_factory):
    """(question file, data root): the question file's prompts carry the
    llava_mme.jsonl suffix, which the converter strips."""
    root = tmp_path_factory.mktemp("mme")
    data = root / "MME_Benchmark"
    lines = []
    for ci, (cat, nested) in enumerate(CATEGORIES.items()):
        qa_dir = data / cat / "questions_answers_YN" if nested else data / cat
        qa_dir.mkdir(parents=True)
        if nested:
            (data / cat / "images").mkdir()
        for i in range(2):
            name = f"{ci * 2 + i:06d}"
            yes_obj, no_obj = OBJECTS[ci * 2 + i], OBJECTS[ci * 2 + i + 1]
            # question 1 of each image: the jsonl text has no yes/no suffix
            # and the ground truth the two-space form the converter falls
            # back to (reference convert_answer_to_mme.py:62-66)
            q_yes = f"Is there a {yes_obj} in this image? Please answer yes or no."
            q_no = f"Is there a {no_obj} in this image?"
            gt = [f"{q_yes}\tYes", f"{q_no}  Please answer yes or no.\tNo"]
            for text in (q_yes + "\nAnswer the question using a single word or phrase.", q_no):
                lines.append({"question_id": f"{cat}/{name}.png", "image": f"{cat}/{name}.png",
                              "text": text, "category": cat})
            (qa_dir / f"{name}.txt").write_text("\n".join(gt) + "\n")
    qf = root / "llava_mme.jsonl"
    qf.write_text("".join(json.dumps(l) + "\n" for l in lines))
    return str(qf), str(data)


def _args(mod, qf, answers, data_root, **kw):
    args = mod.build_parser().parse_args(
        ["--model-path", "random:tiny", "--question-file", qf, "--answers-file", answers,
         "--mme-data-root", data_root])
    args.synthetic_images = True
    args.max_new_tokens = 4
    args.temperature = 0.0
    args.verbose = False
    args.use_dd = args.use_dd_unk = True
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _assert_records_match(got, want):
    assert len(got) == len(want) and want
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            if key in ("naive", "none", "unk"):
                assert g[key].keys() == w[key].keys()
                assert all(abs(g[key][t] - w[key][t]) <= TOL for t in w[key])
            elif key == "logits_score":
                assert all(abs(a - b) <= TOL for a, b in zip(g[key], w[key]))
            else:
                assert g[key] == w[key], key


def _run_both(models, monkeypatch, mme_data, tmp_path, **kw):
    jm, tm = models
    monkeypatch.setattr(jpope, "load_model", lambda *a, **k: jm)
    monkeypatch.setattr(tpope, "load_model", lambda *a, **k: tm)
    qf, data_root = mme_data
    out = {}
    for name, mod, extra in (("jax", jmme, {}), ("port", tmme, {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            report = mod.run(_args(mod, qf, str(d / "answers.jsonl"), data_root, **extra, **kw))
        out[name] = (d, report, printed.getvalue())
    return out["jax"], out["port"]


MODES = {"grouped_calibrate": {"group_by_image": True, "calibrate": True},
         "batched": {"group_by_image": False, "batch_size": 3}}


@pytest.mark.parametrize("mode", list(MODES))
def test_mme_runner_equals_jax(models, monkeypatch, mme_data, tmp_path, mode):
    (jd, jrep, jout), (td, trep, tout) = _run_both(models, monkeypatch, mme_data, tmp_path, **MODES[mode])
    want, got = load_jsonl(str(jd / "answers.jsonl")), load_jsonl(str(td / "answers.jsonl"))
    _assert_records_match(got, want)
    assert len(got) == 8
    jtxt, ttxt = sorted(os.listdir(jd / "mme_eval")), sorted(os.listdir(td / "mme_eval"))
    assert jtxt == ttxt == ["count.txt", "existence.txt"]
    # the records' texts are equal, so the category files are byte-equal
    for f in jtxt:
        assert (td / "mme_eval" / f).read_bytes() == (jd / "mme_eval" / f).read_bytes()
    assert trep == jrep and trep["Perception"]["tasks"]
    assert tout == jout and tout.strip().endswith("}")


def test_mme_score_sweep_and_calibrated_converter_equal_jax(models, monkeypatch, mme_data, tmp_path):
    (jd, _, _), (td, _, _) = _run_both(models, monkeypatch, mme_data, tmp_path, group_by_image=True,
                                       calibrate=True)
    _, data_root = mme_data
    records = load_jsonl(str(td / "answers.jsonl"))
    gt_j, gt_t = jmme.load_mme_gt(data_root), tmme.load_mme_gt(data_root)
    assert gt_t == gt_j and len(gt_t) == 8
    sweep = tmp_path / "sweep"
    for setting, mode in (("none_unk", "individual"), ("unk", "all")):
        outs = []
        for name, m in (("j", jmme_eval), ("t", tmme_eval)):
            d = sweep / name / f"mme_{setting}"
            paths = m.convert_calibrated_answers_to_category_txt(records, gt_t, str(d), setting, mode)
            outs.append((sorted(os.path.basename(p) for p in paths),
                         {os.path.basename(p): open(p, "rb").read() for p in paths}))
        assert outs[0] == outs[1]
    shutil.copytree(td / "mme_eval", sweep / "t" / "mme_plain")
    shutil.copytree(td / "mme_eval", sweep / "j" / "mme_plain")
    results = []
    for name, mod in (("j", jmme), ("t", tmme)):
        csv = str(sweep / f"{name}.csv")
        args = type("A", (), dict(score_sweep=str(sweep / name), sweep_prefix="mme_", sweep_csv=csv))()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rep = mod.run(args)
        results.append((rep, printed.getvalue(), open(csv).read()))
    assert results[0] == results[1]
    assert sorted(results[1][0]) == ["none_unk", "plain", "unk"]


def _score_lines():
    out = []
    for i, (gt, pred) in enumerate([("Yes", "yes"), ("No", "Yes, it is."), ("yes", "nope"), ("no", "maybe"),
                                    ("Yes", "No"), ("No", "no")]):
        out.append(f"{i // 2:04d}.png\tIs it? Please answer yes or no.\t{gt}\t{pred}\n")
    return out


SCORER_CASES = {
    "parse_pred_ans": lambda m: [m.parse_pred_ans(x) for x in ("Yes", "no.", "The answer: yes", "nah", "")],
    "compute_metric": lambda m: m.compute_metric(["yes", "no", "yes", "no"], ["yes", "yes", "other", "no"]),
    "score_task_lines": lambda m: m.score_task_lines(_score_lines()),
    "score_task_lines_odd": lambda m: m.score_task_lines(_score_lines()[:3]),
    "calibrated_predictions": lambda m: m.calibrated_predictions(
        [{"text": "Yes", "naive": {"Yes": 0.6, "No": 0.3}, "none": {"yes": 0.2, "no": 0.7},
          "unk": {"Yes": 0.5}}, {"text": "No", "naive": {"the": 0.9}, "none": {"no": 0.1},
                                 "unk": {"no": 0.4, "yes": 0.1}}], "none_unk", "individual"),
}


@pytest.mark.parametrize("case", list(SCORER_CASES))
def test_mme_scorer_functions_identical(case):
    outs = []
    for m in (jmme_eval, tmme_eval):
        try:
            outs.append(("ok", SCORER_CASES[case](m)))
        except ValueError as e:
            outs.append(("ValueError", str(e)))
    assert outs[0] == outs[1]
    assert tmme_eval.EVAL_TYPE_DICT == jmme_eval.EVAL_TYPE_DICT and tmme_eval.LABEL_MAP == jmme_eval.LABEL_MAP


def test_mme_runner_refuses_qwen(mme_data, tmp_path):
    """--model-family qwen is ported: MME routes it to the qwen_pope runner
    (tests/test_torch_qwen_runners.py holds its records against the JAX
    runner's), which refuses --quant int4 with the JAX runner's reason
    before any model is loaded."""
    qf, data_root = mme_data
    with pytest.raises(ValueError, match="qwen int4 is unsupported"):
        tmme.run(_args(tmme, qf, str(tmp_path / "a.jsonl"), data_root, device="cpu", model_family="qwen",
                       quant="int4"))
