"""The port's LLaVA-Bench judge pipeline (evals/gpt_review.py, a copy)
against the JAX package's with an injected offline judge: score parsing,
the review prompt's assembly, the reviews written (resume included) and
the per-category summary are identical. The openai judge is never called
here; building it needs the openai package, imported only then."""

import json

import pytest

from llava_align_tpu.evals import gpt_review as jgr
from llava_align_tpu_torch.evals import gpt_review as tgr

REVIEWS = ["8 7\nreasoning", "8, 7\nmore", "garbage", "10 10", "", "3 9 1\nthree numbers", "7.5 8.25\nx"]


@pytest.mark.parametrize("review", REVIEWS)
def test_parse_score_identical(review):
    assert tgr.parse_score(review) == jgr.parse_score(review)


def test_build_review_content_identical():
    args = ({"text": "What is shown?"}, {"text": "a dog"}, {"text": "a cat"},
            {"captions": ["cap1", "cap2"], "instances": [{"category": "dog", "bbox": [1, 2, 3, 4]},
                                                         {"category": "cat", "bbox": [5, 6, 7, 8]}]},
            {"role": "Assistant", "prompt": "Rate both."})
    assert tgr.build_review_content(*args) == jgr.build_review_content(*args)
    assert tgr.JUDGE_SYSTEM_PROMPT == jgr.JUDGE_SYSTEM_PROMPT


def _inputs():
    cats = ["conv", "detail", "complex", "conv", "detail"]
    questions = [{"question_id": i, "image": f"img{i % 2}.jpg", "text": f"q{i}", "category": c}
                 for i, c in enumerate(cats)]
    answers1 = [{"question_id": i, "text": f"ref {i}"} for i in range(5)]
    answers2 = [{"question_id": i, "answer_id": f"a{i}", "text": f"model {i}"} for i in range(5)]
    contexts = [{"image": f"img{j}.jpg", "captions": [f"c{j}"], "instances": []} for j in range(2)]
    rules = {c: {"role": "Assistant", "prompt": f"rate {c}"} for c in set(cats)}
    return questions, answers1, answers2, contexts, rules


def _judge(calls):
    replies = iter(["8 9\nbecause", "7 7\ntie", "bad reply", "6, 9\nx", "9 4\ny"] * 2)

    def judge(content, max_tokens):
        calls.append((content, max_tokens))
        return next(replies)

    return judge


def test_run_review_and_summary_identical(tmp_path):
    """Two reviews, then the run resumed for the rest, in each package:
    the written reviews, the judge's prompts and the summaries agree."""
    out = {}
    for name, mod in (("jax", jgr), ("port", tgr)):
        calls = []
        path = str(tmp_path / f"{name}.jsonl")
        q, a1, a2, ctx, rules = _inputs()
        mod.run_review(q[:2], a1[:2], a2[:2], ctx, rules, _judge(calls), path, max_tokens=256)
        res = mod.run_review(q, a1, a2, ctx, rules, _judge(calls), path)
        with open(path) as f:
            written = [json.loads(line) for line in f]
        out[name] = (res, written, calls, mod.summarize_reviews(res))
    assert out["port"] == out["jax"]
    res, written, calls, summary = out["port"]
    assert len(written) == 5 and len(calls) == 5 and [c[1] for c in calls] == [256, 256, 1024, 1024, 1024]
    assert summary["all"]["n"] == 4  # the unparsable review is left out


def test_unknown_category_raises_alike(tmp_path):
    q, a1, a2, ctx, rules = _inputs()
    rules.pop("complex")
    for mod in (jgr, tgr):
        with pytest.raises(KeyError, match="complex"):
            mod.run_review(q, a1, a2, ctx, rules, _judge([]), str(tmp_path / f"{mod.__name__}.jsonl"))
