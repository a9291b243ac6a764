"""LLaVA-Bench GPT-judge pipeline (copy of llava_align_tpu/evals/gpt_review.py,
the functions' source unchanged; plain Python, no torch).

Parity: reference experiments/eval/eval_gpt_review_visual.py (prompt assembly
:84-99, score parsing :36-49, resume :67-72,107-115, rate-limit retry :11-33)
and summarize_gpt_review.py (per-category relative-score aggregation).

The judge backend is pluggable: any callable (content, max_tokens) → str.
`openai_judge()` builds the reference's gpt-4 client when the openai package
and an API key are present; offline runs inject their own callable.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Sequence

Judge = Callable[[str, int], str]

JUDGE_SYSTEM_PROMPT = (
    "You are a helpful and precise assistant for checking the quality of the answer."
)


def openai_judge(model: str = "gpt-4-0314", sleep_s: float = 0.5) -> Judge:
    """Reference get_eval (:11-33): retry forever on rate limits."""
    import openai

    def judge(content: str, max_tokens: int) -> str:
        while True:
            try:
                response = openai.ChatCompletion.create(
                    model=model,
                    messages=[
                        {"role": "system", "content": JUDGE_SYSTEM_PROMPT},
                        {"role": "user", "content": content},
                    ],
                    temperature=0.2,
                    max_tokens=max_tokens,
                )
                return response["choices"][0]["message"]["content"]
            except Exception as e:  # rate limits and transient errors
                print(e)
            time.sleep(sleep_s)

    return judge


def parse_score(review: str) -> List[float]:
    """First line 'x y' (or 'x, y') → [x, y]; [-1, -1] on parse failure."""
    try:
        score_pair = review.split("\n")[0].replace(",", " ")
        sp = [s for s in score_pair.split(" ") if s]
        if len(sp) == 2:
            return [float(sp[0]), float(sp[1])]
        print("error", review)
        return [-1, -1]
    except Exception as e:
        print(e, "error", review)
        return [-1, -1]


def build_review_content(
    question: dict, ans1: dict, ans2: dict, context: dict, rule: dict
) -> str:
    """reference :84-99."""
    cap_str = "\n".join(context["captions"])
    box_str = "\n".join(
        f'{inst["category"]}: {inst["bbox"]}' for inst in context["instances"]
    )
    role = rule["role"]
    return (
        f"[Context]\n{cap_str}\n\n{box_str}\n\n"
        f"[Question]\n{question['text']}\n\n"
        f"[{role} 1]\n{ans1['text']}\n\n[End of {role} 1]\n\n"
        f"[{role} 2]\n{ans2['text']}\n\n[End of {role} 2]\n\n"
        f"[System]\n{rule['prompt']}\n\n"
    )


def run_review(
    questions: Sequence[dict],
    answers1: Sequence[dict],
    answers2: Sequence[dict],
    contexts: Sequence[dict],
    rules: Dict[str, dict],
    judge: Judge,
    output_path: str,
    max_tokens: int = 1024,
) -> List[dict]:
    """Pairwise judging with resume-from-existing-output."""
    image_to_context = {c["image"]: c for c in contexts}
    cur_reviews: List[dict] = []
    if os.path.isfile(output_path):
        with open(output_path) as f:
            cur_reviews = [json.loads(line) for line in f]
    out = open(output_path, "a")
    results = list(cur_reviews)
    for idx, (ques, ans1, ans2) in enumerate(zip(questions, answers1, answers2)):
        if idx < len(cur_reviews):
            continue
        category = ques["category"]
        if category not in rules:
            raise KeyError(f"Visual QA category not found in rule file: {category}")
        content = build_review_content(
            ques, ans1, ans2, image_to_context[ques["image"]], rules[category]
        )
        review = judge(content, max_tokens)
        rec = {
            "id": idx + 1,
            "question_id": ques["question_id"],
            "answer1_id": ans1.get("answer_id", ans1["question_id"]),
            "answer2_id": ans2.get("answer_id", ans2["question_id"]),
            "category": category,
            "content": review,
            "tuple": parse_score(review),
        }
        out.write(json.dumps(rec) + "\n")
        out.flush()
        results.append(rec)
    out.close()
    return results


def summarize_reviews(reviews: Iterable[dict]) -> Dict[str, Dict[str, float]]:
    """Per-category and overall relative score (ans2/ans1, the reference
    summarize_gpt_review.py aggregation): mean scores and win rate."""
    by_cat: Dict[str, List[List[float]]] = defaultdict(list)
    for r in reviews:
        pair = r.get("tuple", [-1, -1])
        if pair[0] == -1:
            continue
        by_cat[r["category"]].append(pair)
        by_cat["all"].append(pair)

    summary = {}
    for cat, pairs in by_cat.items():
        a1 = sum(p[0] for p in pairs) / len(pairs)
        a2 = sum(p[1] for p in pairs) / len(pairs)
        wins = sum(1 for p in pairs if p[1] > p[0])
        ties = sum(1 for p in pairs if p[1] == p[0])
        summary[cat] = {
            "score_1": a1,
            "score_2": a2,
            "relative": a2 / a1 * 100 if a1 else 0.0,
            "win_rate_2": wins / len(pairs),
            "tie_rate": ties / len(pairs),
            "n": len(pairs),
        }
    return summary
