"""MMMU answer parsing + evaluation (copy of llava_align_tpu/evals/mmmu.py,
numpy only, on the port's calibrate/posthoc.py and evals/pope.py; the
`random` choices of parse_multi_choice_response are seeded as there).

Parity: reference experiments/eval/MMMU/utils/eval_utils.py —
parse_multi_choice_response (:10-62), normalize/number extraction (:65-120),
parse_open_response (:122-171), eval_multi_choice/eval_open (:175-216),
evaluate (:219-241), calculate_ins_level_acc (:246-255). The 4-way Post-Hoc
generalization (per-question dynamic label dict, run_llava_calibrate.py:82-135)
is `calibrate_choice_probs`.
"""

from __future__ import annotations

import random
import re
from typing import Dict, List, Mapping, Sequence

import numpy as np

from llava_align_tpu_torch.calibrate.posthoc import calibrate_weight, get_prob_from_logits

_rng = random.Random(42)


def parse_multi_choice_response(
    response: str, all_choices: Sequence[str], index2ans: Mapping[str, str]
) -> str:
    """Extract the predicted choice letter from free-form text."""
    for ch in [",", ".", "!", "?", ";", ":", "'"]:
        response = response.strip(ch)
    response = " " + response + " "

    index_ans = True
    ans_with_brack = False
    candidates: List[str] = []
    for choice in all_choices:
        if f"({choice})" in response:
            candidates.append(choice)
            ans_with_brack = True
    if not candidates:
        for choice in all_choices:
            if f" {choice} " in response:
                candidates.append(choice)
    if not candidates and len(response.split()) > 5:
        for index, ans in index2ans.items():
            if ans.lower() in response.lower():
                candidates.append(index)
                index_ans = False

    if not candidates:
        return _rng.choice(list(all_choices))
    if len(candidates) == 1:
        return candidates[0]

    start_indexes = []
    if index_ans:
        pattern = "({})" if ans_with_brack else " {} "
        for can in candidates:
            start_indexes.append(response.rfind(pattern.format(can)))
    else:
        for can in candidates:
            start_indexes.append(response.lower().rfind(index2ans[can].lower()))
    return candidates[int(np.argmax(start_indexes))]


def check_is_number(string: str) -> bool:
    try:
        float(string.replace(",", ""))
        return True
    except ValueError:
        return False


def normalize_str(string: str) -> List:
    string = string.strip()
    if check_is_number(string):
        return [round(float(string.replace(",", "")), 2)]
    string = string.lower()
    if len(string) == 1:
        return [" " + string, string + " "]
    return [string]


def extract_numbers(string: str) -> List[str]:
    pattern_commas = r"-?\b\d{1,3}(?:,\d{3})+\b"
    pattern_scientific = r"-?\d+(?:\.\d+)?[eE][+-]?\d+"
    pattern_simple = r"-?(?:\d+\.\d+|\.\d+|\d+\b)(?![eE][+-]?\d+)(?![,\d])"
    return (
        re.findall(pattern_commas, string)
        + re.findall(pattern_scientific, string)
        + re.findall(pattern_simple, string)
    )


def parse_open_response(response: str) -> List:
    def get_key_subresponses(resp: str) -> List[str]:
        resp = resp.strip().strip(".").lower()
        sub_responses = re.split(r"\.\s(?=[A-Z])|\n", resp)
        indicators = ["could be ", "so ", "is ", "thus ", "therefore ", "final ", "answer ", "result "]
        keys = []
        for index, sub in enumerate(sub_responses):
            inds = indicators + ["="] if index == len(sub_responses) - 1 else indicators
            shortest = None
            for indicator in inds:
                if indicator in sub:
                    tail = sub.split(indicator)[-1].strip()
                    if shortest is None or len(tail) < len(shortest):
                        shortest = tail
            if shortest and shortest.strip() not in [":", ",", ".", "!", "?", ";", "'"]:
                keys.append(shortest)
        return keys or [resp]

    key_responses = get_key_subresponses(response)
    pred_list = list(key_responses)
    for resp in key_responses:
        pred_list.extend(extract_numbers(resp))
    out: List = []
    for p in pred_list:
        out.extend(normalize_str(p) if isinstance(p, str) else [p])
    return list(set(out))


def eval_multi_choice(gold_i, pred_i) -> bool:
    if isinstance(gold_i, list):
        return any(answer == pred_i for answer in gold_i)
    return gold_i == pred_i


def eval_open(gold_i, pred_i: Sequence) -> bool:
    if isinstance(gold_i, list):
        norm_answers: List = []
        for answer in gold_i:
            norm_answers.extend(normalize_str(answer))
    else:
        norm_answers = normalize_str(gold_i)
    for pred in pred_i:
        if isinstance(pred, str):
            if any(isinstance(a, str) and a in pred for a in norm_answers):
                return True
        elif pred in norm_answers:
            return True
    return False


def evaluate(samples: Sequence[dict]):
    """samples: {id, question_type, answer, parsed_pred} →
    (judge_dict, {'acc': ...})."""
    if not samples:
        return {"acc": 0}
    correct = 0
    judge: Dict[str, str] = {}
    for s in samples:
        ok = (
            eval_multi_choice(s["answer"], s["parsed_pred"])
            if s["question_type"] == "multiple-choice"
            else eval_open(s["answer"], s["parsed_pred"])
        )
        judge[s["id"]] = "Correct" if ok else "Wrong"
        correct += int(ok)
    return judge, {"acc": correct / len(samples)}


def calculate_ins_level_acc(results: Mapping[str, Mapping]) -> float:
    acc = sum(r["acc"] * r["num_example"] for r in results.values())
    n = sum(r["num_example"] for r in results.values())
    return acc / n if n else 0


def calibrate_choice_probs(
    naive_probs: Sequence[float],
    content_free_probs: Sequence[Sequence[float]],
    mode: str = "diagonal_W",
) -> np.ndarray:
    """N-way Post-Hoc calibration for one question: naive class probs plus
    one or more content-free prob vectors (summed into p_cf), returns
    calibrated class probabilities (run_llava_calibrate.py:82-135 semantics)."""
    from llava_align_tpu_torch.evals.pope import _safe_normalize

    gen = _safe_normalize(naive_probs)
    # degenerate content-free probes (none of the choice letters in the
    # dumped top-k) fall back to uniform instead of a nan p_cf
    p_cf = _safe_normalize(
        np.sum(np.asarray(content_free_probs, np.float64), axis=0)
    ) + 1e-4
    W, b = calibrate_weight(p_cf, mode)
    cal = np.matmul(W, gen[:, None]) + b
    s = float(np.sum(cal))
    if np.isfinite(s) and abs(s) > 1e-12:
        cal = cal / s
    return cal.ravel()


def choice_label_dict(all_choices: Sequence[str]) -> Dict[int, List[str]]:
    """Per-question label dict mapping class index → choice letter
    (the dynamic LABEL_DICT of run_llava_calibrate.py:106-109)."""
    return {i: [c] for i, c in enumerate(all_choices)}


# ---------------------------------------------------------------------------
# Calibration-setting sweep (reference run_llava_calibrate_best.py:85-131):
# from ONE inference pass per sample (naive + content-free probes) produce an
# answer set per calibration setting, so the best setting can be picked by
# evaluating each. The combination table below is the reference's verbatim —
# including the quirk that 'none_unk' sums the UNK and ZERO probes.
# ---------------------------------------------------------------------------

SWEEP_SETTINGS = (
    "naive", "noise", "none", "zero", "unk",
    "none_noise", "none_unk", "none_unk_noise", "all",
)

_SWEEP_COMBOS = {
    "none_noise": ("noise", "none"),
    "none_unk": ("unk", "zero"),   # reference run_llava_calibrate_best.py:97-99
    "none_unk_noise": ("noise", "none", "unk"),
    "all": ("noise", "none", "zero", "unk"),
}


def sweep_predict(
    naive_probs: Sequence[float],
    probes: Mapping[str, Sequence[float]],
    all_choices: Sequence[str],
    setting: str,
) -> str:
    """One multiple-choice prediction under one calibration setting.
    'naive' answers argmax of the (normalized) first-token class probs
    (identity W, run_llava_calibrate_best.py:111-113); every other setting
    applies the affine correction with p_cf from the named probe(s)."""
    gen = np.asarray(naive_probs, np.float64)
    if setting == "naive":
        with np.errstate(invalid="ignore", divide="ignore"):
            gen = gen / np.sum(gen)
        return all_choices[int(np.argmax(gen))]
    names = _SWEEP_COMBOS.get(setting, (setting,))
    cal = calibrate_choice_probs(gen, [np.asarray(probes[n], np.float64) for n in names])
    return all_choices[int(np.argmax(cal))]


def settings_sweep(
    records: Sequence[Mapping], settings: Sequence[str] = SWEEP_SETTINGS
) -> Dict[str, Dict[str, str]]:
    """records: runner answer dicts carrying 'naive' plus probe top-k dumps
    ('noise'/'none'/'zero'/'one'/'unk') → {setting: {id: pred}}.
    Multiple-choice samples answer from calibrated logits; open questions
    keep the generated text (parsed downstream), exactly like the
    reference's out_samples (run_llava_calibrate_best.py:86-131)."""
    out: Dict[str, Dict[str, str]] = {}
    for setting in settings:
        per_id: Dict[str, str] = {}
        for r in records:
            rid = str(r.get("question_id", r.get("id")))
            choices = r.get("all_choices")
            needed = _SWEEP_COMBOS.get(setting, (setting,))
            have = all(n == "naive" or r.get(n) for n in needed)
            if choices and r.get("naive") and have:
                label_dict = choice_label_dict(choices)
                naive_p = get_prob_from_logits(r["naive"], label_dict)
                probes = {
                    n: get_prob_from_logits(r[n], label_dict)
                    for n in ("noise", "none", "zero", "one", "unk")
                    if r.get(n)
                }
                per_id[rid] = sweep_predict(naive_p, probes, choices, setting)
            else:
                per_id[rid] = r.get("text", "")
        out[setting] = per_id
    return out


# ---------------------------------------------------------------------------
# Domain/subject aggregation table (reference print_results.py:15-54 +
# utils/data_utils.py:9-50 category spec)
# ---------------------------------------------------------------------------

DOMAIN_CAT2SUB_CAT = {
    "Art and Design": ["Art", "Art_Theory", "Design", "Music"],
    "Business": ["Accounting", "Economics", "Finance", "Manage", "Marketing"],
    "Science": ["Biology", "Chemistry", "Geography", "Math", "Physics"],
    "Health and Medicine": [
        "Basic_Medical_Science", "Clinical_Medicine",
        "Diagnostics_and_Laboratory_Medicine", "Pharmacy", "Public_Health",
    ],
    "Humanities and Social Science": [
        "History", "Literature", "Sociology", "Psychology",
    ],
    "Tech and Engineering": [
        "Agriculture", "Architecture_and_Engineering", "Computer_Science",
        "Electronics", "Energy_and_Power", "Materials",
        "Mechanical_Engineering",
    ],
}

CAT_SHORT2LONG = {
    "acc": "Accounting", "agri": "Agriculture",
    "arch": "Architecture_and_Engineering", "art": "Art",
    "art_theory": "Art_Theory", "bas_med": "Basic_Medical_Science",
    "bio": "Biology", "chem": "Chemistry", "cli_med": "Clinical_Medicine",
    "cs": "Computer_Science", "design": "Design",
    "diag_med": "Diagnostics_and_Laboratory_Medicine", "econ": "Economics",
    "elec": "Electronics", "ep": "Energy_and_Power", "fin": "Finance",
    "geo": "Geography", "his": "History", "liter": "Literature",
    "manage": "Manage", "mark": "Marketing", "mate": "Materials",
    "math": "Math", "mech": "Mechanical_Engineering", "music": "Music",
    "phar": "Pharmacy", "phys": "Physics", "psy": "Psychology",
    "pub_health": "Public_Health", "socio": "Sociology",
}


def results_table(subject_results: Mapping[str, Mapping]) -> str:
    """Org-mode table of per-domain / per-subject accuracies with an Overall
    row — the reference print_results.py output shape. subject_results:
    {subject: {'acc': float, 'num_example': int}}. Subjects not in the
    domain spec (e.g. an 'all' bucket) are listed after the domains."""
    rows: List[List] = []
    seen = set()
    for domain, cats in DOMAIN_CAT2SUB_CAT.items():
        in_domain = {c: subject_results[c] for c in cats if c in subject_results}
        if not in_domain:
            continue
        acc = calculate_ins_level_acc(in_domain)
        num = int(sum(r["num_example"] for r in in_domain.values()))
        rows.append(["Overall-" + domain, num, round(acc, 3)])
        for cat, r in in_domain.items():
            rows.append([cat, int(r["num_example"]), round(r["acc"], 3)])
            seen.add(cat)
    for cat, r in subject_results.items():
        if cat not in seen:
            rows.append([cat, int(r["num_example"]), round(r["acc"], 3)])
    overall = calculate_ins_level_acc(subject_results)
    total = int(sum(r["num_example"] for r in subject_results.values()))
    rows.append(["Overall", total, round(overall, 3)])

    headers = ["Subject", "Data Num", "Acc"]
    widths = [
        max(len(str(x)) for x in [h] + [row[i] for row in rows])
        for i, h in enumerate(headers)
    ]

    def fmt(row):
        return "| " + " | ".join(str(x).ljust(w) for x, w in zip(row, widths)) + " |"

    sep = "|" + "+".join("-" * (w + 2) for w in widths) + "|"
    return "\n".join([fmt(headers), sep] + [fmt(r) for r in rows])
