"""POPE scorers: a copy of llava_align_tpu/evals/pope.py, numpy only, with a
command line that prints what scripts/pope/score.sh prints:

    python -m llava_align_tpu_torch.evals.pope <gt_file> <gen_file>

* `score_pope` — plain string-match scorer
  (parity: reference experiments/eval/eval_pope.py:17-67).
* `score_pope_calibrated` — Post-Hoc calibrated scorer over dumped top-k
  dicts (parity: reference experiments/eval/eval_pope_calibrate.py:31-175),
  supporting per-sample ('individual') and global ('all') p_cf fitting and the
  combined meaningless-input settings ('none_unk', 'none_noise', ...).
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from llava_align_tpu_torch.calibrate.posthoc import (
    LABEL_TO_INT,
    calibrate_weight,
    ece,
    get_prob_from_logits,
)

BASE_SETTINGS = ["naive", "noise", "none", "zero", "unk"]
COMBO_SETTINGS: Dict[str, List[str]] = {
    "none_noise": ["noise", "none"],
    "none_unk": ["unk", "none"],
    "none_unk_noise": ["noise", "none", "unk"],
    "noise_zero": ["noise", "zero"],
    "all": ["noise", "none", "zero", "unk"],
}


def load_jsonl(path: str) -> List[dict]:
    with open(os.path.expanduser(path)) as f:
        # tolerate hand-edited trailing commas present in some reference
        # splits (data/POPE/coco/test_samples.json)
        return [
            json.loads(line.strip().rstrip(","))
            for line in f
            if line.strip().rstrip(",")
        ]


def check_alignment(
    gt_lines: Sequence[dict],
    gen_lines: Sequence[dict],
    gt_name: str = "gt file",
    gen_name: str = "answers file",
) -> None:
    """Raise a clear error on gt/answers misalignment instead of the
    reference's bare assert (eval_pope.py:30). Names both inputs and counts,
    and points at the first diverging question_id."""
    if len(gt_lines) != len(gen_lines):
        raise ValueError(
            f"count mismatch: {gen_name} has {len(gen_lines)} records but "
            f"{gt_name} has {len(gt_lines)} questions — partial run, wrong "
            f"split, or duplicated records (resume without --resume dedupe)?"
        )
    for i, (g, a) in enumerate(zip(gt_lines, gen_lines)):
        if g["question_id"] != a["question_id"]:
            raise ValueError(
                f"question_id mismatch at record {i}: {gt_name} has "
                f"{g['question_id']!r} but {gen_name} has {a['question_id']!r}"
                " — answers out of order or from a different split?"
            )


def _safe_normalize(v: np.ndarray) -> np.ndarray:
    """Normalize to a distribution; degenerate input (all-zero — e.g. neither
    'yes' nor 'no' appeared in the dumped top-k — or non-finite) falls back to
    uniform instead of the reference's silent nan (eval_pope_calibrate.py
    divides unconditionally; argmax(nan)=0 matches uniform's argmax, so
    predictions are preserved while confidence stays finite)."""
    v = np.asarray(v, np.float64)
    s = float(np.sum(v))
    if not np.isfinite(s) or s <= 0.0 or not np.all(np.isfinite(v)):
        return np.full(v.shape, 1.0 / v.size)
    return v / s


def score_pope(
    gt_lines: Sequence[dict],
    gen_lines: Sequence[dict],
    gt_name: str = "gt file",
    gen_name: str = "answers file",
) -> Dict[str, float]:
    """Plain POPE metrics from answer text (reference eval_pope.py:17-67)."""
    check_alignment(gt_lines, gen_lines, gt_name, gen_name)
    tp = tn = fp = fn = unknown = yes = 0
    total = len(gt_lines)
    for i, line in enumerate(gt_lines):
        gt = line["label"].lower().strip()
        gen = gen_lines[i]["text"].lower().strip()
        if gt == "yes":
            if "yes" in gen:
                tp += 1
                yes += 1
            else:
                fn += 1
        elif gt == "no":
            if "no" in gen:
                tn += 1
            else:
                yes += 1
                fp += 1
        else:
            unknown += 1
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    return {
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "accuracy": (tp + tn) / total if total else 0.0,
        "yes_ratio": yes / total if total else 0.0,
        "unknown_ratio": unknown / total if total else 0.0,
        "total": total,
    }


def _setting_p_vector(prob: Mapping[str, List], name: str, i: Optional[int]):
    """p_cf source vector for a setting, per-sample (i given) or stacked."""
    parts = COMBO_SETTINGS.get(name)
    if parts is None:
        v = np.asarray(prob[name][i] if i is not None else prob[name], np.float64)
        return v
    arrs = [np.asarray(prob[p][i] if i is not None else prob[p], np.float64) for p in parts]
    return np.sum(arrs, axis=0)


def score_pope_calibrated(
    gt_lines: Sequence[dict],
    gen_lines: Sequence[dict],
    settings: Sequence[str] = ("naive", "none", "unk", "none_unk"),
    calibrate_mode: str = "individual",
    mode: str = "diagonal_W",
    confidence_low: float = 0.0,
    confidence_high: float = 1.0,
    ece_bins: int = 10,
    gt_name: str = "gt file",
    gen_name: str = "answers file",
) -> Dict[str, Dict[str, float]]:
    """Calibrated POPE metrics per debias setting
    (reference eval_pope_calibrate.py:49-175)."""
    check_alignment(gt_lines, gen_lines, gt_name, gen_name)
    num_classes = 2
    prob: Dict[str, List[List[float]]] = {n: [] for n in BASE_SETTINGS}
    labels: List[int] = []
    for i, line in enumerate(gt_lines):
        labels.append(LABEL_TO_INT[line["label"]])
        for name in BASE_SETTINGS:
            if name in gen_lines[i]:
                prob[name].append(get_prob_from_logits(gen_lines[i][name]))

    scores_naive = prob["naive"]
    results: Dict[str, Dict[str, float]] = {}
    needed = {
        b
        for n in settings
        if n != "naive"
        for b in COMBO_SETTINGS.get(n, [n])
    }
    missing = [n for n in needed if len(prob.get(n, [])) < len(labels)]
    if missing:
        raise ValueError(
            f"answers file lacks per-sample {missing} logit dumps needed for "
            f"calibrated scoring — rerun the runner with --calibrate"
        )
    for name in settings:
        tp = tn = fp = fn = unknown = yes = total = 0
        confidence = 0.0
        calibrated_probs = []

        W = np.identity(num_classes)
        b = np.zeros([num_classes, 1])
        if calibrate_mode == "all" and name != "naive":
            all_p_y = _setting_p_vector(prob, name, None)
            p_cf = _safe_normalize(np.mean(np.asarray(all_p_y, np.float64), axis=0))
            W, b = calibrate_weight(p_cf, mode)

        for i in range(len(labels)):
            gen_answer = _safe_normalize(scores_naive[i])
            if np.max(gen_answer) > confidence_high or np.max(gen_answer) < confidence_low:
                continue
            if calibrate_mode == "individual" and name != "naive":
                p_cf = _safe_normalize(_setting_p_vector(prob, name, i))
                p_cf = p_cf + 1e-4  # reference eval_pope_calibrate.py:136
                W, b = calibrate_weight(p_cf, mode)

            cal = np.matmul(W, np.expand_dims(gen_answer, axis=-1)) + b
            s = float(np.sum(cal))
            # identity_W calibration sums to exactly 0 (p and p_cf both
            # normalized) — argmax/confidence are taken unnormalized then,
            # same ordering, no nan (reference divides by 0 here).
            if np.isfinite(s) and abs(s) > 1e-12:
                cal = cal / s
            calibrated_probs.append(cal)

            gt = labels[i]
            pred = int(np.argmax(cal))
            confidence += float(np.max(cal))
            if gt == 0:
                if pred == 0:
                    tp += 1
                    yes += 1
                else:
                    fn += 1
            elif gt == 1:
                if pred == 1:
                    tn += 1
                else:
                    yes += 1
                    fp += 1
            else:
                unknown += 1
            total += 1

        precision = tp / (tp + fp) if tp + fp else 0.0
        recall = tp / (tp + fn) if tp + fn else 0.0
        f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
        results[name] = {
            "f1": f1,
            "accuracy": (tp + tn) / total if total else 0.0,
            "precision": precision,
            "recall": recall,
            "yes_ratio": yes / total if total else 0.0,
            "unknown_ratio": unknown / total if total else 0.0,
            "total": total,
            "confidence": confidence / total if total else 0.0,
            "ece_naive": ece(scores_naive, labels, ece_bins),
        }
    return results


def format_calibrated_report(results: Dict[str, Dict[str, float]]) -> str:
    lines = []
    for name, m in results.items():
        lines.append(
            f"[{name}] F1: {m['f1']*100:.4} Accuracy: {m['accuracy']*100:.4} "
            f"Precision: {m['precision']*100:.4} Recall: {m['recall']*100:.4} "
            f"yes: {m['yes_ratio']*100:.4} unknown: {m['unknown_ratio']*100:.4} "
            f"n: {m['total']} confidence: {m['confidence']:.4}"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    """Plain report always; the calibrated report per setting when every
    answer record carries its 'none' and 'unk' dumps (runner --calibrate).
    Exit code 1, and the reason on stderr, on misaligned files."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) != 2:
        print("usage: python -m llava_align_tpu_torch.evals.pope <gt_file> <gen_file>", file=sys.stderr)
        return 2
    gt_name, gen_name = argv
    gt, gen = load_jsonl(gt_name), load_jsonl(gen_name)
    try:
        m = score_pope(gt, gen, gt_name=gt_name, gen_name=gen_name)
        print(f"Precision: {m['precision']}\nRecall: {m['recall']}\nF1: {m['f1']}\n"
              f"Accuracy: {m['accuracy']}\nyes: {m['yes_ratio']}\nunknow: {m['unknown_ratio']}")
        if gen and all(("none" in r and "unk" in r) for r in gen):
            print(format_calibrated_report(score_pope_calibrated(
                gt, gen, gt_name=gt_name, gen_name=gen_name)))
    except ValueError as e:
        print(f"evals.pope: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
