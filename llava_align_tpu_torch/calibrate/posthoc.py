"""Post-Hoc affine calibration of output class probabilities: a copy of
llava_align_tpu/calibrate/posthoc.py, numpy only.

Parity: reference experiments/utils/metrics.py (eval_accuracy :8-41, ECELoss
:43-97, calibrate_label_dict :102-113, get_prob_from_logits :115-126). The
calibration fits p' = W·p + b where p_cf is the model's class distribution on
*meaningless* visual inputs (none/unk/noise/zeros/ones), with
    diagonal_W : W = inv(I · p_cf),  b = 0
    identity_W : W = I,              b = -p_cf

Pure numpy — this stage is CPU post-processing of dumped top-k dicts, exactly
as in the reference (eval_pope_calibrate.py is numpy-only).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

LABEL_DICT = {0: ["yes"], 1: ["no"]}
LABEL_TO_INT = {"yes": 0, "no": 1}


def calibrate_weight(p_cf: Sequence[float], mode: str = "diagonal_W") -> Tuple[np.ndarray, np.ndarray]:
    p_cf = np.asarray(p_cf, dtype=np.float64)
    num_classes = p_cf.shape[0]
    if mode == "diagonal_W":
        W = np.linalg.inv(np.identity(num_classes) * p_cf)
        b = np.zeros([num_classes, 1])
    elif mode == "identity_W":
        W = np.identity(num_classes)
        b = -1 * np.expand_dims(p_cf, axis=-1)
    else:
        raise ValueError(f"unknown calibration mode {mode}")
    return W, b


def apply_calibration(label_probs: Sequence[float], W: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Normalize, apply affine map, renormalize (reference metrics.py:30-33)."""
    p = np.asarray(label_probs, dtype=np.float64)
    p = p / np.sum(p)
    out = np.matmul(W, np.expand_dims(p, axis=-1)) + b
    out /= np.sum(out)
    return out


def eval_accuracy(
    all_label_probs: np.ndarray,
    test_labels: Sequence[int],
    mode: str = "diagonal_W",
    p_cf: Optional[Sequence[float]] = None,
) -> Tuple[float, List[np.ndarray]]:
    """Accuracy with/without contextual calibration (metrics.py:8-41)."""
    all_label_probs = np.asarray(all_label_probs)
    num_classes = all_label_probs.shape[1]
    if p_cf is None:
        W = np.identity(num_classes)
        b = np.zeros([num_classes, 1])
    else:
        W, b = calibrate_weight(p_cf, mode)

    assert len(all_label_probs) == len(test_labels)
    correctness, probs = [], []
    for label_probs, true_label in zip(all_label_probs, test_labels):
        cal = apply_calibration(label_probs, W, b)
        probs.append(cal)
        correctness.append(1 if int(np.argmax(cal)) == int(true_label) else 0)
    return float(np.mean(correctness)), probs


def ece(probs_or_logits, labels, n_bins: int = 15) -> float:
    """Expected Calibration Error (metrics.py:43-97 semantics): the input is
    softmaxed (even if it is already a probability vector — the reference does
    the same when fed top-k probability pairs), binned by confidence."""
    x = np.asarray(probs_or_logits, dtype=np.float64)
    labels = np.asarray(labels)
    x = np.squeeze(x)
    if x.ndim == 1:
        x = x[None]
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    softmaxes = e / e.sum(axis=-1, keepdims=True)
    confidences = softmaxes.max(axis=-1)
    predictions = softmaxes.argmax(axis=-1)
    accuracies = (predictions == labels).astype(np.float64)

    bounds = np.linspace(0, 1, n_bins + 1)
    total = 0.0
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        in_bin = (confidences > lo) & (confidences <= hi)
        prop = in_bin.mean()
        if prop > 0:
            total += abs(confidences[in_bin].mean() - accuracies[in_bin].mean()) * prop
    return float(total)


def calibrate_label_dict(
    top_probs: Sequence[float],
    top_ids: Sequence[int],
    tokenizer,
    top_k: int = 10,
) -> Dict[str, float]:
    """Top-k (probability, token) pairs → {decoded_lower_stripped: prob},
    keeping the first occurrence per string (metrics.py:102-113).

    The engine already softmaxes the first-step warped scores on device, so
    this takes (probs, ids) instead of raw logits.
    """
    out: Dict[str, float] = {}
    for prob, token in list(zip(top_probs, top_ids))[:top_k]:
        s = tokenizer.decode(int(token)).lower().strip()
        if s not in out:
            out[s] = float(prob)
    return out


def get_prob_from_logits(
    top_token_probs: Mapping[str, float],
    label_dict: Mapping[int, Sequence[str]] = LABEL_DICT,
) -> List[float]:
    """Class probabilities from a decoded top-k dict (metrics.py:115-126,
    with the key lowercasing of eval_pope_calibrate.py:18-29)."""
    probs = {str(k).lower().strip(): v for k, v in top_token_probs.items()}
    p_y = [0.0] * len(label_dict)
    for i, answers in label_dict.items():
        p_y[i] = sum(probs.get(a.lower(), 0.0) for a in answers)
    return p_y
