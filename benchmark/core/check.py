"""Decides `correct`: the program's served tokens against the plain fp32
reference (benchmark/reference), which runs once the window has closed
and the program's state is freed.

A sample of the questions the window finished, drawn from the seed with
the longest prompt always in it, goes through the reference: every branch
row (main and its contrast rows) over its prompt and the served tokens,
the image features from the reference's own tower (on the clean image,
or on the noised copy it draws from the call's seed). At each served
position the reference's fused scores say by how far the served token
falls short of the reference's greedy choice (reference/common.token_gaps);
the widest such gap over the sample is compared with the cell's limit.
The control (benchmark/control.py) reads the same gap for the token that
a lower-precision reference puts first.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.core.traffic import _seed
from benchmark.reference.common import fp32_mode, fused_scores, pixels, token_gaps


def sample(traffic, records, n: int, seed: int) -> List[tuple]:
    """Up to n distinct (call, question, served tokens) the window
    finished, drawn from the seed; the one with the longest prompt and
    answer always among them."""
    seen: Dict[tuple, list] = {}
    for r in records:
        for qi, toks in enumerate(r.tokens):
            seen.setdefault((r.call, qi), toks)
    keys = list(seen)
    size = lambda k: traffic.expanded(traffic.calls[k[0]].questions[k[1]].ids) + len(seen[k])  # noqa: E731
    longest = max(keys, key=size)
    rest = [k for k in keys if k != longest]
    rng = np.random.default_rng(_seed(seed, 5))
    pick = [rest[i] for i in rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)] if rest else []
    return [(k[0], k[1], seen[k]) for k in [longest] + sorted(pick)]


def noise_eps(traffic, call, device) -> torch.Tensor:
    """The VCD noise `generate` draws for a call: the first draw of the
    call's generator, one image's shape, fp32."""
    S = traffic.family.image_size
    g = torch.Generator(device=device).manual_seed(call.seed)
    return torch.randn((1, 3, S, S), generator=g, device=device, dtype=torch.float32)


def reference_logits(ref, traffic, picked, device) -> List[Dict[str, torch.Tensor]]:
    """Each picked question's branch logits at its served positions, as
    {kind: [n, V]} from reference `ref`."""
    noise_step = int(traffic.mix["decoding"].get("noise_step", 500))
    slots, feats_in = {}, []
    for ci, qi, _ in picked:
        call = traffic.calls[ci]
        q = call.questions[qi]
        u8 = torch.from_numpy(traffic.images[q.image]).to(device)[None]
        if ("clean", q.image) not in slots:
            slots[("clean", q.image)] = len(feats_in)
            feats_in.append(pixels(u8))
        if "cd" in traffic.branches:
            if traffic.mix["entry"] != "generate":
                raise NotImplementedError("the check draws VCD noise as `generate` does")
            slots[("cd", ci)] = len(feats_in)
            feats_in.append(pixels(u8, noise_eps(traffic, call, device), noise_step))
    feats = torch.cat([ref.encode(x) for x in feats_in]) if feats_in else None
    rows = []
    for ci, qi, toks in picked:
        q = traffic.calls[ci].questions[qi]
        for kind in traffic.branches:
            ids = q.ids if kind in ("main", "cd") else q.branch_ids[kind]
            img = slots[("clean", q.image)] if kind == "main" else slots.get(("cd", ci)) if kind == "cd" else None
            n0 = traffic.expanded(ids)
            rows.append((list(ids) + list(toks[:-1]), img, [n0 - 1 + j for j in range(len(toks))]))
    out = ref.logits(rows, feats)
    nb = len(traffic.branches)
    return [dict(zip(traffic.branches, out[i * nb: (i + 1) * nb])) for i in range(len(picked))]


def contrast_of(traffic, logits: Dict[str, torch.Tensor]) -> Optional[torch.Tensor]:
    """The contrast the fusion reads: the mean of the contrast branches."""
    others = [logits[k] for k in traffic.branches[1:]]
    return torch.stack(others).mean(dim=0) if others else None


def served_gaps(traffic, picked, logits) -> List[float]:
    """Each picked question's widest gap of a served token (logit units)."""
    dec = traffic.mix["decoding"]
    out = []
    for (_, _, toks), lg in zip(picked, logits):
        t = torch.as_tensor(toks, device=lg["main"].device)
        out.append(float(token_gaps(lg["main"], contrast_of(traffic, lg), t, dec["cd_alpha"], dec["cd_beta"]).max()))
    return out


def control_gaps(traffic, picked, logits, ctl_logits) -> List[float]:
    """Each picked question's widest gap, under `logits`, of the token the
    lower-precision `ctl_logits` put first at each served position."""
    dec = traffic.mix["decoding"]
    out = []
    for lg, cl in zip(logits, ctl_logits):
        fused = fused_scores(cl["main"], contrast_of(traffic, cl), dec["cd_alpha"], dec["cd_beta"])
        choice = fused.argmax(dim=-1)
        out.append(float(token_gaps(lg["main"], contrast_of(traffic, lg), choice,
                                    dec["cd_alpha"], dec["cd_beta"]).max()))
    return out


def run_check(cfg, traffic, records, seed: int, device) -> Dict[str, float]:
    """The numbers compared: {'max_gap': the widest served-token gap over
    the sample}."""
    fp32_mode()
    n = int(traffic.mix["check"]["questions"])
    picked = sample(traffic, records, n, seed)
    fam = traffic.family
    ref = fam.reference.Reference(cfg, seed, device, precision=fam.sound_precision)
    with torch.inference_mode():
        logits = reference_logits(ref, traffic, picked, device)
        gaps = served_gaps(traffic, picked, logits)
    del ref, logits
    return {"max_gap": max(gaps), "questions_checked": float(len(picked)),
            "tokens_checked": float(sum(len(t) for _, _, t in picked))}
