"""The one traffic generator: reads a mix's parameters (traffic/<mix>.json)
and draws a run's requests from its seed.

Every seed gets the same multiset of question lengths (a quantile grid of
the mix's length distribution), in its own order, with its own token ids
and images, so that seeds change the inputs and not the amount of work.
Token ids are drawn from the configuration's ordinary text ids (no
tokenizer file is in the repository); a mix's template (the text before
and after the image and the question) is a run of ids drawn once a run.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, List, Optional, Sequence

import numpy as np

from benchmark.core.work import common_prefix
from benchmark.reference.common import IMAGE_SENTINEL
ENTRIES = ("generate", "generate_batch", "generate_batch_groups")
BRANCH_SETS = (("main", "unk", "none"), ("main", "none"), ("main", "cd"))  # the engine's row order


@dataclasses.dataclass
class Question:
    ids: List[int]                    # the main prompt, the image as one sentinel
    branch_ids: Dict[str, List[int]]  # every contrast branch's prompt (cd: the main prompt)
    image: Optional[int]              # index into Traffic.images
    tokens: List[int] = dataclasses.field(default_factory=list)  # served tokens, filled by the run


@dataclasses.dataclass
class Call:
    index: int
    questions: List[Question]
    images: List[int]        # the images the call encodes (one per group, or per question)
    seed: int                # the call's generator seed (the VCD noise's stream)
    shape: tuple             # the padded shapes the call runs at


def _seed(*parts: int) -> int:
    return int(np.random.SeedSequence([int(p) for p in parts]).generate_state(1, np.uint64)[0] >> 1)


def lengths_grid(spec: dict, n: int) -> List[int]:
    """n question lengths at the quantiles (i + 0.5) / n of spec's
    distribution: a table of lengths with their weights, uniform integers
    [min, max], or log-normal with a median and a sigma, rounded and
    clipped to [min, max]."""
    if spec["dist"] == "table":
        vals, cum = [int(v) for v in spec["values"]], np.cumsum([float(w) for w in spec["weights"]])
        return [vals[int(np.searchsorted(cum, (i + 0.5) / n * cum[-1]))] for i in range(n)]
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "uniform":
        return [lo + int((i + 0.5) / n * (hi - lo + 1)) for i in range(n)]
    if spec["dist"] == "lognormal":
        z = statistics.NormalDist()
        mu = math.log(spec["median"])
        return [min(hi, max(lo, round(math.exp(mu + spec["sigma"] * z.inv_cdf((i + 0.5) / n))))) for i in range(n)]
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class Traffic:
    """A run's requests: `pool` calls drawn from `seed`, cycled by the run,
    and their images ([3, S, S] uint8, drawn on the host)."""

    def __init__(self, mix: dict, family, seed: int):
        self.mix, self.family, self.seed = mix, family, int(seed)
        if mix["entry"] not in ENTRIES:
            raise ValueError(f"entry {mix['entry']!r} not in {ENTRIES}")
        self.branches = tuple(mix["decoding"]["branches"])
        if self.branches not in BRANCH_SETS:
            raise ValueError(f"branches {self.branches} not one of {BRANCH_SETS}")
        self.entry_groups = mix["entry"] == "generate_batch_groups"
        call = mix["call"]
        self.groups = int(call.get("groups", 0))
        self.per_group = int(call.get("questions_per_group", 0))
        self.per_call = self.groups * self.per_group if self.groups else int(call["questions"])
        if mix["entry"] == "generate" and self.per_call != 1:
            raise ValueError("generate takes one question a call")
        p = mix["prompt"]
        lo, hi = family.text_ids
        trng = np.random.default_rng(_seed(self.seed, 1))
        self.before = trng.integers(lo, hi, p.get("before_image", 0)).tolist()
        self.after_image = trng.integers(lo, hi, p.get("after_image", 0)).tolist()
        self.after_q = trng.integers(lo, hi, p.get("after_question", 0)).tolist()
        self.lead = trng.integers(lo, hi, p.get("lead", 0)).tolist()
        self.unk_token = int(trng.integers(lo, hi))
        n_calls = int(mix["pool_calls"])
        lens = lengths_grid(p["question"], n_calls * self.per_call)
        order = np.random.default_rng(_seed(self.seed, 2)).permutation(len(lens))
        lens = [lens[i] for i in order]
        qrng = np.random.default_rng(_seed(self.seed, 3))
        S = family.image_size
        self.images: List[np.ndarray] = []
        self.calls: List[Call] = []
        for c in range(n_calls):
            qs, imgs = [], []
            for k in range(self.per_call):
                if self.groups and k % self.per_group == 0 or not self.groups:
                    imgs.append(len(self.images))
                    self.images.append(qrng.integers(0, 256, (3, S, S), dtype=np.uint8))
                n = lens[c * self.per_call + k]
                body = self.lead + qrng.integers(lo, hi, max(n - len(self.lead), 1)).tolist()
                qs.append(self._question(body, imgs[-1]))
            self.calls.append(Call(c, qs, imgs, _seed(self.seed, 4, c), self._shape(qs)))

    def _question(self, body: List[int], image: int) -> Question:
        fam = self.family
        ids = self.before + fam.image_block() + self.after_image + body + self.after_q
        branch = {}
        for kind in self.branches[1:]:
            if kind == "unk":
                branch[kind] = self.before + [self.unk_token] + self.after_image + body + self.after_q
            elif kind == "none":
                branch[kind] = fam.none_ids(ids)
            else:
                branch[kind] = list(ids)
        return Question(ids, branch, image)

    def expanded(self, ids: Sequence[int]) -> int:
        """A prompt's positions with its image expanded to its features."""
        n_img = self.family.num_image_tokens
        return len(ids) + sum(n_img - 1 for t in ids if t == IMAGE_SENTINEL)

    def _shape(self, qs: List[Question]) -> tuple:
        b = self.family.bucket
        img = max(self.expanded(q.ids) for q in qs)
        txt = max([len(v) for q in qs for k, v in q.branch_ids.items() if k != "cd"] or [0])
        return (_round_up(max(img, b), b), _round_up(max(txt, b), b) if txt else 0)

    def split_group(self, qs: List[Question]):
        """(prefix, suffixes) of one image group: the longest common token
        prefix of the main prompts, each keeping at least one token."""
        p = common_prefix([q.ids for q in qs])
        return qs[0].ids[:p], [q.ids[p:] for q in qs]

    def warm_calls(self) -> List[Call]:
        """The first call of each distinct shape of the pool."""
        seen, out = set(), []
        for c in self.calls:
            if c.shape not in seen:
                seen.add(c.shape)
                out.append(c)
        return out
