"""Drives the program: builds the engine a mix names and sends it the
traffic's calls, closed loop (the next call starts when the last one
returns), recording each call's host-clock times and served tokens."""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import torch


@dataclasses.dataclass
class CallRecord:
    call: int             # index into Traffic.calls
    t0: float             # host clock at the call's start
    t1: float             # ... and at its return
    first_s: float        # the program's seconds to the first token (GenerationOutput)
    total_s: float        # the program's seconds to the last token
    steps: int            # tokens served to the call's longest answer
    tokens: List[List[int]]  # each question's served tokens


def generation_config(mix: dict, family, max_new_tokens: Optional[int] = None):
    """Greedy decoding with the mix's branches; EOS lies outside the vocab,
    so every answer runs to its cap (random weights emit no real EOS)."""
    from llava_align_tpu_torch.config import GenerationConfig

    dec = mix["decoding"]
    br = dec["branches"]
    return GenerationConfig(
        max_new_tokens=int(max_new_tokens or dec["max_new_tokens"]), do_sample=False, temperature=1.0,
        top_p=None, top_k=None, seed=0, use_cd="cd" in br, use_dd="none" in br, use_dd_unk="unk" in br,
        cd_alpha=float(dec["cd_alpha"]), cd_beta=float(dec["cd_beta"]), noise_step=int(dec.get("noise_step", 500)),
        eos_token_id=family.d["V"] + 1, pad_token_id=0)


class Driver:
    def __init__(self, params, pcfg, adapter, family, traffic, device, max_new_tokens: Optional[int] = None):
        from llava_align_tpu_torch.decoding.engine import DecodeEngine

        if traffic.mix["entry"] == "generate_batch" and "unk" in traffic.branches:
            raise ValueError("generate_batch takes no explicit branch ids, which Qwen-VL's 'unk' branch needs")
        self.traffic, self.device = traffic, device
        gen = generation_config(traffic.mix, family, max_new_tokens)
        self.engine = DecodeEngine(params, pcfg, gen, adapter=adapter, bucket=family.bucket, device=device)

    def _generator(self, call) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(call.seed)

    def run_call(self, call):
        """One call through the mix's entry; returns its outputs, question-major."""
        tr, eng = self.traffic, self.engine
        entry = tr.mix["entry"]
        unk = "unk" in tr.branches
        if entry == "generate":
            q = call.questions[0]
            bids = {"unk": q.branch_ids["unk"]} if unk else None
            return [eng.generate(q.ids, tr.images[q.image], generator=self._generator(call), branch_ids=bids)]
        if entry == "generate_batch":
            return eng.generate_batch([(q.ids, tr.images[q.image]) for q in call.questions],
                                      generator=self._generator(call))
        groups = []
        for g, img in enumerate(call.images):
            qs = call.questions[g * tr.per_group: (g + 1) * tr.per_group]
            prefix, suffixes = tr.split_group(qs)
            bids = [{"unk": q.branch_ids["unk"]} for q in qs] if unk else None
            groups.append((prefix, suffixes, tr.images[img], bids))
        return eng.generate_batch_groups(groups, generator=self._generator(call))

    def timed_call(self, call) -> CallRecord:
        t0 = time.perf_counter()
        outs = self.run_call(call)
        t1 = time.perf_counter()
        return CallRecord(call.index, t0, t1, outs[0].seconds_to_first_token, outs[0].seconds_total,
                          max(o.num_generated for o in outs), [list(o.token_ids) for o in outs])

    def window(self, seconds: float):
        """Calls in turn from the pool until `seconds` have passed; the call
        under way at the close runs to its end. Returns (records, the
        window's start on the host clock)."""
        calls = self.traffic.calls
        records: List[CallRecord] = []
        t_start = time.perf_counter()
        i = 0
        while time.perf_counter() - t_start < seconds:
            records.append(self.timed_call(calls[i % len(calls)]))
            i += 1
        return records, t_start
