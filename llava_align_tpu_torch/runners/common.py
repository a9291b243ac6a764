"""Runner plumbing for the port (copies of llava_align_tpu/runners/common.py
MockTokenizer, build_prompt and load_model's random:* models).

Loading real checkpoints (hf_convert) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np

from llava_align_tpu_torch.config import LlavaConfig
from llava_align_tpu_torch.constants import (
    DEFAULT_IM_END_TOKEN,
    DEFAULT_IM_START_TOKEN,
    DEFAULT_IMAGE_TOKEN,
)
from llava_align_tpu_torch.conversation import conv_templates


def build_prompt(
    question: str,
    conv_mode: str,
    *,
    with_image: bool = True,
    mm_use_im_start_end: bool = False,
    one_word: bool = False,
    suffix: str = "",
) -> Tuple[str, str]:
    """Returns (prompt, stop_str). Mirrors llava_calibrate.py:136-144 /
    llava_naive.py:43-53."""
    qs = question
    if with_image:
        if mm_use_im_start_end:
            qs = (
                DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN + DEFAULT_IM_END_TOKEN
                + "\n" + qs
            )
        else:
            qs = DEFAULT_IMAGE_TOKEN + "\n" + qs
    if one_word:
        qs = qs + " Please answer this question with one word."
    if suffix:
        qs = qs + suffix
    conv = conv_templates[conv_mode].copy()
    conv.append_message(conv.roles[0], qs)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt(), conv.stop_str


class MockTokenizer:
    """Deterministic offline tokenizer for smoke runs (no checkpoint files).
    One id per character, BOS=1, EOS=2; decode maps back to characters."""

    bos_token_id = 1
    eos_token_id = 2
    unk_token_id = 0
    pad_token_id = 0

    def __call__(self, text):
        class R:
            pass

        r = R()
        r.input_ids = [self.bos_token_id] + [min(ord(c), 255) + 3 for c in text]
        return r

    def decode(self, ids, skip_special_tokens=True):
        if isinstance(ids, (int, np.integer)):
            ids = [ids]
        out = []
        for t in ids:
            t = int(t)
            if t >= 3:
                out.append(chr(t - 3))
            elif not skip_special_tokens:
                out.append({0: "<unk>", 1: "<s>", 2: "</s>"}[t])
        return "".join(out)


@dataclasses.dataclass
class LoadedModel:
    tokenizer: Any
    params: Dict[str, Any]
    cfg: LlavaConfig
    model_name: str


def load_model(model_path: str, quant: str = "none", device=None, seed: int = 0) -> LoadedModel:
    """'random:tiny' | 'random:7b' | 'random:13b': a random-weight model at
    that config's shapes with the mock tokenizer, built on `device`.
    quant='int8' builds the quantized, fused tree directly (tiny too, unlike
    the JAX package, which keeps random:tiny in float)."""
    if not model_path.startswith("random:"):
        raise NotImplementedError("checkpoint loading (hf_convert) is not ported yet")
    size = model_path.split(":", 1)[1]
    if size == "tiny":
        cfg = LlavaConfig.tiny(vocab_size=512)
    elif size == "7b":
        cfg = LlavaConfig.llava_v15_7b()
    elif size == "13b":
        cfg = LlavaConfig.llava_v15_13b()
    else:
        raise ValueError(size)
    from llava_align_tpu_torch.utils.synthetic import build_random_llava_params

    params = build_random_llava_params(cfg, quant=quant, device=device, seed=seed)
    return LoadedModel(MockTokenizer(), params, cfg, f"random-{size}")
