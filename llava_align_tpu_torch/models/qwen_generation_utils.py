"""Qwen chat-format prompt construction and decode helpers (a verbatim copy
of llava_align_tpu/models/qwen_generation_utils.py).

Capability parity: reference experiments/Qwen_VL/qwen_generation_utils.py —
make_context chatml assembly (:119-193), decode_tokens/_decode_default
(:196-265), StopWordsLogitsProcessor (:305+, realized here as stop keyword-id
sequences for the engine's on-device suffix matcher), batch padding (:25-107).

The tokenizer must expose: encode(text, allowed_special=...) or
__call__().input_ids, im_start_id, im_end_id, decode().
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


def _encode(tokenizer, text: str) -> List[int]:
    if hasattr(tokenizer, "encode"):
        try:
            allowed = set(getattr(tokenizer, "IMAGE_ST", ()) or ())
            return list(tokenizer.encode(text, allowed_special=allowed))
        except TypeError:
            return list(tokenizer.encode(text))
    return list(tokenizer(text).input_ids)


def make_context(
    tokenizer,
    query: str,
    history: Optional[List[Tuple[str, str]]] = None,
    system: str = "",
    max_window_size: int = 6144,
    chat_format: str = "chatml",
) -> Tuple[str, List[int]]:
    """(raw_text, context_tokens) — chatml layout identical to the reference."""
    history = history or []

    if chat_format == "raw":
        return query, _encode(tokenizer, query)
    if chat_format != "chatml":
        raise NotImplementedError(f"Unknown chat format {chat_format!r}")

    im_start, im_end = "<|im_start|>", "<|im_end|>"
    im_start_tokens = [tokenizer.im_start_id]
    im_end_tokens = [tokenizer.im_end_id]
    nl_tokens = _encode(tokenizer, "\n")

    def tok(role: str, content: str) -> Tuple[str, List[int]]:
        return (
            f"{role}\n{content}",
            _encode(tokenizer, role) + nl_tokens + _encode(tokenizer, content),
        )

    system_text, system_part = tok("system", system)
    system_tokens = im_start_tokens + system_part + im_end_tokens

    raw_text = ""
    context_tokens: List[int] = []
    for turn_query, turn_response in reversed(history):
        q_text, q_part = tok("user", turn_query)
        q_tokens = im_start_tokens + q_part + im_end_tokens
        if turn_response is not None:
            r_text, r_part = tok("assistant", turn_response)
            r_tokens = im_start_tokens + r_part + im_end_tokens
            next_tokens = nl_tokens + q_tokens + nl_tokens + r_tokens
            prev_chat = f"\n{im_start}{q_text}{im_end}\n{im_start}{r_text}{im_end}"
        else:
            next_tokens = nl_tokens + q_tokens + nl_tokens
            prev_chat = f"\n{im_start}{q_text}{im_end}\n"
        if len(system_tokens) + len(next_tokens) + len(context_tokens) < max_window_size:
            context_tokens = next_tokens + context_tokens
            raw_text = prev_chat + raw_text
        else:
            break

    context_tokens = system_tokens + context_tokens
    raw_text = f"{im_start}{system_text}{im_end}" + raw_text
    context_tokens += (
        nl_tokens
        + im_start_tokens
        + tok("user", query)[1]
        + im_end_tokens
        + nl_tokens
        + im_start_tokens
        + _encode(tokenizer, "assistant")
        + nl_tokens
    )
    raw_text += f"\n{im_start}user\n{query}{im_end}\n{im_start}assistant\n"
    return raw_text, context_tokens


def decode_tokens(
    tokens: Sequence[int],
    tokenizer,
    *,
    stop_words: Sequence[str] = (),
    eod_words: Sequence[str] = ("<|im_end|>", "<|endoftext|>"),
    raw_text_len: int = 0,
    errors: str = "replace",
) -> str:
    """Trim generated text at stop/eod words (reference :196-243)."""
    try:
        text = tokenizer.decode(list(tokens), errors=errors)
    except TypeError:
        text = tokenizer.decode(list(tokens))
    text = text[raw_text_len:]
    for w in stop_words:
        text = text.replace(w, "").strip()
    for w in eod_words:
        text = text.split(w)[0]
    return text.strip()


def stop_words_ids(tokenizer, chat_format: str = "chatml") -> List[List[int]]:
    """Stop sequences for the engine's token-suffix matcher — the on-device
    equivalent of the reference StopWordsLogitsProcessor (:305+)."""
    if chat_format == "chatml":
        return [[tokenizer.im_end_id], [tokenizer.im_start_id]]
    eod = getattr(tokenizer, "eod_id", None)
    return [[eod]] if eod is not None else []


def pad_batch(
    sequences: Sequence[Sequence[int]], pad_id: int, padding_side: str = "left"
) -> Tuple[List[List[int]], List[List[int]]]:
    """(padded_ids, attention_mask); left padding is qwen's generation default
    (reference batch helpers :25-107)."""
    max_len = max(len(s) for s in sequences)
    ids, mask = [], []
    for s in sequences:
        pad = [pad_id] * (max_len - len(s))
        ones = [1] * len(s)
        zeros = [0] * (max_len - len(s))
        if padding_side == "left":
            ids.append(pad + list(s))
            mask.append(zeros + ones)
        else:
            ids.append(list(s) + pad)
            mask.append(ones + zeros)
    return ids, mask
