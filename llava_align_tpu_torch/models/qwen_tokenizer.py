"""Native QWen tiktoken-BPE tokenizer (offline, no trust_remote_code): a
copy of llava_align_tpu/models/qwen_tokenizer.py, but for where `regex`
is imported (inside QwenTokenizer.__init__, so that the module, and the
runners that import it, import without the package).

Capability parity with the reference's QWenTokenizer
(reference experiments/Qwen_VL/tokenization_qwen.py:102-358): byte-level BPE
over a base64 rank file (qwen.tiktoken), the chatml special tokens
(<|endoftext|>/<|im_start|>/<|im_end|> + 205 extras), the 9 vision tags
(IMAGE_ST), and the <img>…</img> span surgery — on encode the in-band image
path is re-expressed one byte per token (token id == byte value) and padded
with <imgpad> to the fixed 256-token span (tokenization_qwen.py:274-289);
decode inverts it (tokenization_qwen.py:337-355).

The BPE merge itself is the tiktoken greedy algorithm — repeatedly merge the
adjacent pair with the lowest rank — implemented in pure Python so the
tokenizer runs with zero network access; tests pin it token-for-token against
the real `tiktoken.Encoding` built from the same tables.
"""

from __future__ import annotations

import base64
import unicodedata
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Union

# reference tokenization_qwen.py:37 — the token-split pattern IS the spec
PAT_STR = (
    r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"""
    r""" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"""
)
ENDOFTEXT = "<|endoftext|>"
IMSTART = "<|im_start|>"
IMEND = "<|im_end|>"
EXTRAS = tuple(f"<|extra_{i}|>" for i in range(205))
SPECIAL_TOKENS = (ENDOFTEXT, IMSTART, IMEND) + EXTRAS
IMG_TOKEN_SPAN = 256  # tokenization_qwen.py:51


def load_tiktoken_bpe(path: str) -> Dict[bytes, int]:
    """base64-token rank file, one `b64 rank` pair per line."""
    ranks: Dict[bytes, int] = {}
    with open(path, "rb") as f:
        for line in f.read().splitlines():
            if not line:
                continue
            token, rank = line.split()
            ranks[base64.b64decode(token)] = int(rank)
    return ranks


def bpe_encode(ranks: Dict[bytes, int], piece: bytes) -> List[int]:
    """tiktoken byte-pair merge: repeatedly merge the adjacent pair with the
    lowest rank (leftmost on ties) until no mergeable pair remains."""
    if len(piece) == 1:
        return [ranks[piece]]
    parts = [piece[i : i + 1] for i in range(len(piece))]
    while len(parts) > 1:
        best_rank: Optional[int] = None
        best_i = -1
        for i in range(len(parts) - 1):
            r = ranks.get(parts[i] + parts[i + 1])
            if r is not None and (best_rank is None or r < best_rank):
                best_rank, best_i = r, i
        if best_rank is None:
            break
        parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
    return [ranks[p] for p in parts]


@dataclass
class _Encoding:
    input_ids: List[int]


class QwenTokenizer:
    """Drop-in for the engine/runners' tokenizer seam: `.encode`, `.decode`,
    `__call__(text).input_ids`, `eod_id`, `im_start_id`, `im_end_id`,
    `img_start_id/img_end_id/img_pad_id` (the ids qwen_vl.sentinelize_span and
    qwen_generation_utils.make_context consume)."""

    def __init__(
        self,
        vocab_file: Optional[str] = None,
        *,
        mergeable_ranks: Optional[Dict[bytes, int]] = None,
        errors: str = "replace",
        image_start_tag: str = "<img>",
        image_end_tag: str = "</img>",
        image_pad_tag: str = "<imgpad>",
        ref_start_tag: str = "<ref>",
        ref_end_tag: str = "</ref>",
        box_start_tag: str = "<box>",
        box_end_tag: str = "</box>",
        quad_start_tag: str = "<quad>",
        quad_end_tag: str = "</quad>",
    ):
        try:
            import regex as _regex  # \p{L} / \p{N} classes, which `re` lacks
        except ImportError as e:
            raise ImportError(
                "QwenTokenizer needs the `regex` module for its token-split pattern "
                "(PAT_STR's \\p{L} and \\p{N} classes), and it is not installed") from e
        if mergeable_ranks is None:
            if vocab_file is None:
                raise ValueError("need vocab_file or mergeable_ranks")
            mergeable_ranks = load_tiktoken_bpe(vocab_file)
        self.errors = errors
        self.mergeable_ranks = mergeable_ranks
        self.image_start_tag = image_start_tag
        self.image_end_tag = image_end_tag
        self.image_pad_tag = image_pad_tag
        # vision tags appended after the chatml specials, same order as the
        # reference IMAGE_ST (tokenization_qwen.py:130-136)
        self.IMAGE_ST = (
            ref_start_tag, ref_end_tag, box_start_tag, box_end_tag,
            quad_start_tag, quad_end_tag, image_start_tag, image_end_tag,
            image_pad_tag,
        )
        self.special_tokens: Dict[str, int] = {
            token: index
            for index, token in enumerate(
                SPECIAL_TOKENS + self.IMAGE_ST, start=len(mergeable_ranks)
            )
        }
        self.img_start_id = self.special_tokens[image_start_tag]
        self.img_end_id = self.special_tokens[image_end_tag]
        self.img_pad_id = self.special_tokens[image_pad_tag]
        self.eod_id = self.special_tokens[ENDOFTEXT]
        self.im_start_id = self.special_tokens[IMSTART]
        self.im_end_id = self.special_tokens[IMEND]
        self.eos_token_id = self.eod_id

        self._pat = _regex.compile(PAT_STR)
        self._special_by_id = {v: k for k, v in self.special_tokens.items()}
        self._bytes_by_id = {v: k for k, v in mergeable_ranks.items()}
        # split pattern over all special surface forms, longest first
        forms = sorted(self.special_tokens, key=len, reverse=True)
        self._special_pat = _regex.compile(
            "(" + "|".join(_regex.escape(f) for f in forms) + ")"
        )

    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.mergeable_ranks) + len(self.special_tokens)

    @property
    def vocab_size(self) -> int:
        return len(self)

    def __call__(self, text: str) -> _Encoding:
        return _Encoding(input_ids=self.encode(text))

    # ------------------------------------------------------------------
    # encode
    # ------------------------------------------------------------------

    def _encode_ordinary(self, text: str) -> List[int]:
        ids: List[int] = []
        for m in self._pat.finditer(text):
            ids.extend(bpe_encode(self.mergeable_ranks, m.group().encode("utf-8")))
        return ids

    def encode(
        self,
        text: str,
        allowed_special: Union[str, Set[str]] = "all",
        disallowed_special: Union[str, Iterable[str]] = (),
    ) -> List[int]:
        """NFC-normalize, BPE with special tokens recognized in-text
        (reference default allowed_special='all', tokenization_qwen.py:240),
        then expand <img>url</img> spans to the fixed 256-token layout."""
        text = unicodedata.normalize("NFC", text)
        if allowed_special == "all":
            allowed = set(self.special_tokens)
        else:
            allowed = set(allowed_special or ())
        if disallowed_special == "all":
            disallowed = set(self.special_tokens) - allowed
        else:
            disallowed = set(disallowed_special or ())
        ids: List[int] = []
        for chunk in self._special_pat.split(text):
            if not chunk:
                continue
            if chunk in self.special_tokens and chunk in allowed:
                ids.append(self.special_tokens[chunk])
            else:
                if chunk in disallowed:
                    raise ValueError(
                        f"special token {chunk!r} found in text but disallowed"
                    )
                ids.extend(self._encode_ordinary(chunk))
        return self._expand_img_spans(ids)

    def _expand_img_spans(self, ids: List[int]) -> List[int]:
        """<img>{path}</img> → [img_start] + one id per path byte + <imgpad>
        padding to IMG_TOKEN_SPAN + [img_end] (tokenization_qwen.py:274-289;
        the byte→id identity mapping is the reference's decoder trick at :281)."""
        out: List[int] = []
        i = 0
        while i < len(ids):
            if ids[i] != self.img_start_id:
                out.append(ids[i])
                i += 1
                continue
            try:
                j = ids.index(self.img_end_id, i)
            except ValueError:
                raise ValueError("Unclosed image token")
            url = b"".join(self._id_to_bytes_strict(t) for t in ids[i + 1 : j])
            byte_ids = list(url)
            if len(byte_ids) > IMG_TOKEN_SPAN:
                raise ValueError(
                    f"The content in {self.image_start_tag}..{self.image_end_tag} is too long"
                )
            out.append(self.img_start_id)
            out.extend(byte_ids)
            out.extend([self.img_pad_id] * (IMG_TOKEN_SPAN - len(byte_ids)))
            out.append(self.img_end_id)
            i = j + 1
        return out

    def _id_to_bytes_strict(self, i: int) -> bytes:
        b = self._bytes_by_id.get(i)
        if b is None:
            raise ValueError(f"id {i} inside an image span is not an ordinary token")
        return b

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def decode(
        self,
        token_ids: Union[int, Sequence[int]],
        skip_special_tokens: bool = False,
        errors: Optional[str] = None,
    ) -> str:
        if isinstance(token_ids, int):
            token_ids = [token_ids]
        token_ids = [int(t) for t in token_ids]
        token_ids = self._contract_img_spans(token_ids)
        if skip_special_tokens:
            # reference semantics: drop everything at/above the first special
            # id (tokenization_qwen.py:357)
            token_ids = [i for i in token_ids if i < self.eod_id]
        parts: List[str] = []
        buf = b""
        for i in token_ids:
            if i in self._special_by_id:
                if buf:
                    parts.append(buf.decode("utf-8", errors=errors or self.errors))
                    buf = b""
                parts.append(self._special_by_id[i])
            else:
                b = self._bytes_by_id.get(i)
                if b is None:
                    raise ValueError(f"unknown id {i}")
                buf += b
        if buf:
            parts.append(buf.decode("utf-8", errors=errors or self.errors))
        return "".join(parts)

    def _contract_img_spans(self, ids: List[int]) -> List[int]:
        """Invert _expand_img_spans: strip <imgpad>s, turn the byte ids back
        into the BPE encoding of the path (tokenization_qwen.py:344-352)."""
        out: List[int] = []
        i = 0
        while i < len(ids):
            if ids[i] != self.img_start_id:
                out.append(ids[i])
                i += 1
                continue
            try:
                j = ids.index(self.img_end_id, i)
            except ValueError:
                out.append(ids[i])
                i += 1
                continue
            inner = ids[i + 1 : j]
            if self.img_pad_id in inner:
                inner = inner[: inner.index(self.img_pad_id)]
            url = bytes(inner).decode("utf-8")
            out.append(self.img_start_id)
            out.extend(self._encode_ordinary(url))
            out.append(self.img_end_id)
            i = j + 1
        return out

    # ------------------------------------------------------------------
    # misc parity helpers
    # ------------------------------------------------------------------

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[Union[bytes, str]]:
        out: List[Union[bytes, str]] = []
        for i in ids:
            if i in self._special_by_id:
                out.append(self._special_by_id[i])
            elif i in self._bytes_by_id:
                out.append(self._bytes_by_id[i])
            else:
                raise ValueError("unknown ids")
        return out

    def convert_tokens_to_ids(
        self, tokens: Union[bytes, str, Sequence[Union[bytes, str]]]
    ) -> Union[int, List[int]]:
        if isinstance(tokens, (str, bytes)):
            return self._token_to_id(tokens)
        return [self._token_to_id(t) for t in tokens]

    def _token_to_id(self, token: Union[bytes, str]) -> int:
        if isinstance(token, str) and token in self.special_tokens:
            return self.special_tokens[token]
        key = token.encode("utf-8") if isinstance(token, str) else token
        if key in self.mergeable_ranks:
            return self.mergeable_ranks[key]
        raise ValueError(f"unknown token {token!r}")

    def save_vocabulary(self, path: str) -> str:
        with open(path, "w", encoding="utf8") as w:
            for k, v in self.mergeable_ranks.items():
                w.write(base64.b64encode(k).decode("utf8") + " " + str(v) + "\n")
        return path
