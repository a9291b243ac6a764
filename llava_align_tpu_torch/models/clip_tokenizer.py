"""CLIP BPE tokenizer, pure Python and offline (a copy of
llava_align_tpu/models/clip_tokenizer.py, the functions' source unchanged;
tests/test_torch_copies.py holds them to it).

Capability parity: the reference's vendored open_clip SimpleTokenizer
(lavis/models/clip_models/tokenizer.py): lower-cased, whitespace-normalized
text split by the CLIP regex, byte-level BPE with end-of-word `</w>`
markers, `<start_of_text>` / `<end_of_text>`, and a fixed-context
`tokenize()` returning [N, context_length] int32 arrays (plain truncation).

The merge table is the standard `bpe_simple_vocab_16e6.txt.gz`: pass
`bpe_path` (by default a file of that name beside this module). ftfy's
unicode fixing applies when the package is installed; `regex` is used when
installed, else the stdlib `re` with ASCII classes.
"""

from __future__ import annotations

import gzip
import html
import os
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

try:
    import regex as _re
except ImportError:  # pragma: no cover
    import re as _re

_REFERENCE_BPE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bpe_simple_vocab_16e6.txt.gz")


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte ↔ printable-unicode mapping (GPT-2/CLIP scheme)."""
    visible = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    mapping = {b: chr(b) for b in visible}
    shift = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + shift)
            shift += 1
    return mapping


def _clean(text: str) -> str:
    try:
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    text = html.unescape(html.unescape(text))
    text = _re.sub(r"\s+", " ", text)
    return text.strip().lower()


class ClipTokenizer:
    SOT = "<start_of_text>"
    EOT = "<end_of_text>"

    def __init__(self, bpe_path: str = None):
        if bpe_path is None:
            bpe_path = _REFERENCE_BPE
        if not os.path.exists(bpe_path):
            raise FileNotFoundError(
                f"CLIP BPE merges file not found: {bpe_path}; pass bpe_path="
            )
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        raw = gzip.open(bpe_path).read().decode("utf-8").split("\n")
        # first line is a version header; CLIP uses 48894 merges
        # (49152 - 256 - 2 entries after the byte vocab and specials)
        merge_lines = raw[1 : 49152 - 256 - 2 + 1]
        merges: List[Tuple[str, str]] = [tuple(m.split()) for m in merge_lines]
        base = list(self.byte_encoder.values())
        vocab = base + [v + "</w>" for v in base] + ["".join(m) for m in merges]
        vocab += [self.SOT, self.EOT]
        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.ranks: Dict[Tuple[str, str], int] = {m: i for i, m in enumerate(merges)}
        self._cache: Dict[str, List[str]] = {self.SOT: [self.SOT], self.EOT: [self.EOT]}
        if _re.__name__ == "regex":
            word, digit, other = r"[\p{L}]+", r"[\p{N}]", r"[^\s\p{L}\p{N}]+"
        else:  # stdlib-re fallback (exact for ASCII)
            word, digit, other = r"[a-z]+", r"[0-9]", r"[^\sa-z0-9]+"
        self.pattern = _re.compile(
            rf"{self.SOT}|{self.EOT}|'s|'t|'re|'ve|'m|'ll|'d|{word}|{digit}|{other}",
            _re.IGNORECASE,
        )

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @property
    def sot_id(self) -> int:
        return self.encoder[self.SOT]

    @property
    def eot_id(self) -> int:
        return self.encoder[self.EOT]

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        parts: List[str] = list(token[:-1]) + [token[-1] + "</w>"]
        while len(parts) > 1:
            pairs = [(parts[i], parts[i + 1]) for i in range(len(parts) - 1)]
            ranked = [(self.ranks.get(p, float("inf")), i) for i, p in enumerate(pairs)]
            best_rank, _ = min(ranked)
            if best_rank == float("inf"):
                break
            first, second = pairs[min(i for r, i in ranked if r == best_rank)]
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if (
                    i < len(parts) - 1
                    and parts[i] == first
                    and parts[i + 1] == second
                ):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        self._cache[token] = parts
        return parts

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for chunk in self.pattern.findall(_clean(text)):
            mapped = "".join(self.byte_encoder[b] for b in chunk.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self._bpe(mapped))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def tokenize(
        self, texts: Union[str, List[str]], context_length: int = 77
    ) -> np.ndarray:
        """[N, context_length] int32 with plain truncation — matching the
        reference byte-for-byte (tokenizer.py:198-203 truncates without
        restoring EOT)."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot_id] + self.encode(text) + [self.eot_id]
            if len(ids) > context_length:
                ids = ids[:context_length]
            out[i, : len(ids)] = ids
        return out
