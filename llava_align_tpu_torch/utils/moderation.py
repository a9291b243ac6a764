"""Content moderation helper (a copy of llava_align_tpu/utils/moderation.py).

Capability parity: reference llava/utils.py violates_moderation (OpenAI
moderation endpoint with error tolerance). The client is pluggable; without
the openai package / API key the check fails open (returns False), matching
the reference's exception handling.
"""

from __future__ import annotations

from typing import Callable, Optional


def violates_moderation(
    text: str, client: Optional[Callable[[str], bool]] = None
) -> bool:
    """True if the text is flagged. `client` overrides the default openai
    moderation call (text → flagged bool)."""
    if client is not None:
        try:
            return bool(client(text))
        except Exception:
            return False
    try:
        import openai

        resp = openai.Moderation.create(input=text.replace("\n", ""))
        return bool(resp["results"][0]["flagged"])
    except Exception:
        return False
