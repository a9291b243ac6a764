"""Conversation templates — prompt assembly for each dialogue style.

A verbatim copy of llava_align_tpu/conversation.py: importing the JAX
package pulls in jax (its __init__ imports config.py, which imports
jax.numpy), so the port keeps its own copy. tests/test_torch_copies.py holds
every template's rendered prompt to the original.

Parity: reference experiments/llava/conversation.py (SeparatorStyle :6-12,
Conversation.get_prompt :29-104, template registry :361-377). The rendered
prompt strings must be byte-identical to the reference's so that tokenization
— and therefore every downstream logit — matches.

This is a fresh, minimal implementation: prompt rendering is a pure function
per separator style; the gradio/image plumbing of the reference is out of
scope (the framework feeds images through the tensor pipeline, never through
the conversation object).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence, Tuple


class SeparatorStyle(enum.Enum):
    SINGLE = enum.auto()
    TWO = enum.auto()
    MPT = enum.auto()
    PLAIN = enum.auto()
    LLAMA_2 = enum.auto()


@dataclasses.dataclass
class Conversation:
    """Dialogue state + prompt renderer.

    `messages` is a list of [role, message] pairs; a `None` message marks the
    final assistant slot the model should complete.
    """

    system: str
    roles: Tuple[str, str]
    messages: List[List[Optional[str]]]
    offset: int = 0
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: Optional[str] = None
    version: str = "unknown"

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append([role, message])

    # -- rendering ---------------------------------------------------------

    def get_prompt(self) -> str:
        # tuple first message = (text, image, image_process_mode): strip the
        # inline "<image>" and re-insert per version (reference
        # conversation.py:31-40, incl. the mmtag wrapping)
        messages = self.messages
        if messages and isinstance(messages[0][1], tuple):
            messages = [list(m) for m in self.messages]
            init_role, init_msg = messages[0]
            init_text = init_msg[0].replace("<image>", "").strip()
            if "mmtag" in self.version:
                messages[0] = [init_role, init_text]
                messages.insert(0, [self.roles[0], "<Image><image></Image>"])
                messages.insert(1, [self.roles[1], "Received."])
            else:
                messages[0] = [init_role, "<image>\n" + init_text]
            rendered = Conversation(
                system=self.system, roles=self.roles, messages=messages,
                offset=self.offset, sep_style=self.sep_style, sep=self.sep,
                sep2=self.sep2, version=self.version,
            )
            return rendered.get_prompt()

        # any remaining tuple messages render as their text part (reference
        # unpacks `message, _, _ = message` inside each style loop)
        if any(isinstance(m, tuple) for _, m in messages):
            self = self.copy()
            self.messages = [
                [r, (m[0] if isinstance(m, tuple) else m)] for r, m in messages
            ]

        style = self.sep_style
        if style == SeparatorStyle.SINGLE:
            out = [self.system, self.sep]
            for role, msg in self.messages:
                out.append(f"{role}: {msg}{self.sep}" if msg else f"{role}:")
            return "".join(out)

        if style == SeparatorStyle.TWO:
            seps = (self.sep, self.sep2)
            out = [self.system, seps[0]]
            for i, (role, msg) in enumerate(self.messages):
                out.append(f"{role}: {msg}{seps[i % 2]}" if msg else f"{role}:")
            return "".join(out)

        if style == SeparatorStyle.MPT:
            out = [self.system, self.sep]
            for role, msg in self.messages:
                out.append(f"{role}{msg}{self.sep}" if msg else role)
            return "".join(out)

        if style == SeparatorStyle.PLAIN:
            seps = (self.sep, self.sep2)
            out = [self.system]
            for i, (_, msg) in enumerate(self.messages):
                out.append(f"{msg}{seps[i % 2]}" if msg else "")
            return "".join(out)

        if style == SeparatorStyle.LLAMA_2:
            # reference conversation.py:70-90
            sys_block = f"<<SYS>>\n{self.system}\n<</SYS>>\n\n"
            out = []
            for i, (role, msg) in enumerate(self.messages):
                if i == 0 and not msg:
                    raise ValueError("first message must be non-empty")
                if not msg:
                    continue
                if i == 0:
                    msg = sys_block + msg
                if i % 2 == 0:
                    out.append(f"{self.sep}[INST] {msg} [/INST]")
                else:
                    out.append(f" {msg} {self.sep2}")
            return "".join(out).lstrip(self.sep)

        raise ValueError(f"Invalid separator style: {style}")

    # -- helpers -----------------------------------------------------------

    @property
    def stop_str(self) -> str:
        """The keyword whose appearance terminates generation
        (reference eval scripts: conv.sep2 for TWO style, conv.sep otherwise;
        e.g. llava_calibrate.py:156)."""
        return self.sep2 if self.sep_style == SeparatorStyle.TWO else self.sep

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system,
            roles=self.roles,
            messages=[[r, m] for r, m in self.messages],
            offset=self.offset,
            sep_style=self.sep_style,
            sep=self.sep,
            sep2=self.sep2,
            version=self.version,
        )

    def dict(self) -> dict:
        return {
            "system": self.system,
            "roles": self.roles,
            "messages": self.messages,
            "offset": self.offset,
            "sep": self.sep,
            "sep2": self.sep2,
        }


def _conv(**kw) -> Conversation:
    kw.setdefault("messages", [])
    kw.setdefault("offset", 0)
    return Conversation(**kw)


# System strings are prompt *data* and must match the reference byte-for-byte
# (reference conversation.py:221-358).

_V0_FEWSHOT: Sequence[Tuple[str, str]] = (
    ("Human", "What are the key differences between renewable and non-renewable energy sources?"),
    (
        "Assistant",
        "Renewable energy sources are those that can be replenished naturally in a relatively "
        "short amount of time, such as solar, wind, hydro, geothermal, and biomass. "
        "Non-renewable energy sources, on the other hand, are finite and will eventually be "
        "depleted, such as coal, oil, and natural gas. Here are some key differences between "
        "renewable and non-renewable energy sources:\n"
        "1. Availability: Renewable energy sources are virtually inexhaustible, while non-renewable "
        "energy sources are finite and will eventually run out.\n"
        "2. Environmental impact: Renewable energy sources have a much lower environmental impact "
        "than non-renewable sources, which can lead to air and water pollution, greenhouse gas emissions, "
        "and other negative effects.\n"
        "3. Cost: Renewable energy sources can be more expensive to initially set up, but they typically "
        "have lower operational costs than non-renewable sources.\n"
        "4. Reliability: Renewable energy sources are often more reliable and can be used in more remote "
        "locations than non-renewable sources.\n"
        "5. Flexibility: Renewable energy sources are often more flexible and can be adapted to different "
        "situations and needs, while non-renewable sources are more rigid and inflexible.\n"
        "6. Sustainability: Renewable energy sources are more sustainable over the long term, while "
        "non-renewable sources are not, and their depletion can lead to economic and social instability.\n",
    ),
)

conv_vicuna_v0 = _conv(
    system="A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("Human", "Assistant"),
    messages=[list(m) for m in _V0_FEWSHOT],
    offset=2,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_vicuna_v1 = _conv(
    system="A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the user's questions.",
    roles=("USER", "ASSISTANT"),
    version="v1",
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_llama_2 = _conv(
    system="""You are a helpful, respectful and honest assistant. Always answer as helpfully as possible, while being safe.  Your answers should not include any harmful, unethical, racist, sexist, toxic, dangerous, or illegal content. Please ensure that your responses are socially unbiased and positive in nature.

If a question does not make any sense, or is not factually coherent, explain why instead of answering something not correct. If you don't know the answer to a question, please don't share false information.""",
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_llava_llama_2 = _conv(
    system="You are a helpful language and vision assistant. "
    "You are able to understand the visual content that the user provides, "
    "and assist the user with a variety of tasks using natural language.",
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_mpt = _conv(
    system="""<|im_start|>system
A conversation between a user and an LLM-based AI assistant. The assistant gives helpful and honest answers.""",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    version="mpt",
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
)

conv_llava_plain = _conv(
    system="",
    roles=("", ""),
    sep_style=SeparatorStyle.PLAIN,
    sep="\n",
)

conv_llava_v0 = _conv(
    system="A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("Human", "Assistant"),
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_llava_v0_mmtag = _conv(
    system="A chat between a curious user and an artificial intelligence assistant. "
    "The assistant is able to understand the visual content that the user provides, and assist the user with a variety of tasks using natural language."
    "The visual content will be provided with the following format: <Image>visual content</Image>.",
    roles=("Human", "Assistant"),
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
    version="v0_mmtag",
)

conv_llava_v1 = _conv(
    system="A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("USER", "ASSISTANT"),
    version="v1",
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_llava_v1_mmtag = _conv(
    system="A chat between a curious user and an artificial intelligence assistant. "
    "The assistant is able to understand the visual content that the user provides, and assist the user with a variety of tasks using natural language."
    "The visual content will be provided with the following format: <Image>visual content</Image>.",
    roles=("USER", "ASSISTANT"),
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1_mmtag",
)

default_conversation = conv_vicuna_v0

conv_templates = {
    "default": conv_vicuna_v0,
    "v0": conv_vicuna_v0,
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llama_2": conv_llama_2,
    "plain": conv_llava_plain,
    "v0_plain": conv_llava_plain,
    "llava_v0": conv_llava_v0,
    "v0_mmtag": conv_llava_v0_mmtag,
    "llava_v1": conv_llava_v1,
    "v1_mmtag": conv_llava_v1_mmtag,
    "llava_llama_2": conv_llava_llama_2,
    "mpt": conv_mpt,
}
