"""Prompt-to-prompt attention controllers for BLIP-Diffusion editing (a
copy of llava_align_tpu/models/ptp.py, numpy only, the source unchanged;
tests/test_torch_copies.py holds it to the original).

Capability parity: reference lavis/models/blip_diffusion_models/ptp_utils.py
(AttentionControl/AttentionStore :75-153, LocalBlend :155-182, edit
controllers :184-290, equalizer/time-alpha helpers :293-346, the
sequence-alignment mapper builders :350-527, and the P2PCrossAttnProcessor
seam :530-566).

Design: the reference injects a mutable controller into diffusers'
CrossAttention modules. Here the same seam is expressed against the
caller-provided `unet_apply` that models/blip_diffusion.py delegates to: the
caller threads `hook = make_attn_hook(controller, place)` (or calls
`attention_with_hook`) at each attention site of its UNet. Controllers run
on the host on numpy arrays, an eager loop as the reference's: a torch UNet
hands its attention probabilities over as numpy (`.cpu().numpy()`) and
takes the hook's result back. The denoising math stays in
models/blip_diffusion.py.

Tokenizer protocol (same as the reference's HF tokenizer usage):
`encode(text) -> [bos, *pieces, eos]`, `decode([id]) -> piece` where
word-continuation pieces may carry '#' prefixes (stripped, ptp_utils.py:472).
"""

from __future__ import annotations

import abc
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

MAX_NUM_WORDS = 77


# ---------------------------------------------------------------------------
# controllers (reference ptp_utils.py:75-153)
# ---------------------------------------------------------------------------


class AttentionControl(abc.ABC):
    """Per-site callback with step/layer bookkeeping. The CFG batch stacks
    [uncond | cond] on dim 0; only the cond half is edited (:91-100)."""

    def __init__(self):
        self.cur_step = 0
        self.num_att_layers = -1
        self.cur_att_layer = 0

    def step_callback(self, x_t):
        return x_t

    def between_steps(self):
        return

    @property
    def num_uncond_att_layers(self) -> int:
        return 0

    @abc.abstractmethod
    def forward(self, attn: np.ndarray, is_cross: bool, place_in_unet: str):
        raise NotImplementedError

    def __call__(self, attn: np.ndarray, is_cross: bool, place_in_unet: str):
        attn = np.asarray(attn)
        if self.cur_att_layer >= self.num_uncond_att_layers:
            h = attn.shape[0]
            attn = attn.copy()
            attn[h // 2 :] = self.forward(attn[h // 2 :], is_cross, place_in_unet)
        self.cur_att_layer += 1
        if self.cur_att_layer == self.num_att_layers + self.num_uncond_att_layers:
            self.cur_att_layer = 0
            self.cur_step += 1
            self.between_steps()
        return attn

    def reset(self):
        self.cur_step = 0
        self.cur_att_layer = 0


class EmptyControl(AttentionControl):
    def forward(self, attn, is_cross, place_in_unet):
        return attn


class AttentionStore(AttentionControl):
    """Accumulate per-place attention maps across steps (:118-153). Maps
    larger than 32x32 query positions are skipped (memory guard :127)."""

    @staticmethod
    def get_empty_store() -> Dict[str, List]:
        return {"down_cross": [], "mid_cross": [], "up_cross": [],
                "down_self": [], "mid_self": [], "up_self": []}

    def __init__(self):
        super().__init__()
        self.step_store = self.get_empty_store()
        self.attention_store: Dict[str, List] = {}

    def forward(self, attn, is_cross, place_in_unet):
        key = f"{place_in_unet}_{'cross' if is_cross else 'self'}"
        if attn.shape[1] <= 32**2:
            self.step_store[key].append(np.array(attn))
        return attn

    def between_steps(self):
        if not self.attention_store:
            self.attention_store = self.step_store
        else:
            for key in self.attention_store:
                for i in range(len(self.attention_store[key])):
                    self.attention_store[key][i] = (
                        self.attention_store[key][i] + self.step_store[key][i]
                    )
        self.step_store = self.get_empty_store()

    def get_average_attention(self) -> Dict[str, List]:
        return {
            key: [item / self.cur_step for item in self.attention_store[key]]
            for key in self.attention_store
        }

    def reset(self):
        super().reset()
        self.step_store = self.get_empty_store()
        self.attention_store = {}


def _max_pool2d_3x3(x: np.ndarray) -> np.ndarray:
    """3x3 stride-1 max pool with -inf padding 1 (nnf.max_pool2d semantics
    used by LocalBlend, :163)."""
    B, C, H, W = x.shape
    p = np.full((B, C, H + 2, W + 2), -np.inf, x.dtype)
    p[:, :, 1:-1, 1:-1] = x
    out = np.full_like(x, -np.inf)
    for dy in range(3):
        for dx in range(3):
            out = np.maximum(out, p[:, :, dy : dy + H, dx : dx + W])
    return out


def _interp_nearest(x: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """torch nnf.interpolate default (nearest): idx = floor(i * in/out)."""
    B, C, H, W = x.shape
    h2, w2 = size
    yi = np.floor(np.arange(h2) * (H / h2)).astype(np.int64)
    xi = np.floor(np.arange(w2) * (W / w2)).astype(np.int64)
    return x[:, :, yi][:, :, :, xi]


class LocalBlend:
    """Word-selected cross-attention mask blending edited latents into the
    base latents (:155-182)."""

    def __init__(self, prompts: Sequence[str], words, tokenizer,
                 threshold: float = 0.3, max_num_words: int = MAX_NUM_WORDS):
        # the reference hard-codes 77 and IGNORES its max_num_words argument
        # (ptp_utils.py:172) — replicated verbatim so stored cross-attention
        # map shapes stay interchangeable with reference controllers
        self.max_num_words = MAX_NUM_WORDS
        alpha_layers = np.zeros((len(prompts), 1, 1, 1, 1, self.max_num_words), np.float32)
        for i, (prompt, words_) in enumerate(zip(prompts, words)):
            if isinstance(words_, str):
                words_ = [words_]
            for word in words_:
                ind = get_word_inds(prompt, word, tokenizer)
                alpha_layers[i, :, :, :, :, ind] = 1
        self.alpha_layers = alpha_layers
        self.threshold = threshold

    def __call__(self, x_t: np.ndarray, attention_store: Dict[str, List]) -> np.ndarray:
        k = 1
        maps = attention_store["down_cross"][2:4] + attention_store["up_cross"][:3]
        maps = [
            m.reshape(self.alpha_layers.shape[0], -1, 1, 16, 16, self.max_num_words)
            for m in maps
        ]
        maps = np.concatenate(maps, axis=1)
        maps = (maps * self.alpha_layers).sum(-1).mean(1)
        mask = _max_pool2d_3x3(maps)
        mask = _interp_nearest(mask, tuple(x_t.shape[2:]))
        mask = mask / mask.max(axis=2, keepdims=True).max(axis=3, keepdims=True)
        mask = mask > self.threshold
        mask = (mask[:1] | mask[1:]).astype(x_t.dtype)
        return x_t[:1] + mask * (x_t - x_t[:1])


class AttentionControlEdit(AttentionStore, abc.ABC):
    """Base of the edit controllers (:184-234): store + replace the edited
    rows' attention with (mapped) base attention, gated per step."""

    def __init__(self, prompts: Sequence[str], num_steps: int,
                 cross_replace_steps, self_replace_steps,
                 local_blend: Optional[LocalBlend], tokenizer):
        super().__init__()
        self.tokenizer = tokenizer
        self.batch_size = len(prompts)
        self.cross_replace_alpha = get_time_words_attention_alpha(
            prompts, num_steps, cross_replace_steps, tokenizer
        )
        if isinstance(self_replace_steps, float):
            self_replace_steps = 0, self_replace_steps
        self.num_self_replace = (
            int(num_steps * self_replace_steps[0]),
            int(num_steps * self_replace_steps[1]),
        )
        self.local_blend = local_blend

    def step_callback(self, x_t):
        if self.local_blend is not None:
            x_t = self.local_blend(np.asarray(x_t), self.attention_store)
        return x_t

    def replace_self_attention(self, attn_base, att_replace):
        if att_replace.shape[2] <= 16**2:
            return np.broadcast_to(
                attn_base[None], (att_replace.shape[0],) + attn_base.shape
            )
        return att_replace

    @abc.abstractmethod
    def replace_cross_attention(self, attn_base, att_replace):
        raise NotImplementedError

    def forward(self, attn, is_cross, place_in_unet):
        if is_cross or (
            self.num_self_replace[0] <= self.cur_step < self.num_self_replace[1]
        ):
            h = attn.shape[0] // self.batch_size
            attn = attn.reshape(self.batch_size, h, *attn.shape[1:]).copy()
            attn_base, attn_replace = attn[0], attn[1:]
            if is_cross:
                alpha_words = self.cross_replace_alpha[self.cur_step]
                attn[1:] = (
                    self.replace_cross_attention(attn_base, attn_replace) * alpha_words
                    + (1 - alpha_words) * attn_replace
                )
            else:
                attn[1:] = self.replace_self_attention(attn_base, attn_replace)
            attn = attn.reshape(self.batch_size * h, *attn.shape[2:])
        # The reference calls the store BEFORE editing, but it stores a VIEW
        # that the in-place edit then mutates (ptp_utils.py:202-214) — the
        # store that LocalBlend/visualization actually consumes holds the
        # EDITED maps. With copy semantics, storing after the edit reproduces
        # the running behavior.
        AttentionStore.forward(self, attn, is_cross, place_in_unet)
        return attn


class AttentionReplace(AttentionControlEdit):
    """Word-swap edit: base attention redistributed through the replacement
    mapper (:236-244)."""

    def __init__(self, prompts, num_steps, cross_replace_steps,
                 self_replace_steps, local_blend=None, tokenizer=None):
        super().__init__(prompts, num_steps, cross_replace_steps,
                         self_replace_steps, local_blend, tokenizer)
        self.mapper = get_replacement_mapper(prompts, tokenizer)

    def replace_cross_attention(self, attn_base, att_replace):
        return np.einsum("hpw,bwn->bhpn", attn_base, self.mapper)


class AttentionRefine(AttentionControlEdit):
    """Refinement edit: base attention gathered through the alignment mapper,
    blended by per-token alphas (:247-276)."""

    def __init__(self, prompts, num_steps, cross_replace_steps,
                 self_replace_steps, local_blend=None, tokenizer=None):
        super().__init__(prompts, num_steps, cross_replace_steps,
                         self_replace_steps, local_blend, tokenizer)
        self.mapper, alphas = get_refinement_mapper(prompts, tokenizer)
        self.alphas = alphas.reshape(alphas.shape[0], 1, 1, alphas.shape[1])

    def replace_cross_attention(self, attn_base, att_replace):
        attn_base_replace = attn_base[:, :, self.mapper].transpose(2, 0, 1, 3)
        return attn_base_replace * self.alphas + att_replace * (1 - self.alphas)


class AttentionReweight(AttentionControlEdit):
    """Per-word attention rescaling, optionally composed over another edit
    controller (:278-290)."""

    def __init__(self, prompts, num_steps, cross_replace_steps,
                 self_replace_steps, equalizer, local_blend=None,
                 controller: Optional[AttentionControlEdit] = None,
                 tokenizer=None):
        super().__init__(prompts, num_steps, cross_replace_steps,
                         self_replace_steps, local_blend, tokenizer)
        self.equalizer = np.asarray(equalizer, np.float32)
        self.prev_controller = controller

    def replace_cross_attention(self, attn_base, att_replace):
        if self.prev_controller is not None:
            attn_base = self.prev_controller.replace_cross_attention(
                attn_base, att_replace
            )
        return attn_base[None, :, :, :] * self.equalizer[:, None, None, :]


# ---------------------------------------------------------------------------
# word/token helpers (reference :293-346, :464-482)
# ---------------------------------------------------------------------------


def get_word_inds(text: str, word_place: Union[int, str], tokenizer) -> np.ndarray:
    split_text = text.split(" ")
    if isinstance(word_place, str):
        word_place = [i for i, word in enumerate(split_text) if word_place == word]
    elif isinstance(word_place, int):
        word_place = [word_place]
    out: List[int] = []
    if len(word_place) > 0:
        words_encode = [
            tokenizer.decode([item]).strip("#") for item in tokenizer.encode(text)
        ][1:-1]
        cur_len, ptr = 0, 0
        for i in range(len(words_encode)):
            cur_len += len(words_encode[i])
            if ptr in word_place:
                out.append(i + 1)
            if cur_len >= len(split_text[ptr]):
                ptr += 1
                cur_len = 0
    return np.array(out)


def get_equalizer(text: str, word_select, values, tokenizer,
                  num_subject_token: int = -1) -> np.ndarray:
    if num_subject_token > 0:
        tokens = text.split(" ")
        tokens = [tokens[0]] + ["sks"] * num_subject_token + tokens[1:]
        text = " ".join(tokens)
    if isinstance(word_select, (int, str)):
        word_select = (word_select,)
    equalizer = np.ones((len(values), MAX_NUM_WORDS), np.float32)
    values = np.asarray(values, np.float32)
    for word in word_select:
        inds = get_word_inds(text, word, tokenizer)
        equalizer[:, inds] = values  # same numpy/torch broadcasting
    return equalizer


def update_alpha_time_word(alpha: np.ndarray, bounds, prompt_ind: int,
                           word_inds: Optional[np.ndarray] = None) -> np.ndarray:
    if isinstance(bounds, float):
        bounds = 0, bounds
    start, end = int(bounds[0] * alpha.shape[0]), int(bounds[1] * alpha.shape[0])
    if word_inds is None:
        word_inds = np.arange(alpha.shape[2])
    alpha[:start, prompt_ind, word_inds] = 0
    alpha[start:end, prompt_ind, word_inds] = 1
    alpha[end:, prompt_ind, word_inds] = 0
    return alpha


def get_time_words_attention_alpha(prompts, num_steps, cross_replace_steps,
                                   tokenizer,
                                   max_num_words: int = MAX_NUM_WORDS) -> np.ndarray:
    if not isinstance(cross_replace_steps, dict):
        cross_replace_steps = {"default_": cross_replace_steps}
    if "default_" not in cross_replace_steps:
        cross_replace_steps["default_"] = (0.0, 1.0)
    alpha_time_words = np.zeros((num_steps + 1, len(prompts) - 1, max_num_words), np.float32)
    for i in range(len(prompts) - 1):
        alpha_time_words = update_alpha_time_word(
            alpha_time_words, cross_replace_steps["default_"], i
        )
    for key, item in cross_replace_steps.items():
        if key != "default_":
            inds = [
                get_word_inds(prompts[i], key, tokenizer)
                for i in range(1, len(prompts))
            ]
            for i, ind in enumerate(inds):
                if len(ind) > 0:
                    alpha_time_words = update_alpha_time_word(
                        alpha_time_words, item, i, ind
                    )
    return alpha_time_words.reshape(
        num_steps + 1, len(prompts) - 1, 1, 1, max_num_words
    )


# ---------------------------------------------------------------------------
# sequence alignment → refinement/replacement mappers (reference :350-527)
# ---------------------------------------------------------------------------


class ScoreParams:
    def __init__(self, gap: int, match: int, mismatch: int):
        self.gap = gap
        self.match = match
        self.mismatch = mismatch

    def mis_match_char(self, x, y):
        return self.match if x == y else self.mismatch


def get_matrix(size_x: int, size_y: int, gap: int) -> np.ndarray:
    matrix = np.zeros((size_x + 1, size_y + 1), dtype=np.int32)
    matrix[0, 1:] = (np.arange(size_y) + 1) * gap
    matrix[1:, 0] = (np.arange(size_x) + 1) * gap
    return matrix


def get_traceback_matrix(size_x: int, size_y: int) -> np.ndarray:
    matrix = np.zeros((size_x + 1, size_y + 1), dtype=np.int32)
    matrix[0, 1:] = 1
    matrix[1:, 0] = 2
    matrix[0, 0] = 4
    return matrix


def global_align(x, y, score: ScoreParams):
    matrix = get_matrix(len(x), len(y), score.gap)
    trace_back = get_traceback_matrix(len(x), len(y))
    for i in range(1, len(x) + 1):
        for j in range(1, len(y) + 1):
            left = matrix[i, j - 1] + score.gap
            up = matrix[i - 1, j] + score.gap
            diag = matrix[i - 1, j - 1] + score.mis_match_char(x[i - 1], y[j - 1])
            matrix[i, j] = max(left, up, diag)
            if matrix[i, j] == left:
                trace_back[i, j] = 1
            elif matrix[i, j] == up:
                trace_back[i, j] = 2
            else:
                trace_back[i, j] = 3
    return matrix, trace_back


def get_aligned_sequences(x, y, trace_back):
    x_seq, y_seq = [], []
    i, j = len(x), len(y)
    mapper_y_to_x = []
    while i > 0 or j > 0:
        if trace_back[i, j] == 3:
            x_seq.append(x[i - 1])
            y_seq.append(y[j - 1])
            i -= 1
            j -= 1
            mapper_y_to_x.append((j, i))
        elif trace_back[i][j] == 1:
            x_seq.append("-")
            y_seq.append(y[j - 1])
            j -= 1
            mapper_y_to_x.append((j, -1))
        elif trace_back[i][j] == 2:
            x_seq.append(x[i - 1])
            y_seq.append("-")
            i -= 1
        elif trace_back[i][j] == 4:
            break
    mapper_y_to_x.reverse()
    return x_seq, y_seq, np.asarray(mapper_y_to_x, dtype=np.int64)


def get_mapper(x: str, y: str, tokenizer, max_len: int = MAX_NUM_WORDS):
    x_seq = tokenizer.encode(x)
    y_seq = tokenizer.encode(y)
    score = ScoreParams(0, 1, -1)
    _, trace_back = global_align(x_seq, y_seq, score)
    mapper_base = get_aligned_sequences(x_seq, y_seq, trace_back)[-1]
    alphas = np.ones(max_len, np.float32)
    alphas[: mapper_base.shape[0]] = (mapper_base[:, 1] != -1).astype(np.float32)
    mapper = np.zeros(max_len, dtype=np.int64)
    mapper[: mapper_base.shape[0]] = mapper_base[:, 1]
    mapper[mapper_base.shape[0] :] = len(y_seq) + np.arange(max_len - len(y_seq))
    return mapper, alphas


def get_refinement_mapper(prompts, tokenizer, max_len: int = MAX_NUM_WORDS):
    x_seq = prompts[0]
    mappers, alphas = [], []
    for i in range(1, len(prompts)):
        mapper, alpha = get_mapper(x_seq, prompts[i], tokenizer, max_len)
        mappers.append(mapper)
        alphas.append(alpha)
    return np.stack(mappers), np.stack(alphas)


def get_replacement_mapper_(x: str, y: str, tokenizer,
                            max_len: int = MAX_NUM_WORDS) -> np.ndarray:
    words_x = x.split(" ")
    words_y = y.split(" ")
    if len(words_x) != len(words_y):
        raise ValueError(
            "attention replacement edit can only be applied on prompts with "
            f"the same length but prompt A has {len(words_x)} words and "
            f"prompt B has {len(words_y)} words."
        )
    inds_replace = [i for i in range(len(words_y)) if words_y[i] != words_x[i]]
    inds_source = [get_word_inds(x, i, tokenizer) for i in inds_replace]
    inds_target = [get_word_inds(y, i, tokenizer) for i in inds_replace]
    mapper = np.zeros((max_len, max_len))
    i = j = 0
    cur_inds = 0
    while i < max_len and j < max_len:
        if cur_inds < len(inds_source) and inds_source[cur_inds][0] == i:
            inds_source_, inds_target_ = inds_source[cur_inds], inds_target[cur_inds]
            if len(inds_source_) == len(inds_target_):
                mapper[inds_source_, inds_target_] = 1
            else:
                ratio = 1 / len(inds_target_)
                for i_t in inds_target_:
                    mapper[inds_source_, i_t] = ratio
            cur_inds += 1
            i += len(inds_source_)
            j += len(inds_target_)
        elif cur_inds < len(inds_source):
            mapper[i, j] = 1
            i += 1
            j += 1
        else:
            mapper[j, j] = 1
            i += 1
            j += 1
    return mapper.astype(np.float32)


def get_replacement_mapper(prompts, tokenizer, max_len: int = MAX_NUM_WORDS):
    x_seq = prompts[0]
    return np.stack(
        [get_replacement_mapper_(x_seq, prompts[i], tokenizer, max_len)
         for i in range(1, len(prompts))]
    )


# ---------------------------------------------------------------------------
# attention-processor seam (reference P2PCrossAttnProcessor :530-566)
# ---------------------------------------------------------------------------


def make_attn_hook(controller: Optional[AttentionControl], place_in_unet: str):
    """The one-line interception point: probs -> controller(probs). Thread
    this into the caller's UNet attention sites (one hook per down/mid/up
    block); register the layer count with register_attention_control."""

    def hook(attention_probs: np.ndarray, is_cross: bool) -> np.ndarray:
        if controller is None:
            return attention_probs
        return controller(attention_probs, is_cross, place_in_unet)

    return hook


def register_attention_control(controller: AttentionControl, num_att_layers: int):
    """The caller reports how many attention sites its UNet runs per forward
    (the reference counts CrossAttention modules while installing
    processors); the controller needs it to detect step boundaries."""
    controller.num_att_layers = num_att_layers
    return controller


def attention_with_hook(q: np.ndarray, k: np.ndarray, v: np.ndarray,
                        hook, is_cross: bool) -> np.ndarray:
    """Reference processor math (:537-559) for a caller without its own
    attention: q/k/v [B*heads, S, Dh] (head_to_batch_dim layout) → softmax
    probs → hook → probs @ v."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    scores = np.einsum("bsd,btd->bst", q, k) * scale
    scores = scores - scores.max(axis=-1, keepdims=True)
    probs = np.exp(scores)
    probs = probs / probs.sum(axis=-1, keepdims=True)
    probs = hook(probs, is_cross)
    return np.einsum("bst,btd->bsd", probs, v)
