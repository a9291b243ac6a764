"""The port's copies of the JAX package's pure-Python pieces must behave
identically: conversation prompts for every template, plan_splice,
tokenizer_image_token, MockTokenizer, build_prompt, and the grouped
engine's host logic (common_token_prefix, _txt_kind_prefix_bases). Exact
equality."""

import dataclasses

import numpy as np
import pytest

from llava_align_tpu import conversation as jconv
from llava_align_tpu import tokenization as jtok
from llava_align_tpu.constants import IMAGE_TOKEN_INDEX
from llava_align_tpu.models import llava as jllava
from llava_align_tpu.runners import common as jcommon
from llava_align_tpu_torch import constants as tconst
from llava_align_tpu_torch import conversation as tconv
from llava_align_tpu_torch import tokenization as ttok
from llava_align_tpu_torch.models import llava as tllava
from llava_align_tpu_torch.runners import common as tcommon


def test_constants_identical():
    from llava_align_tpu import constants as jconst

    names = [n for n in dir(jconst) if n.isupper()]
    assert names and all(getattr(tconst, n) == getattr(jconst, n) for n in names)


@pytest.mark.parametrize("mode", sorted(jconv.conv_templates))
def test_conversation_prompts_identical(mode):
    assert sorted(tconv.conv_templates) == sorted(jconv.conv_templates)
    for conv_mod in (jconv, tconv):
        assert conv_mod.conv_templates[mode].sep_style.name in tconv.SeparatorStyle.__members__
    turns = [
        [("<image>\nIs there a dog in the image?", None)],
        [("Describe it.", "A cat on a mat."), ("And the colour?", None)],
        [(("<image>\nWhat is shown?", "IMG", "pad"), None)],  # image-tuple first message
    ]
    for convo in turns:
        prompts = []
        for conv_mod in (jconv, tconv):
            conv = conv_mod.conv_templates[mode].copy()
            for user, assistant in convo:
                conv.append_message(conv.roles[0], user)
                conv.append_message(conv.roles[1], assistant)
            prompts.append((conv.get_prompt(), conv.stop_str, conv.dict()))
        assert prompts[0] == prompts[1]


@pytest.mark.parametrize("mode", ["llava_v1", "v1", "llava_v0", "llava_llama_2", "mpt", "plain"])
def test_build_prompt_identical(mode):
    for kw in ({}, {"with_image": False}, {"mm_use_im_start_end": True},
               {"one_word": True, "suffix": " Answer yes or no."}):
        assert tcommon.build_prompt("Is there a dog?", mode, **kw) == jcommon.build_prompt(
            "Is there a dog?", mode, **kw
        )


def test_plan_splice_identical():
    rng = np.random.default_rng(0)
    for trial in range(20):
        ids = [int(t) for t in rng.integers(3, 300, size=rng.integers(0, 12))]
        for _ in range(int(rng.integers(0, 3))):
            ids.insert(int(rng.integers(0, len(ids) + 1)), IMAGE_TOKEN_INDEX)
        n_img = int(rng.integers(0, 5))
        pad_to = len(ids) + max(n_img - 1, 0) * ids.count(IMAGE_TOKEN_INDEX) + int(rng.integers(0, 4))
        want = dataclasses.asdict(jllava.plan_splice(ids, n_img, pad_to))
        got = dataclasses.asdict(tllava.plan_splice(ids, n_img, pad_to))
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"trial {trial} {k}")
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
    with pytest.raises(ValueError):
        tllava.plan_splice([1, IMAGE_TOKEN_INDEX], 4, 3)


class _NoBosTokenizer:
    bos_token_id = None

    def __call__(self, text):
        class R:
            input_ids = [ord(c) % 50 + 10 for c in text]

        return R()


@pytest.mark.parametrize("tokenizer", [jcommon.MockTokenizer(), _NoBosTokenizer()],
                         ids=["mock_bos", "no_bos"])
def test_tokenizer_image_token_identical(tokenizer):
    for prompt in ("no image here", "<image>\nwhat?", "a <image> b <image> c", "<image>"):
        want = jtok.tokenizer_image_token(prompt, tokenizer)
        assert ttok.tokenizer_image_token(prompt, tokenizer) == want
        np.testing.assert_array_equal(
            ttok.tokenizer_image_token(prompt, tokenizer, return_tensors="np"),
            jtok.tokenizer_image_token(prompt, tokenizer, return_tensors="np"),
        )
        assert ttok.tokenizer_image_token(prompt, tokenizer, return_tensors="pt").tolist() == want
    assert ttok.keyword_token_ids(["</s>", "###"], tokenizer) == jtok.keyword_token_ids(
        ["</s>", "###"], tokenizer
    )


def test_mock_tokenizer_identical():
    t, j = tcommon.MockTokenizer(), jcommon.MockTokenizer()
    text = "USER: <image>\nIs there a dog? ASSISTANT: é€"
    assert t(text).input_ids == j(text).input_ids
    ids = j(text).input_ids + [0, 2]
    for skip in (True, False):
        assert t.decode(ids, skip_special_tokens=skip) == j.decode(ids, skip_special_tokens=skip)
    assert t.decode(np.int64(70)) == j.decode(np.int64(70))
    for attr in ("bos_token_id", "eos_token_id", "unk_token_id", "pad_token_id"):
        assert getattr(t, attr) == getattr(j, attr)


def _token_lists(rng):
    base = [int(t) for t in rng.integers(3, 50, size=rng.integers(0, 6))]
    return [base + [int(t) for t in rng.integers(3, 50, size=rng.integers(0, 5))]
            for _ in range(int(rng.integers(0, 5)))]


def test_common_token_prefix_identical():
    from llava_align_tpu.decoding.engine import DecodeEngine as JEngine
    from llava_align_tpu_torch.decoding.engine import DecodeEngine as TEngine

    rng = np.random.default_rng(0)
    cases = [[[1, 2, 3, 4], [1, 2, 3, 5, 6]], [[1, 2], [1, 2]], [], [[7]], [[1, 2, 3]]]
    cases += [_token_lists(rng) for _ in range(50)]
    for lists in cases:
        assert TEngine.common_token_prefix(lists) == JEngine.common_token_prefix(lists), lists


@pytest.fixture(scope="module")
def engines():
    """A JAX and a port DecodeEngine (dual VDD) for their host-side logic;
    neither runs a model here."""
    import jax

    from llava_align_tpu.config import GenerationConfig as JGen
    from llava_align_tpu.config import LlavaConfig as JCfg
    from llava_align_tpu.decoding.engine import DecodeEngine as JEngine
    from llava_align_tpu_torch.config import GenerationConfig as TGen
    from llava_align_tpu_torch.config import LlavaConfig as TCfg
    from llava_align_tpu_torch.decoding.engine import DecodeEngine as TEngine

    flags = dict(use_dd=True, use_dd_unk=True)
    jeng = JEngine(jax.eval_shape(lambda k: jllava.init(k, JCfg.tiny(97)), jax.random.PRNGKey(0)),
                   JCfg.tiny(97), JGen(**flags))
    teng = TEngine({"llama": {"embed": None}}, TCfg.tiny(97), TGen(**flags), device="cpu")
    return jeng, teng


def test_assemble_images_identical(engines):
    """Per-group images → one array: raw uint8 only when every present slot
    is uint8, else uint8 slots normalized on the host; None slots zero."""
    jeng, teng = engines
    rng = np.random.default_rng(3)
    H = 28
    u8 = [rng.integers(0, 256, (3, H, H), dtype=np.uint8) for _ in range(2)]
    f32 = rng.normal(size=(3, H, H)).astype(np.float32)
    for slots in ([u8[0], u8[1]], [u8[0], None], [u8[0], f32], [None, f32], [None, None]):
        want = jeng._assemble_images(slots, len(slots))
        got = teng._assemble_images(slots, len(slots))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_txt_kind_prefix_bases_identical(engines):
    """Which text kinds share a per-group prefix segment, and with which
    transformed prefix: the port's host logic against the JAX engine's."""
    jeng, teng = engines
    S = IMAGE_TOKEN_INDEX
    groups_list = [
        [([1, 5, S, 6], [[7, 8], [9]], None, None)],
        [([1, 5, S, 6], [[7], [8]], None, None), ([1, S], [[3], [4, 5]], None, None)],
        [([1, 5, 6], [[S, 8], [9]], None, None)],               # sentinel in a suffix
        [([S], [[2], [3]], None, None)],                        # 'none' prefix is empty
        [([1, S, 2], [[3], [4]], None, [{"unk": [1, 0, 2, 3]}, None])],  # explicit ids
        [([1, S, 2], [[3], [4]], None, [None, {"none": [1, 2, 4]}])],
    ]
    for groups in groups_list:
        for kind in ("unk", "none"):
            assert teng._txt_kind_prefix_bases(kind, groups) == jeng._txt_kind_prefix_bases(
                kind, groups), (kind, groups)
