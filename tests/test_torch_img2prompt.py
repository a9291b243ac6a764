"""Img2Prompt in the port (models/img2prompt.py, the zoo's img2prompt_vqa)
against the JAX package's, on the CPU, at the tiny config, from the same
numpy tree (the port's own init, carried into both) and seeded inputs.

JAX references: one compiled program (tests/lavis_ref.run_all) for
forward_itm's GradCAM and the patch uniforms of forward_cap's round (the
JAX loop's key splits replayed); then the JAX package's own loops,
forward_cap with its ITM filter (its itm_rank call recorded, inputs and
probabilities) and forward_qa_generation, with the towers they call
eagerly jitted (tests/lavis_ref.jit_eager). The whole chain is held stage by
stage: kept captions (sampled at top_k = 1, the argmax, with JAX's patch
uniforms; a threshold between two match probabilities drops some),
answer candidates and QG contexts, the generated questions (20 contexts:
two 10-row chunks) and the final prompt string.
Tolerances: GradCAM and match probabilities within 1e-5; captions,
questions and the prompt exact.
"""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavis_ref import close, fast_jit, jit_eager, np_tree, one_torch_thread, run_all  # noqa: F401 (a fixture)
from llava_align_tpu.decoding import sampler as jsampler
from llava_align_tpu.models import blip as jb
from llava_align_tpu.models import img2prompt as ji
from llava_align_tpu.models import t5 as jt5
from llava_align_tpu_torch.models import img2prompt as ti
from llava_align_tpu_torch.models import pnp_vqa as tp
from llava_align_tpu_torch.utils.jax_params import from_jax_params

B, S, V = 2, 6, 64
CAP = dict(num_captions=6, num_patches=3, cap_max_length=5, top_k=1, eos_token_id=3, max_rounds=1)
PROMPT = [2, 5]
QUESTION = "What is the dog doing?"


def config(mod):
    """The tiny config with GradCAM read at block 0: at the last block
    (the tiny config's block 1 of 2) only the cls row has a gradient, and
    GradCAM averages the other rows, so every weight would be 0."""
    return dataclasses.replace(mod.Img2PromptConfig.tiny(V), block_num=0)


def decode(row):
    """Two words a token: enough answer candidates for 20 QG contexts."""
    return " ".join(f"w{t} v{(t * 7) % 61}" for t in row)


def tokenize(texts, width):
    """Words to crc32 ids in [4, V), padded with 0."""
    ids = np.zeros((len(texts), width), np.int64)
    mask = np.zeros_like(ids)
    for i, t in enumerate(texts):
        row = [zlib.crc32(w.encode()) % (V - 4) + 4 for w in t.split()][:width]
        ids[i, : len(row)], mask[i, : len(row)] = row, 1
    return ids, mask


pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def ref():
    cfg, tcfg = config(ji), config(ti)
    tree = np_tree(ti.init(tcfg, device="cpu", seed=4))
    rng = np.random.default_rng(1)
    size, N = cfg.cap.vision.image_size, cfg.cap.vision.num_patches
    pix = rng.standard_normal((B, 3, size, size)).astype(np.float32)
    q_ids, q_mask = tokenize([QUESTION] * B, S)
    key = jax.random.PRNGKey(21)
    J = {k: jnp.asarray(v) for k, v in dict(pix=pix, q_ids=q_ids, q_mask=q_mask).items()}

    def uniforms(k):
        _, k_sel, _ = jax.random.split(k, 3)
        return jax.random.uniform(k_sel, (CAP["num_captions"], B, N))

    want = run_all({
        "itm": (lambda p: ji.forward_itm(p, cfg, J["pix"], J["q_ids"], J["q_mask"]), tree),
        "uniforms": (uniforms, key),
    })
    # the port's match probabilities of the round: the threshold falls
    # between the two middle ones, so the filter keeps about half
    p = from_jax_params(tree, device="cpu")
    gradcams = torch.from_numpy(np.asarray(want["itm"]))
    flat, rows = tp.sampled_patch_captions(
        p["cap"], tcfg.cap, ti.blip_mod.vit_forward(p["cap"]["visual"], tcfg.cap.vision, torch.from_numpy(pix)),
        gradcams, PROMPT, None, torch.from_numpy(np.asarray(want["uniforms"])), num_captions=CAP["num_captions"],
        num_patches=CAP["num_patches"], max_new_tokens=CAP["cap_max_length"], top_k=1, eos_token_id=3)
    width = max(len(r) for r in rows) + 2
    ids, mask = torch.zeros((len(rows), width), dtype=torch.long), torch.zeros((len(rows), width), dtype=torch.long)
    for i, row in enumerate(rows):
        ids[i, : len(row) + 2], mask[i, : len(row) + 2] = torch.tensor([101 % V] + row + [3]), 1
    match = np.sort(ti.itm_rank(p["itm"], tcfg.itm, flat, ids, mask).numpy())
    k = len(match) // 2
    threshold = float(match[k - 1] + match[k]) / 2
    assert match[k] - match[k - 1] > 1e-4, match

    with pytest.MonkeyPatch.context() as mp, fast_jit():
        mp.setattr(jb, "vit_forward", jit_eager(jb.vit_forward))
        mp.setattr(jb, "precompute_cross_kv", jit_eager(jb.precompute_cross_kv))
        mp.setattr(jsampler, "warp_logits", jit_eager(jsampler.warp_logits, "temperature", "top_k", "top_p",
                                                      static_argnums=()))
        mp.setattr(jsampler, "sample_token", jit_eager(jsampler.sample_token, "do_sample", static_argnums=()))
        mp.setattr(ji, "_sample_patches", jit_eager(ji._sample_patches, static_argnums=(2,)))
        rank = jit_eager(ji.itm_rank)

        def recording_rank(params_itm, cfg_itm, *arrays):  # forward_cap's ITM filter call
            want["rank"] = [np.asarray(a) for a in arrays] + [np.asarray(rank(params_itm, cfg_itm, *arrays))]
            return want["rank"][-1]

        mp.setattr(ji, "itm_rank", recording_rank)
        mp.setattr(jt5, "encode", jit_eager(jt5.encode))
        want["cap"] = ji.forward_cap(tree, cfg, J["pix"], jnp.asarray(want["itm"]), PROMPT, key,
                                     enc_token_id=101 % V, itm_threshold=threshold, decode=decode, **CAP)
        captions = [decode(r) for r in want["cap"][0]]
        contexts, answers, ans_to_cap = ji.answer_extraction(captions, num_question_generation=19)
        ctx_ids, ctx_mask = tokenize(contexts, 16)
        want["qg"] = ji.forward_qa_generation(tree["qg"], cfg.qg, jnp.asarray(ctx_ids), jnp.asarray(ctx_mask),
                                              max_length=4)
    questions = [decode(r) for r in want["qg"]]
    want["prompt"] = ji.prompts_construction(QUESTION, captions, questions, answers, ans_to_cap)
    data = dict(pix=pix, q_ids=q_ids, q_mask=q_mask)
    return want, tree, threshold, {k: torch.from_numpy(v) for k, v in data.items()}


def test_itm_rank_matches_jax(ref):
    """On the inputs of JAX's ITM filter call (the round's patch subsets
    and [ENC] + caption + [SEP] rows), and GradCAM."""
    want, tree, _, d = ref
    p = from_jax_params(tree, device="cpu")
    embeds, ids, mask, probs = want["rank"]
    assert embeds.shape[0] == CAP["num_captions"] * B
    close(ti.itm_rank(p["itm"], config(ti).itm, *(torch.from_numpy(a) for a in (embeds, ids, mask))), probs,
          "itm_rank")
    close(ti.forward_itm(p, config(ti), d["pix"], d["q_ids"], d["q_mask"]), want["itm"],
          "forward_itm GradCAM")


def test_forward_cap_itm_filter_and_prompt_match_jax(ref):
    """Kept captions (the ITM filter drops about half), the answer
    candidates, the 20 generated questions (two chunks of 10) and the
    prompt, each equal to JAX's."""
    want, tree, threshold, d = ref
    p, cfg = from_jax_params(tree, device="cpu"), config(ti)
    gradcams = torch.from_numpy(np.asarray(want["itm"]))
    kept = ti.forward_cap(p, cfg, d["pix"], gradcams, PROMPT, enc_token_id=101 % V, itm_threshold=threshold,
                          decode=decode, patch_uniforms=[torch.from_numpy(np.asarray(want["uniforms"]))], **CAP)
    assert kept == want["cap"]
    assert 0 < sum(map(len, kept)) < CAP["num_captions"] * B
    captions = [decode(r) for r in kept[0]]
    contexts, answers, ans_to_cap = ti.answer_extraction(captions, num_question_generation=19)
    assert len(contexts) == 20 and contexts[-1].startswith("answer: yes.  context: ")
    ctx_ids, ctx_mask = tokenize(contexts, 16)
    qg = ti.forward_qa_generation(p["qg"], cfg.qg, torch.from_numpy(ctx_ids), torch.from_numpy(ctx_mask),
                                  max_length=4)
    assert qg == want["qg"] and len(qg) == 20
    questions = [decode(r) for r in qg]
    prompt = ti.prompts_construction(QUESTION, captions, questions, answers, ans_to_cap)
    assert prompt == want["prompt"] and prompt.endswith("Question:" + QUESTION + "\nAnswer:")


def test_answer_extraction_and_prompt_copies_match_jax():
    """The pure parts on hand-written captions: the frequency order (a
    stable sort), the chunk rule, the dead rule branch of the task prompt."""
    caps = ["A dog runs on the grass.", "the dog and a red ball", "Two dogs play with a ball in the park.",
            "grass grass dog"]
    for n in (2, 30):
        got, want = ti.answer_extraction(caps, num_question_generation=n), ji.answer_extraction(
            caps, num_question_generation=n)
        assert got == want
    contexts, answers, ans_to_cap = want
    for qtype in ("neural", "rule"):
        args = (QUESTION, caps, ["Is it a dog?", "What color?"], answers, ans_to_cap)
        kw = dict(question_type=qtype, num_caps_per_img=3, num_question_per_img=2)
        assert ti.prompts_construction(*args, **kw) == ji.prompts_construction(*args, **kw)
