"""PnP-VQA in the port (models/pnp_vqa.py, the zoo's pnp_vqa and
pnp_unifiedqav2_fid) against the JAX package's, on the CPU, at the tiny
config, from the same numpy tree (the port's own init, carried into both)
and seeded inputs.

JAX references: one compiled program (tests/lavis_ref.run_all) for
forward_itm's GradCAM, a Gumbel top-k draw of _sample_patches with its
uniforms, and the patch uniforms of each forward_cap round (the JAX
loop's key splits replayed); then the JAX package's own loop,
predict_answers (its GradCAM is the program's; its forward_cap captions
and its FiD reads are recorded, and the port's forward_cap and
fid_generate are held to them), with the towers it calls eagerly jitted
(tests/lavis_ref.jit_eager), and forward_cap again over scripted caption
rounds (the sampler replaced in both packages), which holds both dedup
rules to JAX's loop. Captions are
sampled at top_k = 1, which makes a draw the argmax, so the port given
JAX's patch uniforms must return JAX's captions token for token.
Tolerances: GradCAM within 1e-5; indices, captions and answers exact.
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
from llava_align_tpu.models import pnp_vqa as jp
from llava_align_tpu.models import t5 as jt5
from llava_align_tpu_torch.models import pnp_vqa as tp
from llava_align_tpu_torch.utils.jax_params import from_jax_params

B, S, V = 2, 6, 64
CAP = dict(num_captions=3, num_patches=2, cap_max_length=5, top_k=1, eos_token_id=3, max_rounds=1)
PROMPT = [2, 5]
QUESTIONS = ["What is on the table?", "How many dogs are there?"]
# caption rows of forward_cap's rounds (B x num_captions a round, image-major):
# image 0 keeps "5 6 7" after "5 6" with `decode` (its text holds an earlier
# one) and drops "6" (an earlier one holds it); equal tokens ([9], [5, 6])
# are dropped by both forms; each image fills up in round 2
ROUNDS = [[[5, 6], [5, 6, 7], [6], [9], [9], [4]],
          [[5, 6], [8], [7, 5], [9, 9], [1, 9], [4]]]


def config(mod):
    """The tiny config with GradCAM read at block 0: at the last block
    (the tiny config's block 1 of 2) only the cls row has a gradient, and
    GradCAM averages the other rows, so every weight would be 0."""
    return dataclasses.replace(mod.PnpVqaConfig.tiny(V), block_num=0)


def decode(row):
    """A coarse decode (three letters at most), so captions repeat as text."""
    return "".join(chr(97 + t % 3) for t in row[:3])


def words(row):
    return " ".join(map(str, row))


def tokenize(texts, width):
    """Words to crc32 ids in [4, V), [CLS]-like 2 first, padded with 0."""
    ids = np.zeros((len(texts), width), np.int64)
    mask = np.zeros_like(ids)
    for i, t in enumerate(texts):
        row = [2] + [zlib.crc32(w.encode()) % (V - 4) + 4 for w in t.split()][: width - 1]
        ids[i, : len(row)], mask[i, : len(row)] = row, 1
    return ids, mask


def jax_round_uniforms(key, shape, rounds):
    """The patch uniforms of each forward_cap round, as the JAX loop splits
    its key (rng, k_sel, k_gen = split(rng, 3); _sample_patches(k_sel))."""
    out = []
    for _ in range(rounds):
        key, k_sel, _ = jax.random.split(key, 3)
        out.append(jax.random.uniform(k_sel, shape))
    return out


pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def ref():
    cfg, tcfg = config(jp), config(tp)
    tree = np_tree(tp.init(tcfg, device="cpu", seed=3))
    rng = np.random.default_rng(0)
    size = cfg.itm.vision.image_size
    N = cfg.cap.vision.num_patches
    pix = rng.standard_normal((B, 3, size, size)).astype(np.float32)
    q_ids, q_mask = tokenize(QUESTIONS, S)
    weights = rng.random((5, 3, 16)).astype(np.float32)
    weights[0, 0, :5] = 0.0  # clipped to 1e-20: ties in log(w), broken by the draw
    weights[1, 1, 3:9] = 0.5
    key_pipe = jax.random.PRNGKey(12)
    J = {k: jnp.asarray(v) for k, v in dict(pix=pix, q_ids=q_ids, q_mask=q_mask).items()}

    want = run_all({
        "itm": (lambda p: jp.forward_itm(p, cfg, J["pix"], J["q_ids"], J["q_mask"]), tree),
        "draws": (lambda key, w: (jp._sample_patches(key, w, 6), jax.random.uniform(key, w.shape)),
                  jax.random.PRNGKey(5), weights),
        "uniforms": (lambda k: jax_round_uniforms(k, (CAP["num_captions"], B, N), CAP["max_rounds"]), key_pipe),
    })
    fid_calls = []  # the FiD reads predict_answers makes: (ids, mask, answer tokens)

    def recording_fid(params_qa, cfg_qa, ids, mask, **kw):
        out = fid(params_qa, cfg_qa, ids, mask, **kw)
        fid_calls.append((np.asarray(ids), np.asarray(mask), kw, out))
        return out

    fid = jp.fid_generate
    with pytest.MonkeyPatch.context() as mp, fast_jit():
        mp.setattr(jb, "vit_forward", jit_eager(jb.vit_forward))
        mp.setattr(jb, "precompute_cross_kv", jit_eager(jb.precompute_cross_kv))
        mp.setattr(jsampler, "warp_logits", jit_eager(jsampler.warp_logits, "temperature", "top_k", "top_p",
                                                      static_argnums=()))
        mp.setattr(jsampler, "sample_token", jit_eager(jsampler.sample_token, "do_sample", static_argnums=()))
        mp.setattr(jp, "_sample_patches", jit_eager(jp._sample_patches, static_argnums=(2,)))
        mp.setattr(jt5, "encode", jit_eager(jt5.encode))
        # the pipeline's GradCAM is the program's above (the same inputs)
        mp.setattr(jp, "forward_itm", lambda *a: jnp.asarray(want["itm"]))
        mp.setattr(jp, "fid_generate", recording_fid)
        cap = jp.forward_cap
        mp.setattr(jp, "forward_cap", lambda *a, **k: want.setdefault("cap", cap(*a, **k)))
        want["pipe"] = jp.predict_answers(
            tree, cfg, J["pix"], QUESTIONS, tokenize_q=lambda t: tokenize(t, S),
            tokenize_ctx=lambda t: tokenize(t, 12), decode_cap=decode, decode_ans=words, prompt_ids=PROMPT,
            rng=key_pipe, num_captions=CAP["num_captions"], num_captions_fid=2, num_patches=CAP["num_patches"],
            max_len=5, cap_max_length=CAP["cap_max_length"], top_k=1, eos_token_id=3, max_rounds=CAP["max_rounds"])
        # the dedup rules on scripted captions (the caption sampler
        # replaced): JAX's loop decides which rows each form keeps
        want["scripted"] = []
        for dec in (None, words):
            mp.setattr(jb, "generate_caption_sampled", lambda *a, rounds=iter(ROUNDS), **k: next(rounds))
            want["scripted"].append(cap(tree, cfg, J["pix"], jnp.asarray(want["itm"]), PROMPT, key_pipe,
                                        decode=dec, **{**CAP, "max_rounds": 3}))
    want["fid"] = fid_calls
    data = dict(pix=pix, q_ids=q_ids, q_mask=q_mask, weights=weights)
    return want, tree, {k: torch.from_numpy(v) for k, v in data.items()}


def _uniforms(arrays):
    return [torch.from_numpy(np.asarray(u)) for u in arrays]


def test_forward_itm_matches_jax(ref):
    want, tree, d = ref
    got = tp.forward_itm(from_jax_params(tree, device="cpu"), config(tp), d["pix"], d["q_ids"],
                         d["q_mask"])
    close(got, want["itm"], "forward_itm GradCAM")
    assert np.abs(want["itm"]).min(axis=-1).max() > 0  # weights the patch draws can tell apart


def test_sample_patches_takes_jax_indices_from_its_uniforms(ref):
    want, _, d = ref
    idx, u = want["draws"]
    got = tp._sample_patches(d["weights"], 6, uniforms=torch.from_numpy(np.asarray(u)))
    np.testing.assert_array_equal(got.numpy(), idx)
    # drawn from a generator instead: 6 distinct, ascending indices per row
    drawn = tp._sample_patches(d["weights"], 6, torch.Generator().manual_seed(0))
    assert drawn.shape == idx.shape and (drawn.diff(dim=-1) > 0).all()


def test_forward_cap_matches_jax(ref):
    """The captions of JAX's pipeline run (its forward_cap, recorded):
    token for token from JAX's patch uniforms, deduplicated by text."""
    want, tree, d = ref
    p, cfg = from_jax_params(tree, device="cpu"), config(tp)
    gradcams = torch.from_numpy(np.asarray(want["itm"]))
    got = tp.forward_cap(p, cfg, d["pix"], gradcams, PROMPT, patch_uniforms=_uniforms(want["uniforms"]),
                         decode=decode, **CAP)
    assert got == want["cap"] and all(len(rows) > 0 for rows in got)


def test_forward_cap_dedup_rules_match_jax(ref, monkeypatch):
    """Both dedup forms on scripted captions: equal tokens dropped; with
    `decode`, a caption whose text an earlier one holds dropped, one
    holding an earlier one kept; an image stops at num_captions."""
    want, tree, d = ref
    p, cfg = from_jax_params(tree, device="cpu"), config(tp)
    gradcams = torch.from_numpy(np.asarray(want["itm"]))
    got = []
    for dec in (None, words):
        monkeypatch.setattr(tp.blip_mod, "generate_caption_sampled",
                            lambda *a, rounds=iter(ROUNDS), **k: next(rounds))
        got.append(tp.forward_cap(p, cfg, d["pix"], gradcams, PROMPT, torch.Generator().manual_seed(0), decode=dec,
                                  **{**CAP, "max_rounds": 3}))
    assert got == want["scripted"]
    assert got == [[[[5, 6], [5, 6, 7], [6]], [[9], [4], [9, 9]]], [[[5, 6], [5, 6, 7], [8]], [[9], [4], [9, 9]]]]


def test_fid_generate_matches_jax(ref):
    """The port's reader on each FiD read of JAX's pipeline (2 contexts of
    two captions, padded): the answer tokens equal."""
    want, tree, _ = ref
    qa = from_jax_params(tree["qa"], device="cpu")
    assert len(want["fid"]) == B and any((mask == 0).any() for _, mask, _, _ in want["fid"])
    for ids, mask, kw, tokens in want["fid"]:
        assert tp.fid_generate(qa, config(tp).qa, torch.from_numpy(ids), torch.from_numpy(mask), **kw) == tokens
        assert len(tokens) > 0


def test_predict_answers_matches_jax(ref):
    """The pipeline end to end: GradCAM, captions deduplicated by decoded
    text (a substring of a kept caption is dropped), FiD over contexts of
    two captions; answers and captions equal JAX's."""
    want, tree, d = ref
    answers, captions, gradcams = tp.predict_answers(
        from_jax_params(tree, device="cpu"), config(tp), d["pix"], QUESTIONS,
        tokenize_q=lambda t: tokenize(t, S), tokenize_ctx=lambda t: tokenize(t, 12), decode_cap=decode,
        decode_ans=words, prompt_ids=PROMPT, num_captions=CAP["num_captions"], num_captions_fid=2,
        num_patches=CAP["num_patches"], max_len=5, cap_max_length=CAP["cap_max_length"], top_k=1, eos_token_id=3,
        max_rounds=CAP["max_rounds"], patch_uniforms=_uniforms(want["uniforms"]))
    w_answers, w_captions, w_gradcams = want["pipe"]
    assert captions == w_captions and answers == w_answers
    close(gradcams, w_gradcams, "predict_answers GradCAM")
    # the text dedup was hit: no kept caption's text is held in an earlier one's
    assert sum(map(len, captions)) < CAP["num_captions"] * B
    for rows in captions:
        assert not any(rows[j] in rows[i] for j in range(len(rows)) for i in range(j))


def test_prepare_qa_input_groups_captions():
    caps = [f"Cap {i} " for i in range(5)]
    assert tp.prepare_qa_input("What IS this?", caps, num_captions=5, num_captions_fid=2) == [
        "what is this? \\n cap 0. cap 1.", "what is this? \\n cap 2. cap 3.", "what is this? \\n cap 4."]
