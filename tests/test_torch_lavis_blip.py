"""BLIP and its variants in the port (models/blip.py, models/blip_variants.py)
against the JAX package's, on the CPU, at the tiny configs, from the same
numpy trees (the port's own inits, carried into both) and seeded inputs.

The JAX side is a few compiled programs (tests/lavis_ref.run_all) built
once for the module: the ViT and MED states, itm_score, extract_features,
compute_gradcam, one decode_step on a fresh cache with and without an
encoder mask, the ITM logits of every image-text pair (compute_sim_matrix's
re-rank reads them) and nlvr_forward (retrieval_train_step and
pretrain_step: tests/test_torch_lavis_blip_train.py). The JAX caption loop runs as it
is (its own jitted steps compiled with FAST_COMPILE): greedy captions token
for token, and a 2-beam search. The sampled
caption loop at top_k = 1 gives the greedy tokens; its repetition penalty
and min_new_tokens (which the JAX loop cannot take: it writes into a
read-only array) and vqa_generate are held to HF's rules replayed on the
decode steps held here.
compute_sim_matrix's re-rank is the JAX function's host logic on the
program's ITC and ITM numbers. Tolerances: fp32 forwards within 1e-5,
losses within 1e-6, gradients within 1e-5 of the largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavis_ref import close, fast_jit, np_tree, run_all
from llava_align_tpu.models import blip as jb
from llava_align_tpu.models import blip_variants as jv
from llava_align_tpu_torch.models import blip as tb
from llava_align_tpu_torch.models import blip_variants as tv
from llava_align_tpu_torch.utils.jax_params import from_jax_params

B, S = 3, 7


def setup():
    """(the JAX config, numpy trees, queue state, inputs as numpy and as
    jax arrays) shared by this file and tests/test_torch_lavis_blip_train.py."""
    cfg, tcfg = jb.BlipConfig.tiny(), tb.BlipConfig.tiny()
    trees = {"base": np_tree(tb.init(tcfg, device="cpu", seed=1)),
             "ret": np_tree(tv.init_retrieval(tcfg, device="cpu", seed=2)),
             "nlvr": np_tree(tv.init_nlvr(tv.NlvrConfig.tiny(), device="cpu", seed=3))}
    trees["ret"]["decoder"] = np_tree(tb.med_init(tcfg.text, device="cpu", seed=4))
    queue = np_tree(tv.init_queue_state(_queue_cfg(), torch.Generator().manual_seed(5), device="cpu"))
    rng = np.random.default_rng(0)
    size = cfg.vision.image_size
    data = {
        "pix": rng.standard_normal((B, 3, size, size)).astype(np.float32),
        "pix1": rng.standard_normal((B, 3, size, size)).astype(np.float32),
        "ids": rng.integers(3, 60, (B, S)).astype(np.int32),
        "mask": np.ones((B, S), np.int32),
        "idx": np.array([0, 1, 1], np.int32),
        "tok": np.array([5, 9, 2], np.int32),
        "enc_mask": np.array([[1] * 5, [1, 1, 1, 0, 0], [1] * 5], np.int32),
    }
    data["mask"][1, 5:] = 0
    data["enc_ids"] = data["ids"].copy()
    data["enc_ids"][:, 0] = 2
    data["dec_ids"] = data["ids"].copy()
    data["dec_ids"][:, 0] = 1
    return cfg, trees, queue, data, {k: jnp.asarray(v) for k, v in data.items()}


@pytest.fixture(scope="module")
def ref():
    cfg, trees, queue, data, J = setup()
    ncfg = jv.NlvrConfig.tiny()

    def forwards(p, nlvr):
        enc = jb.vit_forward(p["visual"], cfg.vision, J["pix"])
        cross = jb.precompute_cross_kv(p["text"], cfg.text, enc[:, :5])
        step = {name: jb.decode_step(p["text"], cfg.text, J["tok"], jnp.asarray(0, jnp.int32),
                                     jb.init_self_cache(cfg.text, B, 4), cross, m)[0]
                for name, m in (("plain", None), ("masked", J["enc_mask"]))}
        return {
            "enc": enc, "text": jb.med_forward(p["text"], cfg.text, J["ids"], J["mask"], encoder_states=enc,
                                               encoder_mask=jnp.ones(enc.shape[:2], jnp.int32), causal=True),
            "logits": jb.med_logits(p["text"], enc[:, :2]),
            "itm": jb.itm_score(p, cfg, J["pix"], J["ids"], J["mask"]),
            "feats": jb.extract_features(p, cfg, J["pix"], J["ids"], J["mask"]),
            "step": step,
            "itm_all": jax.vmap(lambda e: jb.itm_score_from_embeds(p, cfg, jnp.repeat(e[None], B, 0), J["ids"],
                                                                   J["mask"])[:, 1])(enc),
            "nlvr": jv.nlvr_forward(nlvr, ncfg, J["pix"], J["pix1"], J["ids"], J["mask"]),
        }

    out = run_all({"forwards": (forwards, trees["base"], trees["nlvr"]),
                   "cam": (lambda p: jb.compute_gradcam(p, cfg, J["pix"], J["ids"], J["mask"], block_num=1),
                           trees["base"])})
    return {**out["forwards"], "cam": out["cam"]}, trees, queue, data


def _queue_cfg():
    from llava_align_tpu_torch.models.albef import AlbefConfig

    return AlbefConfig.tiny(queue_size=8)


def _t(data):
    return {k: torch.from_numpy(v) for k, v in data.items()}


def test_forwards_match_jax(ref):
    want, trees, _, data = ref
    cfg = tb.BlipConfig.tiny()
    p, d = from_jax_params(trees["base"], device="cpu"), _t(data)
    enc = tb.vit_forward(p["visual"], cfg.vision, d["pix"])
    close(enc, want["enc"], "vit_forward")
    ones = torch.ones(enc.shape[:2], dtype=torch.int32)
    close(tb.med_forward(p["text"], cfg.text, d["ids"], d["mask"], encoder_states=enc, encoder_mask=ones, causal=True),
          want["text"], "med_forward causal + cross")
    close(tb.med_logits(p["text"], enc[:, :2]), want["logits"], "med_logits")
    close(tb.itm_score(p, cfg, d["pix"], d["ids"], d["mask"]), want["itm"], "itm_score")
    feats = tb.extract_features(p, cfg, d["pix"], d["ids"], d["mask"])
    for k, v in want["feats"].items():
        close(feats[k], v, k)
    avg, full = tb.compute_gradcam(p, cfg, d["pix"], d["ids"], d["mask"], block_num=1)
    close(avg, want["cam"][0], "gradcam avg")
    close(full, want["cam"][1], "gradcam map")
    cross = tb.precompute_cross_kv(p["text"], cfg.text, enc[:, :5])
    for name, m in (("plain", None), ("masked", d["enc_mask"])):
        logits, _ = tb.decode_step(p["text"], cfg.text, d["tok"].long(), 0, tb.init_self_cache(cfg.text, B, 4),
                                   cross, m)
        close(logits, want["step"][name], f"decode_step {name}")
    n = from_jax_params(trees["nlvr"], device="cpu")
    close(tv.nlvr_forward(n, tv.NlvrConfig.tiny(), d["pix"], d["pix1"], d["ids"], d["mask"]), want["nlvr"], "nlvr")


def test_compute_sim_matrix_reranks_as_jax(ref):
    """ITC similarity re-ranked by ITM on the top k of each row: the JAX
    function's host logic on the program's ITC and ITM numbers."""
    want, trees, _, data = ref
    p, d = from_jax_params(trees["base"], device="cpu"), _t(data)
    sims = np.asarray(want["feats"]["image_features"]) @ np.asarray(want["feats"]["text_features"]).T
    itm = np.asarray(want["itm_all"])  # [image, text]
    k = 2
    i2t, t2i = np.full_like(sims, -100.0), np.full_like(sims.T, -100.0)
    for i in range(B):
        top = np.argsort(sims[i])[::-1][:k]
        i2t[i, top] = sims[i, top] + itm[i, top]
    for t in range(B):
        top = np.argsort(sims[:, t])[::-1][:k]
        t2i[t, top] = sims[top, t] + itm[top, t]
    got = tb.compute_sim_matrix(p, tb.BlipConfig.tiny(), d["pix"], d["ids"], d["mask"], k_test=k)
    close(got[0], i2t, "i2t")
    close(got[1], t2i, "t2i")
    plain = tb.compute_sim_matrix(p, tb.BlipConfig.tiny(), d["pix"], d["ids"], d["mask"])
    close(plain[0], sims, "itc only")


def test_captions_match_jax_token_for_token(ref):
    _, trees, _, data = ref
    cfg = jb.BlipConfig.tiny()
    p = from_jax_params(trees["base"], device="cpu")
    pix = torch.from_numpy(data["pix"])
    for beams in (1, 2):
        with fast_jit():
            want = jb.generate_caption(trees["base"], cfg, data["pix"], [1, 5], max_new_tokens=5, num_beams=beams)
        got = tb.generate_caption(p, tb.BlipConfig.tiny(), pix, [1, 5], max_new_tokens=5, num_beams=beams)
        assert got == want, beams
        if beams == 1:
            greedy = want
    # the sampled loop at top_k = 1 over the same ViT states: the greedy tokens
    enc_t, cfg_t = tb.vit_forward(p["visual"], tb.BlipConfig.tiny().vision, pix), tb.BlipConfig.tiny()
    got = tb.generate_caption_sampled(p, cfg_t, enc_t, [1, 5], torch.Generator(), max_new_tokens=5, top_k=1)
    assert got == greedy
    # the penalty and min_new_tokens, held to HF's rule on the decode steps
    # (held above): seen logits divided by the penalty where positive,
    # multiplied where not; eos masked until 2 tokens
    got = tb.generate_caption_sampled(p, cfg_t, enc_t, [1], torch.Generator(), max_new_tokens=4, top_k=1,
                                      repetition_penalty=1.5, min_new_tokens=2, eos_token_id=3)
    assert got == _greedy_reference(p["text"], cfg_t.text, enc_t, None, bos=1, eos=3, steps=4, penalty=1.5,
                                    min_new=2)


def _greedy_reference(text, mcfg, states, enc_mask, *, bos, eos, steps, penalty=1.0, min_new=0):
    """HF greedy decoding (with its repetition penalty and min length) on
    decode_step: generated ids per row, cut at eos."""
    cross = tb.precompute_cross_kv(text, mcfg, states)
    cache = tb.init_self_cache(mcfg, B, steps + 1)
    tok, rows, done = torch.full((B,), bos, dtype=torch.long), [[] for _ in range(B)], [False] * B
    with torch.no_grad():
        for t in range(steps):
            lg = tb.decode_step(text, mcfg, tok, t, cache, cross, enc_mask)[0]
            if penalty != 1.0:
                for b in range(B):
                    for s_ in {bos, *rows[b]}:
                        lg[b, s_] = lg[b, s_] / penalty if lg[b, s_] > 0 else lg[b, s_] * penalty
            if t < min_new:
                lg[:, eos] = -1e30
            tok = torch.where(torch.tensor(done), eos, lg.argmax(-1))
            for b in range(B):
                if not done[b]:
                    rows[b].append(int(tok[b]))
                done[b] = done[b] or int(tok[b]) == eos
            if all(done):
                break
    return [r[: r.index(eos)] if eos in r else r for r in rows]


def test_vqa_generate_greedy_on_held_steps(ref):
    """vqa_generate: greedy decoding from [DEC] over the multimodal question
    states (med_forward with cross-attention, held above) with the question
    mask on the cross-attention (decode_step's masked form, held above)."""
    _, trees, _, data = ref
    cfg = tb.BlipConfig.tiny()
    vqa = from_jax_params({"visual": trees["base"]["visual"], "text": trees["base"]["text"],
                           "decoder": trees["ret"]["decoder"]}, device="cpu")
    d = _t(data)
    got = tv.vqa_generate(vqa, cfg, d["pix"], d["enc_ids"], d["mask"], bos_token_id=1, eos_token_id=3,
                          max_new_tokens=4)
    enc = tb.vit_forward(vqa["visual"], cfg.vision, d["pix"])
    states = tb.med_forward(vqa["text"], cfg.text, d["enc_ids"], d["mask"], encoder_states=enc,
                            encoder_mask=torch.ones(enc.shape[:2], dtype=torch.int32))
    assert got == _greedy_reference(vqa["decoder"], cfg.text, states, d["mask"], bos=1, eos=3, steps=4)
