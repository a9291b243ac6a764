"""ALBEF and CLIP in the port (models/albef.py, models/clip.py,
models/clip_tokenizer.py) and the three ops/layers helpers, against the JAX
package's on the CPU, at the tiny configs, from the same numpy trees (the
port's own inits, carried into both) and seeded inputs.

JAX references, a few compiled programs (tests/lavis_ref.run_all):
- ALBEF's forwards: fused_encode, itc_features, itm_logits_from_ids,
  extract_features (multimodal), nlvr_forward on the 6-layer NLVR config
  and nlvr_loss, mlm_loss and vqa_train_loss with momentum distillation
  (the distilled CE of classification_loss and nlvr_loss is held alone
  below), and the VQA decoder's first-token probabilities and
  label-smoothed answer losses for every answer (rank_answers' two stages:
  the JAX function's host logic replayed on them);
- CLIP's encode_image, encode_text, extract_features, and zero_shot_predict
  on zero_shot_classifier's classifier (compute_sim_matrix is the features'
  product).
mlm_mask_inputs takes the JAX draws (its key split replayed);
sample_hard_negative_indices (the port's own draw) is held to its
distribution. ALBEF's retrieval_train_step and classification_loss, BLIP's
classification_loss and CLIP's contrastive_loss are held with their
gradients through the CLI (tests/test_torch_lavis_train_cli*.py),
pretrain_train_step in tests/test_torch_lavis_albef_pretrain.py.
Tolerances: fp32 forwards within 1e-5, losses within 1e-6, gradients
within 1e-5 of the largest.
"""

import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavis_ref import close, leaves, np_tree, run, run_all
from llava_align_tpu.models import albef as ja
from llava_align_tpu.models import clip as jc
from llava_align_tpu_torch.models import albef as ta
from llava_align_tpu_torch.models import clip as tc
from llava_align_tpu_torch.ops import layers as tlayers
from llava_align_tpu_torch.utils.jax_params import from_jax_params

B, S, NA = 3, 6, 5
NEG_IDX = (np.array([1, 2, 0], np.int32), np.array([2, 0, 1], np.int32))


def setup():
    """(JAX configs, numpy trees, inputs as numpy and as jax arrays,
    n_answers) shared with tests/test_torch_lavis_albef_pretrain.py."""
    cfg, ncfg = ja.AlbefConfig.tiny(num_classes=3), ja.AlbefConfig.tiny(num_classes=2, nlvr=True)
    tcfg, tncfg = ta.AlbefConfig.tiny(num_classes=3), ta.AlbefConfig.tiny(num_classes=2, nlvr=True)
    trees = {v: np_tree(ta.init(tcfg, v, device="cpu", seed=i)) for i, v in
             enumerate(("retrieval", "pretrain", "vqa"))}
    trees["nlvr"] = np_tree(ta.init(tncfg, "nlvr", device="cpu", seed=7))
    trees["queue"] = np_tree(ta.init_queue_state(tcfg, torch.Generator().manual_seed(8), device="cpu"))
    trees["clip"] = np_tree(tc.init(tc.ClipConfig.tiny(), device="cpu", seed=9))
    rng = np.random.default_rng(0)
    size = cfg.vision.image_size
    data = {
        "pix": rng.standard_normal((B, 3, size, size)).astype(np.float32),
        "pix1": rng.standard_normal((B, 3, size, size)).astype(np.float32),
        "ids": rng.integers(3, 60, (B, S)).astype(np.int32),
        "mask": np.ones((B, S), np.int32),
        "labels": np.array([0, 2, 1], np.int32),
        "ans": np.concatenate([np.full((NA, 1), 1), rng.integers(3, 60, (NA, 3))], axis=1).astype(np.int32),
        "ans_mask": np.ones((NA, 4), np.int32),
        "weights": np.array([0.5, 0.5, 1.0, 0.3, 0.7], np.float32),
        "mlm_in": rng.integers(3, 60, (B, S)).astype(np.int32),
        "mlm_labels": np.where(rng.random((B, S)) < 0.4, rng.integers(3, 60, (B, S)), -100).astype(np.int32),
        "clip_ids": rng.integers(1, 60, (B, 16)).astype(np.int32),
    }
    data["mask"][1, 4:] = 0
    data["ans"][3, 3] = 0
    data["ans_mask"][3, 3] = 0
    J = {k: jnp.asarray(v) for k, v in data.items()}
    n_answers = (2, 2, 1)
    return (cfg, ncfg), trees, data, J, n_answers


@pytest.fixture(scope="module")
def ref():
    (cfg, ncfg), trees, data, J, n_answers = setup()

    def albef_retrieval(r):
        feats = ja.itc_features(r, cfg, J["pix"], J["ids"], J["mask"])
        return {
            "feats": feats,
            "itm": ja.itm_logits_from_ids(r, cfg, feats["image_embeds"], J["ids"], J["mask"]),
            "extract": ja.extract_features(r, cfg, J["pix"], J["ids"], J["mask"]),
            "mlm": ja.mlm_loss(r, cfg, J["mlm_in"], J["mask"], feats["image_embeds"], J["mlm_labels"], m_params=r,
                               image_embeds_m=feats["image_embeds"] * 0.5, alpha=0.4),
        }

    def albef_vqa_nlvr(v, n):
        fused = ja.fused_encode(v, cfg, J["pix"], J["ids"], J["mask"])
        start = jnp.full((B, 1), J["ans"][0, 0], jnp.int32)
        h0 = ja.med_forward(v["decoder"], cfg.decoder, start, encoder_states=fused, encoder_mask=J["mask"],
                            causal=True)
        tgt = jnp.where(J["ans"] == 0, -100, J["ans"])
        h = ja.med_forward(v["decoder"], cfg.decoder, jnp.tile(J["ans"], (B, 1)), jnp.tile(J["ans_mask"], (B, 1)),
                           encoder_states=jnp.repeat(fused, NA, 0), encoder_mask=jnp.repeat(J["mask"], NA, 0),
                           causal=True)
        ans_loss = ja._lm_loss_per_sample(ja.med_logits(v["decoder"], h), jnp.tile(tgt, (B, 1)), cfg.label_smoothing)
        return {
            "fused": fused,
            "nlvr": ja.nlvr_loss(n, ncfg, J["pix"], J["pix1"], J["ids"], J["mask"], J["labels"] % 2),
            "vqa_loss": ja.vqa_train_loss(v, cfg, J["pix"], J["ids"], J["mask"], J["ans"], J["ans_mask"], n_answers,
                                          J["weights"], m_params=v, alpha=0.4),
            "prob_first": jax.nn.softmax(ja.med_logits(v["decoder"], h0)[:, 0], axis=-1)[:, J["ans"][:, 1]],
            "ans_loss": ans_loss.reshape(B, NA),
        }

    classnames = ["dog", "cat"]
    tokenize = lambda texts: data["clip_ids"][: len(texts)] + len(texts[0]) % 3  # noqa: E731

    def clip_forwards(p):
        ccfg = jc.ClipConfig.tiny()
        classifier = jc.zero_shot_classifier(p, ccfg, classnames, jc.DEFAULT_PROMPT_TEMPLATES[:2], tokenize)
        return {"image": jc.encode_image(p, ccfg, J["pix"]), "text": jc.encode_text(p, ccfg, J["clip_ids"]),
                "feats": jc.extract_features(p, ccfg, J["pix"], J["clip_ids"]),
                "zero_shot": (classifier, jc.zero_shot_predict(p, ccfg, J["pix"], classifier))}

    out = run_all({"retrieval": (albef_retrieval, trees["retrieval"]),
                   "vqa_nlvr": (albef_vqa_nlvr, trees["vqa"], trees["nlvr"]),
                   "clip": (clip_forwards, trees["clip"])})
    want = {**out["retrieval"], **out["vqa_nlvr"], "clip": out["clip"], "zero_shot": out["clip"]["zero_shot"]}
    return want, trees, data, (classnames, tokenize, n_answers)


def _t(data):
    return {k: torch.from_numpy(v) for k, v in data.items()}


def test_albef_forwards_match_jax(ref):
    want, trees, data, (_, _, n_answers) = ref
    cfg, d = ta.AlbefConfig.tiny(num_classes=3), _t(data)
    r = from_jax_params(trees["retrieval"], device="cpu")
    v = from_jax_params(trees["vqa"], device="cpu")
    n = from_jax_params(trees["nlvr"], device="cpu")
    feats = ta.itc_features(r, cfg, d["pix"], d["ids"], d["mask"])
    for k, w in want["feats"].items():
        close(feats[k], w, f"itc_features {k}")
    close(ta.fused_encode(v, cfg, d["pix"], d["ids"], d["mask"]), want["fused"], "fused_encode")
    close(ta.itm_logits_from_ids(r, cfg, feats["image_embeds"], d["ids"], d["mask"]), want["itm"], "itm logits")
    ext = ta.extract_features(r, cfg, d["pix"], d["ids"], d["mask"])
    for k, w in want["extract"].items():
        close(ext[k], w, f"extract_features {k}")
    ncfg = ta.AlbefConfig.tiny(num_classes=2, nlvr=True)
    loss, logits = ta.nlvr_loss(n, ncfg, d["pix"], d["pix1"], d["ids"], d["mask"], d["labels"] % 2)
    close(loss, want["nlvr"][0], "nlvr_loss", rtol=1e-6, atol=0)
    close(logits, want["nlvr"][1], "nlvr_forward")
    loss = ta.mlm_loss(r, cfg, d["mlm_in"], d["mask"], feats["image_embeds"], d["mlm_labels"], m_params=r,
                       image_embeds_m=feats["image_embeds"] * 0.5, alpha=0.4)
    close(loss, want["mlm"], "mlm_loss", rtol=1e-6, atol=0)
    loss = ta.vqa_train_loss(v, cfg, d["pix"], d["ids"], d["mask"], d["ans"], d["ans_mask"], n_answers,
                             d["weights"], m_params=v, alpha=0.4)
    close(loss, want["vqa_loss"], "vqa_train_loss", rtol=1e-6, atol=0)


def test_rank_answers_as_jax(ref):
    """rank_answers: the top k by first-token probability, then the least
    label-smoothed answer loss, replayed on the JAX program's numbers
    (jax.lax.top_k's order: the lower index first among ties)."""
    want, trees, data, _ = ref
    cfg, d = ta.AlbefConfig.tiny(num_classes=3), _t(data)
    v = from_jax_params(trees["vqa"], device="cpu")
    for k in (2, NA):
        top = np.argsort(-np.asarray(want["prob_first"]), axis=1, kind="stable")[:, :k]
        expect = top[np.arange(B), np.argmin(np.take_along_axis(np.asarray(want["ans_loss"]), top, 1), axis=1)]
        got = ta.rank_answers(v, cfg, d["pix"], d["ids"], d["mask"], d["ans"], d["ans_mask"], num_ans_candidates=k)
        np.testing.assert_array_equal(got, expect)


def test_clip_matches_jax(ref):
    want, trees, data, (classnames, tokenize, _) = ref
    cfg, d = tc.ClipConfig.tiny(), _t(data)
    p = from_jax_params(trees["clip"], device="cpu")
    close(tc.encode_image(p, cfg, d["pix"]), want["clip"]["image"], "encode_image")
    close(tc.encode_text(p, cfg, d["clip_ids"]), want["clip"]["text"], "encode_text")
    feats = tc.extract_features(p, cfg, d["pix"], d["clip_ids"])
    for k, w in want["clip"]["feats"].items():
        close(feats[k], w, k)
    sims = tc.compute_sim_matrix(p, cfg, d["pix"], d["clip_ids"])
    w = want["clip"]["feats"]
    close(sims[0], np.asarray(w["image_embeds_proj"]) @ np.asarray(w["text_embeds_proj"]).T, "sim i2t")
    classifier = tc.zero_shot_classifier(p, cfg, classnames, tc.DEFAULT_PROMPT_TEMPLATES[:2], tokenize)
    close(classifier, want["zero_shot"][0], "zero_shot_classifier")
    close(tc.zero_shot_predict(p, cfg, d["pix"], classifier), want["zero_shot"][1], "zero_shot_predict", atol=1e-4)


def test_mlm_mask_inputs_with_the_jax_draws():
    """The JAX function's key split replayed: its four planes handed in give
    its masked ids and labels exactly."""
    ids = np.random.default_rng(1).integers(0, 60, (4, 12)).astype(np.int32)
    ids[:, 0] = 101
    ids[2, 8:] = 0
    kw = dict(mask_token_id=103, pad_token_id=0, cls_token_id=101, mlm_probability=0.5)

    def program(rng, ids):
        k1, k2, k3, k4 = jax.random.split(rng, 4)
        draws = (jax.random.bernoulli(k1, 0.5, ids.shape), jax.random.bernoulli(k2, 0.8, ids.shape),
                 jax.random.bernoulli(k3, 0.5, ids.shape), jax.random.randint(k4, ids.shape, 0, 60))
        return ja.mlm_mask_inputs(rng, ids, 60, **kw), draws

    want, draws = run(program, jax.random.PRNGKey(3), ids)
    got = ta.mlm_mask_inputs(None, torch.from_numpy(ids), 60, draws=[torch.from_numpy(np.asarray(x)) for x in draws],
                             **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    drawn, labels = ta.mlm_mask_inputs(torch.Generator().manual_seed(0), torch.from_numpy(ids), 60, **kw)
    assert ((labels == -100) | ((torch.from_numpy(ids) != 0) & (torch.from_numpy(ids) != 101))).all()
    assert torch.equal(drawn[labels == -100], torch.from_numpy(ids)[labels == -100])


def test_layers_helpers_and_momentum():
    """linear_bias, l2_normalize, momentum_update (in place) and the queue
    as the JAX package computes them; rampup_factor is the same formula."""
    from llava_align_tpu.ops import layers as jlayers

    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    p = {"w": rng.standard_normal((4, 5)).astype(np.float32), "b": rng.standard_normal(4).astype(np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    close(tlayers.linear_bias(torch.from_numpy(x), tp), jlayers.linear_bias(x, p), "linear_bias")
    close(tlayers.l2_normalize(torch.from_numpy(x)), jlayers.l2_normalize(x), "l2_normalize", atol=1e-6)
    tree = {"a": {"w": x}, "t": np.float32(0.07) * np.ones((), np.float32)}
    m = {"a": {"w": x[::-1].copy()}, "t": np.ones((), np.float32)}
    want = ja.momentum_update(tree, m, 0.9)
    got = ta.momentum_update(from_jax_params(tree, device="cpu"), from_jax_params(m, device="cpu"), 0.9)
    for a, b in zip(leaves(got), leaves(want)):
        close(a, b, "momentum_update", atol=1e-7)
    q = ta.init_queue_state(ta.AlbefConfig.tiny(), torch.Generator().manual_seed(0), device="cpu")
    assert q["image_queue"].shape == (16, 16) and int(q["ptr"]) == 0 and (q["idx_queue"] == -100).all()
    close(q["text_queue"].norm(dim=0), np.ones(16, np.float32), "queue columns normalized", atol=1e-6)
    for args in ((0, 3, 10), (1, 5, 10), (3, 0, 7)):
        assert ta.rampup_factor(*args) == ja.rampup_factor(*args)


def test_distilled_ce_as_jax():
    """classification_loss's and nlvr_loss's (1-α)·CE + α·distillation:
    the JAX expression (log_softmax, take_along_axis, softmax of the
    momentum logits) on the same logits, in numpy."""
    rng = np.random.default_rng(3)
    logits, logits_m = rng.standard_normal((4, 3)).astype(np.float32), rng.standard_normal((4, 3)).astype(np.float32)
    tgt = np.array([0, 2, 1, 1])
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    ce = -logp[np.arange(4), tgt].mean()
    soft = np.exp(logits_m) / np.exp(logits_m).sum(-1, keepdims=True)
    want = 0.6 * ce - 0.4 * (soft * logp).sum(-1).mean()
    got = ta.distilled_ce(torch.from_numpy(logits), torch.from_numpy(tgt), torch.from_numpy(logits_m), 0.4)
    close(got, want, "distilled CE", rtol=1e-6, atol=0)
    close(ta.distilled_ce(torch.from_numpy(logits), torch.from_numpy(tgt), None, 0.4), ce, "CE", rtol=1e-6, atol=0)


def test_hard_negative_sampler_distribution():
    """The port's own draw: a zero weight is never drawn, and the frequencies
    follow the weights (8000 draws a row, within 0.03)."""
    w = torch.tensor([[0.0, 0.7, 0.2, 0.1], [0.5, 0.0, 0.0, 0.5], [0.0, 0.0, 1.0, 0.0]])
    g = torch.Generator().manual_seed(0)
    draws = tlayers.sample_hard_negative_indices(g, w.repeat(8000, 1)).reshape(8000, 3)
    for row in range(3):
        freq = torch.bincount(draws[:, row], minlength=4).float() / 8000
        assert (freq[w[row] == 0] == 0).all(), (row, freq)
        assert torch.allclose(freq, w[row], atol=0.03), (row, freq)


def test_clip_tokenizer_copy_tokenizes_as_jax(tmp_path):
    """The copied tokenizer on a small merges table written here (the
    version header, then merges), against the JAX package's."""
    from llava_align_tpu.models.clip_tokenizer import ClipTokenizer as J
    from llava_align_tpu_torch.models.clip_tokenizer import ClipTokenizer as T

    merges = ["t h", "th e</w>", "d o", "do g</w>", "c a", "ca t</w>", "o n</w>", "a </w>", "i n", "in g</w>"]
    path = tmp_path / "bpe.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    j, t = J(str(path)), T(str(path))
    texts = ["The dog on a mat", "a CAT   sleeping!!", "dog-cat 42 &amp; the  end", "x" * 90]
    assert t.vocab_size == j.vocab_size
    np.testing.assert_array_equal(t.tokenize(texts, context_length=12), j.tokenize(texts, context_length=12))
    assert t.decode(t.encode(texts[0])) == j.decode(j.encode(texts[0]))
