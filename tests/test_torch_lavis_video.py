"""TimeSformer and ALPRO in the port (models/timesformer.py,
models/alpro.py) against the JAX package's on the CPU, at the tiny
configs, from the same numpy trees (the port's own inits, carried into
both) and seeded inputs.

JAX references, compiled programs (tests/lavis_ref.run_all): TimeSformer's
forward_features pooled and in the (n t) layout; ALPRO's vtc_features,
fuse, qa_logits and qa_loss; retrieval_train_step's loss with its
gradient (jax.value_and_grad), its hard-negative draws recorded for the
port's `neg_idx`; the VTC similarity of every video-text pair and the
VTM score of every fused pair, on which compute_sim_matrix's host logic
(numpy's argsort of the similarities, the top k_test re-scored) is
replayed as the JAX function runs it.
Tolerances: fp32 forwards and scores within 1e-5, losses within 1e-6,
gradients within 1e-5 of the largest; the re-rank candidate sets equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavis_ref import close, grads_close, np_tree, port_grads, recording_draws, run_all
from llava_align_tpu.models import alpro as ja
from llava_align_tpu.models import timesformer as jtsf
from llava_align_tpu_torch.models import alpro as ta
from llava_align_tpu_torch.models import timesformer as ttsf
from llava_align_tpu_torch.utils.jax_params import from_jax_params

B, S, NT, K = 3, 6, 5, 2


def _t(data):
    return {k: torch.from_numpy(v) for k, v in data.items()}


@pytest.fixture(scope="module")
def ref():
    cfg, tcfg = ja.AlproConfig.tiny(num_classes=3), ta.AlproConfig.tiny(num_classes=3)
    trees = {"retrieval": np_tree(ta.init(tcfg, "retrieval", device="cpu", seed=0)),
             "qa": np_tree(ta.init(tcfg, "qa", device="cpu", seed=1))}
    rng = np.random.default_rng(0)
    v = cfg.video
    data = {"video": rng.standard_normal((B, 3, v.num_frames, v.image_size, v.image_size)).astype(np.float32),
            "ids": rng.integers(3, 60, (B, S)).astype(np.int32), "mask": np.ones((B, S), np.int32),
            "targets": np.array([2, 0, 1], np.int32),
            "text_ids": rng.integers(3, 60, (NT, S)).astype(np.int32), "text_mask": np.ones((NT, S), np.int32)}
    data["mask"][1, 4:] = 0
    data["text_mask"][3, 3:] = 0
    J = {k: jnp.asarray(x) for k, x in data.items()}

    def retrieval(r):
        feats = ja.vtc_features(r, cfg, J["video"], J["ids"], J["mask"])
        return {"feats": feats, "fuse": ja.fuse(r, cfg, feats["text_embeds"], J["mask"], feats["video_embeds"]),
                "tsf": {"pooled": jtsf.forward_features(r["visual"], v, J["video"]),
                        "full": jtsf.forward_features(r["visual"], v, J["video"], pool_frames=False)}}

    def qa(q):
        return {"logits": ja.qa_logits(q, cfg, J["video"], J["ids"], J["mask"]),
                "loss": ja.qa_loss(q, cfg, J["video"], J["ids"], J["mask"], J["targets"])[0]}

    def pairs(r):
        feats = ja.vtc_features(r, cfg, J["video"], J["text_ids"], J["text_mask"])
        te = jnp.tile(feats["text_embeds"], (B, 1, 1))
        ve = jnp.repeat(feats["video_embeds"], NT, axis=0)
        vtm = ja._proj(ja.fuse(r, cfg, te, jnp.tile(J["text_mask"], (B, 1)), ve)[:, 0], r["itm_head"])[:, 1]
        return feats["video_feat"] @ feats["text_feat"].T, vtm.reshape(B, NT)

    def train(r):
        def loss(p):
            out = ja.retrieval_train_step(p, cfg, jax.random.PRNGKey(3), J["video"], J["ids"], J["mask"])
            return out["loss"], out

        return jax.value_and_grad(loss, has_aux=True)(r)

    want = run_all({"retrieval": (retrieval, trees["retrieval"]),
                    "qa": (qa, trees["qa"]), "train": (recording_draws(ja, train), trees["retrieval"]),
                    "pairs": (pairs, trees["retrieval"])})
    want["sim"], want["tsf"] = _replay_rerank(*want["pairs"]), want["retrieval"].pop("tsf")
    return want, trees, data


def _replay_rerank(sims, vtm):
    """alpro.compute_sim_matrix's host loop on its similarities and VTM
    scores (jax.numpy's arrays made numpy ones)."""
    v2t, t2v = np.full_like(sims, -100.0), np.full_like(sims.T, -100.0)
    for i in range(sims.shape[0]):
        topk = np.argsort(sims[i])[::-1][:K]
        v2t[i, topk] = sims[i, topk] + vtm[i, topk]
    for t in range(sims.shape[1]):
        topk = np.argsort(sims[:, t])[::-1][:K]
        t2v[t, topk] = sims[topk, t] + vtm[topk, t]
    return v2t, t2v


def test_timesformer_matches_jax(ref):
    want, trees, data = ref
    c, p, d = ta.AlproConfig.tiny().video, from_jax_params(trees["retrieval"]["visual"], device="cpu"), _t(data)
    pooled = ttsf.forward_features(p, c, d["video"])
    full = ttsf.forward_features(p, c, d["video"], pool_frames=False)
    assert pooled.shape == (B, 1 + c.num_patches, c.hidden_size)
    assert full.shape == (B, 1 + c.num_patches * c.num_frames, c.hidden_size)
    close(pooled, want["tsf"]["pooled"], "forward_features pooled")
    close(full, want["tsf"]["full"], "forward_features (n t)")


def test_alpro_forwards_match_jax(ref):
    want, trees, data = ref
    cfg, d = ta.AlproConfig.tiny(num_classes=3), _t(data)
    r, q = from_jax_params(trees["retrieval"], device="cpu"), from_jax_params(trees["qa"], device="cpu")
    feats = ta.vtc_features(r, cfg, d["video"], d["ids"], d["mask"])
    for k, v in want["retrieval"]["feats"].items():
        close(feats[k], v, k)
    close(ta.fuse(r, cfg, feats["text_embeds"], d["mask"], feats["video_embeds"]), want["retrieval"]["fuse"], "fuse")
    close(ta.qa_logits(q, cfg, d["video"], d["ids"], d["mask"]), want["qa"]["logits"], "qa_logits")
    loss, logits = ta.qa_loss(q, cfg, d["video"], d["ids"], d["mask"], d["targets"])
    close(loss, want["qa"]["loss"], "qa_loss", rtol=1e-6, atol=0)
    close(logits, want["qa"]["logits"], "qa_loss logits")


def test_alpro_sim_matrix_matches_jax(ref):
    """Both score matrices, and the re-rank candidates (the entries not at
    -100) of every row the same."""
    want, trees, data = ref
    cfg, d = ta.AlproConfig.tiny(), _t(data)
    got = ta.compute_sim_matrix(from_jax_params(trees["retrieval"], device="cpu"), cfg, d["video"], d["text_ids"],
                                d["text_mask"], k_test=K)
    for name, g, w in zip(("v2t", "t2v"), got, want["sim"]):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_array_equal(g == -100.0, w == -100.0, err_msg=f"{name} candidates")
        assert ((g != -100.0).sum(1) == K).all()
        close(g, w, name)
    plain = ta.compute_sim_matrix(from_jax_params(trees["retrieval"], device="cpu"), cfg, d["video"], d["text_ids"],
                                  d["text_mask"])
    close(plain[0], plain[1].T, "k_test=0 is the VTC similarity both ways", atol=0)


def test_alpro_retrieval_train_step_matches_jax(ref):
    """The loss and its parts on JAX's hard negatives, and the gradient of
    every leaf; the port's own draws (generator) give finite losses."""
    want, trees, data = ref
    cfg, d = ta.AlproConfig.tiny(), _t(data)
    ((_, w_out), w_grads), draws = want["train"]
    out, grads = port_grads(lambda p: ta.retrieval_train_step(p, cfg, None, d["video"], d["ids"], d["mask"],
                                                              neg_idx=[np.array(x) for x in draws]),
                            from_jax_params(trees["retrieval"], device="cpu"))
    for k, v in w_out.items():
        close(out[k], v, k, rtol=1e-6, atol=0)
    grads_close(grads, w_grads, "retrieval_train_step")
    own = ta.retrieval_train_step(from_jax_params(trees["retrieval"], device="cpu"), cfg,
                                  torch.Generator().manual_seed(0), d["video"], d["ids"], d["mask"])
    assert all(torch.isfinite(v) for v in own.values())
