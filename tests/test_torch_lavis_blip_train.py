"""BLIP's retrieval_train_step and pretrain_step in the port
(models/blip_variants.py) against the JAX package's, on the CPU, at the
tiny config, from the trees and inputs of tests/test_torch_lavis_blip.py:
retrieval_train_step's loss, gradient, momentum tree and queue state after
the step (its hard-negative draws recorded as the JAX program traces them
and handed to the port as `neg_idx`), and pretrain_step on the same draws:
the retrieval losses plus the captioning LM loss (pretrain_step's JAX
lines on the retrieval tree's decoder). Losses within 1e-6 relative,
gradients within 1e-5 of the largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lavis_ref import close, grads_close, leaves, port_grads, recording_draws, run_all
from llava_align_tpu.models import blip as jb
from llava_align_tpu.models import blip_variants as jv
from llava_align_tpu_torch.models import blip as tb
from llava_align_tpu_torch.models import blip_variants as tv
from llava_align_tpu_torch.utils.jax_params import from_jax_params
from test_torch_lavis_blip import _t, setup


@pytest.fixture(scope="module")
def ref():
    cfg, trees, queue, data, J = setup()

    def pretrain_lm(r):
        # blip_variants.pretrain_step's LM lines, on the retrieval tree's image
        enc = jb.vit_forward(r["visual"], cfg.vision, J["pix"])
        targets = jnp.where(J["dec_ids"] == 0, -100, J["dec_ids"])
        h = jb.med_forward(r["decoder"], cfg.text, J["dec_ids"], J["mask"], encoder_states=enc,
                           encoder_mask=jnp.ones(enc.shape[:2], jnp.int32), causal=True)
        per = jv._lm_loss_per_sample(jb.med_logits(r["decoder"], h), targets, 0.1)
        return per.sum() / jnp.maximum((targets[:, 1:] != -100).sum(), 1)

    def ret_step(r, queue):
        def loss(params):
            losses, m2, s2 = jv.retrieval_train_step(params, r, queue, cfg, jax.random.PRNGKey(7), J["pix"], J["ids"],
                                                     J["enc_ids"], J["mask"], J["idx"])
            return losses["loss"], (losses, m2, s2)

        return jax.value_and_grad(loss, has_aux=True)(r)

    out = run_all({"ret": (recording_draws(jv, ret_step), trees["ret"], queue),
                   "loss_lm": (pretrain_lm, trees["ret"])})
    ((_, (losses, m2, s2)), grads), draws = out["ret"]
    want = {"ret": (losses, m2, s2, grads, draws), "loss_lm": out["loss_lm"]}
    return want, trees, queue, data


def test_retrieval_and_pretrain_steps_match_jax(ref):
    """retrieval_train_step's loss, gradient, momentum tree and queue state
    after the step (the JAX draws handed in); pretrain_step on the same
    draws: the retrieval losses plus the LM loss."""
    want, trees, queue, data = ref
    cfg = tb.BlipConfig.tiny()
    d = _t(data)
    w_losses, w_m, w_s, w_grads, draws = want["ret"]
    m = from_jax_params(trees["ret"], device="cpu")
    q = from_jax_params(queue, device="cpu")
    out, grads = port_grads(lambda p: tv.retrieval_train_step(p, m, q, cfg, None, d["pix"], d["ids"], d["enc_ids"],
                                                              d["mask"], d["idx"], neg_idx=draws),
                            from_jax_params(trees["ret"], device="cpu"))
    losses, m2, s2 = out
    for k, v in w_losses.items():
        close(losses[k], v, k, rtol=1e-6, atol=0)
    grads_close(grads, w_grads, "retrieval_train_step")
    for what, got_tree, want_tree in (("momentum", m2, w_m), ("queue", s2, w_s)):
        for i, (a, b) in enumerate(zip(leaves(got_tree), leaves(want_tree))):
            close(a.float(), np.asarray(b, np.float32), f"{what} leaf {i}")
    pre = tv.pretrain_step(from_jax_params(trees["ret"], device="cpu"), from_jax_params(trees["ret"], device="cpu"),
                           from_jax_params(queue, device="cpu"), cfg, None, d["pix"], d["ids"], d["enc_ids"],
                           d["dec_ids"], d["mask"], d["idx"], neg_idx=draws)[0]
    for k in ("loss_itc", "loss_itm"):
        close(pre[k], w_losses[k], k, rtol=1e-6, atol=0)
    close(pre["loss_lm"], want["loss_lm"], "loss_lm", rtol=1e-6, atol=0)
    close(pre["loss"], float(w_losses["loss"]) + float(want["loss_lm"]), "loss", rtol=1e-6, atol=0)
