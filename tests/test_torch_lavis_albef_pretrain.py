"""ALBEF's training steps in the port against the JAX package's, on the
CPU, at the tiny config, from the trees and inputs of
tests/test_torch_lavis_albef_clip.py.

pretrain_train_step (models/albef.py): its losses (ITC over the queue,
ITM with hard negatives, MLM), gradient, momentum tree and queue state
after the step, through the JAX function's own neg_idx / mlm_inputs seams.
alpha is 0, so the program skips the momentum MLM pass (mlm_loss's
distillation is held in tests/test_torch_lavis_albef_clip.py). Losses
within 1e-6 relative, gradients within 1e-5 of the largest.

The config CLI's albef_retrieval step under amp (runners/train.py): the
EMA on the fp32 masters, then retrieval_train_step on their bf16 cast with
an inner momentum of 1.0, the model in bf16. Its loss is held within 2e-2
of JAX's retrieval_train_step on the same rule (a bf16 config, the amp
cast of the trees and of the pixels; the JAX CLI cannot run it), its hard
negatives the JAX program's draws; the momentum tree after the step stays
fp32 and is 0.995·m + 0.005·p within 1e-6; the queue takes the step's
momentum features within 2e-2.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavis_ref import close, grads_close, leaves, np_tree, port_grads, recording_draws, run_all
from llava_align_tpu.framework.optims import amp_cast as jamp_cast
from llava_align_tpu.models import albef as ja
from llava_align_tpu_torch.framework import optims as toptims
from llava_align_tpu_torch.models import albef as ta
from llava_align_tpu_torch.runners import train as ttrain
from llava_align_tpu_torch.utils.jax_params import from_jax_params
from test_torch_lavis_albef_clip import NEG_IDX, _t, setup

IMAGE_ID = np.array([0, 1, 1], np.int32)


def _jax_with_dtype(cfg, dtype):
    """The JAX config with every nested `dtype` field set to dtype."""
    changes = {f.name: dtype if f.name == "dtype" else _jax_with_dtype(getattr(cfg, f.name), dtype)
               for f in dataclasses.fields(cfg)
               if f.name == "dtype" or dataclasses.is_dataclass(getattr(cfg, f.name))}
    return dataclasses.replace(cfg, **changes)


@pytest.fixture(scope="module")
def ref():
    (cfg, _), trees, data, J, _ = setup()

    def pretrain(t):
        p, q = t["pretrain"], t["queue"]

        def loss(params):
            losses, m2, s2 = ja.pretrain_train_step(params, p, q, cfg, jax.random.PRNGKey(0), J["pix"], J["ids"],
                                                    J["mask"], alpha=0.0, mlm_inputs=J["mlm_in"],
                                                    mlm_labels=J["mlm_labels"], neg_idx=NEG_IDX)
            return losses["loss"], (losses, m2, s2)

        return jax.value_and_grad(loss, has_aux=True)(p)

    trees["m"] = np_tree(ta.init(ta.AlbefConfig.tiny(num_classes=3), "retrieval", device="cpu", seed=11))
    bf16 = _jax_with_dtype(cfg, jnp.bfloat16)

    def amp_retrieval(t):
        m = ja.momentum_update(t["retrieval"], t["m"], 0.995)
        losses, _, s2 = ja.retrieval_train_step(jamp_cast(t["retrieval"]), jamp_cast(m), t["queue"], bf16,
                                                jax.random.PRNGKey(4), J["pix"].astype(jnp.bfloat16), J["ids"],
                                                J["mask"], jnp.asarray(IMAGE_ID), momentum=1.0)
        return losses, s2

    out = run_all({"pretrain": (pretrain, {k: trees[k] for k in ("pretrain", "queue")}),
                   "amp": (recording_draws(ja, amp_retrieval), {k: trees[k] for k in ("retrieval", "m", "queue")})})
    want = {}
    (_, want["pretrain"]), want["pretrain_grads"] = out["pretrain"]
    want["amp"] = out["amp"]
    return want, trees, data, None


def test_pretrain_train_step_matches_jax(ref):
    want, trees, data, _ = ref
    cfg, d = ta.AlbefConfig.tiny(num_classes=3), _t(data)
    w_losses, w_m, w_s = want["pretrain"]
    m = from_jax_params(trees["pretrain"], device="cpu")
    q = from_jax_params(trees["queue"], device="cpu")
    out, grads = port_grads(lambda p: ta.pretrain_train_step(
        p, m, q, cfg, None, d["pix"], d["ids"], d["mask"], alpha=0.0, mlm_inputs=d["mlm_in"],
        mlm_labels=d["mlm_labels"], neg_idx=NEG_IDX), from_jax_params(trees["pretrain"], device="cpu"))
    losses, m2, s2 = out
    for k, w in w_losses.items():
        close(losses[k], w, k, rtol=1e-6, atol=0)
    grads_close(grads, want["pretrain_grads"], "pretrain_train_step")
    for what, got, w in (("momentum", m2, w_m), ("queue", s2, w_s)):
        for i, (a, b) in enumerate(zip(leaves(got), leaves(w))):
            close(a, np.asarray(b, np.float32), f"{what} leaf {i}")




def test_amp_retrieval_step_matches_jax(ref, monkeypatch):
    """The CLI's albef_retrieval step under amp: its loss against JAX's
    retrieval_train_step on the amp rule, the fp32 EMA kept, the queue
    filled (the JAX program's hard negatives handed to the port's sampler)."""
    want, trees, data, _ = ref
    (w_losses, w_state), draws = want["amp"]
    picks = [torch.from_numpy(np.asarray(x).astype(np.int64)) for x in draws]
    monkeypatch.setattr(ta, "sample_hard_negative_indices", lambda generator, w: picks.pop(0))
    cfg = ta.AlbefConfig.tiny(num_classes=3)
    params = from_jax_params(trees["retrieval"], device="cpu")
    model = types.SimpleNamespace(cfg=cfg, params=params)
    tx = toptims.build_optimizer(init_lr=1e-3, max_steps=1, steps_per_epoch=1)
    step, init_state, _ = ttrain._make_train_step("albef_retrieval", model, tx, amp=True, device="cpu")
    ext = init_state(params)
    ext["m_params"] = from_jax_params(trees["m"], device="cpu")
    ext["queue"] = from_jax_params(trees["queue"], device="cpu")
    d = _t(data)
    batch = {"image": d["pix"], "text_ids": d["ids"], "text_mask": d["mask"], "image_id": torch.from_numpy(IMAGE_ID)}
    params, ext, loss = step(params, ext, batch)
    assert not picks  # both draws taken
    close(loss, w_losses["loss"], "amp retrieval loss", rtol=2e-2, atol=0)
    for i, (m, m0, p0) in enumerate(zip(leaves(ext["m_params"]), leaves(trees["m"]), leaves(trees["retrieval"]))):
        assert m.dtype == torch.float32, (i, m.dtype)
        close(m, np.float32(0.995) * m0 + np.float32(1 - 0.995) * p0, f"fp32 EMA leaf {i}", atol=1e-6)
    for i, (got, w) in enumerate(zip(leaves(ext["queue"]), leaves(w_state))):
        close(got.float(), np.asarray(w, np.float32), f"queue leaf {i}", atol=2e-2)
