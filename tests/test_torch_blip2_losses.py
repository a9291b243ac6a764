"""BLIP-2's training losses in the port (models/blip2.py pretrain_forward,
opt_forward_loss, t5_forward_loss, _ce_label_smooth, _ce_mean_ignore)
against the JAX package's, on the CPU: each loss and its gradient over
every leaf, from the same numpy tree (the port's own init, carried into
both) and the same seeded inputs. The JAX side is one compiled program per loss
(tests/lavis_ref.run_all), built once for the module.

The towers the losses start from are held elsewhere (eva_vit, qformer,
encode_image_queries: tests/test_torch_blip2.py), so the JAX programs take
their bypasses: stage 1 its `image_embeds` (ln_vision states), OPT and T5
their `q_emb`, and stage 1 runs a 1-layer Q-Former (the tiny config's
first layer, the one with cross-attention), which keeps the compile
short. The port's `images` path is held to its bypass on the port
side. pretrain_forward takes its hard negatives as `neg_idx` on both sides
(the JAX function's own test seam), in both ITC forms (label smoothing;
image_ids soft targets); the stage-1 tree's MLM decoder is an untied copy
on both sides. Also: the zoo's stage-1 and LM entries build and run their
forward. Tolerances: losses within 1e-6, gradients within 1e-5 of the
largest.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavis_ref import grads_close, np_tree, port_grads, run_all
from llava_align_tpu.models import blip2 as jb2
from llava_align_tpu_torch.models import blip2 as tb2
from llava_align_tpu_torch.utils.jax_params import from_jax_params

B, T = 3, 6
NEG = (np.array([2, 0, 1], np.int32), np.array([1, 2, 0], np.int32))
IMAGE_IDS = np.array([5, 5, 7], np.int32)


def text(seed: int, vocab: int):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, 4:] = 0
    ids[1, 4:] = 0  # padding (pad id 0)
    return ids, mask


def stage1_cfg(mod):
    cfg = mod.Blip2QformerConfig.tiny()
    return dataclasses.replace(cfg, qformer=dataclasses.replace(cfg.qformer, num_layers=1))


@pytest.fixture(scope="module")
def cases():
    """name → (JAX loss[, grads]); the trees and the inputs."""
    s_cfg, o_cfg, t_cfg = stage1_cfg(jb2), jb2.Blip2OptConfig.tiny(), jb2.Blip2T5Config.tiny()
    trees = {"stage1": np_tree(tb2.init_stage1(stage1_cfg(tb2), device="cpu", seed=3)),
             "opt": np_tree(tb2.init_opt(tb2.Blip2OptConfig.tiny(), device="cpu", seed=4)),
             "t5": np_tree(tb2.init_t5(tb2.Blip2T5Config.tiny(), device="cpu", seed=5))}
    rng = np.random.default_rng(9)
    data = {"stage1": (rng.standard_normal((B, s_cfg.vision.num_patches + 1, s_cfg.vision.width)).astype(np.float32),
                       *text(0, s_cfg.qformer.vocab_size)),
            "opt": (rng.standard_normal((B, 4, o_cfg.text.hidden_size)).astype(np.float32),
                    *text(1, o_cfg.text.vocab_size)),
            "t5": (rng.standard_normal((B, 4, t_cfg.text.d_model)).astype(np.float32), *text(2, t_cfg.text.vocab_size),
                   *text(3, t_cfg.text.vocab_size), rng.standard_normal((B, 2, t_cfg.text.d_model)).astype(np.float32))}
    J = {k: tuple(map(jnp.asarray, v)) for k, v in data.items()}

    def stage1(p, **kw):
        emb, ids, mask = J["stage1"]
        return jb2.pretrain_forward(p, s_cfg, None, ids, mask, bos_token_id=1, pad_token_id=0, neg_idx=NEG,
                                    image_embeds=emb, **kw)

    q, ids, mask = J["opt"]
    qt, i_ids, i_mask, o_ids, o_mask, fs = J["t5"]
    want = run_all({
        "stage1": (jax.value_and_grad(lambda p: stage1(p)["loss"]), trees["stage1"]),
        "stage1_ids": (lambda p: stage1(p, image_ids=jnp.asarray(IMAGE_IDS)), trees["stage1"]),
        "opt": (jax.value_and_grad(lambda p: jb2.opt_forward_loss(
            p, o_cfg, None, ids, mask, pad_token_id=0, prompt_length=2, q_emb=q)), trees["opt"]),
        "t5": (jax.value_and_grad(lambda p: jb2.t5_forward_loss(
            p, t_cfg, None, i_ids, i_mask, o_ids, o_mask, pad_token_id=0, decoder_start_token_id=0, q_emb=qt,
            few_shot_embeds=fs)), trees["t5"]),
    })
    return want, trees, data


def _port(name: str, tree, data, **kw):
    T_ = torch.from_numpy
    if name == "stage1":
        emb, ids, mask = data
        return tb2.pretrain_forward(tree, stage1_cfg(tb2), None, T_(ids), T_(mask), bos_token_id=1, pad_token_id=0,
                                    neg_idx=NEG, image_embeds=T_(emb), **kw)
    if name == "opt":
        q, ids, mask = data
        return tb2.opt_forward_loss(tree, tb2.Blip2OptConfig.tiny(), None, T_(ids), T_(mask), pad_token_id=0,
                                    prompt_length=2, q_emb=T_(q))
    q, i_ids, i_mask, o_ids, o_mask, fs = data
    return tb2.t5_forward_loss(tree, tb2.Blip2T5Config.tiny(), None, T_(i_ids), T_(i_mask), T_(o_ids), T_(o_mask),
                               pad_token_id=0, decoder_start_token_id=0, q_emb=T_(q), few_shot_embeds=T_(fs))


@pytest.mark.parametrize("name", ["stage1", "opt", "t5"])
def test_loss_and_gradient_match_jax(cases, name):
    want, trees, data = cases
    out, grads = port_grads(lambda t: _port(name, t, data[name]), from_jax_params(trees[name], device="cpu"))
    loss = out["loss"] if name == "stage1" else out
    w_loss, w_grads = want[name]
    np.testing.assert_allclose(float(loss.detach()), float(w_loss), rtol=1e-6, atol=0)
    grads_close(grads, w_grads, name)


def test_pretrain_forward_image_ids_and_images_path(cases):
    """The image_ids form (soft ITC targets, same-id negatives masked): each
    of the four losses as the JAX function's. And the images path: the same
    losses as passing vision_embeds(images) in, and sampled negatives give
    finite losses."""
    want, trees, data = cases
    tree = from_jax_params(trees["stage1"], device="cpu")
    got = _port("stage1", tree, data["stage1"], image_ids=torch.from_numpy(IMAGE_IDS))
    for k, v in want["stage1_ids"].items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-6, atol=0, err_msg=k)
    cfg = stage1_cfg(tb2)
    _, ids, mask = (torch.from_numpy(a) for a in data["stage1"])
    images = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, 3, cfg.vision.image_size, cfg.vision.image_size)).astype(np.float32))
    kw = dict(bos_token_id=1, pad_token_id=0, neg_idx=NEG)
    a = tb2.pretrain_forward(tree, cfg, images, ids, mask, **kw)
    b = tb2.pretrain_forward(tree, cfg, None, ids, mask, image_embeds=tb2.vision_embeds(tree, cfg, images), **kw)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    drawn = tb2.pretrain_forward(tree, cfg, images, ids, mask, bos_token_id=1, pad_token_id=0,
                                 generator=torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v) for v in drawn.values())


def inputs(seed: int, vocab: int, image_size: int):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((B, 3, image_size, image_size)).astype(np.float32)
    return (images, *text(seed, vocab))


@pytest.mark.parametrize("arch", ["blip2", "blip2_image_text_matching", "blip2_opt", "blip2_t5", "blip2_t5_instruct"])
def test_zoo_blip2_entries_forward(arch):
    from llava_align_tpu_torch.framework.model_zoo import load_model

    m = load_model(arch, device="cpu")
    cfg = m.cfg
    images = torch.from_numpy(inputs(0, 8, cfg.vision.image_size)[0])
    if arch in ("blip2", "blip2_image_text_matching"):
        _, ids, mask = inputs(1, cfg.qformer.vocab_size, cfg.vision.image_size)
        out = m.forward(images, torch.from_numpy(ids), torch.from_numpy(mask), bos_token_id=1, pad_token_id=0,
                        generator=torch.Generator().manual_seed(0)) if arch == "blip2" else \
            m.forward(images, torch.from_numpy(ids), torch.from_numpy(mask))
        value = out["loss"] if arch == "blip2" else out
    elif arch == "blip2_opt":
        _, ids, mask = inputs(1, cfg.text.vocab_size, cfg.vision.image_size)
        value = m.forward(images, torch.from_numpy(ids), torch.from_numpy(mask), pad_token_id=0)
    else:
        _, ids, mask = inputs(1, cfg.text.vocab_size, cfg.vision.image_size)
        value = m.forward(images, torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(ids),
                          torch.from_numpy(mask))
    assert torch.isfinite(value).all()
