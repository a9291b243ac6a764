"""The LAVIS zoo's families cut to 2 layers per tower at full width, fp32,
random from a seed: the same params and inputs go through each family on
the card and on the CPU (chip_smoke.py's LAVIS reference phase and
tests/test_torch_cuda.py take their cases from here).

    cases = cut_cases()
    what, params, fn = cases["clip"]
    fn(params, torch.device("cpu")), fn(tree_to(params, "cuda"), "cuda")
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

NAMES = ("albef", "albef_classification", "blip_classification", "blip", "clip", "blip2_stage1", "blip2_opt",
         "blip2_t5")


def tree_to(tree, device):
    """A copy of the tree (dicts, lists, None) on `device`."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return None if tree is None else tree.to(device, copy=True)


def two_layers(cfg, **parts):
    """cfg with each named tower at 2 layers and the given overrides."""
    return dataclasses.replace(cfg, **{k: dataclasses.replace(getattr(cfg, k), num_layers=2, **kw)
                                       for k, kw in parts.items()})


def cut_cases() -> Dict[str, Tuple[str, dict, Callable]]:
    """name → (what, params on the CPU, fn(params, device) → a loss, or
    logits for BLIP's itm_score) for each of NAMES, batch 2."""
    from llava_align_tpu_torch.models import albef, blip, blip2, blip_variants, clip

    g = torch.Generator().manual_seed(21)
    B, f32 = 2, {"dtype": torch.float32}
    ids = torch.randint(1000, 20000, (B, 16), generator=g)
    ids[:, 0] = 101
    mask = torch.ones_like(ids)
    mask[1, 12:] = 0

    def pix(size):
        return torch.randn((B, 3, size, size), generator=g)

    cases = {}
    a = two_layers(albef.AlbefConfig(num_classes=3, queue_size=256), vision={}, text={"fusion_layer": 1})
    ap, xa = albef.init(a, "retrieval", device="cpu", seed=1), pix(a.vision.image_size)
    queue = albef.init_queue_state(a, torch.Generator().manual_seed(2), device="cpu")
    # the momentum tree and the queue are updated in place: each call takes copies
    cases["albef"] = ("ALBEF retrieval_train_step", ap, lambda p, d: albef.retrieval_train_step(
        p, tree_to(p, d), tree_to(queue, d), a, None, xa.to(d), ids.to(d), mask.to(d), torch.arange(B, device=d),
        neg_idx=([1, 0], [1, 0]))[0]["loss"])
    ac = albef.init(a, "classification", device="cpu", seed=3)
    cases["albef_classification"] = ("ALBEF classification_loss", ac, lambda p, d: albef.classification_loss(
        p, a, xa.to(d), ids.to(d), mask.to(d), torch.tensor([0, 2], device=d))[0])
    b = two_layers(blip.BlipConfig(), vision={}, text={})
    bc, xb = blip_variants.init_classification(b, 3, device="cpu", seed=4), pix(b.vision.image_size)
    cases["blip_classification"] = ("BLIP classification_loss", bc, lambda p, d: blip_variants.classification_loss(
        p, b, xb.to(d), ids.to(d), mask.to(d), torch.tensor([1, 2], device=d))[0])
    bp = blip.init(b, device="cpu", seed=5)
    cases["blip"] = ("BLIP itm_score", bp, lambda p, d: blip.itm_score(p, b, xb.to(d), ids.to(d), mask.to(d)))
    c = two_layers(clip.ClipConfig(), vision={}, text={})
    cp, xc = clip.init(c, device="cpu", seed=6), pix(c.vision.image_size)
    cids = torch.randint(1, c.text.vocab_size, (B, c.text.context_length), generator=g)
    cases["clip"] = ("CLIP contrastive_loss", cp, lambda p, d: clip.contrastive_loss(p, c, xc.to(d),
                                                                                      cids.to(d))["loss"])
    s = two_layers(blip2.Blip2QformerConfig(), vision=f32, qformer=f32)
    sp_, xs = blip2.init_stage1(s, device="cpu", seed=7), pix(s.vision.image_size)
    cases["blip2_stage1"] = ("BLIP-2 stage-1 pretrain_forward", sp_, lambda p, d: blip2.pretrain_forward(
        p, s, xs.to(d), ids.to(d) % s.qformer.vocab_size, mask.to(d), bos_token_id=101, pad_token_id=0,
        neg_idx=([1, 0], [1, 0]))["loss"])
    o = two_layers(blip2.Blip2OptConfig(), vision=f32, qformer=f32, text=f32)
    op = blip2.init_opt(o, device="cpu", seed=8)
    cases["blip2_opt"] = ("BLIP-2 OPT opt_forward_loss", op, lambda p, d: blip2.opt_forward_loss(
        p, o, xs.to(d), ids.to(d) % o.text.vocab_size, mask.to(d), pad_token_id=0))
    t = two_layers(blip2.Blip2T5Config(), vision=f32, qformer=f32, text={**f32, "num_decoder_layers": 2})
    tp = blip2.init_t5(t, device="cpu", seed=9)
    cases["blip2_t5"] = ("BLIP-2 T5 t5_forward_loss", tp, lambda p, d: blip2.t5_forward_loss(
        p, t, xs.to(d), ids.to(d) % t.text.vocab_size, mask.to(d), ids.to(d).flip(1) % t.text.vocab_size,
        mask.to(d)))
    assert tuple(cases) == NAMES
    return cases
