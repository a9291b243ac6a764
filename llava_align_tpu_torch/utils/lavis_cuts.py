"""The LAVIS zoo's families (ALPRO's TimeSformer, GPT-2 dialogue, PnP-VQA
and BLIP-Diffusion too) cut to 2 layers per tower at full width, fp32,
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
         "blip2_t5", "alpro", "gpt_dialogue", "pnp_vqa", "blip_diffusion")


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


def linear_unet(width: int, seed: int = 0) -> Callable:
    """A linear stand-in for BLIP-Diffusion's UNet (the reference takes
    diffusers'): unet(latents [B, 4, h, w], t [B], cond [B, S, width]) =
    0.2 latents + the mean of cond through a fixed [width, 4] matrix + 1e-3 t."""
    W = torch.randn((width, 4), generator=torch.Generator().manual_seed(seed)) / width**0.5

    def unet(x, t, cond):
        ctx = torch.einsum("bsd,dc->bc", cond, W.to(cond.device)) / cond.shape[1]
        return 0.2 * x + ctx[:, :, None, None] + 1e-3 * t.float()[:, None, None, None]

    return unet


def _unit(*parts: torch.Tensor) -> torch.Tensor:
    """The parts flattened, each divided by its largest magnitude, and
    concatenated: one vector whose error reads relative to each part."""
    return torch.cat([x.flatten() / x.abs().max() for x in parts])


def cut_cases() -> Dict[str, Tuple[str, dict, Callable]]:
    """name → (what, params on the CPU, fn(params, device) → a loss, or
    logits for BLIP's itm_score, or a vector of parts each scaled to its
    largest for PnP-VQA and BLIP-Diffusion) for each of NAMES, batch 2."""
    from llava_align_tpu_torch.models import (albef, alpro, blip, blip2, blip_diffusion, blip_variants, clip, gpt2,
                                              pnp_vqa, t5)
    from llava_align_tpu_torch.utils.synthetic import build_random_t5_params

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
    v = two_layers(alpro.AlproConfig(), video={}, text={"fusion_layer": 1})
    vp = alpro.init(v, "retrieval", device="cpu", seed=10)
    video = torch.randn((B, 3, v.video.num_frames, v.video.image_size, v.video.image_size), generator=g)
    cases["alpro"] = ("ALPRO (TimeSformer) retrieval_train_step", vp, lambda p, d: alpro.retrieval_train_step(
        p, v, None, video.to(d), ids.to(d), mask.to(d), neg_idx=([1, 0], [1, 0]))["loss"])
    gc = dataclasses.replace(gpt2.GptDialogueConfig(), gpt=dataclasses.replace(gpt2.Gpt2Config(), num_layers=2))
    gp = gpt2.dialogue_init(gc, device="cpu", seed=11)
    fts = torch.randn((B, 8, gc.len_video_ft), generator=g)
    labels = torch.cat([torch.full((B, 8), -1), ids], dim=1)
    cases["gpt_dialogue"] = ("GPT-2 dialogue_forward", gp, lambda p, d: gpt2.dialogue_forward(
        p, gc, ids.to(d), fts.to(d), torch.cat([torch.ones((B, 8), dtype=mask.dtype), mask], 1).to(d),
        labels=labels.to(d))["loss"])
    # PnP-VQA: the GradCAM row of its ITM model (at block 0: at the last of
    # 2 only the cls row, which GradCAM skips, has a gradient), then the FiD
    # reader's logits (3 contexts encoded apart, fused, one teacher-forced decode)
    pc = pnp_vqa.PnpVqaConfig(itm=b, cap=b, qa=dataclasses.replace(t5.T5Config(), num_layers=2, num_decoder_layers=2,
                                                                   **f32), block_num=0)
    pp = {"itm": blip.init(b, device="cpu", seed=12), "qa": build_random_t5_params(pc.qa, device="cpu", seed=13)}
    ctx_ids = torch.randint(0, pc.qa.vocab_size, (3, 16), generator=g)
    ctx_mask = torch.ones_like(ctx_ids)
    ctx_mask[2, 10:] = 0
    dec_ids = torch.randint(0, pc.qa.vocab_size, (1, 4), generator=g)
    dec_ids[0, 0] = 0

    def fid_logits(q, d):
        enc = t5.encode(q, pc.qa, t5.embed_tokens(q, ctx_ids.to(d)), ctx_mask.to(d))
        return t5.decode(q, pc.qa, dec_ids.to(d), enc.reshape(1, -1, enc.shape[-1]), ctx_mask.to(d).reshape(1, -1))

    cases["pnp_vqa"] = ("PnP-VQA forward_itm GradCAM + FiD logits", pp, lambda p, d: _unit(
        pnp_vqa.forward_itm(p, pc, xb.to(d), ids.to(d), mask.to(d)), fid_logits(p["qa"], d)))
    # BLIP-Diffusion: the subject embedding, the ctx-spliced prompt
    # embedding, and the training loss at fixed noise and timesteps
    full = blip_diffusion.BlipDiffusionConfig()
    dc = dataclasses.replace(full, vision=dataclasses.replace(full.vision, num_layers=2),
                             qformer=dataclasses.replace(full.qformer, num_layers=2),
                             text=two_layers(full.text, vision={}, text={}))
    dp = blip_diffusion.init(dc, device="cpu", seed=14)
    xd = pix(dc.vision.image_size)
    prompt = torch.randint(1, dc.text.text.vocab_size, (B, 16), generator=g)
    latents, noise = torch.randn((B, 4, 16, 16), generator=g), torch.randn((B, 4, 16, 16), generator=g)
    unet, steps = linear_unet(dc.text.text.width, seed=15), torch.tensor([10, 900])

    def diffusion(p, d):
        subject = (xd.to(d), ids.to(d), mask.to(d))
        ctx = blip_diffusion.ctx_embeddings(p, dc, *subject)
        cond = blip_diffusion.encode_prompt_ctx(p, dc, prompt.to(d), ctx)
        loss = blip_diffusion.train_loss(p, dc, None, latents.to(d), prompt.to(d), *subject, unet,
                                         noise=noise.to(d), timesteps=steps.to(d))
        return torch.cat([_unit(ctx, cond), loss.reshape(1)])

    cases["blip_diffusion"] = ("BLIP-Diffusion ctx_embeddings + encode_prompt_ctx + train_loss", dp, diffusion)
    assert tuple(cases) == NAMES
    return cases
