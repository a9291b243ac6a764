"""BLIP-Diffusion: subject-driven text-to-image generation (torch twin of
llava_align_tpu/models/blip_diffusion.py; SchedulerConfig, ddim_timesteps
and build_prompt are copies, tests/test_torch_copies.py holds them to the
original's source).

Capability parity: the reference's vendored LAVIS BlipDiffusion
(lavis/models/blip_diffusion_models/blip_diffusion.py +
modeling_ctx_clip.py). The reference delegates the generative stack to the
external `diffusers` library (UNet2DConditionModel, AutoencoderKL, the
DDPM / DDIM schedulers); as in the JAX package, the UNet and the VAE are
the caller's callables, here torch functions `unet_apply(latents, t,
text_embeddings) -> noise_pred` and `vae_decode(latents) -> images`. What
the reference implements itself is here:

  * the subject embedding: BLIP-2 Q-Former multimodal features of the
    (subject image, subject text) pair through ProjLayer
    (forward_ctx_embeddings :878-915, ProjLayer :38-56);
  * CtxCLIPTextModel: the CLIP text encoder with the ctx embeddings
    spliced into the token embeddings at ctx_begin_pos before the causal
    stack (modeling_ctx_clip.py:181-240);
  * the DDPM training loss: the latents noised at a random timestep on the
    Stable-Diffusion scaled-linear schedule, MSE on the noise (forward
    :224-264), its gradient by autograd;
  * the DDIM loop with classifier-free guidance (generate :473-560);
  * prompt amplification (_build_prompt :291-298).

The schedule is the JAX package's float64 numpy table cast to float32, and
ddim_step reads it into Python floats, so both packages compute with the
same constants. The draws (the training noise and timesteps, the initial
latents) come from the caller's torch.Generator, or as keywords (`noise=`,
`timesteps=`, `latents=`; the tests hand in JAX's). The prompt-to-prompt
controllers (models/ptp.py) run on the host, on numpy probabilities that a
torch UNet hands them at its attention sites.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from llava_align_tpu_torch.config import ClipVisionConfig
from llava_align_tpu_torch.models import clip as clip_mod
from llava_align_tpu_torch.models import clip_vit, qformer
from llava_align_tpu_torch.models.clip import ClipConfig
from llava_align_tpu_torch.models.qformer import QFormerConfig
from llava_align_tpu_torch.ops.layers import layer_norm, linear_bias, quick_gelu
from llava_align_tpu_torch.utils.synthetic import normal_init, random_clip_vision, resolve_device

Params = Dict[str, Any]
UnetApply = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Stable-Diffusion DDPM schedule (scaled-linear betas)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    # SD-v1.5 scheduler config values (the reference's DDIMScheduler
    # .from_config('runwayml/stable-diffusion-v1-5')): inference timesteps
    # are shifted +1 and the last denoise targets ᾱ[0], not 1.0
    steps_offset: int = 1
    set_alpha_to_one: bool = False

    def alphas_cumprod(self) -> np.ndarray:
        betas = (
            np.linspace(
                self.beta_start**0.5, self.beta_end**0.5,
                self.num_train_timesteps, dtype=np.float64,
            )
            ** 2
        )
        return np.cumprod(1.0 - betas).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class BlipDiffusionConfig:
    vision: ClipVisionConfig = dataclasses.field(default_factory=lambda: ClipVisionConfig(
        image_size=224, patch_size=14, hidden_size=1024, intermediate_size=4096, num_layers=24, num_heads=16,
        select_layer=-1, select_feature="cls_patch", dtype=torch.float32))
    qformer: QFormerConfig = dataclasses.field(default_factory=lambda: QFormerConfig(
        encoder_width=1024, cross_attention_freq=1, query_length=16, dtype=torch.float32))
    text: ClipConfig = dataclasses.field(default_factory=lambda: ClipConfig(
        text=clip_mod.ClipTextConfig(width=768, num_heads=12, num_layers=12), embed_dim=768))
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    proj_hidden: int = 3072
    ctx_begin_pos: int = 2          # blip_diffusion.py _CTX_BEGIN_POS
    latent_scale: float = 0.18215   # SD VAE scaling (forward :226)

    @staticmethod
    def tiny(vocab_size: int = 64) -> "BlipDiffusionConfig":
        return BlipDiffusionConfig(
            vision=ClipVisionConfig(image_size=32, patch_size=16, hidden_size=32, intermediate_size=64,
                                    num_layers=2, num_heads=4, select_layer=-1, select_feature="cls_patch",
                                    dtype=torch.float32),
            # ProjLayer is residual: the Q-Former's width must equal the text width
            qformer=QFormerConfig(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                                  max_position_embeddings=64, encoder_width=32, cross_attention_freq=1,
                                  query_length=4, dtype=torch.float32),
            text=ClipConfig.tiny(vocab_size),
            scheduler=SchedulerConfig(num_train_timesteps=50),
            proj_hidden=64,
        )


def init(cfg: BlipDiffusionConfig, device=None, seed: int = 0) -> Params:
    """Random params with the JAX init's tree and scales on `device` (the
    GPU unless another is named), each tower from its own seed: the CLIP
    ViT, the Q-Former, its query tokens (N(0, 0.02)), the CLIP model whose
    text tower encodes the prompt, and ProjLayer (N(0, 1/fan_in) kernels,
    zero biases, a unit LayerNorm)."""
    device = resolve_device(device)
    w = normal_init(torch.Generator(device=device).manual_seed(seed + 3), device)
    qd, td, ph = cfg.qformer.hidden_size, cfg.text.text.width, cfg.proj_hidden

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    return {
        "visual": random_clip_vision(cfg.vision, device,
                                     normal_init(torch.Generator(device=device).manual_seed(seed), device)),
        "qformer": qformer.init(cfg.qformer, device=device, seed=seed + 1),
        "query_tokens": w((1, cfg.qformer.query_length, qd), 1, torch.float32) * 0.02,
        "text": clip_mod.init(cfg.text, device=device, seed=seed + 2),
        "proj": {"ln": {"scale": torch.ones((qd,), dtype=torch.float32, device=device), "bias": zeros(qd)},
                 "fc1": {"w": w((ph, qd), qd, torch.float32), "b": zeros(ph)},
                 "fc2": {"w": w((td, ph), ph, torch.float32), "b": zeros(td)}},
    }


def proj_layer(params_proj: Params, x: torch.Tensor) -> torch.Tensor:
    """LN (eps 1e-12) → dense1 → QuickGELU → dense2 → dropout(0) → +residual
    (:50-56)."""
    h = layer_norm(x, params_proj["ln"]["scale"], params_proj["ln"]["bias"], 1e-12)
    return linear_bias(quick_gelu(linear_bias(h, params_proj["fc1"])), params_proj["fc2"]) + x


def ctx_embeddings(params: Params, cfg: BlipDiffusionConfig, subject_pixels: torch.Tensor,
                   subject_ids: torch.Tensor, subject_mask: torch.Tensor) -> torch.Tensor:
    """Q-Former multimodal features of the subject pair (pixels [B, 3, H, W],
    BERT ids and mask [B, T]) → ProjLayer (forward_ctx_embeddings
    :878-886) → [B, Q, text width]."""
    img = clip_vit.forward_features(params["visual"], cfg.vision, subject_pixels)
    B = img.shape[0]
    queries = params["query_tokens"].expand(B, *params["query_tokens"].shape[1:])
    out = qformer.forward(params["qformer"], cfg.qformer, queries, img, text_ids=subject_ids,
                          text_mask=subject_mask)
    return proj_layer(params["proj"], out[:, : cfg.qformer.query_length])


def encode_prompt_ctx(params: Params, cfg: BlipDiffusionConfig, prompt_ids: torch.Tensor,
                      ctx: Optional[torch.Tensor] = None, *, ctx_begin_pos: Optional[int] = None) -> torch.Tensor:
    """CtxCLIPTextModel: the ctx embeddings [B, Q, D] (None: unconditional)
    spliced into the token embeddings of prompt_ids [B, S] at
    ctx_begin_pos, positions over the extended length, then the causal
    CLIP stack (modeling_ctx_clip.py:196-240) → the last hidden [B, S(+Q), D].
    The prompt and its queries must fit the positional table (77 for
    CLIP): callers tokenize prompts to 77 − Q tokens."""
    p = params["text"]
    cbp = cfg.ctx_begin_pos if ctx_begin_pos is None else ctx_begin_pos
    tok = p["token_embedding"][prompt_ids.long()]
    if ctx is not None:
        tok = torch.cat([tok[:, :cbp], ctx.to(tok.dtype), tok[:, cbp:]], dim=1)
    emb = tok + p["positional_embedding"][: tok.shape[1]]
    return clip_mod.text_transformer(p, cfg.text, emb)


def add_noise(cfg: BlipDiffusionConfig, latents: torch.Tensor, noise: torch.Tensor,
              timesteps: torch.Tensor) -> torch.Tensor:
    """DDPM q(x_t | x_0) on the SD scaled-linear schedule:
    √ᾱ_t·x + √(1-ᾱ_t)·ε (ops/noise.py's closed form, another β schedule)."""
    acp = torch.from_numpy(cfg.scheduler.alphas_cumprod()).to(latents.device)[timesteps.long()]
    while acp.ndim < latents.ndim:
        acp = acp[..., None]
    return torch.sqrt(acp) * latents + torch.sqrt(1.0 - acp) * noise


def train_loss(params: Params, cfg: BlipDiffusionConfig, generator: Optional[torch.Generator],
               latents: torch.Tensor, prompt_ids: torch.Tensor, subject_pixels: torch.Tensor,
               subject_ids: torch.Tensor, subject_mask: torch.Tensor, unet_apply: UnetApply, *,
               noise: Optional[torch.Tensor] = None, timesteps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference forward (:224-264): scale the VAE latents [B, C, h, w],
    noise them at a uniform random timestep, condition the UNet on the
    ctx-CLIP prompt embedding, MSE on the noise. `noise` and `timesteps`
    [B] replace the draws from `generator`; the gradient is autograd's."""
    x0 = latents * cfg.latent_scale
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
    if timesteps is None:
        timesteps = torch.randint(0, cfg.scheduler.num_train_timesteps, (x0.shape[0],), generator=generator,
                                  device=x0.device)
    noisy = add_noise(cfg, x0, noise, timesteps)
    ctx = ctx_embeddings(params, cfg, subject_pixels, subject_ids, subject_mask)
    pred = unet_apply(noisy, timesteps, encode_prompt_ctx(params, cfg, prompt_ids, ctx))
    return torch.mean((pred.float() - noise.float()) ** 2)


def ddim_timesteps(cfg: BlipDiffusionConfig, num_inference_steps: int) -> np.ndarray:
    """The reference samples with DDIMScheduler.from_config('runwayml/
    stable-diffusion-v1-5') (blip_diffusion.py:186-191) whose config carries
    steps_offset=1: 50 steps visit t=981..1, NOT 980..0."""
    T = cfg.scheduler.num_train_timesteps
    step = T // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * step).round()[::-1].astype(np.int64)
    return ts + cfg.scheduler.steps_offset


def ddim_step(cfg: BlipDiffusionConfig, latents: torch.Tensor, noise_pred: torch.Tensor, t: int,
              t_prev: int) -> torch.Tensor:
    """Deterministic DDIM (η=0): x₀ = (x_t − √(1−ᾱ_t)ε)/√ᾱ_t;
    x_{t-1} = √ᾱ_prev·x₀ + √(1−ᾱ_prev)·ε, the ᾱ read as Python floats from
    the numpy table. The final step (t_prev < 0) uses ᾱ[0] ≈ 0.99915, not
    1.0: the SD-v1.5 DDIM config is set_alpha_to_one=False."""
    acp = cfg.scheduler.alphas_cumprod()
    if t_prev >= 0:
        a_prev = float(acp[t_prev])
    else:
        a_prev = 1.0 if cfg.scheduler.set_alpha_to_one else float(acp[0])
    a_t = float(acp[t])
    x0 = (latents - (1.0 - a_t) ** 0.5 * noise_pred) / a_t**0.5
    return a_prev**0.5 * x0 + (1.0 - a_prev) ** 0.5 * noise_pred


@torch.no_grad()
def generate(params: Params, cfg: BlipDiffusionConfig, generator: Optional[torch.Generator],
             prompt_ids: torch.Tensor, neg_prompt_ids: torch.Tensor, subject_pixels: torch.Tensor,
             subject_ids: torch.Tensor, subject_mask: torch.Tensor, unet_apply: UnetApply, *,
             latent_shape: Tuple[int, ...] = (1, 4, 64, 64), guidance_scale: float = 7.5,
             num_inference_steps: int = 50, latents: Optional[torch.Tensor] = None,
             vae_decode: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """The reference generate (:473-560): the ctx-conditioned prompt
    embedding (prompt_ids [1, S], amplified), the unconditional one
    without ctx (neg_prompt_ids), classifier-free guidance, DDIM
    denoising from `latents` (else drawn from `generator`) → the decoded
    images when `vae_decode` is given, else the final latents, unscaled."""
    ctx = ctx_embeddings(params, cfg, subject_pixels, subject_ids, subject_mask)
    cond = encode_prompt_ctx(params, cfg, prompt_ids, ctx)
    do_cfg = guidance_scale > 1.0
    if do_cfg:
        uncond = encode_prompt_ctx(params, cfg, neg_prompt_ids, None)
    dev = cond.device
    if latents is None:
        latents = torch.randn(latent_shape, generator=generator, device=dev, dtype=torch.float32)
    ts = ddim_timesteps(cfg, num_inference_steps)
    for i, t in enumerate(ts):
        t_arr = torch.full((latents.shape[0],), int(t), dtype=torch.long, device=dev)
        noise_c = unet_apply(latents, t_arr, cond)
        if do_cfg:
            noise_u = unet_apply(latents, t_arr, uncond)
            noise = noise_u + guidance_scale * (noise_c - noise_u)
        else:
            noise = noise_c
        t_prev = int(ts[i + 1]) if i + 1 < len(ts) else -1
        latents = ddim_step(cfg, latents, noise, int(t), t_prev)
    latents = latents / cfg.latent_scale
    return vae_decode(latents) if vae_decode is not None else latents


def build_prompt(
    prompts: Sequence[str], tgt_subjects: Sequence[str],
    *,
    prompt_strength: float = 1.0, prompt_reps: int = 20,
) -> List[str]:
    """Prompt amplification (:291-298): 'a {subject} {prompt}' repeated
    prompt_strength·prompt_reps times, comma-joined."""
    out = []
    for prompt, subject in zip(prompts, tgt_subjects):
        p = f"a {subject} {prompt.strip()}"
        out.append(", ".join([p] * int(prompt_strength * prompt_reps)))
    return out
