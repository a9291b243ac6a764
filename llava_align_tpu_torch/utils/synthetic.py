"""Random-weight LLaVA and Qwen-VL params at real shapes (torch twin of
llava_align_tpu/utils/synthetic.py build_random_llava_params and
build_random_qwen_vl_params), LLaVA-MPT's (build_random_llava_mpt_params),
and the LLaMA, OPT, MPT and T5 decoders' trees alone
(build_random_llama_params / _opt_ / _mpt_ / _t5_params, which
models/instructblip.init and models/blip2's inits build on).

The tree and the init scales are those of the JAX package's llava.init (+
quantize_llama_params(fuse=True) for quant="int8", + bits=4 for "int4"); the
random numbers are not (parity tests carry JAX params over with
utils/jax_params instead). Quantized stacks are built layer by layer on the
device — each layer's weights are drawn in the model dtype, fused (q|k|v,
gate|up) and quantized — so the peak is the quantized total plus one layer
in float. int4 stacks use the largest group that packs every contraction
dim (128 at real widths); the lm_head stays int8.

The default device is the GPU: without one, building raises unless
device="cpu" is asked for. Qwen-VL follows qwen_vl.init the same way
(int8 quantizes the decoder as quantize_qwen_params(fuse=True) does, layer
by layer; the vision tower stays in its float dtype).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from llava_align_tpu_torch.models import projector
from llava_align_tpu_torch.models.qwen_vit import interpolate_pos_embed, sincos_2d_pos_embed
from llava_align_tpu_torch.ops.quant import (
    int4_auto_group,
    quantize_weight,
    quantize_weight_int4,
)


def resolve_device(device=None) -> torch.device:
    """The device to build on: the GPU unless the caller names another.
    Raises when the GPU is asked for (or defaulted to) and CUDA is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build on the CPU")
    return dev


def normal_init(generator: torch.Generator, device):
    """w(shape, fan_in, dtype): N(0, 1/fan_in) draws from `generator` on
    `device` (in fp32, then cast), the JAX inits' weight scale."""

    def w(shape, fan_in, dtype):
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (x / fan_in**0.5).to(dtype)

    return w


def build_random_llama_params(t, quant: str = "none", device=None, seed: int = 0) -> Dict[str, Any]:
    """The LLaMA decoder's tree alone (LlamaConfig `t`), as
    build_random_llava_params builds its 'llama' subtree."""
    device = resolve_device(device)
    return _random_llama(t, quant, device, normal_init(torch.Generator(device=device).manual_seed(seed), device))


def _random_llama(t, quant: str, device, w) -> Dict[str, Any]:
    if quant not in ("none", "int8", "int4"):
        raise NotImplementedError(f"quant={quant!r}: only none/int8/int4 are ported")

    def ones(shape, dtype):
        return torch.ones(shape, dtype=dtype, device=device)

    D, F, L, V, QD, KD, dt = (
        t.hidden_size, t.intermediate_size, t.num_layers, t.vocab_size, t.q_dim, t.kv_dim, t.dtype,
    )
    # name -> fused parts as (rows, fan_in); every part contracts over `cols`
    stacks = {
        "qkv": ([(QD, D), (KD, D), (KD, D)], D),
        "o": ([(D, QD)], QD),
        "gateup": ([(F, D), (F, D)], D),
        "down": ([(D, F)], F),
    }
    layers: Dict[str, Any] = {"attn_norm": ones((L, D), dt), "mlp_norm": ones((L, D), dt)}
    if quant in ("int8", "int4"):
        group = int4_auto_group(cols for _, cols in stacks.values())
        for name, (parts, cols) in stacks.items():
            O = sum(r for r, _ in parts)
            if quant == "int8":
                wq = {"q": torch.empty((L, O, cols), dtype=torch.int8, device=device),
                      "s": torch.empty((L, O), dtype=torch.float32, device=device)}
            else:
                wq = {"q4": torch.empty((L, cols // 2, O), dtype=torch.int8, device=device),
                      "gs": torch.empty((L, cols // group, O), dtype=torch.float32, device=device)}
            for li in range(L):
                wl = torch.cat([w((r, cols), f, dt) for r, f in parts])
                layer = quantize_weight(wl) if quant == "int8" else quantize_weight_int4(wl, group)
                for k, v in layer.items():
                    wq[k][li] = v
            layers[name] = wq
        lm_head = quantize_weight(w((V, D), D, dt))
    else:
        layers.update(
            q=w((L, QD, D), D, dt), k=w((L, KD, D), D, dt), v=w((L, KD, D), D, dt),
            o=w((L, D, QD), QD, dt), gate=w((L, F, D), D, dt), up=w((L, F, D), D, dt),
            down=w((L, D, F), F, dt),
        )
        lm_head = w((V, D), D, dt)
    return {"embed": w((V, D), D, dt), "layers": layers, "final_norm": ones((D,), dt), "lm_head": lm_head}


def build_random_llava_params(cfg, quant: str = "none", device=None, seed: int = 0) -> Dict[str, Any]:
    device = resolve_device(device)
    w = normal_init(torch.Generator(device=device).manual_seed(seed), device)
    llama = _random_llama(cfg.text, quant, device, w)
    vision, proj = _random_clip_projector(cfg, cfg.text.hidden_size, cfg.text.dtype, device, w)
    return {"llama": llama, "vision": vision, "projector": proj}


def _random_clip_projector(cfg, D: int, dt, device, w) -> tuple:
    """The CLIP tower (cfg.vision) and the cfg.mm_projector_type projector
    into width D, as llava.init draws them."""

    def ones(shape, dtype):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    vc = cfg.vision
    vD, vF, vL, P, vdt = vc.hidden_size, vc.intermediate_size, vc.num_layers, vc.patch_size, vc.dtype

    def ln(shape):
        return {"scale": ones(shape, vdt), "bias": zeros(shape, vdt)}

    def vlin(fan_in, out):
        return {"kernel": w((vL, fan_in, out), fan_in, vdt), "bias": zeros((vL, out), vdt)}

    vision = {
        "cls": w((vD,), vD, vdt),
        "patch_embed": w((P * P * 3, vD), P * P * 3, vdt),
        "pos_embed": w((1 + vc.num_patches, vD), vD, vdt),
        "pre_ln": ln((vD,)),
        "layers": {
            "ln1": ln((vL, vD)), "q": vlin(vD, vD), "k": vlin(vD, vD), "v": vlin(vD, vD),
            "o": vlin(vD, vD), "ln2": ln((vL, vD)), "fc1": vlin(vD, vF), "fc2": vlin(vF, vD),
        },
        "post_ln": ln((vD,)),
    }
    proj_layers = []
    for i in range(projector.num_layers(cfg.mm_projector_type)):
        fan_in = vD if i == 0 else D
        proj_layers.append({"kernel": w((fan_in, D), fan_in, dt), "bias": zeros((D,), dt)})
    return vision, {"layers": proj_layers}


def _draws(device, seed: int, w):
    """(device, w): w as given, else N(0, 1/fan_in) draws from a new
    generator seeded with `seed` on the resolved device."""
    device = resolve_device(device)
    return device, w or normal_init(torch.Generator(device=device).manual_seed(seed), device)


def build_random_opt_params(t, device=None, seed: int = 0) -> Dict[str, Any]:
    """models/opt's tree for OptConfig `t` (opt.init's scales: weights
    N(0, 1/fan_in), biases zeros, norms ones), drawn from a generator
    seeded with `seed`."""
    device, w = _draws(device, seed, None)
    D, F, L, V, dt = t.hidden_size, t.ffn_dim, t.num_layers, t.vocab_size, t.dtype

    def dense(out_d, in_d):
        return {"w": w((L, out_d, in_d), in_d, dt), "b": torch.zeros((L, out_d), dtype=dt, device=device)}

    def ln(shape):
        return {"scale": torch.ones(shape, dtype=dt, device=device), "bias": torch.zeros(shape, dtype=dt, device=device)}

    return {
        "embed_tokens": w((V, D), D, dt),
        "embed_positions": w((t.max_position_embeddings + 2, D), D, dt),
        "layers": {"attn_ln": ln((L, D)), "q": dense(D, D), "k": dense(D, D), "v": dense(D, D),
                   "out": dense(D, D), "ffn_ln": ln((L, D)), "fc1": dense(F, D), "fc2": dense(D, F)},
        "final_ln": ln((D,)),
    }


def build_random_mpt_params(t, device=None, seed: int = 0, w=None) -> Dict[str, Any]:
    """models/mpt's tree for MptConfig `t` (mpt.init's scales; q_ln/k_ln
    only under qk_ln), drawn by `w` (normal_init: build_random_llava_mpt_params's
    one generator) or from a generator seeded with `seed`."""
    device, w = _draws(device, seed, w)
    D, F, L, V, dt = t.d_model, t.ffn_dim, t.n_layers, t.vocab_size, t.dtype
    KV = t.kv_heads * t.head_dim

    def ln(shape):
        return {"scale": torch.ones(shape, dtype=dt, device=device), "bias": torch.zeros(shape, dtype=dt, device=device)}

    layers = {"norm_1": ln((L, D)), "wqkv": w((L, D + 2 * KV, D), D, dt), "out_proj": w((L, D, D), D, dt),
              "norm_2": ln((L, D)), "up_proj": w((L, F, D), D, dt), "down_proj": w((L, D, F), F, dt)}
    if t.qk_ln:
        layers["q_ln"], layers["k_ln"] = ln((L, D)), ln((L, KV))
    return {"wte": w((V, D), D, dt), "layers": layers, "norm_f": ln((D,))}


def build_random_t5_params(t, device=None, seed: int = 0) -> Dict[str, Any]:
    """models/t5's tree for T5Config `t` (t5.init's tree: linears and the
    relative-bias tables N(0, 1/fan_in), RMS scales ones; lm_head None when
    tied), drawn as build_random_opt_params draws. One departure from
    t5.init's scales: every attention's q is drawn at T5's own init scale,
    std (d_model * d_kv)^-0.5 (the reference's T5 _init_weights, which folds
    the 1/sqrt(d_kv) that its unscaled attention lacks into q). At t5.init's
    N(0, 1/d_model) the attention logits have a std of ~sqrt(d_kv) = 8, so
    peaked that a bf16 rounding of q.k moves a 2-layer cut's logits by
    ~1e-1 of their range against fp32, in either framework."""
    device, w = _draws(device, seed, None)
    D, I, F, V, dt = t.d_model, t.inner_dim, t.d_ff, t.vocab_size, t.dtype

    def lin(out_d, in_d):
        return w((out_d, in_d), in_d, dt)

    def attn():
        return {"q": w((I, D), D * t.d_kv, dt), "k": lin(I, D), "v": lin(I, D), "o": lin(D, I)}

    def ffn():
        if t.gated_act:
            return {"wi_0": lin(F, D), "wi_1": lin(F, D), "wo": lin(D, F)}
        return {"wi": lin(F, D), "wo": lin(D, F)}

    def ln():
        return torch.ones((D,), dtype=dt, device=device)

    NB = t.relative_attention_num_buckets
    return {
        "shared": lin(V, D),
        "encoder": {"rel_bias": lin(NB, t.num_heads),
                    "layers": [{"ln1": ln(), "attn": attn(), "ln2": ln(), "ffn": ffn()}
                               for _ in range(t.num_layers)],
                    "final_ln": ln()},
        "decoder": {"rel_bias": lin(NB, t.num_heads),
                    "layers": [{"ln1": ln(), "attn": attn(), "ln_x": ln(), "xattn": attn(), "ln2": ln(),
                                "ffn": ffn()} for _ in range(t.num_decoder_layers)],
                    "final_ln": ln()},
        "lm_head": None if t.tie_word_embeddings else lin(V, D),
    }


def build_random_llava_mpt_params(cfg, device=None, seed: int = 0) -> Dict[str, Any]:
    """{'mpt', 'vision', 'projector'} at cfg's shapes (models/llava_mpt.
    LlavaMptConfig; llava_mpt.init's tree), all drawn from one generator."""
    device, w = _draws(device, seed, None)
    vision, proj = _random_clip_projector(cfg, cfg.text.d_model, cfg.text.dtype, device, w)
    return {"mpt": build_random_mpt_params(cfg.text, device, w=w), "vision": vision, "projector": proj}


def build_random_qwen_vl_params(cfg, quant: str = "none", device=None, seed: int = 0) -> Dict[str, Any]:
    """{'qwen': decoder, 'visual': ViT + Resampler} at cfg's shapes
    (models/qwen_vl.QwenVLConfig), qwen_vl.init's tree and init scales:
    linears N(0, 1/fan_in) in the config's dtype, norms ones, biases zeros,
    the ViT's 256-entry position table and the Resampler's sin-cos tables
    interpolated to the patch grid. quant="int8" builds the fused int8
    decoder stacks (c_attn_w, attn_proj, w12 = w1 | w2, mlp_proj) and lm_head
    directly, one layer in float at a time; the vision tower stays float."""
    if quant not in ("none", "int8"):
        raise ValueError(f"build_random_qwen_vl_params takes quant none or int8, got {quant!r}")
    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(seed)

    def w(shape, fan_in, dtype):
        x = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
        return (x / fan_in**0.5).to(dtype)

    def const(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    t = cfg.text
    D, F2, L, V, QD, dt = t.hidden_size, t.ff_dim, t.num_layers, t.vocab_size, t.q_dim, t.dtype
    # name -> fused parts as (rows, fan_in); every part contracts over `cols`
    stacks = {
        "c_attn_w": ([(3 * QD, D)], D),
        "attn_proj": ([(D, QD)], QD),
        "w12": ([(F2, D), (F2, D)], D),
        "mlp_proj": ([(D, F2)], F2),
    }
    layers: Dict[str, Any] = {"ln_1": const((L, D), 1, dt), "c_attn_b": const((L, 3 * QD), 0, dt),
                              "ln_2": const((L, D), 1, dt)}
    for name, (parts, cols) in stacks.items():
        if quant == "int8":
            O = sum(r for r, _ in parts)
            wq = {"q": torch.empty((L, O, cols), dtype=torch.int8, device=device),
                  "s": torch.empty((L, O), dtype=torch.float32, device=device)}
            for li in range(L):
                layer = quantize_weight(torch.cat([w((r, cols), f, dt) for r, f in parts]))
                wq["q"][li], wq["s"][li] = layer["q"], layer["s"]
            layers[name] = wq
        elif name == "w12":
            layers["w1"], layers["w2"] = (w((L, r, cols), f, dt) for r, f in parts)
        else:
            (r, f), = parts
            layers[name] = w((L, r, cols), f, dt)
    lm_head = w((V, D), D, dt)
    qwen = {"wte": w((V, D), D, dt), "layers": layers, "ln_f": const((D,), 1, dt),
            "lm_head": quantize_weight(lm_head) if quant == "int8" else lm_head}
    del lm_head

    vc = cfg.vision
    W, Fv, vL, E, P, N, Q, vdt = (vc.width, vc.mlp_width, vc.num_layers, vc.output_dim, vc.patch_size,
                                  vc.num_patches, vc.n_queries, vc.dtype)

    def ln(shape):
        return {"scale": const(shape, 1, vdt), "bias": const(shape, 0, vdt)}

    def lin(out, fan_in, stacked=True):
        lead = (vL,) if stacked else ()
        return {"w": w(lead + (out, fan_in), fan_in, vdt), "b": const(lead + (out,), 0, vdt)}

    pos_vit = interpolate_pos_embed(w((256, W), W, torch.float32).cpu().numpy(), N)
    sincos = sincos_2d_pos_embed(E, int(math.sqrt(Q)))
    pos_kv = interpolate_pos_embed(sincos, N)

    def table(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device=device, dtype=vdt)

    visual = {
        "conv": w((W, 3 * P * P), 3 * P * P, vdt),
        "pos_embed": table(pos_vit),
        "ln_pre": ln((W,)),
        "layers": {"ln_1": ln((vL, W)), "in_proj": lin(3 * W, W), "out_proj": lin(W, W),
                   "ln_2": ln((vL, W)), "c_fc": lin(Fv, W), "c_proj": lin(W, Fv)},
        "resampler": {
            "query": w((Q, E), E, vdt), "pos_q": table(sincos), "pos_kv": table(pos_kv),
            "kv_proj": w((E, W), W, vdt), "ln_q": ln((E,)), "ln_kv": ln((E,)),
            "in_proj": lin(3 * E, E, stacked=False), "out_proj": lin(E, E, stacked=False),
        },
        "ln_post": ln((E,)),
        "proj": w((E, E), E, vdt),
    }
    return {"qwen": qwen, "visual": visual}
