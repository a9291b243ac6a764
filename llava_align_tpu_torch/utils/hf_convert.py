"""HF-format LLaVA and Qwen-VL checkpoints, LAVIS InstructBLIP and BLIP-2
ones, and HF T5 / OPT / MPT state dicts → the port's param trees (torch
twin of those parts of llava_align_tpu/utils/hf_convert.py: convert_llama,
convert_clip, convert_projector, load_state_dict, config_from_hf,
load_llava_checkpoint; convert_qwen, convert_qwen_visual,
load_qwen_vl_checkpoint; convert_eva_vit, convert_qformer,
convert_instructblip; convert_t5, convert_opt, convert_mpt,
convert_blip2_stage1, convert_blip2_opt, convert_blip2_t5; the LAVIS zoo's
convert_blip_vit, convert_med, convert_blip, convert_albef,
convert_blip_nlvr, convert_blip_variant, convert_clip_full,
convert_clip_openai, blip_config_from_json, t5_config_from_json and
load_blip_t5_composite; the video and dialogue families'
convert_timesformer, convert_alpro, convert_gpt2 and
convert_gpt_dialogue).

The tree is the JAX package's, so that loading a checkpoint here and
`utils.jax_params.from_jax_params` of the JAX loader's tree give the same
leaves: LLaMA linears keep torch's [out, in], stacked over layers; CLIP and
projector kernels are transposed to [in, out]; the patch conv [D, 3, P, P]
becomes [3*P*P, D]; the lm_head is the embedding table when the checkpoint
has none. Qwen-VL's linears all stay [out, in], its conv [W, 3, P, P]
becomes [W, 3*P*P], and its position tables are bicubic-interpolated to the
patch grid here, on the host in fp32, as the JAX converter does.
InstructBLIP's linears stay [out, in] too (the EVA conv [W, 3, P, P]
becomes [W, 3*P*P]); a Q-Former whose text branch was pruned from the
checkpoint (BLIP-2 OPT/T5) gets zeros for it, and unit norms.

Weights are read without a copy on the host: `.safetensors` files through
this module's own reader of the format (no `safetensors` package) and
`pytorch_model*.bin` shards through torch.load(mmap=True), both as CPU
tensors over a memory map of the file. Each leaf is built on the target
device one source tensor at a time, cast straight from the source dtype
(bf16 included) to the target dtype. The default device is the GPU, as for
load_model: without one, loading raises unless device="cpu" is asked for.
"""

from __future__ import annotations

import json
import os
import struct
import sys
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

import numpy as np

from llava_align_tpu_torch.config import ClipVisionConfig, LlamaConfig, LlavaConfig
from llava_align_tpu_torch.models.eva_vit import EvaVitConfig
from llava_align_tpu_torch.models.qformer import QFormerConfig, has_cross_attention
from llava_align_tpu_torch.models.qwen import QwenConfig
from llava_align_tpu_torch.models.qwen_vit import QwenVisionConfig, interpolate_pos_embed
from llava_align_tpu_torch.models.qwen_vl import QwenVLConfig
from llava_align_tpu_torch.models.projector import num_layers as projector_num_layers
from llava_align_tpu_torch.utils.synthetic import resolve_device

StateDict = Mapping[str, torch.Tensor]

# safetensors dtype tags → torch dtypes
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one .safetensors file, as CPU tensors over a private
    read-only memory map of it. The format: an 8-byte little-endian header
    length n, n bytes of JSON {name: {"dtype", "shape", "data_offsets":
    [begin, end]}, "__metadata__": {...}}, then the raw little-endian data,
    the offsets counted from its start. A tensor whose offset is not a
    multiple of its element size is copied out of the map."""
    if sys.byteorder != "little":
        raise RuntimeError("the safetensors reader assumes a little-endian host")
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        if 8 + n > size:
            raise ValueError(f"{path}: header length {n} past the end of the file")
        header = json.loads(f.read(n))
    data = torch.from_file(path, shared=False, size=size, dtype=torch.uint8)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which the reader does not take")
        begin, end = info["data_offsets"]
        shape = [int(d) for d in info["shape"]]
        itemsize = torch.empty((), dtype=dtype).element_size()
        numel = 1
        for d in shape:
            numel *= d
        if end - begin != numel * itemsize or end > data.numel():
            raise ValueError(f"{path}: {name} spans bytes [{begin}, {end}), not {numel} x {itemsize}")
        raw = data[begin:end]
        if (8 + n + begin) % itemsize:
            raw = raw.clone()
        out[name] = raw.view(dtype).reshape(shape)
    return out


def load_state_dict(model_path: str) -> Dict[str, torch.Tensor]:
    """All weights under a checkpoint dir (safetensors preferred), as CPU
    tensors over memory maps of the files, in their stored dtypes."""
    names = sorted(os.listdir(model_path))
    st_files = [f for f in names if f.endswith(".safetensors")]
    sd: Dict[str, torch.Tensor] = {}
    if st_files:
        for f in st_files:
            sd.update(read_safetensors(os.path.join(model_path, f)))
        return sd
    bin_files = [f for f in names if f.startswith("pytorch_model") and f.endswith(".bin")]
    if not bin_files:
        raise FileNotFoundError(f"no weights found under {model_path}")
    for f in bin_files:
        sd.update(torch.load(os.path.join(model_path, f), map_location="cpu", weights_only=True, mmap=True))
    return sd


def config_from_hf(hf_cfg: dict, dtype: torch.dtype = torch.bfloat16) -> LlavaConfig:
    """LlavaConfig from a llava-v1.5 HF config.json dict (the vision tower
    is CLIP ViT-L/14-336, as in the JAX package)."""
    text = LlamaConfig(
        vocab_size=hf_cfg["vocab_size"],
        hidden_size=hf_cfg["hidden_size"],
        intermediate_size=hf_cfg["intermediate_size"],
        num_layers=hf_cfg["num_hidden_layers"],
        num_heads=hf_cfg["num_attention_heads"],
        num_kv_heads=hf_cfg.get("num_key_value_heads", hf_cfg["num_attention_heads"]),
        head_dim=hf_cfg["hidden_size"] // hf_cfg["num_attention_heads"],
        rope_theta=hf_cfg.get("rope_theta", 10000.0),
        rms_norm_eps=hf_cfg.get("rms_norm_eps", 1e-5),
        max_position_embeddings=hf_cfg.get("max_position_embeddings", 4096),
        dtype=dtype,
    )
    vision = ClipVisionConfig(
        select_layer=hf_cfg.get("mm_vision_select_layer", -2),
        select_feature=hf_cfg.get("mm_vision_select_feature", "patch"),
        dtype=dtype,
    )
    return LlavaConfig(
        text=text,
        vision=vision,
        mm_projector_type=hf_cfg.get("mm_projector_type", "linear"),
        image_aspect_ratio=hf_cfg.get("image_aspect_ratio", "pad"),
        image_grid_pinpoints=hf_cfg.get("image_grid_pinpoints"),
        mm_use_im_start_end=hf_cfg.get("mm_use_im_start_end", False),
        mm_use_im_patch_token=hf_cfg.get("mm_use_im_patch_token", False),
    )


def _stack(sd: StateDict, template: str, num_layers: int, dtype, device,
           transform: Callable[[torch.Tensor], torch.Tensor] = lambda w: w) -> torch.Tensor:
    """[L, ...] from the per-layer tensors, filled on `device` one layer
    at a time."""
    first = transform(sd[template.format(i=0)])
    out = torch.empty((num_layers,) + tuple(first.shape), dtype=dtype, device=device)
    for i in range(num_layers):
        out[i].copy_(transform(sd[template.format(i=i)]))
    return out


def convert_llama(sd: StateDict, cfg: LlamaConfig, prefix: str = "", device=None) -> Dict[str, Any]:
    """HF LlamaForCausalLM state dict → the llama tree (linears [L, out, in])."""
    device = resolve_device(device)
    p, dt, L = prefix, cfg.dtype, cfg.num_layers

    def st(template):
        return _stack(sd, p + template, L, dt, device)

    embed = sd[p + "model.embed_tokens.weight"]
    lm_head = sd.get(p + "lm_head.weight", embed)  # tied embeddings when absent
    return {
        "embed": embed.to(device, dt),
        "layers": {
            "attn_norm": st("model.layers.{i}.input_layernorm.weight"),
            "q": st("model.layers.{i}.self_attn.q_proj.weight"),
            "k": st("model.layers.{i}.self_attn.k_proj.weight"),
            "v": st("model.layers.{i}.self_attn.v_proj.weight"),
            "o": st("model.layers.{i}.self_attn.o_proj.weight"),
            "mlp_norm": st("model.layers.{i}.post_attention_layernorm.weight"),
            "gate": st("model.layers.{i}.mlp.gate_proj.weight"),
            "up": st("model.layers.{i}.mlp.up_proj.weight"),
            "down": st("model.layers.{i}.mlp.down_proj.weight"),
        },
        "final_norm": sd[p + "model.norm.weight"].to(device, dt),
        "lm_head": lm_head.to(device, dt),
    }


def convert_clip(sd: StateDict, cfg: ClipVisionConfig, prefix: str = "vision_model.",
                 device=None) -> Dict[str, Any]:
    """HF CLIPVisionModel state dict → the clip_vit tree (kernels [L, in, out])."""
    device = resolve_device(device)
    p, dt, L = prefix, cfg.dtype, cfg.num_layers

    def st(template, transform=lambda w: w):
        return _stack(sd, p + "encoder.layers.{i}." + template, L, dt, device, transform)

    def linear(name):
        return {"kernel": st(name + ".weight", lambda w: w.t()), "bias": st(name + ".bias")}

    def lnorm(name):
        return {"scale": st(name + ".weight"), "bias": st(name + ".bias")}

    # conv kernel [D, 3, P, P] → [3*P*P, D] in (C, kh, kw)-major order,
    # matching models/clip_vit.patchify's flattening
    conv = sd[p + "embeddings.patch_embedding.weight"]
    return {
        "cls": sd[p + "embeddings.class_embedding"].reshape(-1).to(device, dt),
        "patch_embed": conv.reshape(conv.shape[0], -1).t().to(device, dt).contiguous(),
        "pos_embed": sd[p + "embeddings.position_embedding.weight"].to(device, dt),
        "pre_ln": {"scale": sd[p + "pre_layrnorm.weight"].to(device, dt),
                   "bias": sd[p + "pre_layrnorm.bias"].to(device, dt)},
        "layers": {
            "ln1": lnorm("layer_norm1"),
            "q": linear("self_attn.q_proj"),
            "k": linear("self_attn.k_proj"),
            "v": linear("self_attn.v_proj"),
            "o": linear("self_attn.out_proj"),
            "ln2": lnorm("layer_norm2"),
            "fc1": linear("mlp.fc1"),
            "fc2": linear("mlp.fc2"),
        },
        "post_ln": {"scale": sd[p + "post_layernorm.weight"].to(device, dt),
                    "bias": sd[p + "post_layernorm.bias"].to(device, dt)},
    }


def convert_projector(sd: StateDict, projector_type: str, dtype: torch.dtype,
                      prefix: str = "model.mm_projector.", device=None) -> Dict[str, Any]:
    """mm_projector.{0,2,4...}.{weight,bias} (the Sequential's odd indices
    are its GELUs); a bare Linear for 'linear' without an index."""
    device = resolve_device(device)
    n = projector_num_layers(projector_type)
    layers: List[Dict[str, torch.Tensor]] = []
    for i in range(n):
        key_w = f"{prefix}{2 * i}.weight"
        if key_w not in sd and n == 1:
            key_w = prefix.rstrip(".") + ".weight"
        key_b = key_w.replace("weight", "bias")
        layers.append({"kernel": sd[key_w].t().to(device, dtype).contiguous(), "bias": sd[key_b].to(device, dtype)})
    return {"layers": layers}


def load_llava_checkpoint(model_path: str, dtype: torch.dtype = torch.bfloat16,
                          device=None) -> Tuple[Dict[str, Any], LlavaConfig]:
    """liuhaotian/llava-v1.5-* checkpoint dir → (params, cfg), the params
    built on `device` (the GPU unless another is named)."""
    device = resolve_device(device)
    with open(os.path.join(model_path, "config.json")) as f:
        hf_cfg = json.load(f)
    cfg = config_from_hf(hf_cfg, dtype)
    sd = load_state_dict(model_path)
    params = {
        "llama": convert_llama(sd, cfg.text, device=device),
        "vision": convert_clip(sd, cfg.vision, prefix="model.vision_tower.vision_tower.vision_model.",
                               device=device),
        "projector": convert_projector(sd, cfg.mm_projector_type, dtype, device=device),
    }
    return params, cfg



# ---------------------------------------------------------------------------
# Qwen-VL
# ---------------------------------------------------------------------------


def convert_qwen(sd: StateDict, cfg: QwenConfig, prefix: str = "", device=None) -> Dict[str, Any]:
    """Qwen decoder state dict (transformer.h.{i}.* keys) → the models/qwen
    tree; every linear stays torch's [out, in]."""
    device = resolve_device(device)
    p, dt, L = prefix, cfg.dtype, cfg.num_layers

    def st(template):
        return _stack(sd, p + "transformer.h.{i}." + template, L, dt, device)

    return {
        "wte": sd[p + "transformer.wte.weight"].to(device, dt),
        "layers": {
            "ln_1": st("ln_1.weight"),
            "c_attn_w": st("attn.c_attn.weight"),
            "c_attn_b": st("attn.c_attn.bias"),
            "attn_proj": st("attn.c_proj.weight"),
            "ln_2": st("ln_2.weight"),
            "w1": st("mlp.w1.weight"),
            "w2": st("mlp.w2.weight"),
            "mlp_proj": st("mlp.c_proj.weight"),
        },
        "ln_f": sd[p + "transformer.ln_f.weight"].to(device, dt),
        "lm_head": sd[p + "lm_head.weight"].to(device, dt),
    }


def convert_qwen_visual(sd: StateDict, cfg: QwenVisionConfig, prefix: str = "transformer.visual.",
                        device=None) -> Dict[str, Any]:
    """Qwen-VL ViT + Resampler state dict → the models/qwen_vit tree. The
    position tables are interpolated to the patch grid here (the reference
    interpolates per forward, visual.py:23-39,141,402)."""
    device = resolve_device(device)
    p, dt, L, N = prefix, cfg.dtype, cfg.num_layers, cfg.num_patches

    def st(template):
        return _stack(sd, p + "transformer.resblocks.{i}." + template, L, dt, device)

    def dev(key):
        return sd[p + key].to(device, dt)

    def table(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)

    def ln(key):
        return {"scale": dev(key + ".weight"), "bias": dev(key + ".bias")}

    def ln_stacked(name):
        return {"scale": st(name + ".weight"), "bias": st(name + ".bias")}

    def lin_stacked(name):
        return {"w": st(name + ".weight"), "b": st(name + ".bias")}

    conv = sd[p + "conv1.weight"]  # [W, 3, P, P], bias-free
    pos_q = sd[p + "attn_pool.pos_embed"].float().numpy()
    return {
        "conv": conv.reshape(conv.shape[0], -1).to(device, dt),
        "pos_embed": table(interpolate_pos_embed(sd[p + "positional_embedding"].float().numpy(), N)),
        "ln_pre": ln("ln_pre"),
        "layers": {
            "ln_1": ln_stacked("ln_1"),
            "in_proj": lin_stacked("attn.in_proj"),
            "out_proj": lin_stacked("attn.out_proj"),
            "ln_2": ln_stacked("ln_2"),
            "c_fc": lin_stacked("mlp.c_fc"),
            "c_proj": lin_stacked("mlp.c_proj"),
        },
        "resampler": {
            "query": dev("attn_pool.query"),
            "pos_q": table(pos_q),
            "pos_kv": table(interpolate_pos_embed(pos_q, N)),
            "kv_proj": dev("attn_pool.kv_proj.weight"),
            "ln_q": ln("attn_pool.ln_q"),
            "ln_kv": ln("attn_pool.ln_kv"),
            "in_proj": {"w": dev("attn_pool.attn.in_proj_weight"), "b": dev("attn_pool.attn.in_proj_bias")},
            "out_proj": {"w": dev("attn_pool.attn.out_proj.weight"), "b": dev("attn_pool.attn.out_proj.bias")},
        },
        "ln_post": ln("ln_post"),
        "proj": dev("proj"),
    }


def qwen_vl_config_from_hf(hf: dict, dtype: torch.dtype = torch.bfloat16) -> QwenVLConfig:
    """QwenVLConfig from a Qwen-VL config.json dict, with the JAX loader's
    defaults for absent keys."""
    vis = hf.get("visual", {})
    text = QwenConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        head_dim=hf.get("kv_channels", hf["hidden_size"] // hf["num_attention_heads"]),
        intermediate_size=hf["intermediate_size"],
        layer_norm_eps=hf.get("layer_norm_epsilon", 1e-6),
        rotary_emb_base=hf.get("rotary_emb_base", 10000),
        seq_length=hf.get("seq_length", 2048),
        use_dynamic_ntk=hf.get("use_dynamic_ntk", True),
        use_logn_attn=hf.get("use_logn_attn", True),
        dtype=dtype,
    )
    vision = QwenVisionConfig(
        image_size=vis.get("image_size", 448),
        patch_size=vis.get("patch_size", 14),
        width=vis.get("width", 1664),
        num_layers=vis.get("layers", 48),
        num_heads=vis.get("heads", 16),
        mlp_ratio=vis.get("mlp_ratio", 4.9231),
        n_queries=vis.get("n_queries", 256),
        output_dim=vis.get("output_dim", 4096),
        dtype=dtype,
    )
    return QwenVLConfig(text=text, vision=vision, image_start_id=vis.get("image_start_id", 151857))


def load_qwen_vl_checkpoint(model_path: str, dtype: torch.dtype = torch.bfloat16,
                            device=None) -> Tuple[Dict[str, Any], QwenVLConfig]:
    """Qwen-VL checkpoint dir → (params, QwenVLConfig), the params built on
    `device` (the GPU unless another is named)."""
    device = resolve_device(device)
    with open(os.path.join(model_path, "config.json")) as f:
        cfg = qwen_vl_config_from_hf(json.load(f), dtype)
    sd = load_state_dict(model_path)
    params = {
        "qwen": convert_qwen(sd, cfg.text, device=device),
        "visual": convert_qwen_visual(sd, cfg.vision, device=device),
    }
    return params, cfg


# ---------------------------------------------------------------------------
# InstructBLIP (EVA-ViT + Q-Former + Vicuna)
# ---------------------------------------------------------------------------


def convert_eva_vit(sd: StateDict, cfg: EvaVitConfig, prefix: str = "visual_encoder.",
                    device=None) -> Dict[str, Any]:
    """LAVIS eva_vit state dict → the models/eva_vit tree."""
    device = resolve_device(device)
    p, dt, L = prefix, cfg.dtype, cfg.num_layers

    def st(template):
        return _stack(sd, p + "blocks.{i}." + template, L, dt, device)

    def dev(key):
        return sd[p + key].to(device, dt)

    conv = sd[p + "patch_embed.proj.weight"]
    return {
        "patch_embed": {"w": conv.reshape(conv.shape[0], -1).to(device, dt), "b": dev("patch_embed.proj.bias")},
        "cls": dev("cls_token").reshape(-1),
        "pos_embed": dev("pos_embed").reshape(-1, cfg.width),
        "layers": {
            "norm1": {"scale": st("norm1.weight"), "bias": st("norm1.bias")},
            "qkv_w": st("attn.qkv.weight"),
            "q_bias": st("attn.q_bias"),
            "v_bias": st("attn.v_bias"),
            "proj": {"w": st("attn.proj.weight"), "b": st("attn.proj.bias")},
            "norm2": {"scale": st("norm2.weight"), "bias": st("norm2.bias")},
            "fc1": {"w": st("mlp.fc1.weight"), "b": st("mlp.fc1.bias")},
            "fc2": {"w": st("mlp.fc2.weight"), "b": st("mlp.fc2.bias")},
        },
    }


def convert_qformer(sd: StateDict, cfg: QFormerConfig, prefix: str = "Qformer.bert.",
                    head_prefix: Optional[str] = None, device=None) -> Dict[str, Any]:
    """LAVIS Qformer BertModel state dict → the models/qformer tree.

    head_prefix: where the BertOnlyMLMHead lives when converting a
    BertLMHeadModel (stage-1 BLIP-2), e.g. "Qformer.cls." for a LAVIS
    checkpoint or "cls." for a raw BertLMHeadModel state dict; the result
    then carries a "head" subtree. Blip2-OPT / Blip2-T5 checkpoints prune
    the text branches before saving (cls, word/position embeddings and each
    layer's text feed-forward): those keys are absent, and convert to zeros
    (unit scales for their norms), which the query-only paths never read."""
    device = resolve_device(device)
    p, dt = prefix, cfg.dtype
    D, F_ = cfg.hidden_size, cfg.intermediate_size

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    def dev(key):
        return sd[key].to(device, dt)

    def dense(key, fallback_shape=None):
        wk = p + key + ".weight"
        if fallback_shape is not None and wk not in sd:
            return {"w": zeros(*fallback_shape), "b": zeros(fallback_shape[0])}
        return {"w": dev(wk), "b": dev(p + key + ".bias")}

    def lnorm(key, width=None):
        wk = p + key + ".weight"
        if width is not None and wk not in sd:
            return {"scale": torch.ones((width,), dtype=dt, device=device), "bias": zeros(width)}
        return {"scale": dev(wk), "bias": dev(p + key + ".bias")}

    def attn(base):
        return {
            "query": dense(base + ".self.query"),
            "key": dense(base + ".self.key"),
            "value": dense(base + ".self.value"),
            "out": dense(base + ".output.dense"),
            "ln": lnorm(base + ".output.LayerNorm"),
        }

    layers = []
    for i in range(cfg.num_layers):
        b = f"encoder.layer.{i}"
        lp = {
            "self_attn": attn(b + ".attention"),
            "intermediate": dense(b + ".intermediate.dense", (F_, D)),
            "output": dense(b + ".output.dense", (D, F_)),
            "output_ln": lnorm(b + ".output.LayerNorm", D),
            "intermediate_query": dense(b + ".intermediate_query.dense"),
            "output_query": dense(b + ".output_query.dense"),
            "output_query_ln": lnorm(b + ".output_query.LayerNorm"),
        }
        if has_cross_attention(cfg, i):
            lp["cross_attn"] = attn(b + ".crossattention")
        layers.append(lp)

    wkey, pkey = p + "embeddings.word_embeddings.weight", p + "embeddings.position_embeddings.weight"
    out: Dict[str, Any] = {
        "embeddings": {
            "word": dev(wkey) if wkey in sd else zeros(cfg.vocab_size, D),
            "position": dev(pkey) if pkey in sd else zeros(cfg.max_position_embeddings, D),
            "ln": lnorm("embeddings.LayerNorm"),
        },
        "layers": layers,
    }
    if head_prefix is not None:
        h = head_prefix + "predictions."
        out["head"] = {
            "transform": {"w": dev(h + "transform.dense.weight"), "b": dev(h + "transform.dense.bias")},
            "ln": {"scale": dev(h + "transform.LayerNorm.weight"), "bias": dev(h + "transform.LayerNorm.bias")},
            "decoder": dev(h + "decoder.weight"),
            "bias": dev(h + "bias"),
        }
    return out


def convert_instructblip(sd: StateDict, cfg, device=None) -> Dict[str, Any]:
    """A whole blip2_vicuna_instruct state dict → the models/instructblip
    tree (cfg: InstructBlipConfig), built on `device` (the GPU unless
    another is named)."""
    device = resolve_device(device)
    vdt, tdt = cfg.vision.dtype, cfg.text.dtype
    return {
        "visual": convert_eva_vit(sd, cfg.vision, device=device),
        "ln_vision": {"scale": sd["ln_vision.weight"].to(device, vdt), "bias": sd["ln_vision.bias"].to(device, vdt)},
        "query_tokens": sd["query_tokens"].reshape(cfg.num_query_tokens, -1).to(device, cfg.qformer.dtype),
        "qformer": convert_qformer(sd, cfg.qformer, device=device),
        "llm_proj": {"w": sd["llm_proj.weight"].to(device, tdt), "b": sd["llm_proj.bias"].to(device, tdt)},
        "llama": convert_llama(sd, cfg.text, prefix="llm_model.", device=device),
    }


# ---------------------------------------------------------------------------
# T5 / Flan-T5, OPT, MPT and the BLIP-2 checkpoints
# ---------------------------------------------------------------------------


def convert_t5(sd: StateDict, cfg, prefix: str = "", device=None) -> Dict[str, Any]:
    """HF / LAVIS T5ForConditionalGeneration state dict → the models/t5 tree
    (linears [out, in]; lm_head None when the checkpoint has none)."""
    device = resolve_device(device)
    p, dt = prefix, cfg.dtype

    def dense(key):
        return sd[p + key + ".weight"].to(device, dt)

    def ffn(base):
        names = ("wi_0", "wi_1", "wo") if cfg.gated_act else ("wi", "wo")
        return {n: dense(f"{base}.DenseReluDense.{n}") for n in names}

    def attn(base):
        return {n: dense(f"{base}.{n}") for n in ("q", "k", "v", "o")}

    def enc_layer(i):
        b = f"encoder.block.{i}.layer."
        return {"ln1": dense(b + "0.layer_norm"), "attn": attn(b + "0.SelfAttention"),
                "ln2": dense(b + "1.layer_norm"), "ffn": ffn(b + "1")}

    def dec_layer(i):
        b = f"decoder.block.{i}.layer."
        return {"ln1": dense(b + "0.layer_norm"), "attn": attn(b + "0.SelfAttention"),
                "ln_x": dense(b + "1.layer_norm"), "xattn": attn(b + "1.EncDecAttention"),
                "ln2": dense(b + "2.layer_norm"), "ffn": ffn(b + "2")}

    def side(name, layers):
        return {"rel_bias": dense(f"{name}.block.0.layer.0.SelfAttention.relative_attention_bias"),
                "layers": layers, "final_ln": dense(f"{name}.final_layer_norm")}

    return {
        "shared": dense("shared"),
        "encoder": side("encoder", [enc_layer(i) for i in range(cfg.num_layers)]),
        "decoder": side("decoder", [dec_layer(i) for i in range(cfg.num_decoder_layers)]),
        "lm_head": dense("lm_head") if p + "lm_head.weight" in sd else None,
    }


def convert_opt(sd: StateDict, cfg, prefix: str = "", device=None) -> Dict[str, Any]:
    """HF / LAVIS OPT state dict (model.decoder.*) → the models/opt tree."""
    device = resolve_device(device)
    p, dt, L = prefix + "model.decoder.", cfg.dtype, cfg.num_layers

    def st(template):
        return _stack(sd, p + template, L, dt, device)

    def dense(name):
        return {"w": st(f"layers.{{i}}.{name}.weight"), "b": st(f"layers.{{i}}.{name}.bias")}

    def lnorm(name):
        return {"scale": st(f"layers.{{i}}.{name}.weight"), "bias": st(f"layers.{{i}}.{name}.bias")}

    return {
        "embed_tokens": sd[p + "embed_tokens.weight"].to(device, dt),
        "embed_positions": sd[p + "embed_positions.weight"].to(device, dt),
        "layers": {
            "attn_ln": lnorm("self_attn_layer_norm"),
            "q": dense("self_attn.q_proj"), "k": dense("self_attn.k_proj"),
            "v": dense("self_attn.v_proj"), "out": dense("self_attn.out_proj"),
            "ffn_ln": lnorm("final_layer_norm"),
            "fc1": dense("fc1"), "fc2": dense("fc2"),
        },
        "final_ln": {"scale": sd[p + "final_layer_norm.weight"].to(device, dt),
                     "bias": sd[p + "final_layer_norm.bias"].to(device, dt)},
    }


def convert_mpt(sd: StateDict, cfg, prefix: str = "", device=None) -> Dict[str, Any]:
    """MPT state dict (transformer.blocks.{i}.*) → the models/mpt tree. A
    norm bias the checkpoint lacks (no_bias) is zeros; q_ln/k_ln come over
    when the checkpoint has them."""
    device = resolve_device(device)
    p, dt, L, D = prefix + "transformer.", cfg.dtype, cfg.n_layers, cfg.d_model

    def st(template):
        return _stack(sd, p + "blocks.{i}." + template, L, dt, device)

    def norm(name, width):
        bias_key = p + f"blocks.0.{name}.bias"
        bias = st(name + ".bias") if bias_key in sd else torch.zeros((L, width), dtype=dt, device=device)
        return {"scale": st(name + ".weight"), "bias": bias}

    layers = {"norm_1": norm("norm_1", D), "wqkv": st("attn.Wqkv.weight"), "out_proj": st("attn.out_proj.weight"),
              "norm_2": norm("norm_2", D), "up_proj": st("ffn.up_proj.weight"),
              "down_proj": st("ffn.down_proj.weight")}
    if p + "blocks.0.attn.q_ln.weight" in sd:
        layers["q_ln"] = norm("attn.q_ln", D)
        layers["k_ln"] = norm("attn.k_ln", cfg.kv_heads * cfg.head_dim)
    norm_f_bias = sd.get(p + "norm_f.bias")
    return {
        "wte": sd[p + "wte.weight"].to(device, dt),
        "layers": layers,
        "norm_f": {"scale": sd[p + "norm_f.weight"].to(device, dt),
                   "bias": torch.zeros((D,), dtype=dt, device=device) if norm_f_bias is None
                   else norm_f_bias.to(device, dt)},
    }


def _blip2_common(sd: StateDict, cfg, device, **qf_kw) -> Dict[str, Any]:
    """visual, ln_vision, query_tokens and the Q-Former of a LAVIS BLIP-2
    checkpoint."""
    vdt = cfg.vision.dtype
    return {
        "visual": convert_eva_vit(sd, cfg.vision, device=device),
        "ln_vision": {"scale": sd["ln_vision.weight"].to(device, vdt), "bias": sd["ln_vision.bias"].to(device, vdt)},
        "query_tokens": sd["query_tokens"].reshape(cfg.num_query_tokens, -1).to(device, cfg.qformer.dtype),
        "qformer": convert_qformer(sd, cfg.qformer, device=device, **qf_kw),
    }


def convert_blip2_stage1(sd: StateDict, cfg, device=None) -> Dict[str, Any]:
    """LAVIS blip2 / blip2_feature_extractor / blip2_image_text_matching
    checkpoint → the models/blip2 stage-1 tree (Qformer.bert + Qformer.cls,
    vision/text_proj, itm_head, temp as a 0-d fp32 tensor)."""
    device = resolve_device(device)
    dt = cfg.qformer.dtype

    def lin(name):
        return {"w": sd[name + ".weight"].to(device, dt), "b": sd[name + ".bias"].to(device, dt)}

    out = _blip2_common(sd, cfg, device, head_prefix="Qformer.cls.")
    out.update(vision_proj=lin("vision_proj"), text_proj=lin("text_proj"), itm_head=lin("itm_head"),
               temp=sd["temp"].reshape(()).to(device, torch.float32))
    return out


def _blip2_lm(sd: StateDict, cfg, proj: str, convert_lm, lm_prefix: str, device) -> Dict[str, Any]:
    device = resolve_device(device)
    dt = cfg.text.dtype
    out = _blip2_common(sd, cfg, device)
    out["proj"] = {"w": sd[proj + ".weight"].to(device, dt), "b": sd[proj + ".bias"].to(device, dt)}
    out["lm"] = convert_lm(sd, cfg.text, prefix=lm_prefix, device=device)
    return out


def convert_blip2_opt(sd: StateDict, cfg, device=None) -> Dict[str, Any]:
    """LAVIS blip2_opt checkpoint → the Blip2OptConfig tree (pruned-text
    Q-Former + opt_proj + opt_model)."""
    return _blip2_lm(sd, cfg, "opt_proj", convert_opt, "opt_model.", device)


def convert_blip2_t5(sd: StateDict, cfg, device=None) -> Dict[str, Any]:
    """LAVIS blip2_t5 / blip2_t5_instruct checkpoint → the Blip2T5Config tree
    (t5_proj + t5_model; the instruct variant keeps the Q-Former's text
    branches)."""
    return _blip2_lm(sd, cfg, "t5_proj", convert_t5, "t5_model.", device)


# ---------------------------------------------------------------------------
# the LAVIS zoo: BLIP, ALBEF and CLIP checkpoints, and the BLIP + T5
# composite (visual_encoder.* a timm ViT with a fused qkv; text_encoder /
# text_decoder.* a MED BERT; vision_proj / text_proj / itm_head; cls_head)
# ---------------------------------------------------------------------------


def blip_config_from_json(d: dict):
    """BlipConfig from a component config.json ({vision: {...}, text: {...},
    embed_dim}); missing keys take BLIP-base's values."""
    from llava_align_tpu_torch.models.blip import BlipConfig, BlipVitConfig, MedConfig

    text_kw = dict(d.get("text", {}))
    text_kw.setdefault("use_type_embeddings", False)  # the BLIP family
    return BlipConfig(vision=BlipVitConfig(**d.get("vision", {})), text=MedConfig(**text_kw),
                      embed_dim=d.get("embed_dim", 256))


def t5_config_from_json(d: dict):
    """T5Config from an HF T5 config.json (the format UnifiedQAv2 ships)."""
    from llava_align_tpu_torch.models.t5 import T5Config

    proj = d.get("feed_forward_proj", "relu")
    return T5Config(
        vocab_size=d.get("vocab_size", 32128),
        d_model=d.get("d_model", 2048),
        d_kv=d.get("d_kv", 64),
        num_heads=d.get("num_heads", 32),
        d_ff=d.get("d_ff", 5120),
        num_layers=d.get("num_layers", 24),
        num_decoder_layers=d.get("num_decoder_layers", d.get("num_layers", 24)),
        relative_attention_num_buckets=d.get("relative_attention_num_buckets", 32),
        relative_attention_max_distance=d.get("relative_attention_max_distance", 128),
        gated_act=d.get("is_gated_act", proj.startswith("gated")),
        tie_word_embeddings=d.get("tie_word_embeddings", True),
    )


def _load_component_sd(path: str) -> Tuple[Dict[str, torch.Tensor], dict]:
    """(state dict, config.json dict) of one composite component: a dir of
    safetensors / .bin shards + config.json, one .safetensors file, or a
    LAVIS .pth (its 'model' envelope unwrapped)."""
    if os.path.isdir(path):
        cfg_path = os.path.join(path, "config.json")
        cfg = {}
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
        return load_state_dict(path), cfg
    if path.endswith(".safetensors"):
        return read_safetensors(path), {}
    obj = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]
    return dict(obj), {}


def load_blip_t5_composite(model_path: str, *, qa_key: str = "qa", paths: Optional[Dict[str, str]] = None,
                           device=None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The PnP-VQA / Img2Prompt composite (BLIP-ITM + BLIP-caption + a T5):
    `model_path` holds itm/, cap/ and <qa_key>/ components (each a
    checkpoint dir or file, as _load_component_sd reads), or explicit
    per-component `paths` → (params, cfgs) keyed {itm, cap, <qa_key>}."""
    comp_paths = dict(paths or {})
    for name in ("itm", "cap", qa_key):
        if name not in comp_paths:
            cand = os.path.join(model_path, name)
            if not os.path.exists(cand):
                raise FileNotFoundError(f"composite checkpoint missing component {name!r} (expected {cand} or an "
                                        "explicit path)")
            comp_paths[name] = cand
    params: Dict[str, Any] = {}
    cfgs: Dict[str, Any] = {}
    for name in ("itm", "cap"):
        sd, cfg_json = _load_component_sd(comp_paths[name])
        cfgs[name] = blip_config_from_json(cfg_json)
        params[name] = convert_blip(sd, cfgs[name], device=device)
    sd, cfg_json = _load_component_sd(comp_paths[qa_key])
    cfgs[qa_key] = t5_config_from_json(cfg_json)
    params[qa_key] = convert_t5(sd, cfgs[qa_key], device=device)
    return params, cfgs


def _leaf(sd: StateDict, device, dt):
    """get(name) → sd[name] on `device` in `dt`."""
    return lambda name: sd[name].to(device, dt)


def _linear_or_zeros(sd: StateDict, name: str, o: int, i: int, dt, device) -> Dict[str, torch.Tensor]:
    """{w, b} of a Linear the checkpoint has, else zeros (a head it lacks)."""
    if name + ".weight" in sd:
        return {"w": sd[name + ".weight"].to(device, dt), "b": sd[name + ".bias"].to(device, dt)}
    return {"w": torch.zeros((o, i), dtype=dt, device=device), "b": torch.zeros((o,), dtype=dt, device=device)}


def _temp(sd: StateDict, device) -> torch.Tensor:
    if "temp" in sd:
        return sd["temp"].reshape(()).to(device, torch.float32)
    return torch.tensor(0.07, dtype=torch.float32, device=device)


def convert_blip_vit(sd: StateDict, cfg, prefix: str = "visual_encoder.", device=None) -> Dict[str, Any]:
    """A LAVIS timm ViT (blocks.{i}.attn.qkv fused) → the models/blip visual
    tree; a qkv without bias gets zeros."""
    device = resolve_device(device)
    dt, L, D = cfg.dtype, cfg.num_layers, cfg.hidden_size
    get = _leaf(sd, device, dt)

    def st(template, transform=lambda w: w):
        return _stack(sd, prefix + template, L, dt, device, transform)

    has_qkv_b = prefix + "blocks.0.attn.qkv.bias" in sd

    def qkv(part):
        rows = slice(part * D, (part + 1) * D)
        w = st("blocks.{i}.attn.qkv.weight", lambda x: x[rows])
        b = st("blocks.{i}.attn.qkv.bias", lambda x: x[rows]) if has_qkv_b else torch.zeros((L, D), dtype=dt,
                                                                                           device=device)
        return {"w": w, "b": b}

    def lin(name):
        return {"w": st(f"blocks.{{i}}.{name}.weight"), "b": st(f"blocks.{{i}}.{name}.bias")}

    def lnorm(name):
        return {"scale": st(f"blocks.{{i}}.{name}.weight"), "bias": st(f"blocks.{{i}}.{name}.bias")}

    return {
        "cls": get(prefix + "cls_token"),
        "pos": get(prefix + "pos_embed"),
        "patch": {"w": get(prefix + "patch_embed.proj.weight"), "b": get(prefix + "patch_embed.proj.bias")},
        "layers": {"ln1": lnorm("norm1"), "q": qkv(0), "k": qkv(1), "v": qkv(2), "o": lin("attn.proj"),
                   "ln2": lnorm("norm2"), "fc1": lin("mlp.fc1"), "fc2": lin("mlp.fc2")},
        "final_ln": {"scale": get(prefix + "norm.weight"), "bias": get(prefix + "norm.bias")},
    }


def convert_med(sd: StateDict, cfg, prefix: str = "text_decoder.bert.", head_prefix: str = "text_decoder.cls.",
                device=None) -> Dict[str, Any]:
    """An HF-Bert-style MED state dict (also HF BertLMHeadModel with
    prefix='bert.', head_prefix='cls.') → the models/blip MED tree. Without
    cross-attention keys the cross stacks are zeros (unit norms); without a
    head, an identity transform and a zero decoder; without token-type
    embeddings, zeros."""
    device = resolve_device(device)
    dt, L, D, V = cfg.dtype, cfg.num_layers, cfg.hidden_size, cfg.vocab_size
    get = _leaf(sd, device, dt)

    def st(template):
        return _stack(sd, prefix + template, L, dt, device)

    def lin(base):
        return {"w": st(base + ".weight"), "b": st(base + ".bias")}

    def lnorm(base):
        return {"scale": st(base + ".weight"), "bias": st(base + ".bias")}

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    layers = {
        "sq": lin("encoder.layer.{i}.attention.self.query"),
        "sk": lin("encoder.layer.{i}.attention.self.key"),
        "sv": lin("encoder.layer.{i}.attention.self.value"),
        "so": lin("encoder.layer.{i}.attention.output.dense"),
        "s_ln": lnorm("encoder.layer.{i}.attention.output.LayerNorm"),
        "fc1": lin("encoder.layer.{i}.intermediate.dense"),
        "fc2": lin("encoder.layer.{i}.output.dense"),
        "f_ln": lnorm("encoder.layer.{i}.output.LayerNorm"),
    }
    if prefix + "encoder.layer.0.crossattention.self.query.weight" in sd:
        layers.update(cq=lin("encoder.layer.{i}.crossattention.self.query"),
                      ck=lin("encoder.layer.{i}.crossattention.self.key"),
                      cv=lin("encoder.layer.{i}.crossattention.self.value"),
                      co=lin("encoder.layer.{i}.crossattention.output.dense"),
                      c_ln=lnorm("encoder.layer.{i}.crossattention.output.LayerNorm"))
    else:
        for k in ("cq", "ck", "cv", "co"):
            layers[k] = {"w": zeros(L, D, D), "b": zeros(L, D)}
        layers["c_ln"] = {"scale": torch.ones((L, D), dtype=dt, device=device), "bias": zeros(L, D)}

    hp = head_prefix + "predictions."
    if hp + "transform.dense.weight" in sd:
        head = {"transform": {"w": get(hp + "transform.dense.weight"), "b": get(hp + "transform.dense.bias")},
                "ln": {"scale": get(hp + "transform.LayerNorm.weight"), "bias": get(hp + "transform.LayerNorm.bias")},
                "decoder": get(hp + "decoder.weight"), "bias": get(hp + "bias")}
    else:
        head = {"transform": {"w": torch.eye(D, dtype=dt, device=device), "b": zeros(D)},
                "ln": {"scale": torch.ones((D,), dtype=dt, device=device), "bias": zeros(D)},
                "decoder": zeros(V, D), "bias": zeros(V)}
    type_key = prefix + "embeddings.token_type_embeddings.weight"
    return {
        "embeddings": {
            "word": get(prefix + "embeddings.word_embeddings.weight"),
            "pos": get(prefix + "embeddings.position_embeddings.weight"),
            # ALBEF's med config has no type embeddings: zeros (inert)
            "type": get(type_key) if type_key in sd else zeros(2, D),
            "ln": {"scale": get(prefix + "embeddings.LayerNorm.weight"),
                   "bias": get(prefix + "embeddings.LayerNorm.bias")},
        },
        "layers": layers,
        "head": head,
    }


def convert_blip(sd: StateDict, cfg, device=None) -> Dict[str, Any]:
    """A LAVIS BLIP checkpoint (blip_caption / blip_itm / the feature
    extractor) → the models/blip tree: text_decoder.* for captioning,
    text_encoder.* and the projections for ITM / retrieval; heads the
    checkpoint lacks are zeros."""
    device = resolve_device(device)
    if "text_decoder.bert.embeddings.word_embeddings.weight" in sd:
        text_prefix = "text_decoder.bert."
    elif "text_encoder.bert.embeddings.word_embeddings.weight" in sd:
        text_prefix = "text_encoder.bert."
    else:
        text_prefix = "text_encoder."
    head_prefix = "text_decoder.cls." if text_prefix.startswith("text_decoder") else "__none__."
    dt, E, D = cfg.text.dtype, cfg.embed_dim, cfg.text.hidden_size
    return {
        "visual": convert_blip_vit(sd, cfg.vision, device=device),
        "text": convert_med(sd, cfg.text, prefix=text_prefix, head_prefix=head_prefix, device=device),
        "vision_proj": _proj_or_zeros(sd, "vision_proj", E, cfg.vision.hidden_size, dt, device),
        "text_proj": _proj_or_zeros(sd, "text_proj", E, D, dt, device),
        "itm_head": _linear_or_zeros(sd, "itm_head", 2, D, dt, device),
    }


def _proj_or_zeros(sd: StateDict, name: str, o: int, i: int, dt, device) -> Dict[str, torch.Tensor]:
    """A projection whose bias may be absent (zeros then), or zeros whole."""
    if name + ".weight" not in sd:
        return _linear_or_zeros(sd, name, o, i, dt, device)
    b = sd[name + ".bias"].to(device, dt) if name + ".bias" in sd else torch.zeros((o,), dtype=dt, device=device)
    return {"w": sd[name + ".weight"].to(device, dt), "b": b}


def _pick_bert_prefix(sd: StateDict, base: str) -> Optional[str]:
    for p in (base + ".bert.", base + "."):
        if p + "embeddings.word_embeddings.weight" in sd:
            return p
    return None


def _zero_fill_cross(sd: StateDict, prefix: str, med_cfg) -> Dict[str, torch.Tensor]:
    """The state dict with zero crossattention.* keys (unit LayerNorm) for
    the layers that lack them (ALBEF's pre-fusion layers), so that
    convert_med's stacked layout converts; the zeros are inert under the
    mode gating."""
    D = med_cfg.hidden_size
    out = dict(sd)
    tmpl = prefix + "encoder.layer.{i}.crossattention."
    for i in range(med_cfg.num_layers):
        base = tmpl.format(i=i)
        if base + "self.query.weight" not in out:
            for name in ("self.query", "self.key", "self.value", "output.dense"):
                out[base + name + ".weight"] = torch.zeros((D, D))
                out[base + name + ".bias"] = torch.zeros((D,))
            out[base + "output.LayerNorm.weight"] = torch.ones((D,))
            out[base + "output.LayerNorm.bias"] = torch.zeros((D,))
    return out


def convert_albef(sd: StateDict, cfg, variant: str = "retrieval", device=None) -> Dict[str, Any]:
    """A LAVIS ALBEF checkpoint → the models/albef tree: visual_encoder.*,
    text_encoder[.bert].* (the pre-fusion layers' cross stacks zero-filled),
    text_decoder[.bert].* for vqa, the projections, itm_head, cls_head.{0,2}
    and temp. The momentum copies (*_m) are dropped: the train step carries
    its own."""
    device = resolve_device(device)
    dt = cfg.text.dtype
    text_prefix = _pick_bert_prefix(sd, "text_encoder")
    if text_prefix is None:
        raise KeyError("no text_encoder.* keys in ALBEF state dict")
    # pretrain checkpoints are BertForMaskedLM: the MLM head is text_encoder.cls.*
    head_prefix = "text_encoder.cls." if variant == "pretrain" else "__none__."
    params: Dict[str, Any] = {
        "visual": convert_blip_vit(sd, cfg.vision, prefix="visual_encoder.", device=device),
        "text": convert_med(_zero_fill_cross(sd, text_prefix, cfg.text), cfg.text, prefix=text_prefix,
                            head_prefix=head_prefix, device=device),
    }
    E, D = cfg.embed_dim, cfg.text.hidden_size
    if variant in ("retrieval", "feature", "pretrain"):
        params["vision_proj"] = _linear_or_zeros(sd, "vision_proj", E, cfg.vision.hidden_size, dt, device)
        params["text_proj"] = _linear_or_zeros(sd, "text_proj", E, D, dt, device)
    if variant in ("retrieval", "pretrain"):
        params["itm_head"] = _linear_or_zeros(sd, "itm_head", 2, D, dt, device)
        params["temp"] = _temp(sd, device)
    if variant == "vqa":
        dec_prefix = _pick_bert_prefix(sd, "text_decoder")
        if dec_prefix is None:
            raise KeyError("vqa variant needs text_decoder.* keys")
        params["decoder"] = convert_med(_zero_fill_cross(sd, dec_prefix, cfg.decoder), cfg.decoder,
                                        prefix=dec_prefix, head_prefix="text_decoder.cls.", device=device)
    if variant in ("classification", "nlvr"):
        params["cls_head"] = {"fc1": _linear_or_zeros(sd, "cls_head.0", D, D, dt, device),
                              "fc2": _linear_or_zeros(sd, "cls_head.2", cfg.num_classes, D, dt, device)}
    return params


def convert_clip_full(sd: StateDict, cfg, device=None) -> Dict[str, Any]:
    """An HF CLIPModel state dict → the models/clip tree (the vision tower
    through convert_clip; q/k/v fused to one [L, 3D, D] text qkv)."""
    device = resolve_device(device)
    dt, L, p = cfg.text.dtype, cfg.text.num_layers, "text_model."
    get = _leaf(sd, device, dt)

    def st(template):
        return _stack(sd, p + "encoder.layers.{i}." + template, L, dt, device)

    def cat3(kind):
        return torch.cat([st(f"self_attn.{n}_proj.{kind}") for n in "qkv"], dim=1)

    def lin(name):
        return {"w": st(name + ".weight"), "b": st(name + ".bias")}

    def lnorm(name):
        return {"scale": st(name + ".weight"), "bias": st(name + ".bias")}

    return {
        "visual": convert_clip(sd, cfg.vision, prefix="vision_model.", device=device),
        "visual_proj": sd["visual_projection.weight"].t().to(device, dt).contiguous(),
        "token_embedding": get(p + "embeddings.token_embedding.weight"),
        "positional_embedding": get(p + "embeddings.position_embedding.weight"),
        "text_layers": {"ln1": lnorm("layer_norm1"), "qkv": {"w": cat3("weight"), "b": cat3("bias")},
                        "o": lin("self_attn.out_proj"), "ln2": lnorm("layer_norm2"), "fc1": lin("mlp.fc1"),
                        "fc2": lin("mlp.fc2")},
        "ln_final": {"scale": get(p + "final_layer_norm.weight"), "bias": get(p + "final_layer_norm.bias")},
        "text_proj": sd["text_projection.weight"].t().to(device, dt).contiguous(),
        "logit_scale": sd["logit_scale"].reshape(()).to(device, torch.float32),
    }


def convert_clip_openai(sd: StateDict, cfg, device=None) -> Dict[str, Any]:
    """An open_clip / LAVIS CLIP checkpoint (visual.*, transformer.resblocks.*)
    → the models/clip tree: the vision in_proj split into q/k/v kernels
    [L, in, out], the text's kept fused [L, 3D, D]."""
    device = resolve_device(device)
    dt = vdt = cfg.text.dtype  # the JAX converter casts every leaf to the text dtype
    Lv, Dv, Lt = cfg.vision.num_layers, cfg.vision.hidden_size, cfg.text.num_layers
    get = _leaf(sd, device, dt)

    def vst(template, transform=lambda w: w):
        return _stack(sd, "visual.transformer.resblocks." + template, Lv, vdt, device, transform)

    def tst(template):
        return _stack(sd, "transformer.resblocks." + template, Lt, dt, device)

    def kernel(template, rows=slice(None)):
        return vst(template, lambda w: w[rows].t())

    def v_attn(part):
        rows = slice(part * Dv, (part + 1) * Dv)
        return {"kernel": kernel("{i}.attn.in_proj_weight", rows),
                "bias": vst("{i}.attn.in_proj_bias", lambda b: b[rows])}

    def vln(name):
        return {"scale": vst(f"{{i}}.{name}.weight"), "bias": vst(f"{{i}}.{name}.bias")}

    conv = sd["visual.conv1.weight"]
    visual = {
        "cls": sd["visual.class_embedding"].reshape(-1).to(device, vdt),
        "patch_embed": conv.reshape(conv.shape[0], -1).t().to(device, vdt).contiguous(),
        "pos_embed": sd["visual.positional_embedding"].to(device, vdt),
        "pre_ln": {"scale": sd["visual.ln_pre.weight"].to(device, vdt),
                   "bias": sd["visual.ln_pre.bias"].to(device, vdt)},
        "layers": {
            "ln1": vln("ln_1"), "q": v_attn(0), "k": v_attn(1), "v": v_attn(2),
            "o": {"kernel": kernel("{i}.attn.out_proj.weight"), "bias": vst("{i}.attn.out_proj.bias")},
            "ln2": vln("ln_2"),
            "fc1": {"kernel": kernel("{i}.mlp.c_fc.weight"), "bias": vst("{i}.mlp.c_fc.bias")},
            "fc2": {"kernel": kernel("{i}.mlp.c_proj.weight"), "bias": vst("{i}.mlp.c_proj.bias")},
        },
        "post_ln": {"scale": sd["visual.ln_post.weight"].to(device, vdt),
                    "bias": sd["visual.ln_post.bias"].to(device, vdt)},
    }

    def tlin(name):
        return {"w": tst(f"{{i}}.{name}.weight"), "b": tst(f"{{i}}.{name}.bias")}

    def tln(name):
        return {"scale": tst(f"{{i}}.{name}.weight"), "bias": tst(f"{{i}}.{name}.bias")}

    return {
        "visual": visual,
        "visual_proj": get("visual.proj"),  # already [D, E]
        "token_embedding": get("token_embedding.weight"),
        "positional_embedding": get("positional_embedding"),
        "text_layers": {"ln1": tln("ln_1"),
                        "qkv": {"w": tst("{i}.attn.in_proj_weight"), "b": tst("{i}.attn.in_proj_bias")},
                        "o": tlin("attn.out_proj"), "ln2": tln("ln_2"), "fc1": tlin("mlp.c_fc"),
                        "fc2": tlin("mlp.c_proj")},
        "ln_final": {"scale": get("ln_final.weight"), "bias": get("ln_final.bias")},
        "text_proj": get("text_projection"),  # already [D, E]
        "logit_scale": sd["logit_scale"].reshape(()).to(device, torch.float32),
    }


def convert_blip_nlvr(sd: StateDict, cfg, device=None) -> Dict[str, Any]:
    """A LAVIS BLIP-NLVR checkpoint (nlvr_encoder.py's twin cross-attention:
    crossattention.self0/self1, output.dense0/dense1, output.merge_layer
    from layer merge_from on) → the models/blip_variants NLVR tree; `cfg`
    is an NlvrConfig. merge_layer is zeros where a layer has none."""
    device = resolve_device(device)
    tc = cfg.base.text
    dt, L, D = tc.dtype, tc.num_layers, tc.hidden_size
    prefix = _pick_bert_prefix(sd, "text_encoder")
    if prefix is None:
        raise KeyError("no text_encoder.* keys in NLVR state dict")
    base = convert_med(sd, tc, prefix=prefix, head_prefix="__none__.", device=device)

    def st(template):
        return _stack(sd, prefix + template, L, dt, device)

    def lin(name):
        return {"w": st(name + ".weight"), "b": st(name + ".bias")}

    layers = dict(base["layers"])
    x = "encoder.layer.{i}.crossattention."
    for tw in ("0", "1"):
        layers[f"c{tw}q"] = lin(f"{x}self{tw}.query")
        layers[f"c{tw}k"] = lin(f"{x}self{tw}.key")
        layers[f"c{tw}v"] = lin(f"{x}self{tw}.value")
        layers[f"d{tw}"] = lin(f"{x}output.dense{tw}")
    layers["c_ln"] = {"scale": st(x + "output.LayerNorm.weight"), "bias": st(x + "output.LayerNorm.bias")}
    mw = torch.zeros((L, D, 2 * D), dtype=dt, device=device)
    mb = torch.zeros((L, D), dtype=dt, device=device)
    for i in range(L):
        key = prefix + x.format(i=i) + "output.merge_layer.weight"
        if key in sd:
            mw[i].copy_(sd[key])
            mb[i].copy_(sd[key.replace("weight", "bias")])
    layers["merge"] = {"w": mw, "b": mb}
    for k in ("cq", "ck", "cv", "co"):
        layers.pop(k, None)
    base["layers"] = layers
    return {
        "visual": convert_blip_vit(sd, cfg.base.vision, prefix="visual_encoder.", device=device),
        "text": base,
        "cls_head": {"fc1": _linear_or_zeros(sd, "cls_head.0", D, D, dt, device),
                     "fc2": _linear_or_zeros(sd, "cls_head.2", cfg.num_classes, D, dt, device)},
    }


def convert_blip_variant(sd: StateDict, cfg, variant: str, num_classes: int = 2, device=None) -> Dict[str, Any]:
    """A LAVIS BLIP variant checkpoint → the models/blip_variants tree. The
    text tree always comes from text_encoder.*; vqa adds text_decoder.* (+
    its cls head) as "decoder", classification cls_head.{0,2}, retrieval the
    projections, itm_head and temp, pretrain retrieval + the decoder."""
    device = resolve_device(device)
    tc = cfg.text
    dt, D = tc.dtype, tc.hidden_size
    enc_prefix = _pick_bert_prefix(sd, "text_encoder")
    if enc_prefix is None:
        raise KeyError(f"{variant} checkpoint lacks text_encoder.* keys")
    params: Dict[str, Any] = {
        "visual": convert_blip_vit(sd, cfg.vision, prefix="visual_encoder.", device=device),
        "text": convert_med(sd, tc, prefix=enc_prefix, head_prefix="__none__.", device=device),
    }

    def decoder(what):
        dec_prefix = _pick_bert_prefix(sd, "text_decoder")
        if dec_prefix is None:
            raise KeyError(f"{what} checkpoint lacks text_decoder.* keys")
        return convert_med(sd, tc, prefix=dec_prefix, head_prefix="text_decoder.cls.", device=device)

    if variant in ("retrieval", "pretrain"):
        E = cfg.embed_dim
        params["vision_proj"] = _linear_or_zeros(sd, "vision_proj", E, cfg.vision.hidden_size, dt, device)
        params["text_proj"] = _linear_or_zeros(sd, "text_proj", E, D, dt, device)
        params["itm_head"] = _linear_or_zeros(sd, "itm_head", 2, D, dt, device)
        params["temp"] = _temp(sd, device)
        if variant == "pretrain":
            params["decoder"] = decoder("pretrain")
        return params
    if variant == "vqa":
        params["decoder"] = decoder("vqa")
    elif variant == "classification":
        params["cls_head"] = {"fc1": _linear_or_zeros(sd, "cls_head.0", D, D, dt, device),
                              "fc2": _linear_or_zeros(sd, "cls_head.2", num_classes, D, dt, device)}
    else:
        raise ValueError(f"unknown blip variant {variant!r}")
    return params


# ---------------------------------------------------------------------------
# the video and dialogue families: TimeSformer, ALPRO, GPT-2, GPT dialogue
# ---------------------------------------------------------------------------


def convert_timesformer(sd: StateDict, cfg, prefix: str = "visual_encoder.model.", device=None) -> Dict[str, Any]:
    """A LAVIS TimeSformer state dict (timesformer/vit.py VisionTransformer)
    → the models/timesformer tree (qkv stays fused, [L, 3D, D])."""
    device = resolve_device(device)
    dt, L = cfg.dtype, cfg.num_layers
    get = _leaf(sd, device, dt)

    def lin(name):
        return {"w": _stack(sd, prefix + f"blocks.{{i}}.{name}.weight", L, dt, device),
                "b": _stack(sd, prefix + f"blocks.{{i}}.{name}.bias", L, dt, device)}

    def lnorm(name):
        return {"scale": _stack(sd, prefix + f"blocks.{{i}}.{name}.weight", L, dt, device),
                "bias": _stack(sd, prefix + f"blocks.{{i}}.{name}.bias", L, dt, device)}

    return {
        "cls": get(prefix + "cls_token"),
        "pos": get(prefix + "pos_embed"),
        "time": get(prefix + "time_embed"),
        "patch": {"w": get(prefix + "patch_embed.proj.weight"), "b": get(prefix + "patch_embed.proj.bias")},
        "layers": {"t_ln": lnorm("temporal_norm1"), "t_qkv": lin("temporal_attn.qkv"),
                   "t_proj": lin("temporal_attn.proj"), "t_fc": lin("temporal_fc"),
                   "ln1": lnorm("norm1"), "qkv": lin("attn.qkv"), "proj": lin("attn.proj"),
                   "ln2": lnorm("norm2"), "fc1": lin("mlp.fc1"), "fc2": lin("mlp.fc2")},
        "final_ln": {"scale": get(prefix + "norm.weight"), "bias": get(prefix + "norm.bias")},
    }


def convert_alpro(sd: StateDict, cfg, variant: str = "retrieval", device=None) -> Dict[str, Any]:
    """A LAVIS ALPRO checkpoint → the models/alpro tree. The ALPRO BERT has
    no cross-attention (bert_config_alpro.json add_cross_attention=false):
    its cross stacks are zero-filled and never run (fusion is
    self-attention over the concatenated sequence). Heads the checkpoint
    lacks are zeros; temp defaults to 0.07."""
    device = resolve_device(device)
    text_prefix = _pick_bert_prefix(sd, "text_encoder")
    if text_prefix is None:
        raise KeyError("no text_encoder.* keys in ALPRO state dict")
    dt, D, E = cfg.text.dtype, cfg.text.hidden_size, cfg.embed_dim
    params: Dict[str, Any] = {
        "visual": convert_timesformer(sd, cfg.video, device=device),
        "text": convert_med(_zero_fill_cross(sd, text_prefix, cfg.text), cfg.text, prefix=text_prefix,
                            head_prefix="__none__.", device=device),
    }
    if variant == "retrieval":
        params["vision_proj"] = _linear_or_zeros(sd, "vision_proj", E, cfg.video.hidden_size, dt, device)
        params["text_proj"] = _linear_or_zeros(sd, "text_proj", E, D, dt, device)
        params["itm_head"] = _linear_or_zeros(sd, "itm_head", 2, D, dt, device)
        params["temp"] = _temp(sd, device)
    if variant == "qa":
        params["classifier"] = {"fc1": _linear_or_zeros(sd, "classifier.0", 2 * D, D, dt, device),
                                "fc2": _linear_or_zeros(sd, "classifier.2", cfg.num_classes, 2 * D, dt, device)}
    return params


def convert_gpt2(sd: StateDict, cfg, prefix: str = "transformer.", device=None) -> Dict[str, Any]:
    """An HF GPT2LMHeadModel state dict → the models/gpt2 tree. HF GPT-2's
    Conv1D weights are [in, out]: transposed here to [out, in]."""
    device = resolve_device(device)
    dt, L = cfg.dtype, cfg.num_layers
    get = _leaf(sd, device, dt)

    def conv1d(name):
        return {"w": _stack(sd, prefix + f"h.{{i}}.{name}.weight", L, dt, device, lambda w: w.t()),
                "b": _stack(sd, prefix + f"h.{{i}}.{name}.bias", L, dt, device)}

    def lnorm(name):
        return {"scale": _stack(sd, prefix + f"h.{{i}}.{name}.weight", L, dt, device),
                "bias": _stack(sd, prefix + f"h.{{i}}.{name}.bias", L, dt, device)}

    return {
        "wte": get(prefix + "wte.weight"),
        "wpe": get(prefix + "wpe.weight"),
        "layers": {"ln1": lnorm("ln_1"), "qkv": conv1d("attn.c_attn"), "o": conv1d("attn.c_proj"),
                   "ln2": lnorm("ln_2"), "fc1": conv1d("mlp.c_fc"), "fc2": conv1d("mlp.c_proj")},
        "ln_f": {"scale": get(prefix + "ln_f.weight"), "bias": get(prefix + "ln_f.bias")},
    }


def convert_gpt_dialogue(sd: StateDict, cfg, device=None) -> Dict[str, Any]:
    """A LAVIS GPTDialogue checkpoint (gpt_dialogue.py: GPT2LMHeadModel +
    the video_ff / video_ff_out Linears) → the models/gpt2 dialogue tree."""
    device = resolve_device(device)
    get = _leaf(sd, device, cfg.gpt.dtype)
    return {
        "gpt": convert_gpt2(sd, cfg.gpt, device=device),
        "video_ff": {"w": get("video_ff.weight"), "b": get("video_ff.bias")},
        "video_ff_out": {"w": get("video_ff_out.weight"), "b": get("video_ff_out.bias")},
    }
