"""Numerics-parity checker: the port vs HF-torch logits on a real
checkpoint (torch twin of llava_align_tpu/utils/parity_check.py).

    python -m llava_align_tpu_torch.utils.parity_check \
        --model-path /ckpt/llava-v1.5-7b --prompt "Is there a dog?" \
        [--image /path/img.jpg] [--dtype float32] [--tol 1e-3] [--device cpu]

The oracle is assembled from the checkpoint's OWN state dict, as the JAX
package assembles it:

- **language tower**: a plain `transformers.LlamaForCausalLM` built from
  config.json dims, loading the `model.*`/`lm_head.*` keys directly (not
  `AutoModelForCausalLM`, which maps `model_type: "llava"` to
  `LlavaForConditionalGeneration`, whose `language_model.*` key layout
  mismatches the checkpoint and would load random weights).
- **vision tower + projector** (with --image): `transformers.CLIPVisionModel`
  fed the `model.vision_tower.vision_tower.*` keys, select_layer /
  select_feature applied as in the reference `clip_encoder.py:31-39`, then
  the mm_projector weights applied in torch — compared against the port's
  `llava.encode_images` on the same preprocessed pixels.

Both sides run in fp32 math on `--device` (the GPU unless another is
named); `transformers` is imported only by the oracle functions and the
CLI, so the module imports without it.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def compare_logits(ours: np.ndarray, theirs: np.ndarray, top_k: int = 10) -> dict:
    diff = np.abs(ours - theirs)
    ours_top = np.argsort(-ours)[:top_k]
    theirs_top = np.argsort(-theirs)[:top_k]
    return {
        "max_abs_diff": float(diff.max()),
        "mean_abs_diff": float(diff.mean()),
        "top1_match": bool(ours_top[0] == theirs_top[0]),
        f"top{top_k}_overlap": int(len(set(ours_top.tolist()) & set(theirs_top.tolist()))),
        "ours_top1": int(ours_top[0]),
        "theirs_top1": int(theirs_top[0]),
    }


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=torch.float32)


def torch_language_oracle(sd: dict, hf_cfg: dict, device="cpu"):
    """LlamaForCausalLM carrying the checkpoint's language weights, fp32 on
    `device`."""
    from transformers import LlamaConfig as TLlamaConfig
    from transformers import LlamaForCausalLM

    tcfg = TLlamaConfig(
        vocab_size=hf_cfg["vocab_size"],
        hidden_size=hf_cfg["hidden_size"],
        intermediate_size=hf_cfg["intermediate_size"],
        num_hidden_layers=hf_cfg["num_hidden_layers"],
        num_attention_heads=hf_cfg["num_attention_heads"],
        num_key_value_heads=hf_cfg.get("num_key_value_heads", hf_cfg["num_attention_heads"]),
        rms_norm_eps=hf_cfg.get("rms_norm_eps", 1e-5),
        rope_theta=hf_cfg.get("rope_theta", 10000.0),
        max_position_embeddings=hf_cfg.get("max_position_embeddings", 4096),
    )
    with torch.device(device):  # built where it runs: a random init of every weight it then replaces
        model = LlamaForCausalLM(tcfg).eval().float()
    lang = {
        k: _t(v, device)
        for k, v in sd.items()
        if (
            k.startswith("model.")
            and not k.startswith("model.vision_tower.")
            and not k.startswith("model.mm_projector.")
        )
        or k.startswith("lm_head.")
    }
    missing, unexpected = model.load_state_dict(lang, strict=False)
    # rotary inv_freq is a generated (often non-persistent) buffer
    missing = [k for k in missing if "rotary_emb.inv_freq" not in k]
    if missing:
        raise KeyError(f"language tower keys missing from checkpoint: {missing[:8]}")
    if unexpected:
        print(f"note: {len(unexpected)} non-LLaMA keys ignored "
              f"(e.g. {sorted(unexpected)[:3]})", file=sys.stderr)
    return model


def torch_vision_projector_feats(sd: dict, cfg, pixels: np.ndarray, device="cpu") -> np.ndarray:
    """CLIPVisionModel + mm_projector on [B,3,H,W] float32 pixels → features
    (the HF analog of llava.encode_images), fp32 on `device`."""
    from transformers import CLIPVisionConfig as TClipCfg
    from transformers import CLIPVisionModel

    from llava_align_tpu_torch.models.projector import num_layers

    v = cfg.vision
    tcfg = TClipCfg(
        hidden_size=v.hidden_size,
        intermediate_size=v.intermediate_size,
        num_hidden_layers=v.num_layers,
        num_attention_heads=v.num_heads,
        image_size=v.image_size,
        patch_size=v.patch_size,
    )
    with torch.device(device):
        model = CLIPVisionModel(tcfg).eval().float()
    prefix = "model.vision_tower.vision_tower."
    vsd = {k[len(prefix):]: _t(val, device) for k, val in sd.items() if k.startswith(prefix)}
    missing, _ = model.load_state_dict(vsd, strict=False)
    missing = [k for k in missing if "position_ids" not in k]
    if missing:
        raise KeyError(f"vision tower keys missing from checkpoint: {missing[:8]}")

    with torch.no_grad():
        out = model(_t(pixels, device), output_hidden_states=True)
        feats = out.hidden_states[v.select_layer]
        if v.select_feature == "patch":
            feats = feats[:, 1:]
        x = feats
        n = num_layers(cfg.mm_projector_type)
        for i in range(n):
            if i > 0:
                x = torch.nn.functional.gelu(x)  # exact erf, nn.GELU default
            key_w = f"model.mm_projector.{2 * i}.weight"
            if key_w not in sd and n == 1:
                key_w = "model.mm_projector.weight"  # bare Linear projector
            w = _t(sd[key_w], device)
            b = _t(sd[key_w.replace("weight", "bias")], device)
            x = x @ w.T + b
    return x.cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--prompt", default="Is there a dog in the image?")
    ap.add_argument("--image", default=None)
    ap.add_argument("--conv-mode", default="llava_v1")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--tol", type=float, default=None,
                    help="exit nonzero when the text max_abs_diff (logits are "
                         "O(10)-scaled) or the vision rel_max_diff (features "
                         "are scale-free) exceeds this")
    ap.add_argument("--device", default="cuda", help="where both sides run (default: the GPU)")
    args = ap.parse_args(argv)

    import json
    import os

    from transformers import AutoTokenizer

    from llava_align_tpu_torch.models import llava as tl
    from llava_align_tpu_torch.runners.common import build_prompt, load_image_tensor
    from llava_align_tpu_torch.tokenization import tokenizer_image_token
    from llava_align_tpu_torch.utils.hf_convert import load_llava_checkpoint, load_state_dict

    if args.device == "cuda" and torch.cuda.is_available():
        # fp32 on both sides means fp32 products: no TF32 on the tensor cores
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dtype = torch.float32 if args.dtype == "float32" else torch.bfloat16
    model_path = os.path.expanduser(args.model_path)
    params, cfg = load_llava_checkpoint(model_path, dtype, device=args.device)
    with open(os.path.join(model_path, "config.json")) as f:
        hf_cfg = json.load(f)
    sd = load_state_dict(model_path)
    try:  # slow (sentencepiece) tokenizer when available, fast otherwise
        tokenizer = AutoTokenizer.from_pretrained(model_path, use_fast=False)
    except Exception:
        tokenizer = AutoTokenizer.from_pretrained(model_path, use_fast=True)

    report = {}

    # language tower: text-only last-position logits, ours vs torch LLaMA
    prompt, _ = build_prompt(args.prompt, args.conv_mode, with_image=False, one_word=True)
    ids = tokenizer_image_token(prompt, tokenizer)
    pad = -(-len(ids) // 64) * 64
    with torch.inference_mode():
        logits, length = tl.forward_multimodal(params, cfg, ids, None, pad_to=pad)
    ours = logits[length - 1].float().cpu().numpy()
    hf = torch_language_oracle(sd, hf_cfg, args.device)
    with torch.no_grad():
        theirs = hf(input_ids=torch.tensor([ids], device=args.device)).logits[0, -1].float().cpu().numpy()
    report["text_logits"] = compare_logits(ours, theirs)

    # vision tower + projector on the provided image
    if args.image is not None:
        pixels = np.asarray(
            load_image_tensor("", args.image, image_size=cfg.vision.image_size, transfer="float32"),
            np.float32,
        )[None]
        with torch.inference_mode():
            ours_f = tl.encode_images(params, cfg, torch.from_numpy(pixels).to(args.device, dtype))
        ours_f = ours_f.float().cpu().numpy()
        theirs_f = torch_vision_projector_feats(sd, cfg, pixels, args.device)
        fd = np.abs(ours_f.astype(np.float64) - theirs_f.astype(np.float64))
        rms = float(np.sqrt((theirs_f.astype(np.float64) ** 2).mean()))
        report["vision_projector_feats"] = {
            "max_abs_diff": float(fd.max()),
            "mean_abs_diff": float(fd.mean()),
            "feat_rms": rms,
            # features are scale-free (the projector output feeds layernormed
            # residuals), so the gated quantity is relative to feature RMS
            "rel_max_diff": float(fd.max() / max(rms, 1e-12)),
            "shape": list(ours_f.shape),
        }
        report["note"] = (
            "composed splice parity is pinned by tests/test_llava_arch_oracle.py "
            "against the reference prepare_inputs_labels_for_multimodal"
        )

    print(json.dumps(report))
    if args.tol is not None:
        worst = max(
            v.get("rel_max_diff", v["max_abs_diff"])
            for v in report.values()
            if isinstance(v, dict)
        )
        if worst > args.tol:
            print(f"FAIL: deviation {worst} > tol {args.tol}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
