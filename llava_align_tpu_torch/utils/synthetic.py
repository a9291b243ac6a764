"""Random-weight LLaVA params at real shapes (torch twin of
llava_align_tpu/utils/synthetic.py build_random_llava_params).

The tree and the init scales are those of the JAX package's llava.init (+
quantize_llama_params(fuse=True) for quant="int8"); the random numbers are
not (parity tests carry JAX params over with utils/jax_params instead).
int8 stacks are built layer by layer on the device — each layer's weights
are drawn in the model dtype, fused (q|k|v, gate|up) and quantized — so the
peak is the int8 total plus one layer in float.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from llava_align_tpu_torch.models import projector
from llava_align_tpu_torch.ops.quant import quantize_weight


def build_random_llava_params(cfg, quant: str = "none", device=None, seed: int = 0) -> Dict[str, Any]:
    if quant not in ("none", "int8"):
        raise NotImplementedError(f"quant={quant!r}: only none/int8 are ported")
    g = torch.Generator(device=device).manual_seed(seed)

    def w(shape, fan_in, dtype):
        x = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
        return (x / fan_in**0.5).to(dtype)

    def ones(shape, dtype):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    t = cfg.text
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
    if quant == "int8":
        for name, (parts, cols) in stacks.items():
            O = sum(r for r, _ in parts)
            q = torch.empty((L, O, cols), dtype=torch.int8, device=device)
            s = torch.empty((L, O), dtype=torch.float32, device=device)
            for li in range(L):
                wq = quantize_weight(torch.cat([w((r, cols), f, dt) for r, f in parts]))
                q[li], s[li] = wq["q"], wq["s"]
            layers[name] = {"q": q, "s": s}
        lm_head = quantize_weight(w((V, D), D, dt))
    else:
        layers.update(
            q=w((L, QD, D), D, dt), k=w((L, KD, D), D, dt), v=w((L, KD, D), D, dt),
            o=w((L, D, QD), QD, dt), gate=w((L, F, D), D, dt), up=w((L, F, D), D, dt),
            down=w((L, D, F), F, dt),
        )
        lm_head = w((V, D), D, dt)
    llama = {"embed": w((V, D), D, dt), "layers": layers, "final_norm": ones((D,), dt),
             "lm_head": lm_head}

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
    return {"llama": llama, "vision": vision, "projector": {"layers": proj_layers}}
