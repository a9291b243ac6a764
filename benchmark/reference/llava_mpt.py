"""LLaVA-MPT in plain fp32 PyTorch: the weights the benchmark makes from a
seed, and the reference forward that judges the program's answers.

Follows the published description: CLIP ViT-L/14 (pre-LN blocks with
quick-GELU, a class token and absolute positions; LLaVA takes the
residual stream after the second-to-last layer, patch tokens only), the
mlp2x_gelu projector, and MPT-7B (pre-LayerNorm blocks with no biases,
packed q|k|v, ALiBi attention with the canonical -slope * (i - j) bias,
an exact-GELU MLP of expansion 4, the head tied to the embedding).

`make_weights` lays the float weights out in the tree the program takes
(CLIP kernels and the projector [in, out]; MPT linears [out, in] stacked
over layers); both sides get the same tensors from it. Imports torch and
numpy only.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from benchmark.reference.common import (
    IMAGE_SENTINEL, act_in, attention, causal_key_mask, layer_norm, randn, row_chunks, weight_in,
)


def dims(cfg: dict) -> dict:
    v = cfg["vision"]
    return dict(
        V=cfg["vocab_size"], D=cfg["d_model"], L=cfg["n_layers"], H=cfg["n_heads"],
        F=cfg["expansion_ratio"] * cfg["d_model"], bias_max=cfg["attn_config"]["alibi_bias_max"],
        eps=cfg["layer_norm_eps"], vD=v["hidden_size"], vF=v["intermediate_size"], vL=v["num_hidden_layers"],
        vH=v["num_attention_heads"], P=v["patch_size"], N=(v["image_size"] // v["patch_size"]) ** 2,
        S_img=v["image_size"], select_layer=v["select_layer"], veps=v["layer_norm_eps"],
        dtype=getattr(torch, cfg["serving"]["dtype"]),
    )


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The float LLaVA-MPT tree drawn from `seed` on `device`, one draw per
    leaf: linears N(0, 1/fan_in); norm scales 1 + N(0, 0.05^2); CLIP's and
    the projector's biases N(0, 0.02^2); MPT's norm biases zero (no_bias)."""
    d = dims(cfg)
    g = torch.Generator(device=device).manual_seed(int(seed))
    dt = d["dtype"]
    V, D, L, F = d["V"], d["D"], d["L"], d["F"]

    def lin(shape, fan_in):
        return randn(g, shape, fan_in ** -0.5, dt, device)

    def scale(shape):
        return randn(g, shape, 0.05, dt, device).add_(1.0)

    def bias(shape):
        return randn(g, shape, 0.02, dt, device)

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=device)

    mpt = {
        "wte": lin((V, D), D),
        "layers": {"norm_1": {"scale": scale((L, D)), "bias": zeros((L, D))}, "wqkv": lin((L, 3 * D, D), D),
                   "out_proj": lin((L, D, D), D), "norm_2": {"scale": scale((L, D)), "bias": zeros((L, D))},
                   "up_proj": lin((L, F, D), D), "down_proj": lin((L, D, F), F)},
        "norm_f": {"scale": scale((D,)), "bias": zeros((D,))},
    }
    vD, vF, vL, P, N = d["vD"], d["vF"], d["vL"], d["P"], d["N"]

    def ln(shape):
        return {"scale": scale(shape), "bias": bias(shape)}

    def vlin(fan_in, out):
        return {"kernel": lin((vL, fan_in, out), fan_in), "bias": bias((vL, out))}

    vision = {
        "cls": lin((vD,), vD), "patch_embed": lin((3 * P * P, vD), 3 * P * P), "pos_embed": lin((1 + N, vD), vD),
        "pre_ln": ln((vD,)),
        "layers": {"ln1": ln((vL, vD)), "q": vlin(vD, vD), "k": vlin(vD, vD), "v": vlin(vD, vD),
                   "o": vlin(vD, vD), "ln2": ln((vL, vD)), "fc1": vlin(vD, vF), "fc2": vlin(vF, vD)},
        "post_ln": ln((vD,)),
    }
    projector = {"layers": [{"kernel": lin((vD, D), vD), "bias": bias((D,))},
                            {"kernel": lin((D, D), D), "bias": bias((D,))}]}
    return {"mpt": mpt, "vision": vision, "projector": projector}


def alibi_slopes(n_heads: int, bias_max: float) -> torch.Tensor:
    """MPT's per-head slopes 1 / 2^(8 (h + 1) / n) (n a power of two here)."""
    n = 2 ** math.ceil(math.log2(n_heads))
    m = torch.arange(1, n + 1, dtype=torch.float64) * bias_max / n
    s = 1.0 / torch.pow(2.0, m)
    if n != n_heads:
        s = torch.cat([s[1::2], s[0::2]])[:n_heads]
    return s.float()


class Reference:
    """The fp32 LLaVA-MPT forward over the weights `make_weights` gives for
    `seed`; the decoder's matrices (the tied embedding too) rounded to
    `precision` first (float for the configuration, which serves bf16;
    fp8, weights and the products' inputs, for its control)."""

    def __init__(self, cfg: dict, seed: int, device, precision: str = "float"):
        self.cfg, self.d, self.device, self.precision = cfg, dims(cfg), device, precision
        self.w = make_weights(cfg, seed, device)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Normalized pixels [G, 3, H, W] fp32 → projected patch features [G, N, D]."""
        d, vp = self.d, self.w["vision"]
        f = lambda t: t.float()  # noqa: E731
        G, P, vD, vH = x.shape[0], d["P"], d["vD"], d["vH"]
        gh = x.shape[2] // P
        patches = x.reshape(G, 3, gh, P, gh, P).permute(0, 2, 4, 1, 3, 5).reshape(G, gh * gh, 3 * P * P)
        h = patches @ f(vp["patch_embed"])
        h = torch.cat([f(vp["cls"]).expand(G, 1, vD), h], dim=1) + f(vp["pos_embed"])
        h = layer_norm(h, vp["pre_ln"]["scale"], vp["pre_ln"]["bias"], d["veps"])
        lay = vp["layers"]
        sl = d["select_layer"]
        for li in range(d["vL"] + 1 + sl if sl < 0 else sl):
            def lin(name, y):
                return y @ f(lay[name]["kernel"][li]) + f(lay[name]["bias"][li])

            y = layer_norm(h, lay["ln1"]["scale"][li], lay["ln1"]["bias"][li], d["veps"])
            q, k, v = (lin(n, y).reshape(G, -1, vH, vD // vH) for n in ("q", "k", "v"))
            h = h + lin("o", attention(q, k, v, None).reshape(G, -1, vD))
            y = layer_norm(h, lay["ln2"]["scale"][li], lay["ln2"]["bias"][li], d["veps"])
            y = lin("fc1", y)
            h = h + lin("fc2", y * torch.sigmoid(1.702 * y))
        h = h[:, 1:]
        p0, p1 = self.w["projector"]["layers"]
        h = torch.nn.functional.gelu(h @ f(p0["kernel"]) + f(p0["bias"]))
        return h @ f(p1["kernel"]) + f(p1["bias"])

    def logits(self, rows: Sequence[Tuple[Sequence[int], Optional[int], Sequence[int]]],
               feats: Optional[torch.Tensor], budget: int = 16384) -> List[torch.Tensor]:
        """As qwen_vl.Reference.logits: rows of (ids, image index or None,
        positions) → one fp32 [len(positions), V] per row."""
        d, mp, dev = self.d, self.w["mpt"], self.device
        D, H, eps = d["D"], d["H"], d["eps"]
        wte = weight_in(mp["wte"], self.precision)
        seqs = []
        for ids, img, _ in rows:
            emb = [feats[img] if t == IMAGE_SENTINEL else wte[int(t)][None] for t in ids]
            seqs.append(torch.cat(emb))
        lengths = [s.shape[0] for s in seqs]
        S = max(lengths)
        x = torch.zeros((len(rows), S, D), device=dev)
        for i, s in enumerate(seqs):
            x[i, : s.shape[0]] = s
        slopes = alibi_slopes(H, d["bias_max"]).to(dev)
        pos = torch.arange(S, device=dev).float()
        alibi = -slopes[:, None, None] * (pos[:, None] - pos[None, :]).abs()[None]  # [H, S, S]
        chunks = row_chunks(lengths, budget)
        lay = mp["layers"]
        for li in range(d["L"]):
            w_qkv, w_o, w_up, w_down = (weight_in(lay[k][li], self.precision)
                                        for k in ("wqkv", "out_proj", "up_proj", "down_proj"))
            for rc in chunks:
                n = max(lengths[i] for i in rc)
                xs = x[rc, :n]
                h = layer_norm(xs, lay["norm_1"]["scale"][li], lay["norm_1"]["bias"][li], eps)
                q, k, v = (t.reshape(len(rc), n, H, D // H) for t in (act_in(h, self.precision) @ w_qkv.t()).split(D, dim=-1))
                a = attention(q, k, v, causal_key_mask([lengths[i] for i in rc], n, dev), alibi[None, :, :n, :n])
                xs = xs + act_in(a.reshape(len(rc), n, D), self.precision) @ w_o.t()
                h = layer_norm(xs, lay["norm_2"]["scale"][li], lay["norm_2"]["bias"][li], eps)
                up = torch.nn.functional.gelu(act_in(h, self.precision) @ w_up.t())
                xs = xs + act_in(up, self.precision) @ w_down.t()
                x[rc, :n] = xs
            del w_qkv, w_o, w_up, w_down
        out = []
        for i, (_, _, positions) in enumerate(rows):
            h = layer_norm(x[i, list(positions)], mp["norm_f"]["scale"], mp["norm_f"]["bias"], eps)
            out.append(act_in(h, self.precision) @ wte.t())
        return out
