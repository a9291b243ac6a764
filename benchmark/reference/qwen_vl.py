"""Qwen-VL in plain fp32 PyTorch: the weights the benchmark makes from a
seed, and the reference forward that judges the program's answers.

Follows the published description (Qwen-VL's modeling_qwen.py and
visual.py): a ViT (bias-free conv patchify, absolute positions, pre-LN
blocks with exact GELU), the Resampler (learned queries cross-attending
the patches, 2-D position tables on queries and keys), ln_post and a
projection; then the decoder: RMSNorm, packed q|k|v with a bias, rotary
positions with a dynamic-NTK base and log-n query scaling past the
trained context, SwiGLU-style MLP (w1 * silu(w2)), an untied head.

`make_weights` lays the float weights out in the tree the program takes
(linear weights [out, in] stacked over layers; the ViT's in_proj packed per
head as [H, (q, k, v), Dh]); both sides get the same tensors from it.
Imports torch and numpy only.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from benchmark.reference.common import (
    IMAGE_SENTINEL, act_in, attention, causal_key_mask, layer_norm, randn, rms_norm, row_chunks, weight_in,
)

def dims(cfg: dict) -> dict:
    v = cfg["visual"]
    W = v["width"]
    return dict(
        V=cfg["vocab_size"], D=cfg["hidden_size"], L=cfg["num_hidden_layers"], H=cfg["num_attention_heads"],
        Dh=cfg["kv_channels"], F2=cfg["intermediate_size"] // 2, eps=cfg["layer_norm_epsilon"],
        W=W, vL=v["layers"], vH=v["heads"], Fv=int(W * v["mlp_ratio"]), P=v["patch_size"],
        N=(v["image_size"] // v["patch_size"]) ** 2, Q=v["n_queries"], E=v["output_dim"],
        S_img=v["image_size"], dtype=getattr(torch, cfg["serving"]["dtype"]),
        vdtype=getattr(torch, cfg["serving"]["visual_dtype"]),
    )


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The float Qwen-VL tree drawn from `seed` on `device`, one draw per
    leaf: linears N(0, 1/fan_in); norm scales 1 + N(0, 0.05^2); biases
    N(0, 0.02^2); the position tables N(0, 0.5^2)."""
    d = dims(cfg)
    g = torch.Generator(device=device).manual_seed(int(seed))
    dt, vdt = d["dtype"], d["vdtype"]
    V, D, L, QD, F2 = d["V"], d["D"], d["L"], d["H"] * d["Dh"], d["F2"]

    def lin(shape, fan_in, dtype=dt):
        return randn(g, shape, fan_in ** -0.5, dtype, device)

    def scale(shape, dtype=dt):
        return randn(g, shape, 0.05, dtype, device).add_(1.0)

    def bias(shape, dtype=dt):
        return randn(g, shape, 0.02, dtype, device)

    qwen = {
        "wte": lin((V, D), D),
        "layers": {
            "ln_1": scale((L, D)), "c_attn_w": lin((L, 3 * QD, D), D), "c_attn_b": bias((L, 3 * QD)),
            "attn_proj": lin((L, D, QD), QD), "ln_2": scale((L, D)),
            "w1": lin((L, F2, D), D), "w2": lin((L, F2, D), D), "mlp_proj": lin((L, D, F2), F2),
        },
        "ln_f": scale((D,)),
        "lm_head": lin((V, D), D),
    }
    W, vL, Fv, P, N, Q, E = d["W"], d["vL"], d["Fv"], d["P"], d["N"], d["Q"], d["E"]

    def ln(shape):
        return {"scale": scale(shape, vdt), "bias": bias(shape, vdt)}

    def vlin(out, fan_in, lead=(vL,)):
        return {"w": lin(lead + (out, fan_in), fan_in, vdt), "b": bias(lead + (out,), vdt)}

    visual = {
        "conv": lin((W, 3 * P * P), 3 * P * P, vdt),
        "pos_embed": randn(g, (N, W), 0.5, vdt, device),
        "ln_pre": ln((W,)),
        "layers": {"ln_1": ln((vL, W)), "in_proj": vlin(3 * W, W), "out_proj": vlin(W, W),
                   "ln_2": ln((vL, W)), "c_fc": vlin(Fv, W), "c_proj": vlin(W, Fv)},
        "resampler": {
            "query": lin((Q, E), E, vdt), "pos_q": randn(g, (Q, E), 0.5, vdt, device),
            "pos_kv": randn(g, (N, E), 0.5, vdt, device), "kv_proj": lin((E, W), W, vdt),
            "ln_q": ln((E,)), "ln_kv": ln((E,)), "in_proj": vlin(3 * E, E, ()), "out_proj": vlin(E, E, ()),
        },
        "ln_post": ln((E,)),
        "proj": lin((E, E), E, vdt),
    }
    return {"qwen": qwen, "visual": visual}


class Reference:
    """The fp32 Qwen-VL forward over the weights `make_weights` gives for
    `seed`; the decoder's linears (and head) rounded to `precision` first
    (int8 for the configuration that serves int8; int4 for its control)."""

    def __init__(self, cfg: dict, seed: int, device, precision: str = "int8"):
        self.cfg, self.d, self.device, self.precision = cfg, dims(cfg), device, precision
        self.w = make_weights(cfg, seed, device)

    # -- vision -------------------------------------------------------------
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Normalized pixels [G, 3, H, W] fp32 → [G, n_queries, E] fp32."""
        d, vp = self.d, self.w["visual"]
        f = lambda t: t.float()  # noqa: E731
        G, P, W, vH = x.shape[0], d["P"], d["W"], d["vH"]
        gh = x.shape[2] // P
        patches = x.reshape(G, 3, gh, P, gh, P).permute(0, 2, 4, 1, 3, 5).reshape(G, gh * gh, 3 * P * P)
        h = patches @ f(vp["conv"]).t() + f(vp["pos_embed"])
        h = layer_norm(h, vp["ln_pre"]["scale"], vp["ln_pre"]["bias"], d["eps"])
        lay = vp["layers"]
        for li in range(d["vL"]):
            y = layer_norm(h, lay["ln_1"]["scale"][li], lay["ln_1"]["bias"][li], d["eps"])
            qkv = (y @ f(lay["in_proj"]["w"][li]).t() + f(lay["in_proj"]["b"][li])).reshape(G, -1, vH, 3, W // vH)
            a = attention(qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :], None).reshape(G, -1, W)
            h = h + a @ f(lay["out_proj"]["w"][li]).t() + f(lay["out_proj"]["b"][li])
            y = layer_norm(h, lay["ln_2"]["scale"][li], lay["ln_2"]["bias"][li], d["eps"])
            y = torch.nn.functional.gelu(y @ f(lay["c_fc"]["w"][li]).t() + f(lay["c_fc"]["b"][li]))
            h = h + y @ f(lay["c_proj"]["w"][li]).t() + f(lay["c_proj"]["b"][li])
        rp, E = vp["resampler"], d["E"]
        Hr = max(E // 128, 1)
        kv = layer_norm(h @ f(rp["kv_proj"]).t(), rp["ln_kv"]["scale"], rp["ln_kv"]["bias"], d["eps"])
        q = layer_norm(f(rp["query"]), rp["ln_q"]["scale"], rp["ln_q"]["bias"], d["eps"])
        wq, wk, wv = f(rp["in_proj"]["w"]).chunk(3, dim=0)
        bq, bk, bv = f(rp["in_proj"]["b"]).chunk(3, dim=0)
        qh = ((q + f(rp["pos_q"])) @ wq.t() + bq).expand(G, -1, -1).reshape(G, -1, Hr, E // Hr)
        kh = ((kv + f(rp["pos_kv"])) @ wk.t() + bk).reshape(G, -1, Hr, E // Hr)
        vh = (kv @ wv.t() + bv).reshape(G, -1, Hr, E // Hr)
        out = attention(qh, kh, vh, None).reshape(G, -1, E) @ f(rp["out_proj"]["w"]).t() + f(rp["out_proj"]["b"])
        out = layer_norm(out, vp["ln_post"]["scale"], vp["ln_post"]["bias"], d["eps"])
        return out @ f(vp["proj"])

    # -- decoder ------------------------------------------------------------
    def _w(self, t: torch.Tensor) -> torch.Tensor:
        return weight_in(t, self.precision)

    def _x(self, h: torch.Tensor) -> torch.Tensor:
        return act_in(h, self.precision)

    def _ntk_alpha(self, length: int) -> float:
        seq = self.cfg["seq_length"]
        if not self.cfg["use_dynamic_ntk"] or length <= seq:
            return 1.0
        return max(2 ** math.ceil(math.log(length / seq, 2) + 1) - 1, 1.0)

    def logits(self, rows: Sequence[Tuple[Sequence[int], Optional[int], Sequence[int]]],
               feats: Optional[torch.Tensor], budget: int = 16384) -> List[torch.Tensor]:
        """rows: (token ids with at most one IMAGE_SENTINEL, the index of its
        image in feats [G, Q, E] or None, the positions whose next-token
        logits are wanted). Returns one fp32 [len(positions), V] per row."""
        d, qp, dev = self.d, self.w["qwen"], self.device
        D, H, Dh, eps = d["D"], d["H"], d["Dh"], d["eps"]
        seqs = []
        for ids, img, _ in rows:
            emb = []
            for t in ids:
                if t == IMAGE_SENTINEL:
                    emb.append(feats[img])
                else:
                    emb.append(qp["wte"][int(t)].float()[None])
            seqs.append(torch.cat(emb))
        lengths = [s.shape[0] for s in seqs]
        S = max(lengths)
        x = torch.zeros((len(rows), S, D), device=dev)
        for i, s in enumerate(seqs):
            x[i, : s.shape[0]] = s
        seq_len = self.cfg["seq_length"]
        pos = torch.arange(S, device=dev)
        logn = torch.where(pos + 1 > seq_len, torch.log((pos + 1).float()) / math.log(seq_len),
                           torch.ones(S, device=dev)) if self.cfg["use_logn_attn"] else torch.ones(S, device=dev)
        half = Dh // 2
        inv = [1.0 / ((10000.0 * self._ntk_alpha(n) ** (Dh / (Dh - 2))) ** (torch.arange(0, Dh, 2, device=dev).float() / Dh))
               for n in lengths]
        chunks = row_chunks(lengths, budget)
        lay = qp["layers"]
        for li in range(d["L"]):
            w_qkv, b_qkv = self._w(lay["c_attn_w"][li]), lay["c_attn_b"][li].float()
            w_o, w1, w2, w_down = (self._w(lay[k][li]) for k in ("attn_proj", "w1", "w2", "mlp_proj"))
            for rc in chunks:
                n = max(lengths[i] for i in rc)
                xs = x[rc, :n]
                h = rms_norm(xs, lay["ln_1"][li], eps)
                q, k, v = (self._x(h) @ w_qkv.t() + b_qkv).split(H * Dh, dim=-1)
                q, k, v = (t.reshape(len(rc), n, H, Dh) for t in (q, k, v))
                freqs = torch.stack([pos[:n, None].float() * inv[i][None] for i in rc])  # [B, n, Dh/2]
                cos, sin = torch.cat([freqs, freqs], -1).cos()[:, :, None], torch.cat([freqs, freqs], -1).sin()[:, :, None]

                def rope(t):
                    return t * cos + torch.cat([-t[..., half:], t[..., :half]], -1) * sin

                q, k = rope(q) * logn[:n, None, None], rope(k)
                a = attention(q, k, v, causal_key_mask([lengths[i] for i in rc], n, dev)).reshape(len(rc), n, H * Dh)
                xs = xs + self._x(a) @ w_o.t()
                h = rms_norm(xs, lay["ln_2"][li], eps)
                h = self._x(h)
                xs = xs + self._x((h @ w1.t()) * torch.nn.functional.silu(h @ w2.t())) @ w_down.t()
                x[rc, :n] = xs
            del w_qkv, w_o, w1, w2, w_down
        head = self._w(qp["lm_head"])
        out = []
        for i, (_, _, positions) in enumerate(rows):
            h = rms_norm(x[i, list(positions)], qp["ln_f"], eps)
            out.append(self._x(h) @ head.t())
        return out
