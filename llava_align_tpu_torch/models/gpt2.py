"""GPT-2 and the video-conditioned GPT dialogue model (torch twin of
llava_align_tpu/models/gpt2.py).

Capability parity: the reference's LAVIS GPT-dialogue family
(lavis/models/gpt_models/gpt_dialogue.py: a GPT2LMHeadModel with a
video-feature prefix projected by `video_ff`, token-type embeddings drawn
from the word table, a shifted LM loss with ignore_index=-1 and a shifted
MSE video reconstruction through `video_ff_out`).

Pre-LN blocks with GPT-2's tanh GELU ("gelu_new"), fp32 softmax and
norms, the lm_head tied to `wte`. Layers are stacked on a leading [L] axis
and run in a Python loop. Attention is plain torch (ops.attention.mha with
an additive fp32 mask bias): no kernel of the port lies on this path.
The KV cache is [L, B, S, H, Dh], written in place; dialogue_generate
fills it for the whole prefix in one forward, then decodes greedily one
token per step.

Param tree (linears {w [out, in], b [out]}: the converter transposes HF
GPT-2's Conv1D [in, out] weights):
    wte [V, D], wpe [P, D], layers/{ln1, ln2} {scale, bias [L, D]},
    layers/{qkv, o, fc1, fc2} {w [L, out, in], b [L, out]}, ln_f {scale, bias}
    dialogue: {gpt, video_ff {w [D, Fv], b}, video_ff_out {w [Fv, D], b}}
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from llava_align_tpu_torch.ops.attention import mha
from llava_align_tpu_torch.ops.layers import layer_norm
from llava_align_tpu_torch.utils.synthetic import normal_init, resolve_device

Params = Dict[str, Any]
NEG = -1e30


@dataclasses.dataclass(frozen=True)
class Gpt2Config:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def ffn_dim(self) -> int:
        return 4 * self.hidden_size

    @staticmethod
    def tiny(vocab_size: int = 64) -> "Gpt2Config":
        return Gpt2Config(vocab_size=vocab_size, hidden_size=32, num_layers=2, num_heads=4,
                          max_position_embeddings=64)


def init(cfg: Gpt2Config, device=None, seed: int = 0) -> Params:
    """The JAX init's tree and scales; torch's random numbers from `seed`."""
    device = resolve_device(device)
    w = normal_init(torch.Generator(device=device).manual_seed(seed), device)
    D, F, L, V, dt = cfg.hidden_size, cfg.ffn_dim, cfg.num_layers, cfg.vocab_size, cfg.dtype

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    def lin(o, i):
        return {"w": w((L, o, i), i, dt), "b": zeros(L, o)}

    def ln(*lead):
        return {"scale": torch.ones(lead + (D,), dtype=dt, device=device), "bias": zeros(*lead, D)}

    return {
        "wte": w((V, D), D, dt),
        "wpe": w((cfg.max_position_embeddings, D), D, dt),
        "layers": {"ln1": ln(L), "qkv": lin(3 * D, D), "o": lin(D, D), "ln2": ln(L), "fc1": lin(F, D),
                   "fc2": lin(D, F)},
        "ln_f": ln(),
    }


def _lin(h: torch.Tensor, p: Params, li: Optional[int] = None) -> torch.Tensor:
    w, b = (p["w"], p["b"]) if li is None else (p["w"][li], p["b"][li])
    return h @ w.t() + b


def _ln(x: torch.Tensor, p: Params, eps: float, li: Optional[int] = None) -> torch.Tensor:
    s, b = (p["scale"], p["bias"]) if li is None else (p["scale"][li], p["bias"][li])
    return layer_norm(x, s, b, eps)


def _gelu_new(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x, approximate="tanh")


def _block(x: torch.Tensor, lay: Params, li: int, cfg: Gpt2Config, bias: torch.Tensor,
           cache: Optional[Dict[str, torch.Tensor]] = None, pos: Optional[slice] = None) -> torch.Tensor:
    """One pre-LN block over x [B, S, D]. With a cache, the new keys and
    values are written to it at `pos` and the block attends the whole
    cache layer; without one, its own keys and values."""
    B, S, D = x.shape
    H, Dh, eps = cfg.num_heads, cfg.head_dim, cfg.layer_norm_eps
    q, k, v = _lin(_ln(x, lay["ln1"], eps, li), lay["qkv"], li).chunk(3, dim=-1)
    k, v = k.reshape(B, S, H, Dh), v.reshape(B, S, H, Dh)
    if cache is not None:
        cache["k"][li, :, pos] = k.to(cache["k"].dtype)
        cache["v"][li, :, pos] = v.to(cache["v"].dtype)
        k, v = cache["k"][li], cache["v"][li]
    a = mha(q.reshape(B, S, H, Dh), k, v, causal=False, bias=bias).reshape(B, S, D)
    x = x + _lin(a, lay["o"], li)
    return x + _lin(_gelu_new(_lin(_ln(x, lay["ln2"], eps, li), lay["fc1"], li)), lay["fc2"], li)


def _mask_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B|1, Sq, Sk] bool (True = attend) → the fp32 bias mha adds,
    [B|1, 1, 1, Sq, Sk]: 0 or NEG (a row masked everywhere attends
    uniformly, as the JAX package's where(mask, s, NEG) gives)."""
    return torch.where(mask, 0.0, NEG).to(torch.float32)[:, None, None]


def forward(params: Params, cfg: Gpt2Config, input_embeds: torch.Tensor,
            attention_mask: Optional[torch.Tensor] = None, position_ids: Optional[torch.Tensor] = None,
            cache: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """The full causal pass → hidden [B, S, D] (after ln_f). With `cache`
    (init_cache) the keys and values of positions [0, S) are written to
    it, for decode_step to continue from position S."""
    B, S, D = input_embeds.shape
    dev = input_embeds.device
    if position_ids is None:
        position_ids = torch.arange(S, device=dev)[None].expand(B, S)
    x = input_embeds + params["wpe"][position_ids]
    Sk = S if cache is None else cache["k"].shape[2]  # the keys attended: the cache's, when given
    mask = (torch.arange(Sk, device=dev)[None] <= torch.arange(S, device=dev)[:, None])[None]
    if attention_mask is not None:
        mask = mask & torch.nn.functional.pad(attention_mask.bool(), (0, Sk - S))[:, None, :]
    bias = _mask_bias(mask)
    lay = params["layers"]
    for li in range(cfg.num_layers):
        x = _block(x, lay, li, cfg, bias, cache, slice(0, S))
    return _ln(x, params["ln_f"], cfg.layer_norm_eps)


def logits(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """The tied lm_head (HF GPT2LMHeadModel ties it to wte), fp32."""
    return hidden.float() @ params["wte"].float().t()


def embed(params: Params, ids: torch.Tensor) -> torch.Tensor:
    return params["wte"][ids.long()]


# ---------------------------------------------------------------------------
# incremental decoding
# ---------------------------------------------------------------------------


def init_cache(cfg: Gpt2Config, batch: int, max_len: int, device=None) -> Dict[str, torch.Tensor]:
    shape = (cfg.num_layers, batch, max_len, cfg.num_heads, cfg.head_dim)
    device = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def decode_step(params: Params, cfg: Gpt2Config, emb: torch.Tensor, t: int,
                cache: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One causal step at position t: emb [B, D] → (logits [B, V], cache
    with position t written, in place)."""
    smax = cache["k"].shape[2]
    x = (emb + params["wpe"][t])[:, None]
    bias = _mask_bias((torch.arange(smax, device=emb.device) <= t)[None, None])
    lay = params["layers"]
    for li in range(cfg.num_layers):
        x = _block(x, lay, li, cfg, bias, cache, slice(t, t + 1))
    return logits(params, _ln(x, params["ln_f"], cfg.layer_norm_eps)[:, 0]), cache


# ---------------------------------------------------------------------------
# GPT dialogue (gpt_dialogue.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GptDialogueConfig:
    gpt: Gpt2Config = dataclasses.field(default_factory=Gpt2Config)
    len_video_ft: int = 4224

    @staticmethod
    def tiny(vocab_size: int = 64, len_video_ft: int = 8) -> "GptDialogueConfig":
        return GptDialogueConfig(gpt=Gpt2Config.tiny(vocab_size), len_video_ft=len_video_ft)


def dialogue_init(cfg: GptDialogueConfig, device=None, seed: int = 0) -> Params:
    device = resolve_device(device)
    w = normal_init(torch.Generator(device=device).manual_seed(seed + 1), device)
    D, Fv, dt = cfg.gpt.hidden_size, cfg.len_video_ft, cfg.gpt.dtype
    return {
        "gpt": init(cfg.gpt, device, seed),
        "video_ff": {"w": w((D, Fv), Fv, dt), "b": torch.zeros((D,), dtype=dt, device=device)},
        "video_ff_out": {"w": w((Fv, D), D, dt), "b": torch.zeros((Fv,), dtype=dt, device=device)},
    }


def _prefix(params: Params, video_fts: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
    g = params["gpt"]
    return torch.cat([_lin(video_fts.to(g["wte"].dtype), params["video_ff"]), embed(g, input_ids)], dim=1)


def dialogue_forward(params: Params, cfg: GptDialogueConfig, input_ids: torch.Tensor, video_fts: torch.Tensor,
                     attn_mask: Optional[torch.Tensor] = None, token_type_ids: Optional[torch.Tensor] = None,
                     labels: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """gpt_dialogue.py:36-104: the video prefix [B, Sv, len_video_ft] and
    the tokens [B, St] → {logits, hidden, loss, video_loss}; loss is the
    shifted LM cross-entropy over labels != -1 (when labels are given)
    plus the shifted video-reconstruction MSE."""
    g = params["gpt"]
    emb = _prefix(params, video_fts, input_ids)
    if token_type_ids is not None:
        emb = emb + embed(g, token_type_ids)  # HF GPT-2 embeds token types with wte
    hidden = forward(g, cfg.gpt, emb, attention_mask=attn_mask)
    lm_logits = logits(g, hidden)
    out: Dict[str, torch.Tensor] = {"logits": lm_logits, "hidden": hidden}
    loss = None
    if labels is not None:
        lb = labels[:, 1:].long()
        valid = lb != -1
        logp = torch.log_softmax(lm_logits[:, :-1], dim=-1)
        nll = -logp.gather(-1, lb.clamp(0, cfg.gpt.vocab_size - 1)[..., None])[..., 0]
        loss = torch.where(valid, nll, 0.0).sum() / valid.sum().clamp(min=1)
    sv = video_fts.shape[1]
    video_logits = _lin(hidden[:, :sv], params["video_ff_out"])
    video_loss = (video_logits[:, :-1].float() - video_fts[:, 1:].float()).square().mean()
    out["loss"] = video_loss if loss is None else loss + video_loss
    out["video_loss"] = video_loss
    return out


@torch.inference_mode()
def dialogue_generate(params: Params, cfg: GptDialogueConfig, input_ids, video_fts, *, max_new_tokens: int = 20,
                      eos_token_id: Optional[int] = None) -> np.ndarray:
    """Greedy continuation after the video + text prefix → [B, n] int32
    tokens (n <= max_new_tokens; a finished row repeats eos until every
    row is done), as the JAX package's loop gives them. The prefix goes
    through one forward that fills the cache."""
    g = params["gpt"]
    dev = g["wte"].device
    input_ids = torch.as_tensor(np.asarray(input_ids)).to(dev)
    video_fts = torch.as_tensor(np.asarray(video_fts, np.float32)).to(dev)
    B, St = input_ids.shape
    P = video_fts.shape[1] + St
    T = P + max_new_tokens
    cache = init_cache(cfg.gpt, B, T, dev)
    hidden = forward(g, cfg.gpt, _prefix(params, video_fts, input_ids), cache=cache)
    tok = logits(g, hidden[:, -1]).argmax(-1).cpu().numpy().astype(np.int32)
    out_tokens = []
    done = np.zeros((B,), bool)
    for t in range(P, T):
        if eos_token_id is not None:
            tok = np.where(done, eos_token_id, tok)
            done |= tok == eos_token_id
        out_tokens.append(tok)
        if done.all() or t == T - 1:
            break
        lg, cache = decode_step(g, cfg.gpt, embed(g, torch.from_numpy(tok).to(dev)), t, cache)
        tok = lg.argmax(-1).cpu().numpy().astype(np.int32)
    return np.stack(out_tokens, axis=1) if out_tokens else np.zeros((B, 0), np.int32)
