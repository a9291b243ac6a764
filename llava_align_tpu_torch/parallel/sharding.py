"""Parameter / cache sharding rules, Megatron-style tensor parallelism
(torch twin of llava_align_tpu/parallel/sharding.py: LLaVA, Qwen, MPT
and OPT).

Column-parallel (output features split) for q/k/v/gate/up/fc1,
row-parallel (input features split) for o/down/fc2, so each transformer
block needs one all-reduce per sublayer. Norms, biases and small tensors
are replicated. The specs are plain data, leaf for leaf the JAX package's:
a `Shard(dim, axis)` splits one dim of the leaf over a mesh axis, None
replicates it (`spec_pairs` gives the (dim, axis) pairs a JAX
PartitionSpec names). A fused stack (q|k|v, gate|up) splits each of its
`blocks` along the dim, so that a rank's slice is [q_r | k_r | v_r] and
the column output it computes stays in the fused layout; JAX's GSPMD
keeps the global layout instead and moves the data itself. A vocab
split (`ragged`) may not divide the axis: it takes comm.shard_range's
parts, as GSPMD pads an uneven split.

`shard_params` narrows each leaf to this rank's slice (contiguous, on the
rank's device); `unshard_params` gathers the slices back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from llava_align_tpu_torch.config import LlamaConfig, LlavaConfig
from llava_align_tpu_torch.parallel import comm
from llava_align_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size


@dataclasses.dataclass(frozen=True)
class Shard:
    """Split `dim` of a leaf over mesh `axis`; `blocks` (sizes along dim,
    summing to it) are split one by one (a fused stack); `ragged`: the dim
    need not divide (comm.shard_range's parts)."""

    dim: int
    axis: str = "model"
    blocks: Tuple[int, ...] = ()
    ragged: bool = False


VOCAB = Shard(0, ragged=True)  # [V, D] rows over 'model', any V


Spec = Optional[Shard]


def spec_pairs(spec: Spec) -> Tuple[Tuple[int, str], ...]:
    """The (dim, axis) pairs of a spec: () replicated."""
    return () if spec is None else ((spec.dim, spec.axis),)


def llama_param_shardings(cfg: LlamaConfig, model: int = 1) -> Dict[str, Any]:
    """model: the 'model' axis size. Where the kv heads do not split that
    many ways, k and v stay whole (JAX's GSPMD splits them mid-head and
    moves the data; models/llama.forward reads whole kv heads instead)."""
    # weights are [L, out, in]: column-parallel = dim 1, row-parallel = dim 2
    kv = Shard(1) if cfg.num_kv_heads % model == 0 else None
    return {
        "embed": Shard(1),
        "layers": {
            "attn_norm": None,
            "q": Shard(1),
            "k": kv,
            "v": kv,
            "o": Shard(2),
            "mlp_norm": None,
            "gate": Shard(1),
            "up": Shard(1),
            "down": Shard(2),
        },
        "final_norm": None,
        "lm_head": VOCAB,
    }


def clip_param_shardings() -> Dict[str, Any]:
    # kernels are [L, in, out]: column-parallel = dim 2, row-parallel = dim 1
    def lin(col: bool):
        return {"kernel": Shard(2) if col else Shard(1), "bias": None}

    ln = {"scale": None, "bias": None}
    return {
        "cls": None,
        "patch_embed": None,
        "pos_embed": None,
        "pre_ln": dict(ln),
        "layers": {
            "ln1": dict(ln),
            "q": lin(True),
            "k": lin(True),
            "v": lin(True),
            "o": lin(False),
            "ln2": dict(ln),
            "fc1": lin(True),
            "fc2": lin(False),
        },
        "post_ln": dict(ln),
    }


def projector_shardings(params_projector: Dict[str, Any]) -> Dict[str, Any]:
    return {"layers": [{"kernel": None, "bias": None} for _ in params_projector["layers"]]}


def llava_param_shardings(cfg: LlavaConfig, params: Dict[str, Any], model: int = 1) -> Dict[str, Any]:
    return {
        "llama": llama_param_shardings(cfg.text, model),
        "vision": clip_param_shardings(),
        "projector": projector_shardings(params["projector"]),
    }


def qwen_param_shardings(cfg) -> Dict[str, Any]:
    """models/qwen params ([L, out, in]; cfg: QwenConfig). The packed
    c_attn (weight and bias) is [q | k | v], split block by block so that
    a rank holds whole heads of each; attn_proj and mlp_proj row-parallel;
    wte split on hidden, lm_head on vocab."""
    qkv = Shard(1, blocks=(cfg.q_dim,) * 3)
    return {
        "wte": Shard(1),
        "layers": {
            "ln_1": None,
            "c_attn_w": qkv,
            "c_attn_b": qkv,
            "attn_proj": Shard(2),
            "ln_2": None,
            "w1": Shard(1),
            "w2": Shard(1),
            "mlp_proj": Shard(2),
        },
        "ln_f": None,
        "lm_head": VOCAB,
    }


def mpt_param_shardings() -> Dict[str, Any]:
    """models/mpt params. The packed wqkv output is [D | KV | KV]; under
    multi-query (KV = head_dim) its kv blocks do not split, so wqkv is
    row-parallel (its input dim) and every rank gets the whole q|k|v after
    one all_reduce: right for MHA and MQA alike. wte (the tied head too)
    split on vocab."""
    return {
        "wte": VOCAB,
        "layers": {
            "norm_1": None,
            "wqkv": Shard(2),
            "out_proj": Shard(2),
            "norm_2": None,
            "up_proj": Shard(1),
            "down_proj": Shard(2),
        },
        "norm_f": None,
    }


def opt_param_shardings() -> Dict[str, Any]:
    """models/opt params ({w [L, out, in], b [L, out]} linears): q/k/v/fc1
    column-parallel, out/fc2 row-parallel, biases whole; embed_tokens (the
    tied head too) split on vocab, the learned positions whole."""

    def dense(col: bool):
        return {"w": Shard(1) if col else Shard(2), "b": None}

    ln = {"scale": None, "bias": None}
    return {
        "embed_tokens": VOCAB,
        "embed_positions": None,
        "layers": {
            "attn_ln": dict(ln),
            "q": dense(True),
            "k": dense(True),
            "v": dense(True),
            "out": dense(False),
            "ffn_ln": dict(ln),
            "fc1": dense(True),
            "fc2": dense(False),
        },
        "final_ln": dict(ln),
    }


def cache_shardings() -> Dict[str, Shard]:
    """KV cache [L, B, Smax, K, Dh]: kv heads over 'model' (the int8
    cache's scale planes [L, B, Smax, K, 1] too)."""
    s = Shard(3)
    return {"k": s, "v": s, "ks": s, "vs": s}


def complete_shardings(params: Dict[str, Any], partial: Any) -> Dict[str, Any]:
    """Fill a partial spec tree out to the full params structure: where
    `partial` gives a spec for the same path it is used, everything else is
    replicated. An int8 {'q', 's'} leaf standing where a dense spec was
    written takes the spec on 'q', and 's' ([..., O], the contracted dim
    dropped) keeps it unless it split the contracted (last) dim."""

    def walk(p, s):
        if isinstance(p, dict):
            if set(p) == {"q", "s"} and isinstance(s, Shard):
                q_nd = p["q"].dim()
                return {"q": s, "s": s if s.dim != q_nd - 1 else None}
            sub = s if isinstance(s, dict) else {}
            return {k: walk(v, sub.get(k)) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            sub = s if isinstance(s, (list, tuple)) else [None] * len(p)
            return type(p)(walk(v, sv) for v, sv in zip(p, sub))
        return s if isinstance(s, Shard) else None

    return walk(params, partial or {})


def _slices(size: int, spec: Shard, n: int, r: int):
    """(start, length) of rank r's pieces along spec.dim of a leaf `size`
    long there."""
    if spec.ragged and not spec.blocks:
        return [comm.shard_range(size, n, r)]
    blocks = spec.blocks or (size,)
    if sum(blocks) != size:
        raise ValueError(f"blocks {blocks} do not sum to dim {spec.dim} ({size})")
    out, off = [], 0
    for b in blocks:
        if b % n:
            raise ValueError(f"dim {spec.dim} block of {b} does not split {n} ways")
        out.append((off + r * (b // n), b // n))
        off += b
    return out


def _map_specs(fn, params, specs):
    if isinstance(params, dict):
        return {k: _map_specs(fn, v, (specs or {}).get(k) if isinstance(specs, dict) else None)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        sub = specs if isinstance(specs, (list, tuple)) else [None] * len(params)
        return type(params)(_map_specs(fn, v, s) for v, s in zip(params, sub))
    return fn(params, specs)


def shard_params(params: Dict[str, Any], specs: Dict[str, Any], mesh, device=None) -> Dict[str, Any]:
    """Each leaf narrowed to this rank's slice of its spec (replicated
    leaves whole), made contiguous and moved to `device` (default: the
    leaf's own)."""

    def one(x, spec):
        if isinstance(spec, Shard) and axis_size(mesh, spec.axis) > 1:
            n, r = axis_size(mesh, spec.axis), axis_rank(mesh, spec.axis)
            parts = [x.narrow(spec.dim, a, b) for a, b in _slices(x.shape[spec.dim], spec, n, r)]
            x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=spec.dim)
        return x.to(device if device is not None else x.device).contiguous()

    return _map_specs(one, params, specs)


def unshard_params(params: Dict[str, Any], specs: Dict[str, Any], mesh) -> Dict[str, Any]:
    """Inverse of shard_params: every rank gets the whole leaves (the
    slices gathered over their axis, block by block)."""

    def one(x, spec):
        if not isinstance(spec, Shard) or axis_size(mesh, spec.axis) == 1:
            return x
        n, group = axis_size(mesh, spec.axis), axis_group(mesh, spec.axis)
        local = x.shape[spec.dim]
        if spec.ragged and not spec.blocks:  # the whole size: the parts summed
            size = int(comm.all_reduce_(torch.tensor([local], device=x.device), group)[0])
            return comm.gather_dim(x.contiguous(), group, spec.dim, size)
        blocks = [b // n for b in spec.blocks] if spec.blocks else [local]
        out, off = [], 0
        for b in blocks:
            piece = x.narrow(spec.dim, off, b).contiguous()
            out.append(comm.gather_dim(piece, group, spec.dim))
            off += b
        return out[0] if len(out) == 1 else torch.cat(out, dim=spec.dim)

    return _map_specs(one, params, specs)


def spec_leaves(specs: Any) -> list:
    """The specs of a completed spec tree in tree_leaves order (dict keys
    sorted, as the params' leaves are listed), None for a replicated leaf."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    if isinstance(specs, (list, tuple)):
        return [x for v in specs for x in spec_leaves(v)]
    return [specs]


def split_leaves(specs: Any, axis: str = "model") -> list:
    """Per leaf (tree_leaves order), True where it is split over `axis`."""
    return [isinstance(s, Shard) and s.axis == axis for s in spec_leaves(specs)]
