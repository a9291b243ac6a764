"""Model adapters: the decode engine's interface to each VLM family (torch
twin of llava_align_tpu/decoding/adapters.py: LLaVA, LLaVA-MPT, Qwen-VL,
InstructBLIP and BLIP-2 OPT).

Branch degradation for llava: 'unk' → IMAGE_TOKEN_INDEX→token 0; 'none' →
sentinel removed (reference vcd_sample.py:153-160). For qwen: 'none' drops
the sentinel and the <img>/</img> framing ids; 'unk' needs the tokenizer's
text ('None {q} Answer:') and is passed as explicit branch ids. For
instructblip: 'none' drops the sentinel; there is no 'unk'.

LLaVA, Qwen-VL and InstructBLIP take the two opt-in serving modes of the
JAX adapters, which DecodeEngine(act_quant=..., kv_quant=...) sets on a
copy of the adapter: act_quant (W8A8 at prefill row counts,
ops/quant.int8_matmul_w8a8) and kv_quant (the int8 KV cache,
ops/quant.kv_quantize_block). LLaVA-MPT and BLIP-2 OPT take neither, nor
the shared-prefix forward, as in JAX: the engine warns and ignores the
modes, and generate_batch_groups refuses them.

Every adapter takes a ('data', 'model') mesh (DecodeEngine(mesh=...)):
`param_shardings` places the tree leaf for leaf as the JAX adapter does
(parallel/sharding), `lm_key` names the decoder subtree the engine reads,
`tp_split_layers` says whether its layer stacks split over 'model' and
`tp_cache_kv_heads` how many kv heads a rank's cache holds.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch

from llava_align_tpu_torch.config import LlavaConfig
from llava_align_tpu_torch.constants import IMAGE_TOKEN_INDEX
from llava_align_tpu_torch.models import clip_vit, llama, llava, mpt, opt, projector, qwen, qwen_vl

Params = Dict[str, Any]

UNK_TOKEN_ID = 0  # reference vcd_sample.py:155


def _model_group(mesh):
    """The 'model' group the embeddings and heads are split over, or None."""
    if mesh is None:
        return None
    from llava_align_tpu_torch.parallel.mesh import axis_group

    return axis_group(mesh, "model")


def _model_size(mesh) -> int:
    from llava_align_tpu_torch.parallel.mesh import axis_size

    return axis_size(mesh, "model")


def _quant_kinds(layers):
    """(any int8 stack, any int4 stack) among a layer tree's leaves."""
    from llava_align_tpu_torch.ops.quant import is_quantized, is_quantized_int4

    return (any(is_quantized(v) for v in layers.values()),
            any(is_quantized_int4(v) for v in layers.values()))


def _replicate_layers(partial, key: str):
    """The spec tree with every layer stack of `key` replicated."""
    return dict(partial, **{key: dict(partial[key], layers=None)})


class LlavaAdapter:
    name = "llava"

    # Opt-in W8A8 (set by DecodeEngine(act_quant=True)): int8 stacks take
    # the W8A8 product at W8A8_MIN_ROWS rows and more; decode rows keep K1.
    act_quant = False
    supports_act_quant = True
    # Opt-in int8 KV cache (set by DecodeEngine(kv_quant="int8")): int8
    # values with per-(position, head) fp32 scales; shared prefix segments
    # quantize too.
    kv_quant = False
    supports_kv_quant = True

    # Tensor parallelism (set by DecodeEngine(mesh=...) on its copy of the
    # adapter): the ('data', 'model') DeviceMesh the tree is sharded over
    # (embed, lm_head and the vision tower always), whether the decoder's
    # layer stacks are split too (not int4 ones, nor int8 ones the engine
    # could not align), and the kv heads of this rank's cache.
    lm_key = "llama"
    tp_mesh = None
    tp_layers = False
    cache_kv_heads = None

    def __init__(self, cfg: LlavaConfig):
        self.cfg = cfg

    @property
    def num_image_tokens(self) -> int:
        return self.cfg.num_image_tokens

    @property
    def num_kv_heads(self) -> int:
        return self.cfg.text.num_kv_heads

    # --- sharding (TP over the 'model' mesh axis) ---------------------------
    def int8_tp_ready(self, params, n_shards: int) -> bool:
        """True iff every int8 stack's per-shard dim stays lane-aligned:
        then the quantized matmuls run tensor-parallel
        (ops/quant.int8_matmul_stacked_tp)."""
        from llava_align_tpu_torch.ops.quant import int8_tp_aligned, int8_tp_mode, is_quantized

        layers = params.get("llama", {}).get("layers", {})
        qs = {k: v for k, v in layers.items() if is_quantized(v)}
        # kv heads that do not split n ways leave the int8 stacks whole
        # (models/llama.forward splits only float k/v stacks at heads)
        return (bool(qs) and self.cfg.text.num_kv_heads % n_shards == 0
                and all(int8_tp_aligned(v, int8_tp_mode(k), n_shards) for k, v in qs.items()))

    def int8_tp_pad(self, params, n_shards: int):
        """Lane-align misaligned int8 MLP stacks by bit-inert padding
        (ops/quant.pad_llama_quantized_for_tp); params unchanged when there
        is nothing to pad."""
        from llava_align_tpu_torch.ops.quant import pad_llama_quantized_for_tp

        llama_p = params.get("llama")
        if not isinstance(llama_p, dict) or "layers" not in llama_p:
            return params
        new_layers, changed = pad_llama_quantized_for_tp(llama_p["layers"], n_shards)
        if not changed:
            return params
        return dict(params, llama=dict(llama_p, layers=new_layers))

    def tp_split_layers(self, params, n_shards: int) -> bool:
        """Whether the decoder's layer stacks split over 'model': float
        stacks, or int8 ones that are TP-ready; int4 stacks stay whole."""
        has_quant, has_quant4 = _quant_kinds(params[self.lm_key]["layers"])
        return not has_quant4 and (not has_quant or self.int8_tp_ready(params, n_shards))

    def tp_cache_kv_heads(self, n_shards: int, split: bool) -> int:
        """The local kv heads where they split (the JAX engine's
        _kv_shardable), else every kv head."""
        K = self.num_kv_heads
        return K // n_shards if split and K % n_shards == 0 else K

    def _llama_specs(self, params, n: int):
        """The LLaMA subtree's specs (sharding.llama_param_shardings): int8
        stacks split column/row when int8_tp_ready (the fused q|k|v and
        gate|up block by block); otherwise, and for int4 stacks, whole."""
        from llava_align_tpu_torch.ops.quant import int8_tp_mode, is_quantized, is_quantized_int4
        from llava_align_tpu_torch.parallel import sharding as shd

        specs = shd.llama_param_shardings(self.cfg.text, n)
        ready = n > 1 and self.int8_tp_ready(params, n)
        t = self.cfg.text
        lay = dict(specs["layers"])
        for k, v in params["llama"]["layers"].items():
            if is_quantized_int4(v) or (is_quantized(v) and not ready):
                lay[k] = None
            elif is_quantized(v):
                if k == "qkv":
                    lay[k] = shd.Shard(1, blocks=(t.q_dim, t.kv_dim, t.kv_dim))
                elif k == "gateup":
                    half = int(v["q"].shape[1]) // 2
                    lay[k] = shd.Shard(1, blocks=(half, half))
                else:
                    lay[k] = shd.Shard(1 if int8_tp_mode(k) == "column" else 2)
        return dict(specs, layers=lay)

    def param_shardings(self, params, mesh):
        """Megatron TP specs for the whole tree (parallel/sharding, leaf for
        leaf the JAX adapter's placement)."""
        from llava_align_tpu_torch.parallel import sharding as shd

        n = _model_size(mesh)
        partial = shd.llava_param_shardings(self.cfg, params, n)
        partial["llama"] = self._llama_specs(params, n)
        return shd.complete_shardings(params, partial)

    def _tp_group(self):
        """The 'model' group the embed and lm_head are split over, or None."""
        return _model_group(self.tp_mesh)

    def _tp_forward_mesh(self):
        """The mesh the forward's layer stacks are split over, or None."""
        return self.tp_mesh if self.tp_layers else None

    @property
    def vision_dtype(self) -> torch.dtype:
        return self.cfg.vision.dtype

    @property
    def image_size(self) -> int:
        return self.cfg.vision.image_size

    def branch_token_ids(self, input_ids: Sequence[int], kind: str) -> List[int]:
        ids = [int(t) for t in input_ids]
        if kind in ("main", "cd"):
            return ids
        if kind == "unk":
            return [UNK_TOKEN_ID if t == IMAGE_TOKEN_INDEX else t for t in ids]
        if kind == "none":
            return [t for t in ids if t != IMAGE_TOKEN_INDEX]
        raise ValueError(kind)

    def encode_images(self, params: Params, images: torch.Tensor) -> torch.Tensor:
        return llava.encode_images(params, self.cfg, images, self.tp_mesh)

    def splice_embeds(self, params, tokens, tok_g, img_g, is_img, feats):
        return llava.splice_embeds(params, self.cfg, tokens, tok_g, img_g, is_img, feats,
                                   self._tp_group())

    def embed_tokens(self, params: Params, ids: torch.Tensor) -> torch.Tensor:
        return llama.embed_tokens(params["llama"], ids, self._tp_group())

    def params_device(self, params: Params) -> torch.device:
        return params["llama"]["embed"].device

    def init_cache(self, batch: int, max_len: int, device=None):
        return llama.init_cache(self.cfg.text, batch, max_len, kv_quant=self.kv_quant, device=device,
                                num_kv_heads=self.cache_kv_heads)

    def forward(self, params, embeds, positions, cache, offsets, *, attn_impl="auto",
                max_seq_len: int, cache_row_offset=0, shared_kv=None, shared_len=None,
                shared_rows_per_prefix=None, shared_rows_per_prefix2=0):
        """llama.forward; max_seq_len (the call's cache length) is taken and
        ignored, as in the JAX adapter: LLaMA's rotary base is fixed."""
        return llama.forward(
            params["llama"], self.cfg.text, embeds, positions, cache, offsets,
            attn_impl=attn_impl, cache_row_offset=cache_row_offset, shared_kv=shared_kv,
            shared_len=shared_len,
            shared_rows_per_prefix=shared_rows_per_prefix,
            shared_rows_per_prefix2=shared_rows_per_prefix2, act_quant=self.act_quant,
            tp_mesh=self._tp_forward_mesh(),
        )

    # Shared-prefix decoding (engine.generate_batch_groups) needs the model
    # forward to accept a read-only prefix KV segment; the llama forward does.
    supports_shared_prefix = True

    def logits(self, params: Params, hidden: torch.Tensor) -> torch.Tensor:
        return llama.logits_from_hidden(params["llama"], hidden, self._tp_group(), self.cfg.text.vocab_size)


class LlavaMptAdapter(LlavaAdapter):
    """LLaVA with the MPT backbone (reference llava/model/language_model/
    llava_mpt.py): LLaVA's vision tower, projector and splice, the alibi
    MPT decoder (models/mpt). cfg: models.llava_mpt.LlavaMptConfig; params
    {'mpt', 'vision', 'projector'}. Under a 'model' mesh only the MPT
    decoder splits (the vision tower and projector stay whole, as in JAX):
    wqkv row-parallel, so the alibi attention and the cache keep every kv
    head on every rank."""

    name = "llava_mpt"
    lm_key = "mpt"
    supports_shared_prefix = False  # mpt.forward has no shared-segment path
    supports_act_quant = False  # mpt.forward has no act_quant path
    supports_kv_quant = False  # mpt.init_cache has no int8 layout

    @property
    def num_kv_heads(self) -> int:
        return self.cfg.text.kv_heads

    def tp_split_layers(self, params, n_shards: int) -> bool:
        t = self.cfg.text
        return t.d_model % n_shards == 0 and t.ffn_dim % n_shards == 0

    def tp_cache_kv_heads(self, n_shards: int, split: bool) -> int:
        return self.num_kv_heads  # the attention runs whole on every rank

    def param_shardings(self, params, mesh):
        from llava_align_tpu_torch.parallel import sharding as shd

        n = _model_size(mesh)
        partial = {"mpt": shd.mpt_param_shardings()}
        if n > 1 and not self.tp_split_layers(params, n):
            partial = _replicate_layers(partial, "mpt")
        return shd.complete_shardings(params, partial)

    def encode_images(self, params: Params, images: torch.Tensor) -> torch.Tensor:
        feats = clip_vit.forward_features(params["vision"], self.cfg.vision, images)
        return projector.forward(params["projector"], feats.to(self.cfg.text.dtype))

    def splice_embeds(self, params, tokens, tok_g, img_g, is_img, feats):
        return llava.splice(self.embed_tokens(params, tokens), tok_g, img_g, is_img, feats)

    def embed_tokens(self, params: Params, ids: torch.Tensor) -> torch.Tensor:
        return mpt.embed_tokens(params["mpt"], ids, self._tp_group(), self.cfg.text.vocab_size)

    def params_device(self, params: Params) -> torch.device:
        return params["mpt"]["wte"].device

    def init_cache(self, batch: int, max_len: int, device=None):
        return mpt.init_cache(self.cfg.text, batch, max_len, device=device)

    def forward(self, params, embeds, positions, cache, offsets, *, attn_impl="auto",
                max_seq_len: int, cache_row_offset=0):
        return mpt.forward(params["mpt"], self.cfg.text, embeds, positions, cache, offsets,
                           attn_impl=attn_impl, cache_row_offset=cache_row_offset,
                           tp_mesh=self._tp_forward_mesh())

    def logits(self, params: Params, hidden: torch.Tensor) -> torch.Tensor:
        return mpt.logits_from_hidden(params["mpt"], hidden, self._tp_group(), self.cfg.text.vocab_size)


class QwenVLAdapter:
    """Qwen-VL: in-band image spans. Callers mark the 256-token image span
    with one IMAGE_TOKEN_INDEX sentinel (models/qwen_vl.sentinelize_span);
    the splice plan expands it to n_queries feature slots framed by the
    real img_start/img_end tokens. Under a 'model' mesh the Qwen decoder
    splits (qwen_param_shardings; the visual tower stays whole, as in
    JAX); an int8 fused w1|w2 splits block by block, as LLaVA's gate|up."""

    name = "qwen_vl"
    lm_key = "qwen"
    tp_mesh = None  # see LlavaAdapter's tensor-parallel attributes
    tp_layers = False
    cache_kv_heads = None
    supports_shared_prefix = True
    act_quant = False  # see LlavaAdapter.act_quant
    supports_act_quant = True
    kv_quant = False  # see LlavaAdapter.kv_quant
    supports_kv_quant = True

    def __init__(self, cfg: qwen_vl.QwenVLConfig):
        self.cfg = cfg

    @property
    def num_image_tokens(self) -> int:
        return self.cfg.vision.n_queries

    @property
    def image_size(self) -> int:
        return self.cfg.vision.image_size

    @property
    def vision_dtype(self) -> torch.dtype:
        return self.cfg.vision.dtype

    @property
    def num_kv_heads(self) -> int:
        return self.cfg.text.num_heads  # MHA: as many kv heads as heads

    # --- sharding (TP over the 'model' mesh axis) ---------------------------
    _MLP_COLUMNS = (("w12", 2), ("w1", 1), ("w2", 1))

    def int8_tp_ready(self, params, n_shards: int) -> bool:
        """LlavaAdapter.int8_tp_ready's rule on the Qwen stacks."""
        from llava_align_tpu_torch.ops.quant import int8_tp_aligned, int8_tp_mode, is_quantized

        qs = {k: v for k, v in params["qwen"]["layers"].items() if is_quantized(v)}
        return (bool(qs) and self.cfg.text.num_heads % n_shards == 0
                and all(int8_tp_aligned(v, int8_tp_mode(k), n_shards) for k, v in qs.items()))

    def int8_tp_pad(self, params, n_shards: int):
        """Bit-inert lane padding of the int8 MLP stacks (w12 or w1/w2
        column, mlp_proj row), as LlavaAdapter.int8_tp_pad pads LLaMA's."""
        from llava_align_tpu_torch.ops.quant import pad_llama_quantized_for_tp

        layers, changed = pad_llama_quantized_for_tp(params["qwen"]["layers"], n_shards,
                                                     self._MLP_COLUMNS, "mlp_proj")
        return dict(params, qwen=dict(params["qwen"], layers=layers)) if changed else params

    def tp_split_layers(self, params, n_shards: int) -> bool:
        """Whole heads on each rank, and float stacks or TP-ready int8 ones."""
        has_quant, has_quant4 = _quant_kinds(params["qwen"]["layers"])
        return (self.cfg.text.num_heads % n_shards == 0 and not has_quant4
                and (not has_quant or self.int8_tp_ready(params, n_shards)))

    def tp_cache_kv_heads(self, n_shards: int, split: bool) -> int:
        return self.num_kv_heads // n_shards if split else self.num_kv_heads

    def param_shardings(self, params, mesh):
        from llava_align_tpu_torch.ops.quant import is_quantized
        from llava_align_tpu_torch.parallel import sharding as shd

        n = _model_size(mesh)
        partial = {"qwen": shd.qwen_param_shardings(self.cfg.text)}
        if n > 1 and not self.tp_split_layers(params, n):
            partial = _replicate_layers(partial, "qwen")
        elif is_quantized(params["qwen"]["layers"].get("w12")):
            half = int(params["qwen"]["layers"]["w12"]["q"].shape[1]) // 2
            lay = dict(partial["qwen"]["layers"], w12=shd.Shard(1, blocks=(half, half)))
            partial = {"qwen": dict(partial["qwen"], layers=lay)}
        return shd.complete_shardings(params, partial)

    def _tp_group(self):
        return _model_group(self.tp_mesh)

    def branch_token_ids(self, input_ids: Sequence[int], kind: str) -> List[int]:
        ids = [int(t) for t in input_ids]
        if kind in ("main", "cd"):
            return ids
        if kind == "none":
            # drop the whole <img>…</img> block: the sentinel and the framing tokens
            framing = (IMAGE_TOKEN_INDEX, self.cfg.image_start_id, self.cfg.image_end_id)
            return [t for t in ids if t not in framing]
        raise ValueError(
            f"qwen branch '{kind}' requires tokenizer text; pass explicit "
            "branch ids via generate(..., branch_ids={...})"
        )

    def encode_images(self, params: Params, images: torch.Tensor) -> torch.Tensor:
        return qwen_vl.encode_images(params, self.cfg, images)

    def splice_embeds(self, params, tokens, tok_g, img_g, is_img, feats):
        return llava.splice(self.embed_tokens(params, tokens), tok_g, img_g, is_img, feats)

    def embed_tokens(self, params: Params, ids: torch.Tensor) -> torch.Tensor:
        return qwen.embed_tokens(params["qwen"], ids, self._tp_group())

    def params_device(self, params: Params) -> torch.device:
        return params["qwen"]["wte"].device

    def init_cache(self, batch: int, max_len: int, device=None):
        return qwen.init_cache(self.cfg.text, batch, max_len, kv_quant=self.kv_quant, device=device,
                               num_heads=self.cache_kv_heads)

    def forward(self, params, embeds, positions, cache, offsets, *, attn_impl="auto",
                max_seq_len: int, cache_row_offset=0, shared_kv=None, shared_len=None,
                shared_rows_per_prefix=None, shared_rows_per_prefix2=0):
        """qwen.forward at the dynamic-NTK alpha of max_seq_len, the call's
        cache length (the same in every phase of one call)."""
        return qwen.forward(
            params["qwen"], self.cfg.text, embeds, positions, cache, offsets,
            ntk_alpha=qwen.ntk_alpha_for_len(self.cfg.text, max_seq_len),
            attn_impl=attn_impl, cache_row_offset=cache_row_offset,
            shared_kv=shared_kv, shared_len=shared_len,
            shared_rows_per_prefix=shared_rows_per_prefix,
            shared_rows_per_prefix2=shared_rows_per_prefix2, act_quant=self.act_quant,
            tp_mesh=self.tp_mesh if self.tp_layers else None,
        )

    def logits(self, params: Params, hidden: torch.Tensor) -> torch.Tensor:
        return qwen.logits_from_hidden(params["qwen"], hidden, self._tp_group(), self.cfg.text.vocab_size)


class InstructBlipAdapter(LlavaAdapter):
    """InstructBLIP: the 32 projected Q-Former query embeddings are the
    "image features"; prompts are [sentinel] + Vicuna token ids. The
    Q-Former is conditioned on the instruction, so the features are encoded
    OUTSIDE the engine (models/instructblip.encode) and passed as
    generate(..., precomputed_feats=...), as the reference computes
    inputs_llm / inputs_llm_cd once per question before llm.generate. The
    decoder side (splice, embeddings, cache, forward, logits) is LLaVA's
    LLaMA, with LlavaAdapter's act_quant and kv_quant, and its mesh: only
    the 'llama' subtree splits (EVA-ViT and the Q-Former stay whole, as in
    JAX)."""

    name = "instructblip"  # cfg: models.instructblip.InstructBlipConfig

    @property
    def num_image_tokens(self) -> int:
        return self.cfg.num_query_tokens

    @property
    def num_kv_heads(self) -> int:
        return self.cfg.text.num_kv_heads

    def branch_token_ids(self, input_ids: Sequence[int], kind: str) -> List[int]:
        if kind not in ("main", "cd", "none"):  # 'none' = use_image=False: no query embeddings
            raise ValueError(f"instructblip does not define branch '{kind}'")
        return super().branch_token_ids(input_ids, kind)

    def param_shardings(self, params, mesh):
        from llava_align_tpu_torch.parallel import sharding as shd

        partial = {"llama": self._llama_specs(params, _model_size(mesh))} if "llama" in params else {}
        return shd.complete_shardings(params, partial)

    def encode_images(self, params: Params, images: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            "InstructBLIP features are text-conditioned; encode with "
            "models.instructblip.encode and pass precomputed_feats to generate()"
        )


class Blip2OptAdapter(InstructBlipAdapter):
    """BLIP-2 with the OPT backbone (reference blip2_opt): the query-only
    Q-Former's projected queries are the prompt prefix
    (models/blip2.encode_image_queries, passed as precomputed_feats as for
    InstructBLIP); OPT decodes. cfg: models.blip2.Blip2OptConfig; params
    {'visual', 'ln_vision', 'query_tokens', 'qformer', 'proj', 'lm'}. Under
    a 'model' mesh only OPT splits (opt_param_shardings)."""

    name = "blip2_opt"
    lm_key = "lm"
    supports_shared_prefix = False
    supports_act_quant = False  # opt.forward has no act_quant path
    supports_kv_quant = False  # opt.init_cache has no int8 layout

    @property
    def num_kv_heads(self) -> int:
        return self.cfg.text.num_heads

    def tp_split_layers(self, params, n_shards: int) -> bool:
        t = self.cfg.text
        return t.num_heads % n_shards == 0 and t.ffn_dim % n_shards == 0

    def param_shardings(self, params, mesh):
        from llava_align_tpu_torch.parallel import sharding as shd

        n = _model_size(mesh)
        partial = {"lm": shd.opt_param_shardings()} if "lm" in params else {}
        if partial and n > 1 and not self.tp_split_layers(params, n):
            partial = _replicate_layers(partial, "lm")
        return shd.complete_shardings(params, partial)

    def splice_embeds(self, params, tokens, tok_g, img_g, is_img, feats):
        return llava.splice(self.embed_tokens(params, tokens), tok_g, img_g, is_img, feats)

    def embed_tokens(self, params: Params, ids: torch.Tensor) -> torch.Tensor:
        return opt.embed_tokens(params["lm"], ids, self._tp_group(), self.cfg.text.vocab_size)

    def params_device(self, params: Params) -> torch.device:
        return params["lm"]["embed_tokens"].device

    def init_cache(self, batch: int, max_len: int, device=None):
        return opt.init_cache(self.cfg.text, batch, max_len, device=device, num_heads=self.cache_kv_heads)

    def forward(self, params, embeds, positions, cache, offsets, *, attn_impl="auto",
                max_seq_len: int, cache_row_offset=0):
        return opt.forward(params["lm"], self.cfg.text, embeds, positions, cache, offsets,
                           attn_impl=attn_impl, cache_row_offset=cache_row_offset,
                           tp_mesh=self._tp_forward_mesh())

    def logits(self, params: Params, hidden: torch.Tensor) -> torch.Tensor:
        return opt.logits_from_hidden(params["lm"], hidden, self._tp_group(), self.cfg.text.vocab_size)
