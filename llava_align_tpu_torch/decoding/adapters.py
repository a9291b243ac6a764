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
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch

from llava_align_tpu_torch.config import LlavaConfig
from llava_align_tpu_torch.constants import IMAGE_TOKEN_INDEX
from llava_align_tpu_torch.models import clip_vit, llama, llava, mpt, opt, projector, qwen, qwen_vl

Params = Dict[str, Any]

UNK_TOKEN_ID = 0  # reference vcd_sample.py:155


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
    # could not align), and the kv heads of this rank's cache. Only LLaVA
    # takes a mesh with a 'model' axis above 1 (the others: ROADMAP item 8b).
    supports_tp = True
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

    def param_shardings(self, params, mesh):
        """Megatron TP specs for the whole tree (parallel/sharding, leaf for
        leaf the JAX adapter's placement). int8 stacks split column/row
        when int8_tp_ready (the fused q|k|v and gate|up block by block);
        otherwise, and for int4 stacks, they stay whole."""
        from llava_align_tpu_torch.ops.quant import int8_tp_mode, is_quantized, is_quantized_int4
        from llava_align_tpu_torch.parallel import sharding as shd
        from llava_align_tpu_torch.parallel.mesh import axis_size

        n = axis_size(mesh, "model")
        partial = shd.llava_param_shardings(self.cfg, params, n)
        ready = n > 1 and self.int8_tp_ready(params, n)
        t = self.cfg.text
        lay = dict(partial["llama"]["layers"])
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
        partial["llama"] = dict(partial["llama"], layers=lay)
        return shd.complete_shardings(params, partial)

    def _tp_group(self):
        """The 'model' group the embed and lm_head are split over, or None."""
        if self.tp_mesh is None:
            return None
        from llava_align_tpu_torch.parallel.mesh import axis_group

        return axis_group(self.tp_mesh, "model")

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
            tp_mesh=self.tp_mesh if self.tp_layers else None,
        )

    # Shared-prefix decoding (engine.generate_batch_groups) needs the model
    # forward to accept a read-only prefix KV segment; the llama forward does.
    supports_shared_prefix = True

    def logits(self, params: Params, hidden: torch.Tensor) -> torch.Tensor:
        return llama.logits_from_hidden(params["llama"], hidden, self._tp_group())


class LlavaMptAdapter(LlavaAdapter):
    """LLaVA with the MPT backbone (reference llava/model/language_model/
    llava_mpt.py): LLaVA's vision tower, projector and splice, the alibi
    MPT decoder (models/mpt). cfg: models.llava_mpt.LlavaMptConfig; params
    {'mpt', 'vision', 'projector'}."""

    supports_tp = False  # the mesh for this family: ROADMAP item 8b

    name = "llava_mpt"
    supports_shared_prefix = False  # mpt.forward has no shared-segment path
    supports_act_quant = False  # mpt.forward has no act_quant path
    supports_kv_quant = False  # mpt.init_cache has no int8 layout

    @property
    def num_kv_heads(self) -> int:
        return self.cfg.text.kv_heads

    def encode_images(self, params: Params, images: torch.Tensor) -> torch.Tensor:
        feats = clip_vit.forward_features(params["vision"], self.cfg.vision, images)
        return projector.forward(params["projector"], feats.to(self.cfg.text.dtype))

    def splice_embeds(self, params, tokens, tok_g, img_g, is_img, feats):
        return llava.splice(self.embed_tokens(params, tokens), tok_g, img_g, is_img, feats)

    def embed_tokens(self, params: Params, ids: torch.Tensor) -> torch.Tensor:
        return mpt.embed_tokens(params["mpt"], ids)

    def params_device(self, params: Params) -> torch.device:
        return params["mpt"]["wte"].device

    def init_cache(self, batch: int, max_len: int, device=None):
        return mpt.init_cache(self.cfg.text, batch, max_len, device=device)

    def forward(self, params, embeds, positions, cache, offsets, *, attn_impl="auto",
                max_seq_len: int, cache_row_offset=0):
        return mpt.forward(params["mpt"], self.cfg.text, embeds, positions, cache, offsets,
                           attn_impl=attn_impl, cache_row_offset=cache_row_offset)

    def logits(self, params: Params, hidden: torch.Tensor) -> torch.Tensor:
        return mpt.logits_from_hidden(params["mpt"], hidden)


class QwenVLAdapter:
    """Qwen-VL: in-band image spans. Callers mark the 256-token image span
    with one IMAGE_TOKEN_INDEX sentinel (models/qwen_vl.sentinelize_span);
    the splice plan expands it to n_queries feature slots framed by the
    real img_start/img_end tokens."""

    name = "qwen_vl"
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
        return llava.splice(qwen.embed_tokens(params["qwen"], tokens), tok_g, img_g, is_img, feats)

    def embed_tokens(self, params: Params, ids: torch.Tensor) -> torch.Tensor:
        return qwen.embed_tokens(params["qwen"], ids)

    def params_device(self, params: Params) -> torch.device:
        return params["qwen"]["wte"].device

    def init_cache(self, batch: int, max_len: int, device=None):
        return qwen.init_cache(self.cfg.text, batch, max_len, kv_quant=self.kv_quant, device=device)

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
        )

    def logits(self, params: Params, hidden: torch.Tensor) -> torch.Tensor:
        return qwen.logits_from_hidden(params["qwen"], hidden)


class InstructBlipAdapter(LlavaAdapter):
    """InstructBLIP: the 32 projected Q-Former query embeddings are the
    "image features"; prompts are [sentinel] + Vicuna token ids. The
    Q-Former is conditioned on the instruction, so the features are encoded
    OUTSIDE the engine (models/instructblip.encode) and passed as
    generate(..., precomputed_feats=...), as the reference computes
    inputs_llm / inputs_llm_cd once per question before llm.generate. The
    decoder side (splice, embeddings, cache, forward, logits) is LLaVA's
    LLaMA, with LlavaAdapter's act_quant and kv_quant."""

    supports_tp = False  # the mesh for this family: ROADMAP item 8b

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
    {'visual', 'ln_vision', 'query_tokens', 'qformer', 'proj', 'lm'}."""

    name = "blip2_opt"
    supports_shared_prefix = False
    supports_act_quant = False  # opt.forward has no act_quant path
    supports_kv_quant = False  # opt.init_cache has no int8 layout

    @property
    def num_kv_heads(self) -> int:
        return self.cfg.text.num_heads

    def splice_embeds(self, params, tokens, tok_g, img_g, is_img, feats):
        return llava.splice(self.embed_tokens(params, tokens), tok_g, img_g, is_img, feats)

    def embed_tokens(self, params: Params, ids: torch.Tensor) -> torch.Tensor:
        return opt.embed_tokens(params["lm"], ids)

    def params_device(self, params: Params) -> torch.device:
        return params["lm"]["embed_tokens"].device

    def init_cache(self, batch: int, max_len: int, device=None):
        return opt.init_cache(self.cfg.text, batch, max_len, device=device)

    def forward(self, params, embeds, positions, cache, offsets, *, attn_impl="auto",
                max_seq_len: int, cache_row_offset=0):
        return opt.forward(params["lm"], self.cfg.text, embeds, positions, cache, offsets,
                           attn_impl=attn_impl, cache_row_offset=cache_row_offset)

    def logits(self, params: Params, hidden: torch.Tensor) -> torch.Tensor:
        return opt.logits_from_hidden(params["lm"], hidden)
