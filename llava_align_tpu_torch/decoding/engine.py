"""Debiased decode engine (torch twin of llava_align_tpu/decoding/engine.py:
`generate`, `submit_generate`, `collect_generate`, the lockstep batch
`generate_batch`, `submit_batch`, `collect_batch`, the grouped
shared-prefix entry points `generate_batch_prefix`, `generate_batch_groups`,
`submit_batch_groups`, `collect_batch_groups`, and the single-branch beam
search `generate_beam`).

All branches of one request live on the batch axis of one forward and one
packed KV cache (row 0 = main):
    main            full visual input
    'unk'           degraded-token branch (llava: sentinel→0)
    'none'          visual positions physically removed (a genuinely
                    shorter row, right-padded, masked by length)
Contrast logits = the primary branch, or the mean of (primary, 'none') when
both use_dd and use_dd_unk are set. Prefill is split-bucket: the image rows
at their 128-bucket, the text-only rows at theirs, into disjoint rows of the
cache. As in the JAX engine, the contrastive correction applies under greedy
decoding too.

With use_cd (VCD) the 'cd' branch reads the features of a diffusion-noised
copy of the image (ops.noise), encoded in the same vision-tower call as the
clean image: in `generate` its row reads feature source 1, in the lockstep
batch the noised copies follow the clean ones, and in the grouped path each
group gets a second shared prefix segment for its noised image.

The decode loops are eager Python loops with one host read per step (the
sampled tokens, which decide `done`); the JAX engine runs them on device in
lax.while_loop. Unlike it, the loops skip the forward after the last token.

The JAX engine's two opt-in serving modes are taken as it takes them:
act_quant=True (W8A8: int8 stacks take the W8A8 product at prefill row
counts, ops/quant.int8_matmul_w8a8) and kv_quant="int8" (the int8 KV cache,
shared prefix segments included). Neither is bit-exact with the default
path, by design.

mesh= (a ('data', 'model') DeviceMesh, parallel/mesh; one process per
rank, every rank calls the same entry point with the same inputs and gets
the whole result): the params are sharded at init over 'model' by the
adapter's Megatron specs (every adapter; int8 stacks lane-padded where
that makes them TP-ready, as in the JAX engine; int4 stacks stay whole),
the KV cache holds the adapter's share of the kv heads, and the forwards
carry their collectives.
Data parallelism over 'data' splits the lockstep work by question
(generate_batch) or by group (generate_batch_groups), never by row: a
question's main/unk/none/cd rows stay together, as the fusion reads them
together. The outputs are then gathered, so every rank returns the whole
batch. A single request (generate, generate_beam) runs whole on every
'data' slice. Every slice draws from one stream as the unsharded engine
does: the VCD noise of a split batch is drawn for the whole batch and
sliced, and a sampled decode gathers every slice's scores each step and
samples them whole, so a split batch's tokens, greedy or sampled, are the
unsharded engine's.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import time
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from llava_align_tpu_torch.config import GenerationConfig
from llava_align_tpu_torch.constants import IMAGE_TOKEN_INDEX
from llava_align_tpu_torch.decoding import sampler as S
from llava_align_tpu_torch.decoding.adapters import LlavaAdapter, _quant_kinds
from llava_align_tpu_torch.decoding.beam import make_beam_fn
from llava_align_tpu_torch.models import llava as llava_model
from llava_align_tpu_torch.ops.image import normalize_device, normalize_host
from llava_align_tpu_torch.ops.noise import add_diffusion_noise
from llava_align_tpu_torch.parallel import comm
from llava_align_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size

Params = Dict[str, Any]


def draw_noise_eps(shape, generator: torch.Generator, device) -> torch.Tensor:
    """The VCD noise's standard-normal draw for a batch split over 'data'
    (fp32, from `generator`, as ops/noise.add_diffusion_noise draws it)."""
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


class _DataSplit(NamedTuple):
    """This 'data' slice's share of a split batch: its rows of the VCD
    noise drawn for the whole batch (None without use_cd or images), and
    every slice's question count."""

    eps: Optional[torch.Tensor]
    counts: Tuple[int, ...]

logger = logging.getLogger("llava_align_tpu_torch.engine")


def branch_kinds(gen: GenerationConfig) -> List[str]:
    """Row layout of the packed branch axis (row 0 = main): the primary
    contrast branch is cd > unk > none by priority; a secondary 'none'
    branch exists iff use_dd AND use_dd_unk."""
    kinds = ["main"]
    if gen.use_cd:
        kinds.append("cd")
    elif gen.use_dd_unk:
        kinds.append("unk")
    elif gen.use_dd:
        kinds.append("none")
    if gen.use_dd and gen.use_dd_unk:
        kinds.append("none")
    return kinds


def branch_token_ids(input_ids: Sequence[int], kind: str) -> List[int]:
    """LLaVA-family branch degradation (kept for compatibility; adapters own
    this per family)."""
    return LlavaAdapter.branch_token_ids(None, input_ids, kind)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _make_fuse_and_warp(gen: GenerationConfig, n_contrast: int):
    """[Q, nb, V] branch logits → warped [Q, V]."""

    def fuse_and_warp(branch_logits: torch.Tensor) -> torch.Tensor:
        main = branch_logits[:, 0]
        if n_contrast:
            contrast = branch_logits[:, 1 : 1 + n_contrast].mean(dim=1)
            fused = S.fuse_contrastive_logits(main, contrast, gen.cd_alpha, gen.cd_beta)
        else:
            fused = main
        return S.warp_logits(fused, gen.temperature, gen.top_k, gen.top_p)

    return fuse_and_warp


def _stop_hit(out: List[int], kws: Sequence[Sequence[int]]) -> bool:
    """True iff the generated ids end with one of the stop keyword ids."""
    return any(len(out) >= len(kw) and out[-len(kw):] == list(kw) for kw in kws)


@dataclasses.dataclass
class GenerationOutput:
    token_ids: List[int]                # generated ids (trimmed at stop)
    num_generated: int
    first_scores_top_probs: np.ndarray  # [k] softmax of first-step warped scores
    first_scores_top_ids: np.ndarray    # [k]
    prompt_length: int                  # main-branch spliced length
    seconds_to_first_token: float = 0.0  # submit → first token on the host
    seconds_total: float = 0.0           # submit → last token on the host


class DecodeEngine:
    """Runs debiased generation for one (model, GenerationConfig).

    The adapter (decoding/adapters) is the model family: LlavaAdapter(cfg)
    by default, or QwenVLAdapter with a QwenVLConfig. Every forward of one
    call passes the call's cache length as max_seq_len (Qwen's dynamic NTK
    reads it). Prefill lengths are bucketed to multiples of `bucket`, as in
    the JAX engine (here it fixes the kernels' shapes rather than compiled
    programs). `device` defaults to the device of the params.

    act_quant: opt-in W8A8 (decode rows keep the exact K1). kv_quant:
    "int8" for the int8 KV cache; other modes raise. Each is set on a copy
    of the adapter (the caller's adapter may serve engines without it); an
    adapter without the mode logs a warning and the flag is ignored, as in
    the JAX engine."""

    def __init__(
        self,
        params: Params,
        cfg,
        gen: GenerationConfig,
        *,
        adapter=None,
        stop_keyword_ids: Optional[Sequence[Sequence[int]]] = None,
        attn_impl: str = "auto",
        bucket: int = 128,
        top_scores_k: int = 100,
        device: Optional[torch.device] = None,
        act_quant: bool = False,
        kv_quant: Optional[str] = None,
        mesh=None,
    ):
        self.params = params
        self.cfg = cfg
        self.gen = gen
        self.adapter = adapter if adapter is not None else LlavaAdapter(cfg)
        if kv_quant and kv_quant != "int8":
            raise ValueError(f"unknown kv_quant mode {kv_quant!r}")
        for flag, on, what in (("kv_quant", bool(kv_quant), "int8 cache"), ("act_quant", act_quant, "W8A8")):
            if not on:
                continue
            if not getattr(type(self.adapter), f"supports_{flag}", False):
                logger.warning("%s requested but adapter %s has no %s path; ignoring.",
                               flag, getattr(self.adapter, "name", "?"), what)
            else:
                self.adapter = copy.copy(self.adapter)
                setattr(self.adapter, flag, True)
        self.kinds = branch_kinds(gen)
        self.stop_keyword_ids = [list(map(int, k)) for k in (stop_keyword_ids or [])]
        self.attn_impl = attn_impl  # the causal prefill's route (ops.attention.causal_attention)
        self.bucket = bucket
        self.top_scores_k = top_scores_k
        self.device = torch.device(device) if device is not None else self.adapter.params_device(params)
        self.mesh = mesh
        self._model_size = axis_size(mesh, "model")
        self._data_size = axis_size(mesh, "data")
        self._data_rank = axis_rank(mesh, "data")
        self._data_group = axis_group(mesh, "data") if self._data_size > 1 else None
        self._int8_tp = False
        if self._model_size > 1:
            self._shard_over_model()

    def _shard_over_model(self):
        """The JAX engine's readiness/padding decision (engine.py:228-294),
        then the params sharded by the adapter's specs and the adapter
        copied with the mesh, whether its layer stacks split, and this
        rank's cache kv heads (the adapter's rule: LLaMA and Qwen K / m
        where it divides, OPT H / m, MPT every kv head)."""
        from llava_align_tpu_torch.parallel.sharding import shard_params

        adapter, m, params = self.adapter, self._model_size, self.params
        has_quant, has_quant4 = _quant_kinds(params[adapter.lm_key]["layers"])
        if has_quant and not adapter.int8_tp_ready(params, m):
            padded = adapter.int8_tp_pad(params, m)
            if padded is not params and adapter.int8_tp_ready(padded, m):
                params = padded
        self._int8_tp = has_quant and adapter.int8_tp_ready(params, m)
        split = adapter.tp_split_layers(params, m)
        if has_quant and not self._int8_tp:
            logger.warning(
                "int8-quantized stacks are replicated across the %d-way 'model' axis (per-shard dims "
                "not lane-aligned for the TP kernels); TP shards only the float tensors.", m)
        if has_quant4:
            logger.warning(
                "int4-quantized stacks are replicated across the %d-way 'model' axis (no int4 TP "
                "kernel); use int8 for TP serving.", m)
        self.params = shard_params(params, adapter.param_shardings(params, self.mesh), self.mesh,
                                   self.device)
        self.adapter = copy.copy(adapter)
        self.adapter.tp_mesh = self.mesh
        self.adapter.tp_layers = split
        self.adapter.cache_kv_heads = adapter.tp_cache_kv_heads(m, split)

    # ------------------------------------------------------------------
    # host-side packing (identical to the JAX engine's _pack)
    # ------------------------------------------------------------------

    def _pack(
        self,
        input_ids: Sequence[int],
        has_image: bool,
        branch_ids: Optional[Mapping[str, Sequence[int]]] = None,
        kinds: Optional[Sequence[str]] = None,
        num_image_tokens: Optional[int] = None,
    ):
        n_img = (num_image_tokens or self.adapter.num_image_tokens) if has_image else 0
        branch_ids = branch_ids or {}
        per_branch = []
        for kind in (kinds if kinds is not None else self.kinds):
            if kind in branch_ids:
                ids = [int(t) for t in branch_ids[kind]]
            else:
                ids = self.adapter.branch_token_ids(input_ids, kind)
            n = n_img if kind in ("main", "cd") else 0
            per_branch.append((kind, ids, n))
        max_len = max(
            len(ids) + (n - 1) * sum(1 for t in ids if t == IMAGE_TOKEN_INDEX)
            if n
            else len(ids)
            for _, ids, n in per_branch
        )
        pad_to = _round_up(max(max_len, self.bucket), self.bucket)

        nb = len(per_branch)
        tokens = np.zeros((nb, pad_to), np.int32)
        tok_g = np.zeros((nb, pad_to), np.int32)
        img_g = np.zeros((nb, pad_to), np.int32)
        is_img = np.zeros((nb, pad_to), bool)
        lengths = np.zeros((nb,), np.int32)
        feats_src = np.full((nb,), -1, np.int32)  # -1 = no image features
        for b, (kind, ids, n) in enumerate(per_branch):
            plan = llava_model.plan_splice(ids, n, pad_to)
            tokens[b, : len(plan.tokens)] = plan.tokens
            tok_g[b] = plan.tok_gather
            img_g[b] = plan.img_gather
            is_img[b] = plan.is_image
            lengths[b] = plan.length
            if kind == "main" and has_image:
                feats_src[b] = 0
            elif kind == "cd":
                feats_src[b] = 1
        return pad_to, tokens, tok_g, img_g, is_img, lengths, feats_src

    def _assemble_images(self, imgs_np, count: int) -> np.ndarray:
        """Per-slot [3,H,W] images (or None) → one [count, 3, H, H] array.
        Raw uint8 ships only when every present slot is uint8 AND no cd run
        needs a normalized-space zero placeholder (a missing slot's zeros
        must mean 'zero in normalized space'); otherwise uint8 slots are
        normalized on the host."""
        H = self.adapter.image_size
        use_u8 = (
            any(i is not None for i in imgs_np)
            and all(i is None or i.dtype == np.uint8 for i in imgs_np)
            and not (self.gen.use_cd and any(i is None for i in imgs_np))
        )
        dtype = np.uint8 if use_u8 else np.float32
        images = np.zeros((count, 3, H, H), dtype)
        for qi, im in enumerate(imgs_np):
            if im is None:
                continue
            if im.dtype == np.uint8 and not use_u8:
                im = normalize_host(im)
            images[qi] = im.astype(dtype)
        return images

    @property
    def img_kinds(self) -> List[str]:
        """Image-bearing branches — always a prefix of self.kinds."""
        return [k for k in self.kinds if k in ("main", "cd")]

    @property
    def txt_kinds(self) -> List[str]:
        return [k for k in self.kinds if k not in ("main", "cd")]

    # ------------------------------------------------------------------
    # device side
    # ------------------------------------------------------------------

    def _encode(self, images: np.ndarray, generator: torch.Generator, eps=None) -> torch.Tensor:
        """[G, 3, H, W] pixels (uint8 raw, normalized on the device, or
        normalized floats) → [G, N, D] features; with use_cd [2G, N, D]:
        the clean images' then their diffusion-noised copies', the noise
        drawn from `generator` in normalized pixel space (or given: `eps`,
        this slice's rows of a split batch's draw), in one vision-tower
        call."""
        pixels = normalize_device(torch.from_numpy(np.ascontiguousarray(images)).to(self.device),
                                  self.adapter.vision_dtype)
        if self.gen.use_cd:
            if eps is None:
                noised = add_diffusion_noise(pixels, self.gen.noise_step, generator=generator)
            else:
                noised = add_diffusion_noise(pixels, self.gen.noise_step, eps=eps)
            pixels = torch.cat([pixels, noised])
        return self.adapter.encode_images(self.params, pixels)

    def _request_features(self, image: np.ndarray, generator: torch.Generator) -> torch.Tensor:
        """[n_srcs, N, D] feature sources of one request (row 0 the image,
        row 1 its noised copy under use_cd): image [3, H, W], or an anyres
        grid stack [G, 3, H, W] whose G grids' features concatenate into
        one run of G * num_image_tokens."""
        images = np.asarray(image)
        if images.ndim == 3:
            images = images[None]
        G = images.shape[0]
        grid_feats = self._encode(images, generator)
        D = grid_feats.shape[2]
        return grid_feats.reshape(grid_feats.shape[0] // G, -1, D)

    def _prefill(self, pack, pad: int, feats, cache, row_offset: int, max_seq_len: int):
        """Splice + prefill one row group at its bucket; returns the group's
        last-token logits [rows, V]. max_seq_len: the call's cache length,
        which every forward of a call passes (Qwen's dynamic NTK reads it)."""
        dev = self.device
        tokens, tok_g, img_g, is_img, lengths, feats_src = (
            torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in pack
        )
        rows = tokens.shape[0]
        D = self.cfg.text.hidden_size
        if feats is None:
            branch_feats = torch.zeros((rows, 1, D), dtype=self.cfg.text.dtype, device=dev)
        else:
            zero = torch.zeros((1,) + tuple(feats.shape[1:]), dtype=feats.dtype, device=dev)
            branch_feats = torch.cat([zero, feats], dim=0)[feats_src.long() + 1]
        embeds = self.adapter.splice_embeds(self.params, tokens, tok_g, img_g, is_img, branch_feats)
        positions = torch.arange(pad, device=dev).expand(rows, pad)
        hidden, _ = self.adapter.forward(
            self.params, embeds, positions, cache,
            torch.zeros((rows,), dtype=torch.long, device=dev), cache_row_offset=row_offset,
            attn_impl=self.attn_impl, max_seq_len=max_seq_len,
        )
        last = hidden[torch.arange(rows, device=dev), lengths.long() - 1]
        return self.adapter.logits(self.params, last)

    @torch.inference_mode()
    def submit_generate(
        self,
        input_ids: Sequence[int],
        image: Optional[np.ndarray] = None,
        *,
        generator: Optional[torch.Generator] = None,
        branch_ids: Optional[Mapping[str, Sequence[int]]] = None,
        precomputed_feats=None,
    ):
        """Pack on the host, encode, prefill and run the decode loop. The
        tokens end up on the host (the loop reads each one); the first-step
        scores (the warped fused logits, 'first_scores') and their summary
        stay on the device until collect_generate.

        image: pixels [3, H, W] (uint8 raw, or float already normalized), an
        anyres grid stack [G, 3, H, W] (each grid contributes
        num_image_tokens features, concatenated), or None. branch_ids:
        explicit token ids per branch kind. precomputed_feats: [n_srcs, N, D]
        image features computed outside the engine (row 0 = main, row 1 =
        cd), in place of the vision tower. generator: the noise and sampling
        stream (default: seeded from gen.seed)."""
        t0 = time.perf_counter()
        gen, adapter, dev = self.gen, self.adapter, self.device
        n_sentinels = sum(1 for t in input_ids if t == IMAGE_TOKEN_INDEX)
        has_image = (image is not None or precomputed_feats is not None) and n_sentinels > 0
        if has_image and n_sentinels != 1:
            # a second sentinel would gather past the one image's features
            # (torch faults where JAX clamps)
            raise ValueError(f"one image per request, but the prompt holds {n_sentinels} <image>")
        n_tok = None
        if precomputed_feats is not None:
            n_srcs, n_tok = int(np.shape(precomputed_feats)[0]), int(np.shape(precomputed_feats)[1])
            if has_image and "cd" in self.kinds and n_srcs < 2:
                raise ValueError("use_cd reads feature source 1: precomputed_feats needs 2 rows")
        elif image is not None and np.ndim(image) == 4:
            n_tok = adapter.num_image_tokens * int(np.shape(image)[0])

        pad_img, *pi = self._pack(input_ids, has_image, branch_ids, kinds=self.img_kinds,
                                  num_image_tokens=n_tok)
        pad_txt, pt = 0, None
        if self.txt_kinds:
            pad_txt, *pt = self._pack(input_ids, has_image, branch_ids, kinds=self.txt_kinds,
                                      num_image_tokens=n_tok)
        nb = len(self.kinds)
        T = gen.max_new_tokens
        cache_len = max(pad_img, pad_txt) + T
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(gen.seed)

        feats = None
        if has_image and precomputed_feats is not None:
            feats = torch.as_tensor(precomputed_feats).to(dev)
        elif has_image:
            feats = self._request_features(image, generator)
        cache = adapter.init_cache(nb, cache_len, device=dev)
        logits = self._prefill(pi, pad_img, feats, cache, 0, cache_len)
        lengths_host = pi[4].astype(np.int64)
        if pt is not None:
            logits = torch.cat([logits, self._prefill(pt, pad_txt, None, cache, len(self.img_kinds),
                                                      cache_len)])
            lengths_host = np.concatenate([lengths_host, pt[4].astype(np.int64)])
        lengths = torch.from_numpy(lengths_host).to(dev)

        fuse_and_warp = _make_fuse_and_warp(gen, nb - 1)
        kws = [k for k in self.stop_keyword_ids if 0 < len(k) <= T]
        out: List[int] = []
        first_scores = None
        t_first = None
        while True:
            warped = fuse_and_warp(logits[None])[0]
            if first_scores is None:
                first_scores = warped
            tok = S.sample_token(generator, warped, gen.do_sample)
            out.append(int(tok))  # the step's one host read
            if t_first is None:
                t_first = time.perf_counter()
            if out[-1] == gen.eos_token_id or _stop_hit(out, kws) or len(out) >= T:
                break
            if int(lengths_host.max()) >= cache_len:  # torch would fault, not clamp
                raise RuntimeError(f"cache write at {lengths_host} past cache_len={cache_len}")
            emb = adapter.embed_tokens(self.params, tok.reshape(1, 1).expand(nb, 1))
            hidden, cache = adapter.forward(self.params, emb, lengths[:, None], cache, lengths,
                                            attn_impl=self.attn_impl, max_seq_len=cache_len)
            logits = adapter.logits(self.params, hidden[:, 0])
            lengths = lengths + 1
            lengths_host = lengths_host + 1

        top_probs, top_ids = _top_scores(first_scores, self.top_scores_k)
        return dict(
            tokens=out, top_probs=top_probs, top_ids=top_ids, first_scores=first_scores,
            prompt_length=int(pi[4][0]),
            seconds_to_first_token=t_first - t0, seconds_total=time.perf_counter() - t0,
        )

    def collect_generate(self, handle) -> GenerationOutput:
        """Fetch a submit_generate handle's outputs to the host."""
        return GenerationOutput(
            token_ids=list(handle["tokens"]),
            num_generated=len(handle["tokens"]),
            first_scores_top_probs=handle["top_probs"].cpu().numpy(),
            first_scores_top_ids=handle["top_ids"].cpu().numpy(),
            prompt_length=handle["prompt_length"],
            seconds_to_first_token=handle["seconds_to_first_token"],
            seconds_total=handle["seconds_total"],
        )

    def generate(
        self,
        input_ids: Sequence[int],
        image: Optional[np.ndarray] = None,
        *,
        generator: Optional[torch.Generator] = None,
        branch_ids: Optional[Mapping[str, Sequence[int]]] = None,
        precomputed_feats=None,
    ) -> GenerationOutput:
        """One request, end to end: submit_generate then collect_generate
        (which see for the inputs)."""
        return self.collect_generate(self.submit_generate(
            input_ids, image, generator=generator, branch_ids=branch_ids,
            precomputed_feats=precomputed_feats))

    # ------------------------------------------------------------------
    # beam search (single branch; the reference's BLIP-2 generate,
    # num_beams=5; the reference sampler never combines CD with beams)
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def generate_beam(
        self,
        input_ids: Sequence[int],
        image: Optional[np.ndarray] = None,
        *,
        num_beams: int = 5,
        length_penalty: float = 1.0,
        min_new_tokens: int = 0,
        precomputed_feats=None,
    ) -> GenerationOutput:
        """HF-semantics beam search (do_sample=False, early_stopping=False;
        decoding/beam.py) over one packed 'main' row: its prefill (K3 on the
        card), then the beams. image / precomputed_feats as for `generate`.
        The returned token_ids exclude the finishing eos; the first-step
        scores are empty, as in the JAX engine."""
        if len(self.kinds) != 1:
            raise ValueError(
                "beam search is single-branch; the reference never combines "
                "CD/DD with beams (vcd_sample patches `sample` only)"
            )
        gen, adapter, dev = self.gen, self.adapter, self.device
        n_sentinels = sum(1 for t in input_ids if t == IMAGE_TOKEN_INDEX)
        has_image = (image is not None or precomputed_feats is not None) and n_sentinels > 0
        if has_image and n_sentinels != 1:
            raise ValueError(f"one image per request, but the prompt holds {n_sentinels} <image>")
        n_tok = None
        if precomputed_feats is not None:
            n_tok = int(np.shape(precomputed_feats)[1])
        elif image is not None and np.ndim(image) == 4:
            n_tok = adapter.num_image_tokens * int(np.shape(image)[0])
        pad, *pi = self._pack(input_ids, has_image, num_image_tokens=n_tok, kinds=["main"])
        cache_len = pad + gen.max_new_tokens
        feats = None
        if has_image and precomputed_feats is not None:
            feats = torch.as_tensor(precomputed_feats).to(dev)
        elif has_image:
            feats = self._request_features(image, None)
        cache = adapter.init_cache(1, cache_len, device=dev)
        first_logits = self._prefill(pi, pad, feats, cache, 0, cache_len)
        beam = make_beam_fn(
            adapter, num_beams=num_beams, max_new_tokens=gen.max_new_tokens,
            eos_token_id=gen.eos_token_id, pad_token_id=gen.pad_token_id,
            length_penalty=length_penalty, min_new_tokens=min_new_tokens,
            attn_impl=self.attn_impl, cache_len=cache_len,
        )
        seq, n, _ = beam(self.params, cache, first_logits, torch.from_numpy(pi[4]).to(dev))
        return GenerationOutput(
            token_ids=seq[:n].tolist(),
            num_generated=n,
            first_scores_top_probs=np.zeros((0,), np.float32),
            first_scores_top_ids=np.zeros((0,), np.int64),
            prompt_length=int(pi[4][0]),
        )

    # ------------------------------------------------------------------
    # lockstep multi-question generation (unshared prompts)
    # ------------------------------------------------------------------

    def generate_batch(
        self,
        batch: Sequence[tuple],
        *,
        generator: Optional[torch.Generator] = None,
    ) -> List[GenerationOutput]:
        """batch: list of (input_ids, image), image [3, H, W] or None (with
        use_cd, a question without an image has a cd row without image
        positions). All questions decode in lockstep on a [Q * nb] packed
        batch axis, and each stops on its own done flag (EOS, a stop
        keyword, or max_new_tokens); a finished question's later tokens are
        pad.

        Prefill is split-bucket, as in `generate`: the Q * n_img
        image-bearing rows prefill at the image bucket, the Q * n_txt
        text-only rows at their own, into disjoint cache row groups
        [image rows | text rows]."""
        return self.collect_batch(self.submit_batch(batch, generator=generator))

    @torch.inference_mode()
    def submit_batch(
        self,
        batch: Sequence[tuple],
        *,
        generator: Optional[torch.Generator] = None,
    ):
        """Host packing, the prefills and the decode loop of
        generate_batch; the first-step scores (the warped fused logits
        [Q, V], 'first_scores') and their summaries stay on the device until
        collect_batch. The loop reads each step's tokens, so this returns
        when the decode is done (the JAX engine returns at dispatch): the
        POPE runner's order (submit the main call and both scoring calls,
        then collect) is kept but overlaps nothing here. Under a mesh with
        a 'data' axis each slice runs its chunk of the questions and the
        handle holds the whole batch (every rank's)."""
        if self._data_size > 1 and batch:
            present = [(i, im) for i, (ids, im) in enumerate(batch)
                       if im is not None and IMAGE_TOKEN_INDEX in [int(t) for t in ids]]
            generator, split, (lo, hi) = self._split(len(batch), present, generator)
            local = self._submit_batch(batch[lo:hi], generator, split)
            return self._gather_handle(local, split.counts, {"lens_img": len(self.img_kinds)})
        return self._submit_batch(batch, generator)

    def _submit_batch(self, batch, generator, split=None):
        t0 = time.perf_counter()
        Q = len(batch)
        if Q == 0:
            return self._empty_handle(split, generator) if split is not None else []
        img_packs, txt_packs, slots, present = [], [], [], []
        for qi, (input_ids, image) in enumerate(batch):
            n_sentinels = sum(1 for t in input_ids if t == IMAGE_TOKEN_INDEX)
            has_image = image is not None and n_sentinels > 0
            if has_image and n_sentinels != 1:
                raise ValueError(f"one image per question, but question {qi} holds {n_sentinels} <image>")
            if image is not None and np.asarray(image).ndim != 3:
                raise ValueError(f"question {qi}: images are [3, H, W]; decode anyres stacks "
                                 "through engine.generate")
            img_packs.append(self._pack(input_ids, has_image, kinds=self.img_kinds))
            if self.txt_kinds:
                txt_packs.append(self._pack(input_ids, has_image, kinds=self.txt_kinds))
            slots.append(np.asarray(image) if image is not None else None)
            if has_image:
                present.append(qi)
        # only the images a row takes are encoded: the main rows read the
        # clean images in question order, the cd rows their noised copies,
        # which follow them
        n_img, P = len(self.img_kinds), len(present)
        feats_src = np.full((Q * n_img,), -1, np.int32)
        for k, qi in enumerate(present):
            for i, kind in enumerate(self.img_kinds):
                feats_src[qi * n_img + i] = k if kind == "main" else P + k
        pack_img = _stack_packs(img_packs)[:5] + (feats_src,)
        pack_txt = _stack_packs(txt_packs) if txt_packs else None
        # every slot decides whether uint8 ships raw (the JAX engine's rule)
        images = self._assemble_images(slots, Q)[present] if present else None
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(self.gen.seed)
        out = self._run_batch(Q, pack_img, pack_txt, images, generator, split)
        out.update(lens_img=pack_img[4], n_img=len(self.img_kinds),
                   seconds_to_first_token=out["t_first"] - t0, seconds_total=time.perf_counter() - t0)
        return out

    def _run_batch(self, Q, pack_img, pack_txt, images, generator, split=None):
        """The device side of submit_batch: encode (only when a row takes
        image features), the two prefills, and the decode loop over the
        cache rows [Q * n_img image rows | Q * n_txt text rows]."""
        gen, adapter, params, dev = self.gen, self.adapter, self.params, self.device
        nb, n_img, n_txt = len(self.kinds), len(self.img_kinds), len(self.txt_kinds)
        pad_img = pack_img[0].shape[1]
        pad_txt = pack_txt[0].shape[1] if n_txt else 0
        cache_len = max(pad_img, pad_txt) + gen.max_new_tokens

        # branch b of question q sits at cache row perm[q * nb + b]
        perm = np.zeros((Q * nb,), np.int64)
        for q in range(Q):
            i = j = 0
            for b, kind in enumerate(self.kinds):
                if kind in ("main", "cd"):
                    perm[q * nb + b] = q * n_img + i
                    i += 1
                else:
                    perm[q * nb + b] = Q * n_img + q * n_txt + j
                    j += 1
        # cache row -> question, to broadcast each sampled token to its rows
        row_to_q = np.concatenate([np.repeat(np.arange(Q), n_img), np.repeat(np.arange(Q), n_txt)])

        eps = split.eps if split is not None else None
        feats = self._encode(images, generator, eps) if images is not None else None
        cache = adapter.init_cache(Q * nb, cache_len, device=dev)
        logits = self._prefill(pack_img, pad_img, feats, cache, 0, cache_len)
        lengths_host = pack_img[4].astype(np.int64)
        if n_txt:
            logits = torch.cat([logits, self._prefill(pack_txt, pad_txt, None, cache, Q * n_img, cache_len)])
            lengths_host = np.concatenate([lengths_host, pack_txt[4].astype(np.int64)])
        lengths = torch.from_numpy(lengths_host).to(dev)

        def step(tok_rows):  # at most T - 1 steps: the cache holds every write
            nonlocal cache, lengths
            emb = adapter.embed_tokens(params, tok_rows[:, None])
            hidden, cache = adapter.forward(params, emb, lengths[:, None], cache, lengths,
                                            attn_impl=self.attn_impl, max_seq_len=cache_len)
            lengths = lengths + 1
            return adapter.logits(params, hidden[:, 0])

        return self._lockstep_decode(logits, perm, row_to_q, step, generator, split)

    def collect_batch(self, handle) -> List[GenerationOutput]:
        """Fetch a submit_batch handle's outputs to the host, one
        GenerationOutput per question (timings are the whole call's)."""
        if not handle:  # submit of an empty batch returns []
            return []
        lens_img, n_img = handle["lens_img"], handle["n_img"]
        return _collect(handle, [int(lens_img[q * n_img]) for q in range(len(handle["n_done"]))])

    def _lockstep_decode(self, logits, perm, row_to_q, step, generator, split=None):
        """The decode loop of the lockstep entry points (generate_batch,
        generate_batch_groups) over Q questions: logits [R, V] of the cache
        rows after the prefills, perm[q * nb + b] the cache row of branch b
        of question q, row_to_q the question of each cache row, and
        step(tok_rows [R], on the device) -> the next logits [R, V] (one
        forward of every row). One host read (the step's tokens) per step;
        each question stops on its own done flag (EOS, a stop keyword, or
        max_new_tokens), and a finished question's later tokens are pad.
        Returns the tokens [Q, T], each question's count, and the
        first-step scores with their softmax top-k.

        split: this slice's share of a batch split over 'data'. A sampled
        decode then gathers every slice's scores each step, samples them
        whole (one stream, as the unsharded engine draws) and keeps this
        slice's rows; every slice steps until every question is done."""
        gen = self.gen
        sync = split is not None and gen.do_sample
        nb = len(self.kinds)
        Q, V, T = len(perm) // nb, logits.shape[-1], gen.max_new_tokens
        fuse_and_warp = _make_fuse_and_warp(gen, nb - 1)
        kws = [k for k in self.stop_keyword_ids if 0 < len(k) <= T]
        perm_t = torch.from_numpy(perm).to(self.device)
        out_buf = np.zeros((Q, T), np.int64)
        done = np.zeros((Q,), bool)
        n_done = np.full((Q,), T, np.int64)
        first_scores, t_first, n = None, None, 0
        while True:
            warped = fuse_and_warp(logits[perm_t].reshape(Q, nb, V))
            if first_scores is None:
                first_scores = warped
            if sync:
                toks = self._sample_whole(warped, split.counts, generator).cpu().numpy()
            else:
                toks = S.sample_token(generator, warped, gen.do_sample).cpu().numpy()
            if t_first is None:
                t_first = time.perf_counter()
            toks = np.where(done, gen.pad_token_id, toks)
            out_buf[:, n] = toks
            n += 1
            done_now = (toks == gen.eos_token_id) | _stop_hits(out_buf, n, kws)
            n_done = np.where(done_now & ~done, n, n_done)
            done = done | done_now | (n >= T)
            if self._all_done(done, sync):
                break
            logits = step(torch.from_numpy(toks[row_to_q]).to(self.device))

        top_probs, top_ids = _top_scores(first_scores, self.top_scores_k)
        return dict(out_buf=out_buf, n_done=n_done, top_probs=top_probs, top_ids=top_ids,
                    first_scores=first_scores, t_first=t_first)

    # ------------------------------------------------------------------
    # shared-prefix grouped generation (the POPE throughput path)
    #
    # POPE ships 6 questions per image, and within one question the VDD
    # branches differ only in their visual degradation. The shared
    # [system + image] prefix of each image group prefills ONCE into a
    # read-only KV segment; each question's main row prefills only its
    # suffix against [shared | local] joint-softmax attention and decodes
    # the same way. Text-only degraded kinds whose transformed prompt prefix
    # is shared by every question of a group (llava unk/none) get per-group
    # segments of their own (the second table); kinds with explicit
    # per-question ids keep full-prompt rows. No KV copies: every row reads
    # its segment in place.
    # ------------------------------------------------------------------

    def generate_batch_prefix(
        self,
        prefix_ids: Sequence[int],
        suffixes: Sequence[Sequence[int]],
        image: Optional[np.ndarray],
        *,
        generator: Optional[torch.Generator] = None,
        branch_ids_list: Optional[Sequence[Mapping[str, Sequence[int]]]] = None,
    ) -> List[GenerationOutput]:
        """Lockstep-decode the questions that share one image and one token
        prefix (one group of generate_batch_groups). prefix_ids holds the
        IMAGE_TOKEN_INDEX sentinel; each question's full prompt is
        prefix_ids + suffixes[q] (common_token_prefix gives the split).
        branch_ids_list: optional per-question explicit token ids for the
        text-only degraded branches."""
        return self.generate_batch_groups(
            [(prefix_ids, suffixes, image, branch_ids_list)], generator=generator
        )

    def generate_batch_groups(
        self,
        groups: Sequence[tuple],
        *,
        generator: Optional[torch.Generator] = None,
    ) -> List[GenerationOutput]:
        """Lockstep-decode G image groups in one call. Each group is
        (prefix_ids, suffixes, image[, branch_ids_list]); every group carries
        the same number of questions (pad the tail group by repeating a
        question and drop the duplicates). Returns the outputs question-major
        (group 0's questions first)."""
        return self.collect_batch_groups(self.submit_batch_groups(groups, generator=generator))

    @torch.inference_mode()
    def submit_batch_groups(
        self,
        groups: Sequence[tuple],
        *,
        generator: Optional[torch.Generator] = None,
    ):
        """Host packing, the prefills and the decode loop of
        generate_batch_groups; the first-step scores (the warped fused
        logits [M, V], 'first_scores') and their summaries stay on the device
        until collect_batch_groups. The loop reads each step's tokens,
        so this returns when the decode is done (the JAX engine returns at
        dispatch): submitting call g+1 before collecting call g keeps the
        runner's call order but overlaps nothing here. Under a mesh with a
        'data' axis each slice runs its chunk of the groups and the handle
        holds every group's questions."""
        if self._data_size > 1 and groups:
            Qg = len(groups[0][1])
            present = [(i, g[2]) for i, g in enumerate(groups) if len(g) > 2 and g[2] is not None]
            generator, split, (lo, hi) = self._split(len(groups), present, generator, Qg)
            local = self._submit_batch_groups(groups[lo:hi], generator, split)
            return self._gather_handle(local, split.counts, {"p_lens": 1.0 / Qg, "suf_lens": 1},
                                       extra=dict(Qg=Qg, M=len(groups) * Qg))
        return self._submit_batch_groups(groups, generator)

    def _submit_batch_groups(self, groups, generator, split=None):
        t0 = time.perf_counter()
        if self.gen.use_cd and any(len(g) < 3 or g[2] is None for g in groups):
            raise ValueError(
                "use_cd groups need an image (the noised prefix segment); "
                "use generate_batch for image-less cd prompts"
            )
        if not getattr(self.adapter, "supports_shared_prefix", False):
            raise ValueError(f"adapter {self.adapter.name!r} has no shared-prefix forward")
        G = len(groups)
        if G == 0:
            return self._empty_handle(split, generator) if split is not None else []
        groups = [tuple(g) + (None,) * (4 - len(g)) for g in groups]
        Qg = len(groups[0][1])
        if Qg == 0 or any(len(g[1]) != Qg for g in groups):
            raise ValueError(
                "every group must carry the same (nonzero) question count; "
                "pad the tail group by repeating a question"
            )
        for prefix_ids, suffixes, image, _ in groups:
            if any(len(s) == 0 for s in suffixes):
                raise ValueError("each suffix needs >= 1 token")
            if any(IMAGE_TOKEN_INDEX in [int(t) for t in s] for s in suffixes):
                raise ValueError(
                    "image sentinel must be inside the shared prefix, not a "
                    "suffix — group questions by image before splitting"
                )
            if image is not None and list(prefix_ids).count(IMAGE_TOKEN_INDEX) > 1:
                raise ValueError("one image per group, but the prefix holds several <image>")
        imgs_np = [np.asarray(g[2]) if g[2] is not None else None for g in groups]
        if any(i is not None and i.ndim == 4 for i in imgs_np):
            raise ValueError(
                "anyres grid stacks ([K,3,H,W]) are per-question inputs; "
                "shared-prefix grouping needs single images — decode anyres "
                "prompts through engine.generate"
            )
        M = G * Qg
        # text kinds whose transformed prompt prefix is shared by every
        # question (branch(prefix) + suffix == branch(full), checked exactly)
        # get per-group prefix segments; the rest keep full-prompt rows
        tp_bases = {}
        for k in self.txt_kinds:
            bases = self._txt_kind_prefix_bases(k, groups)
            if bases is not None:
                tp_bases[k] = bases
        sh_kinds = tuple(tp_bases)
        pl_kinds = tuple(k for k in self.txt_kinds if k not in tp_bases)

        # ---- prefix rows: one per group, at the shared bucket
        prefix_packs, has_images = [], []
        for prefix_ids, _, image, _ in groups:
            has_image = image is not None and IMAGE_TOKEN_INDEX in list(prefix_ids)
            has_images.append(has_image)
            prefix_packs.append(self._pack(list(prefix_ids), has_image, kinds=["main"]))
        pack_prefix = _stack_packs(prefix_packs)

        # ---- suffix rows [M], at a 32-bucket
        max_suf = max(len(s) for _, sfx, _, _ in groups for s in sfx)
        pad_suf = _round_up(max(max_suf, 32), 32)
        suf_tokens = np.zeros((M, pad_suf), np.int32)
        suf_lens = np.zeros((M,), np.int32)
        for gi, (_, sfx, _, _) in enumerate(groups):
            for qi, s in enumerate(sfx):
                suf_tokens[gi * Qg + qi, : len(s)] = [int(t) for t in s]
                suf_lens[gi * Qg + qi] = len(s)

        # ---- shared text-branch prefix rows [G * n_sh], one per (group,
        # kind): the kind's transformed prefix, passed as explicit ids
        pack_tp = None
        if sh_kinds:
            pack_tp = _stack_packs([
                self._pack(list(prefix_ids), False, {kind: tp_bases[kind][gi]}, kinds=[kind])
                for gi, (prefix_ids, _, _, _) in enumerate(groups)
                for kind in sh_kinds
            ])

        # ---- plain text-only rows [M * n_pl] (full short prompts)
        pack_txt = None
        if pl_kinds:
            pack_txt = _stack_packs([
                self._pack(list(prefix_ids) + [int(t) for t in s], has_images[gi],
                           bids_list[qi] if bids_list else None, kinds=list(pl_kinds))
                for gi, (prefix_ids, sfx, _, bids_list) in enumerate(groups)
                for qi, s in enumerate(sfx)
            ])

        images = self._assemble_images(imgs_np, G)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(self.gen.seed)
        # the bucketed full-prompt length the unshared paths would take
        # (their cache_len less T), so that Qwen's dynamic NTK is the same in
        # both layouts
        max_full = max(int(pack_prefix[4][row // Qg]) + int(suf_lens[row]) for row in range(M))
        ntk_pad = _round_up(max(max_full, self.bucket), self.bucket)
        out = self._run_groups(G, Qg, sh_kinds, pl_kinds, pack_prefix, suf_tokens, suf_lens,
                               pack_tp, pack_txt, images, generator, ntk_pad, split)
        out.update(p_lens=pack_prefix[4], suf_lens=suf_lens, Qg=Qg, M=M,
                   seconds_to_first_token=out["t_first"] - t0,
                   seconds_total=time.perf_counter() - t0)
        return out

    def _run_groups(self, G, Qg, sh_kinds, pl_kinds, pack_prefix, suf_tokens, suf_lens,
                    pack_tp, pack_txt, images, generator, ntk_pad, split=None):
        """The device side of submit_batch_groups: encode, the three
        prefills, and the decode loop over the row layout
        [G*n_img segment blocks of Qg image rows | G*n_sh blocks of Qg
        shared-text rows | M*n_pl plain text rows (question-major)]. With
        use_cd (n_img = 2) each group's noised image has its own prefix
        segment: segments [g0 clean, g0 noised, g1 clean, ...]. Every forward
        passes max_seq_len = ntk_pad + T, what the unshared paths would pass."""
        gen, adapter, params, dev = self.gen, self.adapter, self.params, self.device
        nb = len(self.kinds)
        n_sh, n_pl = len(sh_kinds), len(pl_kinds)
        n_img = len(self.img_kinds)
        M = G * Qg
        M2, Msh = M * n_img, M * n_sh
        T = gen.max_new_tokens
        pad_suf = suf_tokens.shape[1]
        cache_len = max(pad_suf, pack_txt[0].shape[1] if n_pl else 0) + T
        total_len = ntk_pad + T

        # branch b of question qq sits at cache row perm[qq * nb + b]
        perm = np.zeros((M * nb,), np.int64)
        for qq in range(M):
            g, q = divmod(qq, Qg)
            jp = 0
            for b, kind in enumerate(self.kinds):
                if kind in ("main", "cd"):
                    perm[qq * nb + b] = (g * n_img + self.img_kinds.index(kind)) * Qg + q
                elif kind in sh_kinds:
                    perm[qq * nb + b] = M2 + (g * n_sh + sh_kinds.index(kind)) * Qg + q
                else:
                    perm[qq * nb + b] = M2 + Msh + qq * n_pl + jp
                    jp += 1
        # cache row → question, to broadcast each sampled token to its rows
        row_to_q = np.concatenate([
            _span_tile(np.arange(M).reshape(G, Qg), n_img),
            _span_tile(np.arange(M).reshape(G, Qg), n_sh),
            np.repeat(np.arange(M), n_pl),
        ])

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        def prefill(pack, feats, cache, row_offset=0, **shared):
            tokens, tok_g, img_g, is_img, lengths, _ = (put(a) for a in pack)
            rows, pad = tokens.shape[0], tok_g.shape[1]
            embeds = adapter.splice_embeds(params, tokens, tok_g, img_g, is_img, feats)
            positions = torch.arange(pad, device=dev).expand(rows, pad)
            hidden, _ = adapter.forward(
                params, embeds, positions, cache, torch.zeros((rows,), dtype=torch.long, device=dev),
                cache_row_offset=row_offset, attn_impl=self.attn_impl, max_seq_len=total_len, **shared,
            )
            return hidden, lengths

        # ---- vision ([clean; noised] under use_cd, into segment order),
        # then the shared prefix segments: G * n_img rows
        feats = self._encode(images, generator, split.eps if split is not None else None)
        N, D = feats.shape[1], feats.shape[2]
        feats = feats.reshape(n_img, G, N, D).transpose(0, 1).reshape(G * n_img, N, D)
        p_cache = adapter.init_cache(G * n_img, pack_prefix[1].shape[1], device=dev)
        prefill(tuple(np.repeat(a, n_img, axis=0) for a in pack_prefix), feats, p_cache)
        shared = dict(p_cache)  # [L, G, P, K, Dh] (+ 'ks'/'vs' scale planes, int8)
        sh_len_suf = np.repeat(np.repeat(pack_prefix[4], n_img), Qg)  # [M2]
        # ...and the shared text-branch segments: G * n_sh rows, own bucket
        if n_sh:
            t_cache = adapter.init_cache(G * n_sh, pack_tp[1].shape[1], device=dev)
            zero = torch.zeros((G * n_sh, 1, D), dtype=feats.dtype, device=dev)
            prefill(pack_tp, zero, t_cache)
            shared["k2"], shared["v2"] = t_cache["k"], t_cache["v"]
            if "ks" in t_cache:  # int8 cache: the second table's scale planes
                shared["k2s"], shared["v2s"] = t_cache["ks"], t_cache["vs"]
            sh_len_suf = np.concatenate([sh_len_suf, np.repeat(pack_tp[4], Qg)])

        # ---- per-question suffixes of the image rows and the shared-text
        # rows in one forward, each row span against its own segment table;
        # rows span-blocked [g, i, q] then [g, j, q]
        R = M2 + Msh + M * n_pl
        cache = adapter.init_cache(R, cache_len, device=dev)
        suf_t = suf_tokens.reshape(G, Qg, pad_suf)
        suf_l = suf_lens.reshape(G, Qg)
        tokens2 = np.concatenate([_span_tile(suf_t, n_img), _span_tile(suf_t, n_sh)])
        lens2 = np.concatenate([_span_tile(suf_l, n_img), _span_tile(suf_l, n_sh)])
        sh_len = put(sh_len_suf).long()
        positions = sh_len[:, None] + torch.arange(pad_suf, device=dev)
        hidden, _ = adapter.forward(
            params, adapter.embed_tokens(params, put(tokens2)), positions, cache,
            torch.zeros((M2 + Msh,), dtype=torch.long, device=dev),
            shared_kv=shared, shared_len=sh_len, shared_rows_per_prefix=Qg,
            shared_rows_per_prefix2=Qg, attn_impl=self.attn_impl, max_seq_len=total_len,
        )
        rows = torch.arange(M2 + Msh, device=dev)
        logits = adapter.logits(params, hidden[rows, put(lens2).long() - 1])
        lengths_host = lens2.astype(np.int64)

        # ---- plain text rows (explicit branch ids): full short prompts
        if n_pl:
            zero = torch.zeros((M * n_pl, 1, D), dtype=feats.dtype, device=dev)
            t_hidden, t_len = prefill(pack_txt, zero, cache, row_offset=M2 + Msh)
            t_rows = torch.arange(M * n_pl, device=dev)
            logits = torch.cat([logits, adapter.logits(params, t_hidden[t_rows, t_len.long() - 1])])
            lengths_host = np.concatenate([lengths_host, pack_txt[4].astype(np.int64)])
        # segmented rows carry their segment length, plain rows 0
        sh_len_all = put(np.concatenate([sh_len_suf, np.zeros((M * n_pl,), np.int64)])).long()

        lengths = put(lengths_host)

        def step(tok_rows):
            nonlocal cache, lengths
            hidden, cache = adapter.forward(
                params, adapter.embed_tokens(params, tok_rows[:, None]), (sh_len_all + lengths)[:, None],
                cache, lengths, shared_kv=shared, shared_len=sh_len_all, shared_rows_per_prefix=Qg,
                shared_rows_per_prefix2=Qg, attn_impl=self.attn_impl, max_seq_len=total_len,
            )
            lengths = lengths + 1
            return adapter.logits(params, hidden[:, 0])

        return self._lockstep_decode(logits, perm, row_to_q, step, generator, split)

    def collect_batch_groups(self, handle) -> List[GenerationOutput]:
        """Fetch a submit_batch_groups handle's outputs to the host, one
        GenerationOutput per question (timings are the whole call's)."""
        if not handle:  # submit of an empty groups list returns []
            return []
        Qg, p_lens, suf_lens = handle["Qg"], handle["p_lens"], handle["suf_lens"]
        return _collect(handle, [int(p_lens[row // Qg]) + int(suf_lens[row]) for row in range(handle["M"])])

    def _txt_kind_prefix_bases(self, kind: str, groups):
        """Per-group transformed prefixes when this text kind's branch
        transform is prefix-local for EVERY question — branch(prefix) +
        suffix == branch(prefix + suffix) — so one per-group prefix segment
        reproduces the per-question rows exactly; None otherwise. Explicit
        branch_ids are never split."""
        adapter = self.adapter
        bases = []
        for prefix_ids, sfx, _, bids_list in groups:
            if bids_list and any(b and kind in b for b in bids_list):
                return None
            pref = [int(t) for t in prefix_ids]
            try:
                base = list(adapter.branch_token_ids(pref, kind))
            except ValueError:
                return None
            if not base:
                return None  # empty transformed prefix: nothing to share
            for s in sfx:
                suf = [int(t) for t in s]
                if adapter.branch_token_ids(pref + suf, kind) != base + suf:
                    return None
            bases.append(base)
        return bases

    # ------------------------------------------------------------------
    # data parallelism: one stream for the whole batch, the ranks' chunks
    # gathered into one handle
    # ------------------------------------------------------------------

    def _split(self, n: int, images: Sequence[tuple], generator, per_item: int = 1):
        """This 'data' slice's chunk (lo, hi) of n items (questions, or
        groups of per_item questions), its _DataSplit and the generator
        (seeded from gen.seed when None). images: (item index, image) of
        the items whose image is encoded. Under use_cd the generator first
        draws the noise of all of them, as the unsharded engine does, and
        the split keeps this chunk's rows."""
        counts, (lo, hi) = _data_chunks(n, self._data_size, self._data_rank)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(self.gen.seed)
        eps = None
        if self.gen.use_cd and images:
            whole = draw_noise_eps((len(images),) + tuple(np.shape(images[0][1])), generator, self.device)
            mine = [k for k, (i, _) in enumerate(images) if lo <= i < hi]
            eps = whole[mine[0] : mine[-1] + 1] if mine else None
        return generator, _DataSplit(eps, tuple(c * per_item for c in counts)), (lo, hi)

    def _sample_whole(self, warped: torch.Tensor, counts: Sequence[int], generator) -> torch.Tensor:
        """Sample this slice's rows of a split batch: every slice's warped
        scores gathered, sampled whole from the one stream, then sliced."""
        lo = sum(counts[: self._data_rank])
        full = comm.gather_rows(warped.float().contiguous(), counts, self._data_group)
        return S.sample_token(generator, full, True)[lo : lo + warped.shape[0]]

    def _all_done(self, done: np.ndarray, sync: bool) -> bool:
        """True when every question is done: this slice's, or with sync
        every slice's (one all_reduce of the open count)."""
        if not sync:
            return bool(done.all())
        n_open = torch.tensor([int((~done).sum())], dtype=torch.long, device=self.device)
        return int(comm.all_reduce_(n_open, self._data_group)) == 0

    def _empty_handle(self, split: "_DataSplit", generator) -> dict:
        """A handle of zero questions (a 'data' slice whose chunk is empty:
        it still joins the gather and, in a sampled decode, each step's
        draw)."""
        V, T = int(self.cfg.text.vocab_size), self.gen.max_new_tokens
        k = min(self.top_scores_k, V)
        dev = self.device
        if self.gen.do_sample:
            none = torch.zeros((0, V), dtype=torch.float32, device=dev)
            while True:
                self._sample_whole(none, split.counts, generator)
                if self._all_done(np.zeros((0,), bool), True):
                    break
        return dict(out_buf=np.zeros((0, T), np.int64), n_done=np.zeros((0,), np.int64),
                    top_probs=torch.zeros((0, k), dtype=torch.float32, device=dev),
                    top_ids=torch.zeros((0, k), dtype=torch.long, device=dev),
                    first_scores=torch.zeros((0, V), dtype=torch.float32, device=dev),
                    lens_img=np.zeros((0,), np.int32), p_lens=np.zeros((0,), np.int32),
                    suf_lens=np.zeros((0,), np.int32), t_first=time.perf_counter(),
                    n_img=len(self.img_kinds), seconds_to_first_token=0.0, seconds_total=0.0)

    def _gather_handle(self, local: dict, counts: Sequence[int], per_question: Mapping[str, float],
                       extra: Optional[dict] = None) -> dict:
        """Concatenate the 'data' slices' handles in rank order (counts:
        each slice's questions): out_buf, n_done, first_scores and its
        top-k (a row per question), and the keys of per_question, with
        their rows per question (lens_img: n_img; p_lens: 1/Qg, one per
        group). Every rank gathers the same keys, its chunk empty or not."""
        group, dev = self._data_group, self.device
        out = dict(local, **(extra or {}))
        for key in ["out_buf", "n_done", "first_scores", "top_probs", "top_ids"] + list(per_question):
            x = local[key]
            host = isinstance(x, np.ndarray)
            t = torch.from_numpy(np.ascontiguousarray(x)).to(dev) if host else x
            per = per_question.get(key, 1)
            rows = [int(round(c * per)) for c in counts]
            t = comm.gather_rows(t.contiguous(), rows, group)
            out[key] = t.cpu().numpy() if host else t
        return out

    @staticmethod
    def common_token_prefix(token_lists: Sequence[Sequence[int]]) -> int:
        """Longest common prefix length over token lists, capped so every
        list keeps >= 1 suffix token (the exact prefix/suffix split for
        generate_batch_prefix)."""
        if not token_lists:
            return 0
        lo = min(len(t) for t in token_lists)
        p = 0
        first = token_lists[0]
        while p < lo - 1 and all(t[p] == first[p] for t in token_lists):
            p += 1
        return p


def _data_chunks(n: int, data: int, rank: int):
    """Each 'data' slice's count of n items split as runners/common.
    split_list splits (contiguous, ceil-sized), and this rank's (lo, hi)."""
    size = -(-n // data)
    bounds = [(min(r * size, n), min((r + 1) * size, n)) for r in range(data)]
    return [hi - lo for lo, hi in bounds], bounds[rank]


def _top_scores(first_scores: torch.Tensor, k: int):
    """The softmax of the first-step scores [..., V] and its k largest
    (values, ids), equal values in jax.lax.top_k's order, the lower id
    first (a stable descending sort: torch.topk promises no order among
    equal values, and top-k / top-p warping leaves many zeros tied)."""
    vals, ids = torch.sort(torch.softmax(first_scores, dim=-1), dim=-1, descending=True, stable=True)
    k = min(k, vals.shape[-1])
    return vals[..., :k], ids[..., :k]


def _collect(handle, prompt_lengths: Sequence[int]) -> List[GenerationOutput]:
    """A lockstep handle's outputs on the host, one GenerationOutput per
    question, each trimmed to its own count."""
    top_probs = handle["top_probs"].cpu().numpy()
    top_ids = handle["top_ids"].cpu().numpy()
    outs = []
    for q, prompt_length in enumerate(prompt_lengths):
        n = int(handle["n_done"][q])
        outs.append(GenerationOutput(
            token_ids=[int(t) for t in handle["out_buf"][q, :n]],
            num_generated=n,
            first_scores_top_probs=top_probs[q],
            first_scores_top_ids=top_ids[q],
            prompt_length=prompt_length,
            seconds_to_first_token=handle["seconds_to_first_token"],
            seconds_total=handle["seconds_total"],
        ))
    return outs


def _stack_packs(packs) -> tuple:
    """_pack results → one (tokens, tok_g, img_g, is_img, lengths, feats_src)
    set, rows concatenated, zero-padded to the widest pack."""
    rows = sum(p[1].shape[0] for p in packs)
    width = max(p[0] for p in packs)
    tokens, tok_g, img_g = (np.zeros((rows, width), np.int32) for _ in range(3))
    is_img = np.zeros((rows, width), bool)
    lengths = np.zeros((rows,), np.int32)
    r = 0
    for _, t, tg, ig, ii, ln, _ in packs:
        sl = slice(r, r + t.shape[0])
        tokens[sl, : t.shape[1]] = t
        tok_g[sl, : tg.shape[1]] = tg
        img_g[sl, : ig.shape[1]] = ig
        is_img[sl, : ii.shape[1]] = ii
        lengths[sl] = ln
        r += t.shape[0]
    return tokens, tok_g, img_g, is_img, lengths, np.full((rows,), -1, np.int32)


def _span_tile(x: np.ndarray, n: int) -> np.ndarray:
    """[G, Qg, ...] per-question arrays → [G * n * Qg, ...] rows blocked
    [g, i, q] (the attention tables cover contiguous row spans)."""
    return np.repeat(x[:, None], n, axis=1).reshape((-1,) + x.shape[2:])


def _stop_hits(out_buf: np.ndarray, n: int, kws) -> np.ndarray:
    """Per-question stop-keyword suffix match over the first n tokens."""
    hit = np.zeros((out_buf.shape[0],), bool)
    for kw in kws:
        m = len(kw)
        if n >= m:
            hit |= np.all(out_buf[:, n - m : n] == np.asarray(kw), axis=1)
    return hit
