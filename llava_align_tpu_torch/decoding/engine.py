"""Debiased decode engine (torch twin of llava_align_tpu/decoding/engine.py:
`generate`, `submit_generate`, `collect_generate`).

All branches of one request live on the batch axis of one forward and one
packed KV cache (row 0 = main):
    main            full visual input
    'unk'           degraded-token branch (llava: sentinel→0)
    'none'          visual positions physically removed (a genuinely shorter
                    row, right-padded, masked by length)
Contrast logits = the primary branch, or the mean of (primary, 'none') when
both use_dd and use_dd_unk are set. Prefill is split-bucket: the image rows
at their 128-bucket, the text-only rows at theirs, into disjoint rows of the
cache. As in the JAX engine, the contrastive correction applies under greedy
decoding too.

The decode loop is an eager Python loop with one host read per step (the
sampled token, which decides `done`); the JAX engine runs it on device in
lax.while_loop. Unlike it, this loop skips the forward after the last token.
Not ported yet: generate_batch*, VCD (use_cd), mesh/act_quant/kv_quant,
explicit per-branch ids and precomputed image features.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from llava_align_tpu_torch.config import GenerationConfig, LlavaConfig
from llava_align_tpu_torch.constants import IMAGE_TOKEN_INDEX
from llava_align_tpu_torch.decoding import sampler as S
from llava_align_tpu_torch.decoding.adapters import LlavaAdapter
from llava_align_tpu_torch.models import llava as llava_model
from llava_align_tpu_torch.ops.image import normalize_device

Params = Dict[str, Any]


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

    Prefill lengths are bucketed to multiples of `bucket`, as in the JAX
    engine (here it fixes the kernels' shapes rather than compiled
    programs). `device` defaults to the device of the params."""

    def __init__(
        self,
        params: Params,
        cfg: LlavaConfig,
        gen: GenerationConfig,
        *,
        adapter=None,
        stop_keyword_ids: Optional[Sequence[Sequence[int]]] = None,
        bucket: int = 128,
        top_scores_k: int = 100,
        device: Optional[torch.device] = None,
    ):
        if gen.use_cd:
            raise NotImplementedError("VCD (use_cd) is not ported yet")
        self.params = params
        self.cfg = cfg
        self.gen = gen
        self.adapter = adapter if adapter is not None else LlavaAdapter(cfg)
        self.kinds = branch_kinds(gen)
        self.stop_keyword_ids = [list(map(int, k)) for k in (stop_keyword_ids or [])]
        self.bucket = bucket
        self.top_scores_k = top_scores_k
        self.device = torch.device(device) if device is not None else params["llama"]["embed"].device

    # ------------------------------------------------------------------
    # host-side packing (identical to the JAX engine's _pack)
    # ------------------------------------------------------------------

    def _pack(self, input_ids: Sequence[int], has_image: bool, kinds: Sequence[str]):
        n_img = self.adapter.num_image_tokens if has_image else 0
        per_branch = []
        for kind in kinds:
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

    def _image_features(self, image: np.ndarray) -> torch.Tensor:
        """[1, N, D] features of the request's [3, H, W] image. uint8 pixels
        go to the device raw and normalize there."""
        img = torch.from_numpy(np.ascontiguousarray(image)[None]).to(self.device)
        return self.adapter.encode_images(
            self.params, normalize_device(img, self.adapter.vision_dtype)
        )

    def _prefill(self, pack, pad: int, feats, cache, row_offset: int):
        """Splice + prefill one row group at its bucket; returns the group's
        last-token logits [rows, V]."""
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
    ):
        """Pack on the host, encode, prefill and run the decode loop. The
        tokens end up on the host (the loop reads each one); the first-step
        score summary stays on the device until collect_generate.

        image: pixels [3, H, W] (uint8 raw, or float already normalized) or
        None. generator: the sampling stream (default: seeded from gen.seed)."""
        t0 = time.perf_counter()
        gen, adapter, dev = self.gen, self.adapter, self.device
        n_sentinels = sum(1 for t in input_ids if t == IMAGE_TOKEN_INDEX)
        has_image = image is not None and n_sentinels > 0
        if has_image and n_sentinels != 1:
            # a second sentinel would gather past the one image's features
            # (torch faults where JAX clamps)
            raise ValueError(f"one image per request, but the prompt holds {n_sentinels} <image>")

        pad_img, *pi = self._pack(input_ids, has_image, self.img_kinds)
        pad_txt, pt = 0, None
        if self.txt_kinds:
            pad_txt, *pt = self._pack(input_ids, has_image, self.txt_kinds)
        nb = len(self.kinds)
        T = gen.max_new_tokens
        cache_len = max(pad_img, pad_txt) + T
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(gen.seed)

        feats = self._image_features(image) if has_image else None
        cache = adapter.init_cache(nb, cache_len, device=dev)
        logits = self._prefill(pi, pad_img, feats, cache, 0)
        lengths_host = pi[4].astype(np.int64)
        if pt is not None:
            logits = torch.cat([logits, self._prefill(pt, pad_txt, None, cache, len(self.img_kinds))])
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
            hidden, cache = adapter.forward(self.params, emb, lengths[:, None], cache, lengths)
            logits = adapter.logits(self.params, hidden[:, 0])
            lengths = lengths + 1
            lengths_host = lengths_host + 1

        probs = torch.softmax(first_scores, dim=-1)
        top = torch.topk(probs, min(self.top_scores_k, probs.shape[-1]))
        return dict(
            tokens=out, top_probs=top.values, top_ids=top.indices,
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
    ) -> GenerationOutput:
        """One request, end to end: submit_generate then collect_generate."""
        return self.collect_generate(self.submit_generate(input_ids, image, generator=generator))
