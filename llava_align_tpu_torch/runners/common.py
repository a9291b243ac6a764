"""Runner plumbing for the port: copies of llava_align_tpu/runners/common.py
(dataset chunking, question loading, the resumable jsonl AnswerFile and its
per-rank merge, build_prompt, postprocess_answer, load_image_tensor,
make_generation_config, MockTokenizer and load_model: random:* models and
HF-format checkpoint dirs; the train CLI's mock_tokenize and
resolve_tokenizer, verbatim), and pope_groups, POPE-style traffic split as
the grouped entry points take it.

and --dist auto (apply_dist_auto / finish_dist_auto over torch.distributed,
parallel/dist, where the JAX package takes jax.distributed).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from llava_align_tpu_torch.config import GenerationConfig, LlavaConfig
from llava_align_tpu_torch.constants import (
    DEFAULT_IM_END_TOKEN,
    DEFAULT_IM_START_TOKEN,
    DEFAULT_IMAGE_TOKEN,
)
from llava_align_tpu_torch.conversation import conv_templates


def split_list(lst: Sequence, n: int) -> List[Sequence]:
    """Split into n (roughly) equal chunks (reference MME/run_llava.py:32-38)."""
    chunk_size = math.ceil(len(lst) / n)
    return [lst[i : i + chunk_size] for i in range(0, len(lst), chunk_size)]


def get_chunk(
    lst: Sequence, n: int, k: int, *, allow_out_of_range: bool = False
) -> Sequence:
    """Chunk k of split_list(lst, n). Ceil chunking can yield fewer than n
    chunks; an index past them is an empty shard when allow_out_of_range
    (a rank of a distributed run), an IndexError otherwise (a user-typed
    --chunk-idx, as in the reference MME/run_llava.py:41)."""
    chunks = split_list(lst, n)
    if k < len(chunks):
        return chunks[k]
    if allow_out_of_range:
        return lst[:0]
    raise IndexError(
        f"chunk_idx {k} out of range: {len(lst)} items split into "
        f"{len(chunks)} chunks (num_chunks={n})"
    )


def load_questions(
    path: str, num_chunks: int = 1, chunk_idx: int = 0,
    *, allow_out_of_range: bool = False,
) -> List[dict]:
    """jsonl questions (trailing commas on a line tolerated, as some
    reference splits carry them), chunk chunk_idx of num_chunks."""
    with open(os.path.expanduser(path)) as f:
        questions = [
            json.loads(line.strip().rstrip(","))
            for line in f
            if line.strip().rstrip(",")
        ]
    if num_chunks > 1:
        questions = list(
            get_chunk(questions, num_chunks, chunk_idx,
                      allow_out_of_range=allow_out_of_range)
        )
    return questions


def load_questions_for(args) -> List[dict]:
    """load_questions wired to the runner arg namespace: chunk indices set
    by a distributed run may exceed the ceil-chunk count (empty shard),
    while user-typed --num-chunks/--chunk-idx out of range raises."""
    return load_questions(
        args.question_file, args.num_chunks, args.chunk_idx,
        allow_out_of_range=getattr(args, "dist_merge_target", None) is not None,
    )


def apply_dist_auto(args) -> bool:
    """--dist auto: initialize torch.distributed from the launcher's
    environment (RANK, WORLD_SIZE, MASTER_ADDR / MASTER_PORT: torchrun, or
    ranks spawned with it set; parallel/dist picks the backend), shard the
    question file by rank, and write a per-rank answers part
    `<answers>.rank{r}-of-{n}<ext>`. Each rank holds one whole model
    (data parallelism over processes), so every model family takes it.
    Returns True when multi-process."""
    if getattr(args, "dist", "none") != "auto":
        return False
    from llava_align_tpu_torch.parallel.dist import get_rank, get_world_size, init_distributed_mode

    if not init_distributed_mode(device=getattr(args, "device", None)):
        return False
    n, r = get_world_size(), get_rank()
    args.num_chunks, args.chunk_idx = n, r
    args.dist_merge_target = args.answers_file  # finish_dist_auto merges here
    root, ext = os.path.splitext(args.answers_file)
    args.answers_file = f"{root}.rank{r}-of-{n}{ext}"
    return True


def finish_dist_auto(args) -> str:
    """Counterpart of apply_dist_auto, called after the answer loop: a
    barrier (every rank's part is complete once its loop returns), then
    rank 0 concatenates the parts into the requested answers file. Returns
    the merged path on rank 0, the rank's part elsewhere, and
    args.answers_file unchanged without --dist auto."""
    target = getattr(args, "dist_merge_target", None)
    if target is None:
        return args.answers_file
    from llava_align_tpu_torch.parallel.dist import barrier, get_rank, get_world_size

    barrier()
    if get_rank() != 0:
        return args.answers_file
    return merge_chunk_files(target, get_world_size())


def is_dist_worker(args) -> bool:
    """True on a rank other than 0 of a --dist auto run: it holds a part
    file only, and leaves converting and scoring to rank 0."""
    if getattr(args, "dist_merge_target", None) is None:
        return False
    from llava_align_tpu_torch.parallel.dist import get_rank

    return get_rank() != 0


def merge_chunk_files(answers_file: str, world_size: int) -> str:
    """Concatenate per-rank `.rank{r}-of-{n}` parts back into
    `answers_file`. Chunks are contiguous slices (split_list), so rank-order
    concatenation restores question order. A missing part (a failed rank)
    raises rather than hand scoring a truncated file."""
    root, ext = os.path.splitext(os.path.expanduser(answers_file))
    parts = [f"{root}.rank{r}-of-{world_size}{ext}" for r in range(world_size)]
    missing = [p for p in parts if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            f"answer part(s) missing at merge — did those ranks fail? {missing}"
        )
    with open(os.path.expanduser(answers_file), "w") as out:
        for part in parts:
            with open(part) as f:
                out.write(f.read())
    return answers_file


class AnswerFile:
    """Append-only jsonl answers with skip-done resume."""

    def __init__(self, path: str, resume: bool = False):
        self.path = os.path.expanduser(path)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self.done_ids = set()
        self.done_keys = set()
        if resume and os.path.exists(self.path):
            with open(self.path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                        self.done_ids.add(rec["question_id"])
                        self.done_keys.add((rec["question_id"], rec.get("prompt")))
                    except (ValueError, KeyError, TypeError):  # a torn or foreign line
                        pass
            self._f = open(self.path, "a")
        else:
            self._f = open(self.path, "w")

    def is_done(self, question_id, prompt=None) -> bool:
        """Resume check. Pass the question text too when ids are not unique
        (MME reuses the image name as question_id for both of its questions
        per image)."""
        if prompt is None:
            return question_id in self.done_ids
        return (question_id, prompt) in self.done_keys

    def write(self, record: dict) -> None:
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def build_prompt(
    question: str,
    conv_mode: str,
    *,
    with_image: bool = True,
    mm_use_im_start_end: bool = False,
    one_word: bool = False,
    suffix: str = "",
) -> Tuple[str, str]:
    """Returns (prompt, stop_str). Mirrors llava_calibrate.py:136-144 /
    llava_naive.py:43-53."""
    qs = question
    if with_image:
        if mm_use_im_start_end:
            qs = (
                DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN + DEFAULT_IM_END_TOKEN
                + "\n" + qs
            )
        else:
            qs = DEFAULT_IMAGE_TOKEN + "\n" + qs
    if one_word:
        qs = qs + " Please answer this question with one word."
    if suffix:
        qs = qs + suffix
    conv = conv_templates[conv_mode].copy()
    conv.append_message(conv.roles[0], qs)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt(), conv.stop_str


def postprocess_answer(text: str, stop_str: str) -> str:
    """Trim at the stop keyword (reference llava_calibrate.py:202-207 plus
    first-occurrence truncation for strings the token matcher couldn't see)."""
    text = text.strip()
    if stop_str:
        pos = text.find(stop_str)
        if pos >= 0:
            text = text[:pos]
    return text.strip()


def load_image_tensor(
    image_folder: str,
    image_file: str,
    *,
    image_size: int = 336,
    image_aspect_ratio: Optional[str] = None,
    synthetic_ok: bool = False,
    grid_pinpoints=None,
    transfer: str = "uint8",
) -> np.ndarray:
    """CLIP-preprocessed [3, H, W]. transfer='uint8' (default) returns raw
    resized pixels, which the DecodeEngine normalizes on the device;
    transfer='float32' returns host-normalized floats. anyres grids return
    float32 stacks. With synthetic_ok, a deterministic noise image replaces
    a missing file; that branch needs no PIL (ops.image.synthetic_image_uint8)."""
    from llava_align_tpu_torch.ops.image import (
        clip_preprocess_pil,
        clip_resize_pil_uint8,
        normalize_host,
        synthetic_image_uint8,
    )

    path = os.path.join(image_folder, image_file) if image_folder else image_file
    if os.path.exists(path):
        from PIL import Image

        img = Image.open(path)
        if image_aspect_ratio == "anyres":
            from llava_align_tpu_torch.ops.anyres import process_anyres_image

            pinpoints = grid_pinpoints or [
                (image_size, image_size * 2), (image_size * 2, image_size),
                (image_size * 2, image_size * 2),
            ]
            return process_anyres_image(img, pinpoints, image_size, image_size)
        if transfer == "uint8":
            return clip_resize_pil_uint8(img, image_size, image_aspect_ratio)
        return clip_preprocess_pil(img, image_size, image_aspect_ratio)
    if not synthetic_ok:
        raise FileNotFoundError(path)
    u8 = synthetic_image_uint8(image_file, image_size)
    return u8 if transfer == "uint8" else normalize_host(u8)


def make_generation_config(args, **overrides) -> GenerationConfig:
    """argparse namespace (reference knob names) → GenerationConfig."""
    temp = getattr(args, "temperature", 1.0)
    kw = dict(
        max_new_tokens=getattr(args, "max_new_tokens", 64),
        do_sample=temp > 0,
        temperature=temp if temp > 0 else 1.0,
        top_p=getattr(args, "top_p", None),
        top_k=getattr(args, "top_k", None),
        seed=getattr(args, "seed", 42),
        use_cd=getattr(args, "use_cd", False),
        use_dd=getattr(args, "use_dd", False),
        use_dd_unk=getattr(args, "use_dd_unk", False),
        cd_alpha=getattr(args, "cd_alpha", 1.0),
        cd_beta=getattr(args, "cd_beta", 0.1),
        noise_step=getattr(args, "noise_step", 500),
    )
    kw.update(overrides)
    return GenerationConfig(**kw)


POPE_OBJECTS = ("dog", "person", "dining table", "car", "bicycle", "chair")


def pope_groups(tokenizer, image_size: int, n_groups: int, seed: int = 0):
    """n_groups image groups of POPE's 6 questions, split as the POPE runner
    splits them: (common token prefix, suffixes, seeded uint8 image)."""
    from llava_align_tpu_torch.decoding.engine import DecodeEngine
    from llava_align_tpu_torch.tokenization import tokenizer_image_token

    rng = np.random.default_rng(seed)
    ids = [tokenizer_image_token(build_prompt(f"Is there a {o} in the image?", "llava_v1")[0], tokenizer)
           for o in POPE_OBJECTS]
    p = DecodeEngine.common_token_prefix(ids)
    return [(ids[0][:p], [x[p:] for x in ids],
             rng.integers(0, 256, (3, image_size, image_size), dtype=np.uint8))
            for _ in range(n_groups)]


class MockTokenizer:
    """Deterministic offline tokenizer for smoke runs (no checkpoint files).
    One id per character, BOS=1, EOS=2; decode maps back to characters."""

    bos_token_id = 1
    eos_token_id = 2
    unk_token_id = 0
    pad_token_id = 0

    def __call__(self, text):
        class R:
            pass

        r = R()
        r.input_ids = [self.bos_token_id] + [min(ord(c), 255) + 3 for c in text]
        return r

    def decode(self, ids, skip_special_tokens=True):
        if isinstance(ids, (int, np.integer)):
            ids = [ids]
        out = []
        for t in ids:
            t = int(t)
            if t >= 3:
                out.append(chr(t - 3))
            elif not skip_special_tokens:
                out.append({0: "<unk>", 1: "<s>", 2: "</s>"}[t])
        return "".join(out)


@dataclasses.dataclass
class LoadedModel:
    tokenizer: Any
    params: Dict[str, Any]
    cfg: LlavaConfig
    model_name: str


def load_model(model_path: str, quant: str = "none", device=None, seed: int = 0) -> LoadedModel:
    """'random:tiny' | 'random:7b' | 'random:13b': a random-weight model at
    that config's shapes with the mock tokenizer; anything else: an
    HF-format llava-v1.5 checkpoint dir (utils.hf_convert, in bf16) with
    its tokenizer (transformers' AutoTokenizer, slow then fast, as in the
    JAX package). Built on `device` (default: the GPU; raises without one
    unless device="cpu" is asked for).
    quant='int8' or 'int4' quantizes the decoder (ops.quant
    .quantize_llama_params, fused); for 7b and 13b the quantized, fused
    tree is built directly (quantizing beside a live bf16 tree would double
    the peak). random:tiny stays in float whatever `quant` says, as in the
    JAX package, and its caller quantizes it."""
    if model_path.startswith("random:"):
        size = model_path.split(":", 1)[1]
        if size == "tiny":
            cfg = LlavaConfig.tiny(vocab_size=512)
        elif size == "7b":
            cfg = LlavaConfig.llava_v15_7b()
        elif size == "13b":
            cfg = LlavaConfig.llava_v15_13b()
        else:
            raise ValueError(size)
        from llava_align_tpu_torch.utils.synthetic import build_random_llava_params

        params = build_random_llava_params(cfg, quant="none" if size == "tiny" else quant,
                                           device=device, seed=seed)
        return LoadedModel(MockTokenizer(), params, cfg, f"random-{size}")

    import torch

    from llava_align_tpu_torch.tokenization import get_model_name_from_path
    from llava_align_tpu_torch.utils.hf_convert import load_llava_checkpoint

    path = os.path.expanduser(model_path)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint dir at {path}")
    tokenizer = _load_tokenizer(path)
    params, cfg = load_llava_checkpoint(path, torch.bfloat16, device=device)
    if quant in ("int8", "int4"):
        from llava_align_tpu_torch.ops.quant import quantize_llama_params

        params = dict(params, llama=quantize_llama_params(params["llama"], bits=4 if quant == "int4" else 8))
    elif quant != "none":
        raise NotImplementedError(f"quant={quant!r}: only none/int8/int4 are ported")
    return LoadedModel(tokenizer, params, cfg, get_model_name_from_path(model_path))


def _load_tokenizer(path: str):
    """The checkpoint's tokenizer: AutoTokenizer, slow (sentencepiece) when
    it loads, fast otherwise, as the JAX package's load_model does."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(
            "loading a checkpoint's tokenizer needs the transformers package, which is not "
            "installed; random:* models use the mock tokenizer") from e
    try:
        return AutoTokenizer.from_pretrained(path, use_fast=False)
    except (OSError, ValueError, ImportError):  # no slow tokenizer files, class or sentencepiece
        return AutoTokenizer.from_pretrained(path, use_fast=True)


def mock_tokenize(texts, vocab: int = 64, length: int = 16):
    """Deterministic offline-smoke tokenizer shared by the config-driven
    train/evaluate CLIs: stable crc32 word hashing (process-independent,
    unlike str hash) → ([N, length] ids, mask). Real checkpoints need a real
    tokenizer — pass run.tokenizer_path in the CLI configs."""
    import zlib

    import numpy as np

    vocab = min(int(vocab), 30000)
    ids = np.zeros((len(texts), length), np.int64)
    for i, t in enumerate(texts):
        for j, w in enumerate(str(t).split()[:length]):
            ids[i, j] = zlib.crc32(w.encode()) % (vocab - 2) + 1
    return ids, (ids != 0).astype(np.int64)


def resolve_tokenizer(run_cfg, vocab: int):
    """run.tokenizer_path → BertTokenizerFast over a local vocab file;
    otherwise the crc32 mock (offline smoke). Returns texts → (ids, mask)."""
    import numpy as np

    path = run_cfg.get("tokenizer_path")
    if path:
        from transformers import BertTokenizerFast

        tok = BertTokenizerFast(vocab_file=path)

        def real(texts, length: int = 32):
            out = tok(
                list(map(str, texts)), padding="max_length", truncation=True,
                max_length=length, return_tensors="np",
            )
            return out["input_ids"].astype(np.int64), out["attention_mask"].astype(np.int64)

        return real
    import logging

    logging.getLogger(__name__).info(
        "no run.tokenizer_path — using the offline crc32 mock tokenizer "
        "(metrics are smoke-only for real checkpoints)"
    )
    return lambda texts, length=16: mock_tokenize(texts, vocab=vocab, length=length)
