"""Port parity: llava_align_tpu_torch.models against the JAX package, with the
JAX params carried over by from_jax_params (fp32 LlavaConfig.tiny).

Tolerance 1e-5 (relative and absolute): fp32 on both sides through a few
layers; only reduction orders differ, and for the int8 tree the kernel
path's scale-after-reduction against XLA's dequantize-first (~1e-7 each).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llava_align_tpu.config import LlavaConfig as JCfg
from llava_align_tpu.constants import IMAGE_TOKEN_INDEX
from llava_align_tpu.models import clip_vit as jclip
from llava_align_tpu.models import llama as jllama
from llava_align_tpu.models import llava as jllava
from llava_align_tpu.models import projector as jproj
from llava_align_tpu.ops.quant import quantize_llama_params
from llava_align_tpu_torch.config import LlavaConfig as TCfg
from llava_align_tpu_torch.models import clip_vit as tclip
from llava_align_tpu_torch.models import llama as tllama
from llava_align_tpu_torch.models import llava as tllava
from llava_align_tpu_torch.models import projector as tproj
from llava_align_tpu_torch.utils.jax_params import from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL, ATOL = 1e-5, 1e-5
JCFG, TCFG = JCfg.tiny(vocab_size=97), TCfg.tiny(vocab_size=97)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def params():
    jp = jax.device_get(jllava.init(jax.random.PRNGKey(0), JCFG))
    return jp, from_jax_params(jp, device="cpu")


@pytest.fixture(scope="module")
def images():
    H = JCFG.vision.image_size
    return np.random.default_rng(1).normal(size=(2, 3, H, H)).astype(np.float32)


def test_forward_features(params, images):
    jp, tp = params
    _close(tclip.forward_features(tp["vision"], TCFG.vision, torch.from_numpy(images)),
           jclip.forward_features(jp["vision"], JCFG.vision, jnp.asarray(images)))


@pytest.mark.parametrize("ptype", ["linear", "mlp2x_gelu", "identity"])
def test_projector(ptype):
    D = 64 if ptype != "identity" else 32
    jp = jax.device_get(jproj.init(jax.random.PRNGKey(2), ptype, 32, D, jnp.float32))
    x = np.random.default_rng(3).normal(size=(2, 4, 32)).astype(np.float32)
    _close(tproj.forward(from_jax_params(jp, device="cpu"), torch.from_numpy(x)),
           jproj.forward(jp, jnp.asarray(x)))


def test_encode_images_and_splice(params, images):
    jp, tp = params
    jf = jllava.encode_images(jp, JCFG, jnp.asarray(images[:1]))
    tf = tllava.encode_images(tp, TCFG, torch.from_numpy(images[:1]))
    _close(tf, jf)
    ids = [1, 40, IMAGE_TOKEN_INDEX, 60, 70]
    plans = [jllava.plan_splice(ids, JCFG.num_image_tokens, 16),
             jllava.plan_splice([1, 40, 60, 70], 0, 16)]
    stack = {k: np.stack([getattr(p, k) for p in plans]) for k in ("tok_gather", "img_gather", "is_image")}
    tokens = np.zeros((2, 16), np.int32)
    for b, p in enumerate(plans):
        tokens[b, : len(p.tokens)] = p.tokens
    feats = np.concatenate([np.asarray(jf), np.zeros_like(np.asarray(jf))])
    want = jllava.splice_embeds(jp, JCFG, jnp.asarray(tokens), jnp.asarray(stack["tok_gather"]),
                                jnp.asarray(stack["img_gather"]), jnp.asarray(stack["is_image"]),
                                jnp.asarray(feats))
    got = tllava.splice_embeds(tp, TCFG, *(torch.from_numpy(a) for a in (
        tokens, stack["tok_gather"], stack["img_gather"], stack["is_image"], feats)))
    _close(got, want)
    # the sentinel id is clipped into the vocab, not wrapped
    _close(tllama.embed_tokens(tp["llama"], torch.tensor([[IMAGE_TOKEN_INDEX, 96, 500]])),
           jllama.embed_tokens(jp["llama"], jnp.asarray([[IMAGE_TOKEN_INDEX, 96, 500]])))


@pytest.mark.parametrize("quant", ["fp32", "int8_fused", "int8_unfused"])
def test_llama_prefill_then_decode(params, quant):
    """Prefill an image-row group (72 rows > 64: the dequant path) at cache
    row 0 and a text-row group at cache_row_offset=1, then three decode steps
    over all rows at unequal per-row offsets; logits and cache must match."""
    jl = params[0]["llama"]
    if quant != "fp32":
        jl = jax.device_get(quantize_llama_params(jl, fuse=quant == "int8_fused"))
    tl = from_jax_params(jl, device="cpu")
    c = JCFG.text
    rng = np.random.default_rng(4)
    Smax, SA, SB = 80, 72, 8
    jcache = jllama.init_cache(c, 3, Smax)
    tcache = tllama.init_cache(TCFG.text, 3, Smax)

    def both(embeds, positions, offsets, row_offset, last):
        nonlocal jcache
        jh, jcache = jllama.forward(jl, c, jnp.asarray(embeds), jnp.asarray(positions), jcache,
                                    jnp.asarray(offsets), attn_impl="xla",
                                    cache_row_offset=row_offset)
        th, _ = tllama.forward(tl, TCFG.text, torch.from_numpy(embeds), torch.from_numpy(positions),
                               tcache, torch.from_numpy(offsets), cache_row_offset=row_offset)
        _close(tllama.last_token_logits(tl, th, torch.from_numpy(last)),
               jllama.last_token_logits(jl, jh, jnp.asarray(last)))

    def emb(*shape):
        return rng.normal(size=shape + (c.hidden_size,)).astype(np.float32)

    both(emb(1, SA), np.arange(SA, dtype=np.int32)[None], np.zeros(1, np.int32), 0,
         np.array([60], np.int32))
    both(emb(2, SB), np.tile(np.arange(SB, dtype=np.int32), (2, 1)), np.zeros(2, np.int32), 1,
         np.array([7, 4], np.int32))
    lengths = np.array([61, 8, 5], np.int32)
    for _ in range(3):
        both(emb(3, 1), lengths[:, None], lengths, 0, np.zeros(3, np.int32))
        lengths = lengths + 1
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_synthetic_tree_matches_jax_layout(quant):
    """build_random_llava_params gives the JAX tree's keys, shapes and dtypes
    (llava.init, + quantize_llama_params(fuse=True) for int8, bits=4 for
    int4)."""
    from llava_align_tpu_torch.utils.synthetic import build_random_llava_params

    jp = jax.eval_shape(lambda k: jllava.init(k, JCFG), jax.random.PRNGKey(0))
    if quant != "none":
        bits = 4 if quant == "int4" else 8
        jp = dict(jp, llama=jax.eval_shape(
            lambda p: quantize_llama_params(p, fuse=True, bits=bits), jp["llama"]))
    tp = build_random_llava_params(TCFG, quant=quant, device="cpu", seed=0)
    want = {jax.tree_util.keystr(p): (tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for p, x in jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert got == want


def test_random_params_default_to_the_gpu(monkeypatch):
    """build_random_llava_params and load_model build on the card unless the
    caller asks for the CPU; with no CUDA they raise instead of falling back."""
    from llava_align_tpu_torch.runners.common import load_model
    from llava_align_tpu_torch.utils.synthetic import build_random_llava_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_random_llava_params(TCFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model("random:tiny", quant="int4")
    assert load_model("random:tiny", quant="int4", device="cpu").params["llama"]["embed"].device.type == "cpu"


def _layout(tree):
    return {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_load_model_keeps_tiny_in_float_as_jax(quant):
    """load_model("random:tiny", quant=...) returns the float tree, with the
    JAX load_model's keys, shapes and dtypes (no q/q4 leaves); the caller
    quantizes it with quantize_llama_params, as the JAX POPE runner does,
    and gets the JAX quantized layout, which the engine takes."""
    from llava_align_tpu.runners.common import load_model as jload_model
    from llava_align_tpu_torch.ops.quant import quantize_llama_params as tquantize
    from llava_align_tpu_torch.runners.common import load_model

    bits = 4 if quant == "int4" else 8
    jp = jload_model("random:tiny", quant=quant).params
    tp = load_model("random:tiny", quant=quant, device="cpu").params
    assert _layout(tp) == {k: (shape, np.dtype(dt).name) for k, (shape, dt) in _layout(jp).items()}
    # float: no int8 leaf (no 'q' or 'q4' dict), no scales
    assert not any(dt == "int8" or k.endswith(("['s']", "['gs']")) for k, (_, dt) in _layout(tp).items())
    jq = jax.eval_shape(lambda p: quantize_llama_params(p, bits=bits), jp["llama"])
    tq = tquantize(tp["llama"], bits=bits)
    assert _layout(tq) == {k: (shape, np.dtype(dt).name) for k, (shape, dt) in _layout(jq).items()}
