"""Port parity for models/t5 (Flan-T5): llava_align_tpu_torch against the
JAX package on T5Config.tiny (gated-GELU; and the ReLU / tied-head
variant), the JAX params carried over (utils/jax_params), fp32 on the CPU.

- the relative-position bucket tables, integer-exact, for every relative
  position in [-512, 512], bidirectional and causal, at the flan-t5-xl
  bucket settings and the tiny ones;
- encode (a padded mask), decode (teacher-forced logits) within 1e-5;
- decode_step, step by step over the incremental cache, against the JAX
  decode_step and against the port's own full decode;
- generate_greedy's tokens exactly (eos inside the run for some rows).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llava_align_tpu.models import t5 as jt5
from llava_align_tpu_torch.models import t5 as tt5
from llava_align_tpu_torch.utils import synthetic
from llava_align_tpu_torch.utils.jax_params import from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False

TOL = 1e-5
VARIANTS = {"gated": {}, "relu_tied": {"gated_act": False, "tie_word_embeddings": True}}


def perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a)), jnp.float32), tree)


def close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bidirectional", "causal"])
@pytest.mark.parametrize("buckets,max_distance", [(32, 128), (8, 20)])
def test_bucket_tables_integer_exact_vs_jax(bidirectional, buckets, max_distance):
    rel = np.arange(-512, 513, dtype=np.int32)
    want = np.asarray(jax.jit(lambda r: jt5.relative_position_bucket(r, bidirectional, buckets, max_distance))(rel))
    got = tt5.relative_position_bucket(rel, bidirectional, buckets, max_distance)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    eager = np.asarray(jt5.relative_position_bucket(jnp.asarray(rel), bidirectional, buckets, max_distance))
    np.testing.assert_array_equal(got, eager)


@pytest.fixture(scope="module", params=list(VARIANTS))
def trees(request):
    changes = VARIANTS[request.param]
    jcfg = dataclasses.replace(jt5.T5Config.tiny(vocab_size=61), **changes)
    tcfg = dataclasses.replace(tt5.T5Config.tiny(vocab_size=61), **changes)
    jp = perturb(jax.device_get(jt5.init(jax.random.PRNGKey(0), jcfg)), 1)
    return jcfg, tcfg, jp, from_jax_params(jp, device="cpu")


def _encoder_input(cfg, B=3, S=9):
    rng = np.random.default_rng(2)
    embeds = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    mask = (np.arange(S)[None, :] < np.array([[S], [5], [7]])).astype(np.int32)
    return embeds, mask


def test_encode_and_decode_vs_jax(trees):
    jcfg, tcfg, jp, tp = trees
    embeds, mask = _encoder_input(jcfg)
    want_enc = jt5.encode(jp, jcfg, jnp.asarray(embeds), jnp.asarray(mask))
    got_enc = tt5.encode(tp, tcfg, torch.from_numpy(embeds), torch.from_numpy(mask))
    close(got_enc, want_enc)
    ids = np.random.default_rng(3).integers(0, 70, (3, 6)).astype(np.int32)  # past the vocab: clipped
    want = jt5.decode(jp, jcfg, jnp.asarray(ids), want_enc, jnp.asarray(mask))
    close(tt5.decode(tp, tcfg, torch.from_numpy(ids), got_enc, torch.from_numpy(mask)), want)


def test_decode_step_vs_jax_and_full_decode(trees):
    jcfg, tcfg, jp, tp = trees
    embeds, mask = _encoder_input(jcfg)
    enc = np.array(jt5.encode(jp, jcfg, jnp.asarray(embeds), jnp.asarray(mask)))
    ids = np.random.default_rng(4).integers(0, 61, (3, 5)).astype(np.int32)
    T = ids.shape[1]
    jcache, tcache = jt5.init_self_cache(jcfg, 3, T), tt5.init_self_cache(tcfg, 3, T, device="cpu")
    jx = jt5.precompute_cross_kv(jp, jcfg, jnp.asarray(enc))
    tx = tt5.precompute_cross_kv(tp, tcfg, torch.from_numpy(enc))
    close(tx["k"], jx["k"])
    full = tt5.decode(tp, tcfg, torch.from_numpy(ids), torch.from_numpy(enc), torch.from_numpy(mask))
    jstep = jax.jit(lambda p, tok, t, c, x, m: jt5.decode_step(p, jcfg, tok, t, c, x, m))
    for t in range(T):
        want, jcache = jstep(jp, jnp.asarray(ids[:, t]), jnp.asarray(t, jnp.int32), jcache, jx, jnp.asarray(mask))
        got, tcache = tt5.decode_step(tp, tcfg, torch.from_numpy(ids[:, t]), t, tcache, tx, torch.from_numpy(mask))
        close(got, want)
        np.testing.assert_allclose(got.numpy(), full[:, t].numpy(), rtol=TOL, atol=TOL)


def test_generate_greedy_tokens_vs_jax(trees):
    jcfg, tcfg, jp, tp = trees
    embeds, mask = _encoder_input(jcfg)
    enc = np.array(jt5.encode(jp, jcfg, jnp.asarray(embeds), jnp.asarray(mask)))
    # eos = the greedy first token of row 1, so that row stops at once
    first = np.asarray(jt5.decode(jp, jcfg, jnp.zeros((3, 1), jnp.int32), jnp.asarray(enc),
                                  jnp.asarray(mask)))[:, 0].argmax(-1)
    for eos in (int(first[1]), 10**6):
        kw = dict(max_new_tokens=7, decoder_start_token_id=0, eos_token_id=eos)
        want = jt5.generate_greedy(jp, jcfg, jnp.asarray(enc), jnp.asarray(mask), **kw)
        got = tt5.generate_greedy(tp, tcfg, torch.from_numpy(enc), torch.from_numpy(mask), **kw)
        assert got == want
        if eos == first[1]:
            assert got[1] == []
        else:
            assert [len(r) for r in got] == [7, 7, 7]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_random_tree_and_config_match_jax(variant):
    changes = VARIANTS[variant]
    jcfg = dataclasses.replace(jt5.T5Config.tiny(), **changes)
    tcfg = dataclasses.replace(tt5.T5Config.tiny(), **changes)
    want = jax.device_get(jt5.init(jax.random.PRNGKey(0), jcfg))
    got = synthetic.build_random_t5_params(tcfg, device="cpu")
    assert (got["lm_head"] is None) == (want["lm_head"] is None)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat_w) == len([x for x in jax.tree_util.tree_leaves(got)])
    for path, w in flat_w:
        node = got
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        assert tuple(node.shape) == w.shape and node.dtype == torch.float32, path
    for jc, tc in ((jt5.T5Config.flan_t5_xl(), tt5.T5Config.flan_t5_xl()), (jcfg, tcfg)):
        j, t = dataclasses.asdict(jc), dataclasses.asdict(tc)
        j.pop("dtype"), t.pop("dtype")
        assert j == t
