"""Port parity: the InstructBLIP modules of llava_align_tpu_torch against the
JAX package's, on the tiny configs with the JAX params carried over
(utils/jax_params), fp32 on the CPU, within 1e-5:

- eva_vit.forward (the q/v-only qkv bias nonzero);
- qformer.forward with no text, with text, and with a padded text mask
  (ids past the vocab clipped), its biases and norms randomized;
- instructblip.encode, with and without a padded instruction;
- the configs' derived widths, and the port's `init` trees against the
  JAX init's (same keys, shapes and dtypes; unit norms, zero biases).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from llava_align_tpu.models import eva_vit as jeva
from llava_align_tpu.models import instructblip as jblip
from llava_align_tpu.models import qformer as jqf
from llava_align_tpu_torch.models import eva_vit as teva
from llava_align_tpu_torch.models import instructblip as tblip
from llava_align_tpu_torch.models import qformer as tqf
from llava_align_tpu_torch.utils.jax_params import from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False

TOL = 1e-5


def _perturb(tree, seed):
    """Every float leaf + N(0, 0.1): nonzero biases (q_bias, v_bias, the
    denses') and norms away from 1, so that none of them is a no-op."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a))).astype(np.float32), tree)


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_eva_vit_forward_matches_jax():
    jcfg, tcfg = jeva.EvaVitConfig.tiny(), teva.EvaVitConfig.tiny()
    jp = _perturb(jax.device_get(jeva.init(jax.random.PRNGKey(0), jcfg)), 1)
    images = np.random.default_rng(2).standard_normal((2, 3, 28, 28)).astype(np.float32)
    want = jeva.forward(jp, jcfg, images)
    got = teva.forward(from_jax_params(jp, device="cpu"), tcfg, torch.from_numpy(images))
    _close(got, want)
    assert got.shape == (2, 1 + tcfg.num_patches, tcfg.width)


@pytest.fixture(scope="module")
def qformer_params():
    jcfg = jqf.QFormerConfig.tiny()
    jp = _perturb(jax.device_get(jqf.init(jax.random.PRNGKey(1), jcfg)), 3)
    return jcfg, tqf.QFormerConfig.tiny(), jp, from_jax_params(jp, device="cpu")


QF_TEXT = {
    "no_text": (None, None),
    "text": (np.array([[5, 6, 7, 8, 9], [11, 3, 200, 4, 2]], np.int32), None),  # 200 > vocab: clipped
    "padded_mask": (np.array([[5, 6, 7, 0, 0], [11, 3, 9, 4, 2]], np.int32),
                    np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.int32)),
}


@pytest.mark.parametrize("case", list(QF_TEXT))
def test_qformer_forward_matches_jax(qformer_params, case):
    jcfg, tcfg, jp, tp = qformer_params
    rng = np.random.default_rng(4)
    queries = rng.standard_normal((2, jcfg.query_length, jcfg.hidden_size)).astype(np.float32)
    image = rng.standard_normal((2, 5, jcfg.encoder_width)).astype(np.float32)
    ids, mask = QF_TEXT[case]
    want = jqf.forward(jp, jcfg, queries, image, text_ids=ids, text_mask=mask)
    got = tqf.forward(tp, tcfg, torch.from_numpy(queries), torch.from_numpy(image),
                      text_ids=None if ids is None else torch.from_numpy(ids),
                      text_mask=None if mask is None else torch.from_numpy(mask))
    _close(got, want)
    assert [("cross_attn" in lp) for lp in tp["layers"]] == [True, False, True]


@pytest.fixture(scope="module")
def blip_params():
    jcfg = jblip.InstructBlipConfig.tiny(vocab_size=128)
    jp = _perturb(jax.device_get(jblip.init(jax.random.PRNGKey(2), jcfg)), 5)
    return jcfg, tblip.InstructBlipConfig.tiny(vocab_size=128), jp, from_jax_params(jp, device="cpu")


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
def test_instructblip_encode_matches_jax(blip_params, padded):
    jcfg, tcfg, jp, tp = blip_params
    rng = np.random.default_rng(6)
    images = rng.standard_normal((2, 3, 28, 28)).astype(np.float32)
    ids = np.array([[101, 7, 8, 9, 102, 0, 0, 0], [101, 5, 6, 7, 8, 9, 10, 102]], np.int32)
    mask = (ids > 0).astype(np.int32) if padded else None
    want = jblip.encode(jp, jcfg, images, ids, mask)
    got = tblip.encode(tp, tcfg, torch.from_numpy(images), torch.from_numpy(ids),
                       None if mask is None else torch.from_numpy(mask))
    _close(got, want)
    assert got.shape == (2, tcfg.num_query_tokens, tcfg.text.hidden_size)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _leaves(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _leaves(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def test_init_trees_match_jax():
    jcfg, tcfg = jblip.InstructBlipConfig.tiny(), tblip.InstructBlipConfig.tiny()
    want = _leaves(jax.device_get(jblip.init(jax.random.PRNGKey(0), jcfg)))
    got = _leaves(tblip.init(tcfg, device="cpu", seed=0))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape and got[k].dtype == torch.float32, k
        if k.endswith(("/scale", "/b", "/bias", "q_bias", "v_bias")):
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)  # ones and zeros
    assert tblip.init(tcfg, device="cpu", seed=0)["query_tokens"].std() < 0.05


def test_configs_match_jax():
    for jc, tc in ((jblip.InstructBlipConfig.vicuna7b(), tblip.InstructBlipConfig.vicuna7b()),
                   (jblip.InstructBlipConfig.tiny(), tblip.InstructBlipConfig.tiny())):
        for part in ("vision", "qformer", "text"):
            j, t = dataclasses.asdict(getattr(jc, part)), dataclasses.asdict(getattr(tc, part))
            j.pop("dtype"), t.pop("dtype")
            assert j == t, part
        assert jc.num_query_tokens == tc.num_query_tokens
    full = tblip.InstructBlipConfig.vicuna7b()
    assert (full.vision.mlp_width, full.vision.num_patches, full.vision.width // full.vision.num_heads) == (6144, 256, 88)
    assert [tqf.has_cross_attention(full.qformer, i) for i in range(4)] == [True, False, True, False]
