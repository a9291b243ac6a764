"""The port's image preprocessing against the JAX package's, on images the
test builds: expand2square, clip_preprocess_pil and clip_resize_pil_uint8
(both aspect modes, the 'pad' path included), clip_normalize,
load_image_tensor (a real file in both transfers and the PIL-free synthetic
branch), and the anyres copy. uint8 outputs exact, float outputs within
1e-6 (in practice they are bitwise equal: the same numpy and PIL calls).

clip_preprocess_torch, the twin of the jitted clip_preprocess_jax, is held
two ways: its resize weights equal jax.image's compute_weight_mat evaluated
op by op within one fp32 ulp at 1.0, and its outputs clip_preprocess_jax's
within 1e-4. The second bound is looser because XLA's fused CPU program
computes those weights up to 5.6e-6 away from the op-by-op formulas (640 ->
336); with up to 8 x 8 taps per output when shrinking by two and 1/std ~ 3.8
after normalization, that moves an output by up to ~1e-3, and it moved them
by at most 4.3e-5 on these images.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from llava_align_tpu.ops import anyres as janyres
from llava_align_tpu.ops import image as jimage
from llava_align_tpu.runners import common as jcommon
from llava_align_tpu_torch.ops import anyres as tanyres
from llava_align_tpu_torch.ops import image as timage
from llava_align_tpu_torch.runners import common as tcommon

SIZES = [(50, 80), (80, 50), (33, 33), (17, 301)]  # (width, height)


def _pil(w, h, seed=0, mode="RGB"):
    rng = np.random.default_rng(seed + w * 1000 + h)
    arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    img = Image.fromarray(arr)
    return img.convert(mode) if mode != "RGB" else img


@pytest.mark.parametrize("w,h", SIZES)
def test_expand2square_identical(w, h):
    for mode in ("RGB", "L"):
        img = _pil(w, h, mode=mode)
        bg = (122, 116, 104) if mode == "RGB" else 7
        got, want = timage.expand2square(img, bg), jimage.expand2square(img, bg)
        assert got.size == want.size and got.mode == want.mode
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("aspect", [None, "pad"])
@pytest.mark.parametrize("w,h", SIZES)
def test_clip_preprocess_pil_identical(w, h, aspect):
    img = _pil(w, h, mode="RGBA")  # converted to RGB inside
    got = timage.clip_preprocess_pil(img, 28, aspect)
    want = jimage.clip_preprocess_pil(img, 28, aspect)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (3, 28, 28)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    got8 = timage.clip_resize_pil_uint8(img, 28, aspect)
    want8 = jimage.clip_resize_pil_uint8(img, 28, aspect)
    assert got8.dtype == want8.dtype == np.uint8
    np.testing.assert_array_equal(got8, want8)


def test_clip_normalize_identical():
    rng = np.random.default_rng(2)
    for shape in ((28, 28, 3), (3, 28, 28)):
        x = rng.random(shape).astype(np.float32)
        got = timage.clip_normalize(torch.from_numpy(x)).numpy()
        want = np.asarray(jimage.clip_normalize(jnp.asarray(x)))
        assert got.shape == want.shape == (3, 28, 28)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("transfer", ["uint8", "float32"])
@pytest.mark.parametrize("aspect", [None, "pad"])
def test_load_image_tensor_identical(tmp_path, transfer, aspect):
    """A real file (PNG written here) and a missing one under synthetic_ok:
    the port's synthetic branch builds the JAX runner's noise image without
    PIL; a missing file without it raises in both."""
    _pil(60, 40).save(tmp_path / "a.png")
    for name in ("a.png", "COCO_val2014_000000000042.jpg"):
        got = tcommon.load_image_tensor(str(tmp_path), name, image_size=28, image_aspect_ratio=aspect,
                                        synthetic_ok=True, transfer=transfer)
        want = jcommon.load_image_tensor(str(tmp_path), name, image_size=28, image_aspect_ratio=aspect,
                                         synthetic_ok=True, transfer=transfer)
        assert got.dtype == want.dtype and got.shape == want.shape == (3, 28, 28)
        if transfer == "uint8":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for m in (tcommon, jcommon):
        with pytest.raises(FileNotFoundError):
            m.load_image_tensor(str(tmp_path), "missing.jpg", image_size=28)


def test_synthetic_image_needs_no_pil():
    import subprocess
    import sys

    code = ("import sys; sys.modules['PIL'] = None\n"
            "from llava_align_tpu_torch.runners.common import load_image_tensor\n"
            "x = load_image_tensor('', 'img_0.jpg', image_size=336, synthetic_ok=True)\n"
            "assert x.shape == (3, 336, 336) and x.dtype.name == 'uint8'; print('OK')")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                          cwd=str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    assert proc.returncode == 0 and proc.stdout.strip() == "OK", proc.stderr[-2000:]
    got = timage.synthetic_image_uint8("img_0.jpg", 336)
    want = jcommon.load_image_tensor("", "img_0.jpg", image_size=336, synthetic_ok=True)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("w,h", [(50, 80), (90, 40), (56, 56)])
def test_anyres_identical(w, h):
    img = _pil(w, h, seed=3)
    pinpoints = [(28, 56), (56, 28), (56, 56)]
    for fn in ("select_best_resolution",):
        assert getattr(tanyres, fn)(img.size, pinpoints) == getattr(janyres, fn)(img.size, pinpoints)
    assert tanyres.get_anyres_image_grid_shape(img.size, str(pinpoints), 28) == \
        janyres.get_anyres_image_grid_shape(img.size, str(pinpoints), 28)
    best = janyres.select_best_resolution(img.size, pinpoints)
    got_pad, want_pad = tanyres.resize_and_pad_image(img, best), janyres.resize_and_pad_image(img, best)
    np.testing.assert_array_equal(np.asarray(got_pad), np.asarray(want_pad))
    assert [np.asarray(p).tolist() for p in tanyres.divide_to_patches(want_pad, 28)] == \
        [np.asarray(p).tolist() for p in janyres.divide_to_patches(want_pad, 28)]
    got = tanyres.process_anyres_image(img, pinpoints, 28, 28)
    want = janyres.process_anyres_image(img, pinpoints, 28, 28)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("in_size,out_size", [(640, 336), (480, 252), (13, 28), (336, 336), (7, 3)])
def test_resize_weights_match_jax(in_size, out_size):
    from jax._src.image.scale import _fill_keys_cubic_kernel, compute_weight_mat

    want = np.asarray(compute_weight_mat(in_size, out_size, out_size / in_size, 0.0,
                                         _fill_keys_cubic_kernel, True))
    got = timage._resize_weights(in_size, out_size, "cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-23)


@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("h,w,size", [(50, 80, 28), (20, 13, 28), (28, 28, 28), (480, 640, 336)])
def test_clip_preprocess_torch_matches_jax(h, w, size, pad):
    img = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    want = np.asarray(jimage.clip_preprocess_jax(jnp.asarray(img), image_size=size, pad_to_square=pad))
    got = timage.clip_preprocess_torch(torch.from_numpy(img), size, pad)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (3, size, size)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
