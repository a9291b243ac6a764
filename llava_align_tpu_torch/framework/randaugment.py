"""RandAugment for the BLIP training pipeline, pure numpy (a copy of
llava_align_tpu/framework/randaugment.py, the source unchanged;
tests/test_torch_copies.py holds it to it).

Capability parity: reference lavis/processors/randaugment.py (the 14-op
table, the level→argument mappings, and the N-of-M policy blip_image_train
uses). The reference builds on cv2 (LUT + warpAffine); this copy is numpy
only, with an affine-warp sampler in float that follows cv2.warpAffine's
INTER_LINEAR + constant border (cv2 rounds bilinear weights to 1/32, so a
warped pixel may differ by 1-2 LSB). The magnitude constants are the op
table's. The op/argument draws consume numpy's global RNG in the
reference's order, or a private `rng=`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

MAX_LEVEL = 10
TRANSLATE_CONST = 10
REPLACE_VALUE = (128, 128, 128)


# ---------------------------------------------------------------------------
# pixel ops (uint8 [H, W, 3] in, uint8 out)
# ---------------------------------------------------------------------------


def identity(img: np.ndarray) -> np.ndarray:
    return img


def autocontrast(img: np.ndarray, cutoff: int = 0) -> np.ndarray:
    """PIL.ImageOps.autocontrast semantics (reference randaugment.py:19-49)."""
    out = np.empty_like(img)
    for c in range(img.shape[2]):
        ch = img[:, :, c]
        n = ch.size
        cut = cutoff * n // 100
        if cut == 0:
            high, low = int(ch.max()), int(ch.min())
        else:
            hist = np.bincount(ch.reshape(-1), minlength=256).astype(np.float64)
            cum = np.cumsum(hist)
            lo_idx = np.argwhere(cum > cut)
            low = 0 if lo_idx.shape[0] == 0 else int(lo_idx[0])
            cum_r = np.cumsum(hist[::-1])
            hi_idx = np.argwhere(cum_r > cut)
            high = 255 if hi_idx.shape[0] == 0 else 255 - int(hi_idx[0])
        if high <= low:
            table = np.arange(256)
        else:
            scale = 255.0 / (high - low)
            table = np.arange(256) * scale - low * scale
            table = np.clip(table, 0, 255)
        out[:, :, c] = table.clip(0, 255).astype(np.uint8)[ch]
    return out


def equalize(img: np.ndarray) -> np.ndarray:
    """PIL.ImageOps.equalize semantics (reference randaugment.py:52-73)."""
    out = np.empty_like(img)
    for c in range(img.shape[2]):
        ch = img[:, :, c]
        hist = np.bincount(ch.reshape(-1), minlength=256).astype(np.int64)
        nonzero = hist[hist != 0]
        step = int(nonzero[:-1].sum()) // 255 if nonzero.size else 0
        if step == 0:
            out[:, :, c] = ch
            continue
        n = np.empty_like(hist)
        n[0] = step // 2
        n[1:] = hist[:-1]
        table = (np.cumsum(n) // step).clip(0, 255).astype(np.uint8)
        out[:, :, c] = table[ch]
    return out


def solarize(img: np.ndarray, thresh: int = 128) -> np.ndarray:
    el = np.arange(256)
    table = np.where(el < thresh, el, 255 - el).clip(0, 255).astype(np.uint8)
    return table[img]


def posterize(img: np.ndarray, bits: int) -> np.ndarray:
    return np.bitwise_and(img, np.uint8((255 << (8 - bits)) & 255))


def color(img: np.ndarray, factor: float) -> np.ndarray:
    """ImageEnhance.Color via the reference's 3x3 blend matrix
    (randaugment.py:97-112; coefficient order kept verbatim)."""
    m = np.float32(
        [[0.886, -0.114, -0.114], [-0.587, 0.413, -0.587], [-0.299, -0.299, 0.701]]
    ) * factor + np.float32([[0.114], [0.587], [0.299]])
    return np.matmul(img, m).clip(0, 255).astype(np.uint8)


def contrast(img: np.ndarray, factor: float) -> np.ndarray:
    mean = float(np.sum(np.mean(img, axis=(0, 1)) * np.array([0.114, 0.587, 0.299])))
    table = ((np.arange(256) - mean) * factor + mean).clip(0, 255).astype(np.uint8)
    return table[img]


def brightness(img: np.ndarray, factor: float) -> np.ndarray:
    table = (np.arange(256, dtype=np.float32) * factor).clip(0, 255).astype(np.uint8)
    return table[img]


def _smooth3x3(img: np.ndarray) -> np.ndarray:
    """13-normalized 3x3 smoothing kernel with center 5 (the PIL SMOOTH
    kernel), reflect-101 borders like cv2.filter2D's default."""
    kernel = np.ones((3, 3), np.float32)
    kernel[1, 1] = 5.0
    kernel /= 13.0
    x = np.pad(img.astype(np.float32), ((1, 1), (1, 1), (0, 0)), mode="reflect")
    out = np.zeros(img.shape, np.float32)
    for dy in range(3):
        for dx in range(3):
            out += kernel[dy, dx] * x[dy : dy + img.shape[0], dx : dx + img.shape[1]]
    return np.floor(out + 0.5).clip(0, 255).astype(np.uint8)


def sharpness(img: np.ndarray, factor: float) -> np.ndarray:
    """Interior blend toward/away from the smoothed image (reference
    randaugment.py:138-156). For factor > 1 overshoot values the reference's
    bare `.astype(np.uint8)` WRAPS mod 256 (a live bug at magnitude 10,
    where the enhance table reaches factor 1.9); we clip like
    PIL.ImageEnhance — divergence pinned in tests/test_randaugment.py.
    In-range values truncate exactly like the reference."""
    degenerate = _smooth3x3(img)
    if factor == 0.0:
        return degenerate
    if factor == 1.0:
        return img
    out = img.astype(np.float32)
    deg = degenerate.astype(np.float32)[1:-1, 1:-1, :]
    out[1:-1, 1:-1, :] = deg + factor * (out[1:-1, 1:-1, :] - deg)
    return np.floor(out.clip(0, 255)).astype(np.uint8)


def _warp_affine(img: np.ndarray, m: np.ndarray, fill) -> np.ndarray:
    """cv2.warpAffine semantics: m maps src→dst; sample src at m⁻¹·dst with
    bilinear interpolation, out-of-bounds taps read the constant fill."""
    H, W = img.shape[:2]
    a = np.asarray(m, np.float64)[:, :2]
    b = np.asarray(m, np.float64)[:, 2]
    ainv = np.linalg.inv(a)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    dst = np.stack([xs.reshape(-1) - b[0], ys.reshape(-1) - b[1]])
    src = ainv @ dst  # [2, H*W] (x, y)
    sx, sy = src[0], src[1]
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    wx = (sx - x0).astype(np.float32)[:, None]
    wy = (sy - y0).astype(np.float32)[:, None]
    fill = np.asarray(fill, np.float32).reshape(1, -1)

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        vals = img[np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)].astype(np.float32)
        return np.where(valid[:, None], vals, fill)

    out = (
        tap(y0, x0) * (1 - wx) * (1 - wy)
        + tap(y0, x0 + 1) * wx * (1 - wy)
        + tap(y0 + 1, x0) * (1 - wx) * wy
        + tap(y0 + 1, x0 + 1) * wx * wy
    )
    return np.floor(out + 0.5).clip(0, 255).astype(np.uint8).reshape(img.shape)


def rotate(img: np.ndarray, degree: float, fill=REPLACE_VALUE) -> np.ndarray:
    """cv2.getRotationMatrix2D about the image center, degrees CCW."""
    H, W = img.shape[:2]
    cx, cy = W / 2.0, H / 2.0
    rad = np.deg2rad(degree)
    al, be = np.cos(rad), np.sin(rad)
    m = np.array(
        [[al, be, (1 - al) * cx - be * cy], [-be, al, be * cx + (1 - al) * cy]]
    )
    return _warp_affine(img, m, fill)


def shear_x(img: np.ndarray, factor: float, fill=REPLACE_VALUE) -> np.ndarray:
    return _warp_affine(img, np.array([[1.0, factor, 0.0], [0.0, 1.0, 0.0]]), fill)


def shear_y(img: np.ndarray, factor: float, fill=REPLACE_VALUE) -> np.ndarray:
    return _warp_affine(img, np.array([[1.0, 0.0, 0.0], [factor, 1.0, 0.0]]), fill)


def translate_x(img: np.ndarray, offset: float, fill=REPLACE_VALUE) -> np.ndarray:
    return _warp_affine(img, np.array([[1.0, 0.0, -offset], [0.0, 1.0, 0.0]]), fill)


def translate_y(img: np.ndarray, offset: float, fill=REPLACE_VALUE) -> np.ndarray:
    return _warp_affine(img, np.array([[1.0, 0.0, 0.0], [0.0, 1.0, -offset]]), fill)


def cutout(img: np.ndarray, pad_size: int, replace=REPLACE_VALUE,
           rng: Optional[np.random.Generator] = None) -> np.ndarray:
    rh, rw = (rng.random(2) if rng is not None else np.random.random(2))
    H, W = img.shape[:2]
    pad_size = pad_size // 2
    ch, cw = int(rh * H), int(rw * W)
    out = img.copy()
    out[max(ch - pad_size, 0) : min(ch + pad_size, H),
        max(cw - pad_size, 0) : min(cw + pad_size, W)] = np.asarray(replace, np.uint8)
    return out


# ---------------------------------------------------------------------------
# level → args (reference randaugment.py:222-323; random sign draws consume
# the same RNG stream position as the reference)
# ---------------------------------------------------------------------------


def _enhance_args(level, _rand):
    return ((level / MAX_LEVEL) * 1.8 + 0.1,)


def _shear_args(level, rand):
    v = (level / MAX_LEVEL) * 0.3
    if rand() > 0.5:
        v = -v
    return (v, REPLACE_VALUE)


def _translate_args(level, rand):
    v = (level / MAX_LEVEL) * float(TRANSLATE_CONST)
    if rand() > 0.5:
        v = -v
    return (v, REPLACE_VALUE)


def _rotate_args(level, rand):
    v = (level / MAX_LEVEL) * 30
    if rand() < 0.5:
        v = -v
    return (v, REPLACE_VALUE)


def _solarize_args(level, _rand):
    return (int((level / MAX_LEVEL) * 256),)


def _posterize_args(level, _rand):
    return (int((level / MAX_LEVEL) * 4),)


def _none_args(_level, _rand):
    return ()


OPS = {
    "Identity": (identity, _none_args),
    "AutoContrast": (autocontrast, _none_args),
    "Equalize": (equalize, _none_args),
    "Rotate": (rotate, _rotate_args),
    "Solarize": (solarize, _solarize_args),
    "Color": (color, _enhance_args),
    "Contrast": (contrast, _enhance_args),
    "Brightness": (brightness, _enhance_args),
    "Sharpness": (sharpness, _enhance_args),
    "ShearX": (shear_x, _shear_args),
    "TranslateX": (translate_x, _translate_args),
    "TranslateY": (translate_y, _translate_args),
    "Posterize": (posterize, _posterize_args),
    "ShearY": (shear_y, _shear_args),
}

# blip_image_train's 10-op subset (reference blip_processors.py:113-133)
BLIP_TRAIN_AUGS = (
    "Identity", "AutoContrast", "Brightness", "Sharpness", "Equalize",
    "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate",
)


class RandomAugment:
    """N ops sampled (with replacement) from the table, each applied with
    probability 0.5 at magnitude M (reference randaugment.py:326-349).

    rng=None consumes numpy's GLOBAL stream in the reference's exact draw
    order (np.random.seed gives schedule-for-schedule reproduction of the
    reference pipeline); pass a Generator for an isolated stream.
    """

    def __init__(self, N: int = 2, M: int = 10, isPIL: bool = False,
                 augs: Sequence[str] = (),
                 rng: Optional[np.random.Generator] = None):
        self.N = N
        self.M = M
        self.isPIL = isPIL
        self.augs = list(augs) if augs else list(OPS)
        self.rng = rng

    def _choice(self):
        if self.rng is not None:
            return [self.augs[i] for i in self.rng.integers(0, len(self.augs), self.N)]
        return list(np.random.choice(self.augs, self.N))

    def _rand(self):
        return float(self.rng.random() if self.rng is not None else np.random.random())

    def get_random_ops(self):
        return [(op, 0.5, self.M) for op in self._choice()]

    def __call__(self, img):
        if self.isPIL:
            img = np.array(img)
        img = np.ascontiguousarray(img, np.uint8)
        for name, prob, level in self.get_random_ops():
            if self._rand() > prob:
                continue
            fn, arg_fn = OPS[name]
            img = fn(img, *arg_fn(level, self._rand))
        return img


class VideoRandomAugment:
    """Video variant (reference randaugment.py:352-392 VideoRandomAugment):
    N ops sampled WITHOUT replacement once per clip and applied to every
    frame; the apply/skip gate `rand(N) > p` is also drawn once per clip
    (p=0.0 default → always applied); op ARGUMENTS are re-drawn per frame
    (the reference calls arg_dict[name](level) inside the per-frame _aug),
    so e.g. a rotation's random sign can differ frame to frame.

    Input/output: [T, H, W, 3] uint8-like array → float32 array (the
    reference returns a float tensor of the same layout).
    """

    def __init__(self, N: int = 2, M: int = 10, p: float = 0.0,
                 augs: Sequence[str] = (),
                 rng: Optional[np.random.Generator] = None):
        self.N = N
        self.M = M
        self.p = p
        self.augs = list(augs) if augs else list(OPS)
        self.rng = rng

    def _choice_no_replace(self):
        if self.rng is not None:
            idx = self.rng.choice(len(self.augs), self.N, replace=False)
            return [self.augs[i] for i in idx]
        return list(np.random.choice(self.augs, self.N, replace=False))

    def _rand(self):
        return float(self.rng.random() if self.rng is not None else np.random.random())

    def _randn(self, n):
        if self.rng is not None:
            return self.rng.random(n)
        return np.random.random(size=n)

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        frames = np.asarray(frames)
        assert frames.shape[-1] == 3, (
            "Expecting last dimension for 3-channels RGB (t, h, w, c)."
        )
        ops = self._choice_no_replace()
        apply_or_not = self._randn(self.N) > self.p
        out = []
        for frame in frames.astype(np.uint8):
            img = np.ascontiguousarray(frame)
            for i, name in enumerate(ops):
                if not apply_or_not[i]:
                    continue
                fn, arg_fn = OPS[name]
                img = fn(img, *arg_fn(self.M, self._rand))
            out.append(img)
        return np.stack(out).astype(np.float32)
