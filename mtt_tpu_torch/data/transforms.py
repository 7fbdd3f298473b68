"""Joint image and label augmentation on the host, in numpy (port of
mtt_tpu/data/transforms.py): label-aware random scaling (depth divided by the
scale), the semseg-rebalanced random crop, the horizontal flip with the
normals' x negated, the uint8 photometric distortion, ImageNet normalisation,
centre padding with per-task fill values and the ignore regions.

Each transform draws from the ``np.random.Generator`` it is given in the JAX
package's order, so one seed gives both packages the same scale, crop, flip
and jitter. The JAX package computes the resizes and colour conversions with
cv2, which the card's machine does not have; the functions below compute
what cv2 computes (checked against it on the CPU):

- ``resize`` nearest: the source pixel floor(dst * (1 / (dst_size /
  src_size))), clamped to the last one (not the half-pixel centre).
- ``resize`` linear: half-pixel centres, the source position in f64 and its
  fraction f rounded to f32, each pass ``fma(b - a, f, a)``; the horizontal
  pass clamps position and fraction at the borders, the vertical pass clamps
  the row indices only (cv2's float path, bit for bit).
- ``resize`` cubic (a = -0.75): half-pixel centres, the four weights of the
  f64 fraction rounded to f32, the taps clamped at the borders; sums within
  a few f32 ulps of cv2's. ``resize_cubic_u8``, the inference CLI's resize
  of a uint8 image, rounds it to the nearest level, as cv2 5.0 does: at
  most one level apart, a few pixels in a million.
- ``rgb2hsv``: cv2's uint8 RGB2HSV with its fixed-point division tables
  (``sdiv_table``, ``hdiv_table180``, 12-bit shift), bit for bit.
- ``hsv2rgb``: cv2's uint8 HSV2RGB through f32 (s, v scaled by 1/255, h by
  6/180, the sector terms contracted into fused multiply-adds); the first
  32 * (width // 32) pixels of a row truncate to uint8, as cv2's vector loop
  of four 8-lane blocks does on an AVX2 host, the rest round (``cvRound``),
  as its scalar tail does; bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

_F32 = np.float32

# per-key resize mode during random scaling
SCALE_MODE = {"semseg": "nearest", "depth": "nearest", "normals": "nearest",
              "edge": "nearest", "sal": "nearest", "human_parts": "nearest",
              "image": "linear"}

PAD_FILL = {"edge": 255, "human_parts": 255, "semseg": 255, "depth": 0,
            "normals": 0, "sal": 255, "image": 0}

_SKIP = ("meta",)


# --- cv2's resize and colour conversions in numpy ----------------------------

def _fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """f32 a * b + c rounded once: the f32 product is exact in f64."""
    return (a.astype(np.float64) * b + c).astype(_F32)


def _positions(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """(integer part, f64 fraction) of each destination pixel's source
    position at half-pixel centres."""
    pos = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    base = np.floor(pos).astype(np.int64)
    return base, pos - base


def _nearest_index(src: int, dst: int) -> np.ndarray:
    step = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * step).astype(np.int64),
                      src - 1)


def _linear_pass(a: np.ndarray, axis: int, dst: int, clamp: bool
                 ) -> np.ndarray:
    src = a.shape[axis]
    base, frac = _positions(src, dst)
    f = frac.astype(_F32)
    if clamp:
        low, high = base < 0, base >= src - 1
        f = np.where(low | high, _F32(0), f)
        base = np.where(low, 0, np.where(high, src - 1, base))
    s0 = np.take(a, np.clip(base, 0, src - 1), axis)
    s1 = np.take(a, np.clip(base + 1, 0, src - 1), axis)
    shape = [1] * a.ndim
    shape[axis] = dst
    return _fma(s1 - s0, f.reshape(shape), s0)


def _cubic_weights(frac: np.ndarray) -> np.ndarray:
    a = -0.75
    x = frac
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    return np.stack([c0, c1, c2, 1 - c0 - c1 - c2], -1).astype(_F32)


def _cubic_pass(a: np.ndarray, axis: int, dst: int) -> np.ndarray:
    src = a.shape[axis]
    base, frac = _positions(src, dst)
    w = _cubic_weights(frac)
    shape = [1] * a.ndim
    shape[axis] = dst
    taps = [np.take(a, np.clip(base - 1 + k, 0, src - 1), axis)
            * w[:, k].reshape(shape) for k in range(4)]
    return (taps[0] + taps[1]) + (taps[2] + taps[3])


def resize_cubic_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_CUBIC)`` of a uint8
    (H, W) or (H, W, C) image, ``size`` = (width, height). cv2 5.0's uint8
    result is its float cubic rounded to the nearest level (equal on every
    pixel tested); this rounds the float cubic of ``resize``, which sits
    within a few f32 ulps of cv2's, so a sum that close to a half level can
    land one level apart (a few pixels in a million)."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_cubic_u8 takes uint8, got {img.dtype}")
    if img.shape[:2] == (size[1], size[0]):
        return img.copy()
    out = resize(img.astype(_F32), size, "cubic")
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def resize(arr: np.ndarray, size: Tuple[int, int], mode: str) -> np.ndarray:
    """``cv2.resize(arr, size, interpolation=...)`` for an (H, W) or (H, W, C)
    float32 array, ``size`` = (width, height) as cv2 takes it, ``mode`` one
    of nearest, linear, cubic."""
    w, h = size
    if mode == "nearest":
        return arr[_nearest_index(arr.shape[0], h)][
            :, _nearest_index(arr.shape[1], w)]
    a = np.asarray(arr, _F32)
    if mode == "linear":
        return _linear_pass(_linear_pass(a, 1, w, True), 0, h, False)
    if mode == "cubic":
        return _cubic_pass(_cubic_pass(a, 1, w), 0, h)
    raise ValueError(f"resize mode {mode!r}")


_INV = np.arange(1, 256, dtype=np.float64)
# cv2's fixed-point divisions of RGB2HSV: round((255 << 12) / v) and
# round((180 << 12) / (6 * diff)), half to even as its saturate_cast
_SDIV = np.concatenate([[0], np.rint((255 << 12) / _INV)]).astype(np.int64)
_HDIV = np.concatenate([[0], np.rint((180 << 12) / (6.0 * _INV))]
                       ).astype(np.int64)
# HSV2RGB: for each sector, which of (v, p, q, t) is b, g, r
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])
_HSV_BLOCK = 32


def rgb2hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` of a uint8 (H, W, 3) RGB
    image: h in [0, 180)."""
    x = img.astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    vr = np.where(v == r, -1, 0)
    vg = np.where(v == g, -1, 0)
    s = (diff * _SDIV[v] + (1 << 11)) >> 12
    h = (vr & (g - b)) + (~vr & ((vg & (b - r + 2 * diff))
                                 + (~vg & (r - g + 4 * diff))))
    h = (h * _HDIV[diff] + (1 << 11)) >> 12
    h = h + np.where(h < 0, 180, 0)
    return np.stack([np.clip(h, 0, 255), s, v], -1).astype(np.uint8)


def hsv2rgb(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` of a uint8 (H, W, 3) image
    with h in [0, 180) (larger h wrap as cv2 wraps them)."""
    one = _F32(1)
    h = hsv[..., 0].astype(_F32) * (_F32(6) / _F32(180))
    s = hsv[..., 1].astype(_F32) * _F32(1.0 / 255.0)
    v = hsv[..., 2].astype(_F32) * _F32(1.0 / 255.0)
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(_F32)
    sector %= 6
    tab = np.stack([v, v * (one - s), v * _fma(-s, h, one),
                    v * _fma(-s, one - h, one)], -1)
    bgr = np.take_along_axis(tab, _SECTORS[sector], -1)
    rgb = bgr[..., ::-1] * _F32(255)
    vec = _HSV_BLOCK * (hsv.shape[1] // _HSV_BLOCK)
    out = np.concatenate([np.trunc(rgb[:, :vec]), np.rint(rgb[:, vec:])], 1)
    return np.clip(out, 0, 255).astype(np.uint8)


# --- the transforms ----------------------------------------------------------

def _is_map_key(k: str) -> bool:
    # det_* entries are padded box arrays, not spatial maps
    return k not in _SKIP and not k.startswith("det_")


def _label_keys(sample):
    return [k for k in sample if _is_map_key(k)]


def _ensure_3d(arr):
    return arr[..., None] if arr.ndim == 2 else arr


def random_scaling(sample: Dict, rng: np.random.Generator,
                   scale_factors=(0.5, 2.0)) -> Dict:
    """Uniform random rescale; depth values divided by the scale."""
    s = float(rng.uniform(*scale_factors))
    if s == 1.0:
        return sample
    for key in _label_keys(sample):
        arr = np.squeeze(sample[key])
        h, w = arr.shape[:2]
        new = _ensure_3d(resize(arr, (int(w * s), int(h * s)),
                                SCALE_MODE[key]))
        if key == "depth":
            new = new / s
        sample[key] = new
    return sample


def random_crop(sample: Dict, rng: np.random.Generator,
                size: Tuple[int, int], cat_max_ratio: float = 1.0) -> Dict:
    """Random crop; when cat_max_ratio < 1, resample the location up to 10x
    until no semseg class dominates."""
    img = sample["image"]
    h, w = img.shape[:2]
    ch, cw = size

    def _loc():
        if h == ch and w == cw:
            return None
        oh = int(rng.integers(0, max(h - ch, 0) + 1))
        ow = int(rng.integers(0, max(w - cw, 0) + 1))
        return (oh, oh + ch, ow, ow + cw)

    loc = _loc()
    if cat_max_ratio < 1.0 and "semseg" in sample:
        for _ in range(10):
            seg = sample["semseg"] if loc is None else \
                sample["semseg"][loc[0]:loc[1], loc[2]:loc[3]]
            labels, cnt = np.unique(seg, return_counts=True)
            cnt = cnt[labels != 255]
            if len(cnt) > 1 and cnt.max() / cnt.sum() < cat_max_ratio:
                break
            loc = _loc()
    if loc is not None:
        for key in _label_keys(sample):
            sample[key] = sample[key][loc[0]:loc[1], loc[2]:loc[3], :]
    return sample


def random_hflip(sample: Dict, rng: np.random.Generator, p: float = 0.5
                 ) -> Dict:
    """Horizontal flip; negates the normals' x component."""
    if rng.random() < p:
        for key in _label_keys(sample):
            arr = np.ascontiguousarray(np.fliplr(sample[key]))
            if key == "normals":
                arr[:, :, 0] *= -1
            sample[key] = arr
    return sample


def photometric_distortion(sample: Dict, rng: np.random.Generator,
                           brightness_delta: int = 32,
                           contrast_range=(0.5, 1.5),
                           saturation_range=(0.5, 1.5),
                           hue_delta: int = 18) -> Dict:
    """uint8 brightness / contrast / HSV jitter, with the uint8 round trips
    of the reference."""
    img = sample["image"].astype(np.uint8)

    def conv(im, alpha=1.0, beta=0.0):
        return np.clip(im.astype(np.float32) * alpha + beta, 0,
                       255).astype(np.uint8)

    if rng.random() < 0.5:
        img = conv(img, beta=float(rng.uniform(-brightness_delta,
                                               brightness_delta)))

    def contrast(im):
        if rng.random() < 0.5:
            return conv(im, alpha=float(rng.uniform(*contrast_range)))
        return im

    f_mode = rng.random() < 0.5
    if f_mode:
        img = contrast(img)
    if rng.random() < 0.5:  # saturation
        hsv = rgb2hsv(img)
        hsv[:, :, 1] = conv(hsv[:, :, 1],
                            alpha=float(rng.uniform(*saturation_range)))
        img = hsv2rgb(hsv)
    if rng.random() < 0.5:  # hue
        hsv = rgb2hsv(img)
        hsv[:, :, 0] = (hsv[:, :, 0].astype(int) +
                        int(rng.integers(-hue_delta, hue_delta))) % 180
        img = hsv2rgb(hsv)
    if not f_mode:
        img = contrast(img)

    sample["image"] = img.astype(np.float32)
    return sample


def normalize_image(sample: Dict, mean=(0.485, 0.456, 0.406),
                    std=(0.229, 0.224, 0.225)) -> Dict:
    img = sample["image"].astype(np.float32) / 255.0
    img -= np.asarray(mean, np.float32)
    img /= np.asarray(std, np.float32)
    sample["image"] = img
    return sample


def pad_image(sample: Dict, size: Tuple[int, int]) -> Dict:
    """Centre-pad every key to >= size with per-task fill values."""
    for key in _label_keys(sample):
        arr = sample[key]
        h, w, c = arr.shape
        dh, dw = max(size[0] - h, 0), max(size[1] - w, 0)
        if dh == 0 and dw == 0:
            continue
        out = np.full((max(size[0], h), max(size[1], w), c),
                      PAD_FILL[key], dtype=np.float32)
        out[dh // 2:dh // 2 + h, dw // 2:dw // 2 + w, :] = arr
        sample[key] = out
    return sample


def add_ignore_regions(sample: Dict, depth_ignore: float = 255.0) -> Dict:
    """Normals with zero norm -> 255; human-parts images without
    annotations -> all 255; depth zeros -> ``depth_ignore`` (255 InvPT, -1
    TaskPrompter / NYUD)."""
    if "normals" in sample:
        n = sample["normals"]
        norm = np.sqrt((n.astype(np.float32) ** 2).sum(-1))
        n[norm == 0, :] = 255
    if "human_parts" in sample:
        hp = sample["human_parts"]
        if np.all((hp == 0) | (hp == 255)):
            sample["human_parts"] = np.full_like(hp, 255)
    if "depth" in sample:
        d = sample["depth"]
        d[d == 0] = depth_ignore
    return sample


def direct_resize(sample: Dict, size: Tuple[int, int],
                  flagvals: Optional[Dict[str, str]] = None) -> Dict:
    """Deterministic resize to ``size`` with per-key modes (image cubic,
    labels nearest unless ``flagvals`` says otherwise): the inference
    path's transform."""
    for key in _label_keys(sample):
        arr = np.squeeze(sample[key])
        mode = (flagvals or {}).get(key, "cubic" if key == "image"
                                    else "nearest")
        arr = resize(arr, (size[1], size[0]), mode)
        sample[key] = _ensure_3d(arr).astype(np.float32)
    return sample


class TrainTransforms:
    """The training pipeline: scale, crop, flip, photometric distortion,
    normalise, pad, ignore regions."""

    def __init__(self, size: Tuple[int, int], depth_ignore: float = 255.0,
                 scale_factors=(0.5, 2.0), cat_max_ratio: float = 0.75):
        self.size = tuple(size)
        self.depth_ignore = depth_ignore
        self.scale_factors = scale_factors
        self.cat_max_ratio = cat_max_ratio

    def __call__(self, sample: Dict, rng: np.random.Generator) -> Dict:
        sample = {k: (_ensure_3d(np.asarray(v, np.float32))
                      if _is_map_key(k) else v) for k, v in sample.items()}
        sample = random_scaling(sample, rng, self.scale_factors)
        sample = random_crop(sample, rng, self.size, self.cat_max_ratio)
        sample = random_hflip(sample, rng)
        sample = photometric_distortion(sample, rng)
        sample = normalize_image(sample)
        sample = pad_image(sample, self.size)
        sample = add_ignore_regions(sample, self.depth_ignore)
        return sample


class ValTransforms:
    """The eval pipeline: normalise, pad, ignore regions."""

    def __init__(self, size: Tuple[int, int], depth_ignore: float = 255.0):
        self.size = tuple(size)
        self.depth_ignore = depth_ignore

    def __call__(self, sample: Dict, rng=None) -> Dict:
        sample = {k: (_ensure_3d(np.asarray(v, np.float32))
                      if _is_map_key(k) else v) for k, v in sample.items()}
        sample = normalize_image(sample)
        sample = pad_image(sample, self.size)
        sample = add_ignore_regions(sample, self.depth_ignore)
        return sample
