"""Image/mask augmentations on numpy, without OpenCV.

The JAX package's transforms (albumentations-style names, parameters and
dict-call convention) with the same per-example random draws::

    tfs = Compose([RandomScale(...), ...], seed=0)
    out = tfs(image=img, mask=msk)   # {'image': ..., 'mask': ...}

Images are HWC (or HW) numpy; masks take nearest interpolation and no
photometric change. The geometric kernels reproduce what cv2 computes
for the JAX package:

- ``resize_linear``: cv2.resize INTER_LINEAR (half-pixel centers,
  clamped borders; uint8 in cv2's fixed point, weights in 1/2048); a few uint8 pixels may differ by one grey level;
- ``resize_nearest``: cv2.resize INTER_NEAREST (source index
  floor(i * src / dst));
- ``resize_area``: cv2.resize INTER_AREA when shrinking a float32 image:
  block means for integer factors, cv2's fractional-area weights
  otherwise, summed in float32 in cv2's order;
- ``warp_affine``: cv2.warpAffine with a zero border: nearest in its
  fixed-point source coordinates (1/1024 pixel), bilinear in float32
  coordinates and weights (OpenCV 5's kernel), rounded for integer
  images;
- ``GaussianBlur``: cv2's kernels and reflect-101 border, rounded half
  up for integer images.
"""

from __future__ import annotations

import math

import numpy as np

from empanada_torch.data.utils.target_creation import (
    gaussian_blur,
    gaussian_kernel,
)

__all__ = [
    "Compose",
    "RandomScale",
    "PadIfNeeded",
    "RandomCrop",
    "CenterCrop",
    "Rotate",
    "RandomBrightnessContrast",
    "HorizontalFlip",
    "VerticalFlip",
    "GaussNoise",
    "GaussianBlur",
    "Normalize",
    "FactorPad",
    "resize_linear",
    "resize_nearest",
    "resize_area",
    "rotation_matrix",
    "warp_affine",
    "resize_by_factor",
    "factor_pad_numpy",
    "create_augmentations",
]


def _linear_taps(dst, src):
    """Per output index along one axis: (index0, index1, weight1) of
    cv2's INTER_LINEAR."""
    f = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    a = (f - i0).astype(np.float64)
    a[i0 < 0] = 0.0
    i0[i0 < 0] = 0
    last = i0 >= src - 1
    a[last] = 0.0
    i0[last] = src - 1
    return i0, np.minimum(i0 + 1, src - 1), a


def _as_dtype(out, dtype):
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return np.clip(np.rint(out), info.min, info.max).astype(dtype)
    return out.astype(dtype)


def resize_linear(img, size):
    """cv2.resize(img, (w, h), interpolation=INTER_LINEAR) for an
    (H, W[, C]) image; ``size`` = (h, w). uint8 images follow cv2's
    fixed point (rows, then columns, as its vector path rounds)."""
    h, w = img.shape[:2]
    oh, ow = size
    y0, y1, b = _linear_taps(oh, h)
    x0, x1, a = _linear_taps(ow, w)
    col = (1, -1) + (1,) * (img.ndim - 2)
    row = (-1,) + (1,) * (img.ndim - 1)
    if img.dtype == np.uint8:
        # weights in 1/2048 units
        a = np.rint(a * 2048).astype(np.int64)
        b = np.rint(b * 2048).astype(np.int64)
        src = img.astype(np.int64)
        rows = src[:, x0] * (2048 - a).reshape(col) \
            + src[:, x1] * a.reshape(col)
        out = ((((2048 - b).reshape(row) * (rows[y0] >> 4)) >> 16)
               + ((b.reshape(row) * (rows[y1] >> 4)) >> 16) + 2) >> 2
        return np.clip(out, 0, 255).astype(np.uint8)
    src = img.astype(np.float64)
    rows = src[:, x0] * (1 - a).reshape(col) + src[:, x1] * a.reshape(col)
    out = rows[y0] * (1 - b).reshape(row) + rows[y1] * b.reshape(row)
    return _as_dtype(out, img.dtype)


def resize_nearest(img, size):
    """cv2.resize(img, (w, h), interpolation=INTER_NEAREST)."""
    h, w = img.shape[:2]
    oh, ow = size
    ys = np.minimum(np.floor(np.arange(oh) * (1.0 / (oh / h))), h - 1)
    xs = np.minimum(np.floor(np.arange(ow) * (1.0 / (ow / w))), w - 1)
    return img[ys.astype(np.int64)][:, xs.astype(np.int64)]


def _area_tab(src, dst, scale):
    """cv2's computeResizeAreaTab: (dst index, src index, float32 weight)
    over the source cells each destination cell covers, in cv2's order."""
    tab = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(math.floor(f2), src - 1)
        s1 = min(math.ceil(f1), s2)
        if s1 - f1 > 1e-3:
            tab.append((d, s1 - 1, np.float32((s1 - f1) / cell)))
        tab.extend((d, s, np.float32(1.0 / cell)) for s in range(s1, s2))
        if f2 - s2 > 1e-3:
            tab.append((d, s2, np.float32(min(f2 - s2, 1.0, cell) / cell)))
    return tab


def _by_rank(tab):
    """Split a tab into steps: step j holds the j-th entry of every
    destination index, so per-index sums keep cv2's order."""
    steps, seen = [], {}
    for d, s, a in tab:
        j = seen[d] = seen.get(d, -1) + 1
        if j == len(steps):
            steps.append(([], [], []))
        for lst, v in zip(steps[j], (d, s, a)):
            lst.append(v)
    return [(np.array(d), np.array(s), np.array(a, np.float32))
            for d, s, a in steps]


def resize_area(img, size):
    """cv2.resize(img, (w, h), interpolation=INTER_AREA) of a float32
    (H, W) image to ``size`` = (h, w) no larger on either side."""
    img = np.asarray(img, np.float32)
    h, w = img.shape
    oh, ow = size
    sx, sy = 1.0 / (ow / w), 1.0 / (oh / h)
    if sx < 1 or sy < 1:
        raise ValueError(f"resize_area shrinks only: {(h, w)} -> {size}")
    if sx == round(sx) and sy == round(sy):
        # cv2's fast path: the block's sum (four at a time), times 1/area
        ix, iy = int(round(sx)), int(round(sy))
        blocks = img[:oh * iy, :ow * ix].reshape(oh, iy, ow, ix)
        taps = blocks.transpose(1, 3, 0, 2).reshape(iy * ix, oh, ow)
        total = np.zeros((oh, ow), np.float32)
        k = 0
        while k + 4 <= len(taps):
            total += ((taps[k] + taps[k + 1]) + taps[k + 2]) + taps[k + 3]
            k += 4
        for k in range(k, len(taps)):
            total += taps[k]
        return total * np.float32(1.0 / (ix * iy))
    rows = np.zeros((h, ow), np.float32)
    for d, s, a in _by_rank(_area_tab(w, ow, sx)):
        rows[:, d] += img[:, s] * a
    out = np.zeros((oh, ow), np.float32)
    for d, s, a in _by_rank(_area_tab(h, oh, sy)):
        out[d] += a[:, None] * rows[s]
    return out


def rotation_matrix(center, angle, scale=1.0):
    """cv2.getRotationMatrix2D: the (2, 3) forward map."""
    a = math.radians(angle)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _invert_affine(m):
    """cv2.invertAffineTransform."""
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2]])


def warp_affine(img, m, nearest=False):
    """cv2.warpAffine(img, m, (w, h), flags, BORDER_CONSTANT, 0) for an
    (H, W[, C]) image: each output pixel samples the source at the
    inverse map of its position, in cv2's fixed point."""
    h, w = img.shape[:2]
    inv = _invert_affine(np.asarray(m, np.float64))
    ab = 1024  # cv2's AB_SCALE: source coordinates in 1/1024 pixel
    xs = np.arange(w, dtype=np.float64)
    ys = np.arange(h, dtype=np.float64)
    adelta = np.rint(inv[0, 0] * xs * ab).astype(np.int64)
    bdelta = np.rint(inv[1, 0] * xs * ab).astype(np.int64)
    x0 = np.rint((inv[0, 1] * ys + inv[0, 2]) * ab).astype(np.int64) + ab // 2
    y0 = np.rint((inv[1, 1] * ys + inv[1, 2]) * ab).astype(np.int64) + ab // 2
    big_x = x0[:, None] + adelta[None, :]
    big_y = y0[:, None] + bdelta[None, :]

    def tap(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        vals = img[yi.clip(0, h - 1), xi.clip(0, w - 1)]
        mask = inside.reshape(inside.shape + (1,) * (img.ndim - 2))
        return np.where(mask, vals, 0)

    if nearest:
        return tap(big_y >> 10, big_x >> 10).astype(img.dtype)
    # bilinear: float32 source coordinates and weights
    f = np.float32
    yy, xx = np.mgrid[:h, :w].astype(f)
    sx = f(inv[0, 0]) * xx + f(inv[0, 1]) * yy + f(inv[0, 2])
    sy = f(inv[1, 0]) * xx + f(inv[1, 1]) * yy + f(inv[1, 2])
    ix, iy = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    extra = (1,) * (img.ndim - 2)
    fx = (sx - ix).reshape(sx.shape + extra)
    fy = (sy - iy).reshape(sy.shape + extra)
    out = (tap(iy, ix) * (1 - fx) * (1 - fy) + tap(iy, ix + 1) * fx * (1 - fy)
           + tap(iy + 1, ix) * (1 - fx) * fy + tap(iy + 1, ix + 1) * fx * fy)
    return _as_dtype(out, img.dtype)


def resize_by_factor(image, scale_factor=1):
    """Downscale an (H, W) image by a factor (bilinear)."""
    if scale_factor == 1:
        return image
    h, w = image.shape
    return resize_linear(image, (math.ceil(h / scale_factor),
                                 math.ceil(w / scale_factor)))


def factor_pad_numpy(image, factor=128):
    """Bottom/right zero-pad to a multiple of factor."""
    h, w = image.shape[:2]
    padding = [(0, (-h) % factor), (0, (-w) % factor)]
    if image.ndim == 3:
        padding.append((0, 0))
    return np.pad(image, padding)


class _Transform:
    """Base: applies with probability p (one uniform draw per call, even
    at p = 1); subclasses define params/apply."""

    def __init__(self, p=0.5):
        self.p = p

    def get_params(self, rng, image):
        return {}

    def apply_image(self, image, **params):
        return image

    def apply_mask(self, mask, **params):
        return mask

    def __call__(self, rng, out):
        if rng.random() >= self.p:
            return out
        params = self.get_params(rng, out["image"])
        out["image"] = self.apply_image(out["image"], **params)
        if out.get("mask") is not None:
            out["mask"] = self.apply_mask(out["mask"], **params)
        return out


class Compose:
    """Applies transforms with one numpy Generator per worker: worker i
    of a loader draws from the i-th child spawned from
    ``SeedSequence(seed)`` (``set_stream``); used outside a loader, the
    first call spawns the next child, as the JAX package's per-thread
    streams do."""

    def __init__(self, transforms, seed=None):
        self.transforms = transforms
        self.seed_seq = np.random.SeedSequence(seed)
        self._rng = None

    def set_stream(self, seed_seq):
        """Draw from ``seed_seq`` (a spawned child) from now on."""
        self._rng = np.random.default_rng(seed_seq)

    @property
    def rng(self):
        if self._rng is None:
            self.set_stream(self.seed_seq.spawn(1)[0])
        return self._rng

    def __call__(self, image, mask=None, **kwargs):
        rng = self.rng
        out = {"image": image, "mask": mask}
        for t in self.transforms:
            out = t(rng, out)
        if mask is None:
            out.pop("mask")
        return out


def _scaled(shape, scale):
    return max(1, round(shape[0] * scale)), max(1, round(shape[1] * scale))


class RandomScale(_Transform):
    def __init__(self, scale_limit=(-0.1, 0.1), p=0.5):
        super().__init__(p)
        if np.isscalar(scale_limit):
            scale_limit = (-scale_limit, scale_limit)
        self.scale_limit = scale_limit

    def get_params(self, rng, image):
        return {"scale": 1.0 + rng.uniform(*self.scale_limit)}

    def apply_image(self, image, scale):
        return resize_linear(image, _scaled(image.shape, scale))

    def apply_mask(self, mask, scale):
        return resize_nearest(mask, _scaled(mask.shape, scale))


class PadIfNeeded(_Transform):
    def __init__(self, min_height, min_width, border_mode=0, p=1.0):
        super().__init__(p)
        self.min_height = min_height
        self.min_width = min_width

    def _pad(self, img):
        h, w = img.shape[:2]
        ph = max(0, self.min_height - h)
        pw = max(0, self.min_width - w)
        if ph == 0 and pw == 0:
            return img
        top, left = ph // 2, pw // 2
        pad = [(top, ph - top), (left, pw - left)]
        if img.ndim == 3:
            pad.append((0, 0))
        return np.pad(img, pad)

    def apply_image(self, image):
        return self._pad(image)

    def apply_mask(self, mask):
        return self._pad(mask)


class RandomCrop(_Transform):
    def __init__(self, height, width, p=1.0):
        super().__init__(p)
        self.height = height
        self.width = width

    def get_params(self, rng, image):
        return {"hs": rng.random(), "ws": rng.random()}

    def _crop(self, img, hs, ws):
        h, w = img.shape[:2]
        y0 = int((h - self.height) * hs) if h > self.height else 0
        x0 = int((w - self.width) * ws) if w > self.width else 0
        return img[y0:y0 + self.height, x0:x0 + self.width]

    apply_image = _crop
    apply_mask = _crop


class CenterCrop(_Transform):
    def __init__(self, height, width, p=1.0):
        super().__init__(p)
        self.height = height
        self.width = width

    def _crop(self, img):
        h, w = img.shape[:2]
        y0 = max(0, (h - self.height) // 2)
        x0 = max(0, (w - self.width) // 2)
        return img[y0:y0 + self.height, x0:x0 + self.width]

    def apply_image(self, image):
        return self._crop(image)

    def apply_mask(self, mask):
        return self._crop(mask)


class Rotate(_Transform):
    def __init__(self, limit=90, border_mode=0, p=0.5):
        super().__init__(p)
        self.limit = limit if not np.isscalar(limit) else (-limit, limit)

    def get_params(self, rng, image):
        return {"angle": rng.uniform(*self.limit)}

    def _rotate(self, img, angle, nearest=False):
        h, w = img.shape[:2]
        m = rotation_matrix((w / 2 - 0.5, h / 2 - 0.5), angle)
        return warp_affine(img, m, nearest)

    def apply_image(self, image, angle):
        return self._rotate(image, angle)

    def apply_mask(self, mask, angle):
        return self._rotate(mask, angle, nearest=True)


class RandomBrightnessContrast(_Transform):
    def __init__(self, brightness_limit=0.2, contrast_limit=0.2, p=0.5):
        super().__init__(p)
        self.brightness_limit = brightness_limit \
            if not np.isscalar(brightness_limit) \
            else (-brightness_limit, brightness_limit)
        self.contrast_limit = contrast_limit \
            if not np.isscalar(contrast_limit) \
            else (-contrast_limit, contrast_limit)

    def get_params(self, rng, image):
        return {"alpha": 1.0 + rng.uniform(*self.contrast_limit),
                "beta": rng.uniform(*self.brightness_limit)}

    def apply_image(self, image, alpha, beta):
        dtype = image.dtype
        max_value = float(np.iinfo(dtype).max) \
            if np.issubdtype(dtype, np.integer) else 1.0
        out = image.astype(np.float32) * alpha + beta * max_value
        return np.clip(out, 0, max_value).astype(dtype)


class HorizontalFlip(_Transform):
    def apply_image(self, image):
        return np.ascontiguousarray(image[:, ::-1])

    apply_mask = apply_image


class VerticalFlip(_Transform):
    def apply_image(self, image):
        return np.ascontiguousarray(image[::-1])

    apply_mask = apply_image


class GaussNoise(_Transform):
    def __init__(self, var_limit=(10.0, 50.0), p=0.5):
        super().__init__(p)
        self.var_limit = var_limit

    def get_params(self, rng, image):
        sigma = rng.uniform(*self.var_limit) ** 0.5
        return {"noise": rng.normal(0, sigma, image.shape).astype(np.float32)}

    def apply_image(self, image, noise):
        dtype = image.dtype
        if np.issubdtype(dtype, np.integer):
            lo, hi = np.iinfo(dtype).min, np.iinfo(dtype).max
        else:
            lo, hi = 0.0, 1.0
        return np.clip(image.astype(np.float32) + noise, lo, hi).astype(dtype)


class GaussianBlur(_Transform):
    def __init__(self, blur_limit=(3, 7), p=0.5):
        super().__init__(p)
        self.blur_limit = blur_limit

    def get_params(self, rng, image):
        k = int(rng.integers(self.blur_limit[0] // 2,
                             self.blur_limit[1] // 2 + 1)) * 2 + 1
        return {"ksize": k}

    def apply_image(self, image, ksize):
        kernel = gaussian_kernel(ksize, 0)
        planes = image[..., None] if image.ndim == 2 else image
        out = np.stack([gaussian_blur(planes[..., c], kernel, "mirror")
                        for c in range(planes.shape[-1])], axis=-1)
        if image.ndim == 2:
            out = out[..., 0]
        if np.issubdtype(image.dtype, np.integer):
            info = np.iinfo(image.dtype)
            return np.clip(np.floor(out + 0.5), info.min,
                           info.max).astype(image.dtype)
        return out.astype(image.dtype)


class Normalize(_Transform):
    """(img / max_pixel_value - mean) / std -> float32, always applied."""

    def __init__(self, mean=0.0, std=1.0, max_pixel_value=255.0, p=1.0):
        super().__init__(p)
        self.mean = mean
        self.std = std
        self.max_pixel_value = max_pixel_value

    def apply_image(self, image):
        img = image.astype(np.float32) / self.max_pixel_value
        return (img - self.mean) / self.std


class FactorPad(_Transform):
    def __init__(self, factor=128, p=1.0):
        super().__init__(p)
        self.factor = factor

    def apply_image(self, image):
        return factor_pad_numpy(image, self.factor)

    apply_mask = apply_image


AUGMENTATIONS = {
    "RandomScale": RandomScale,
    "PadIfNeeded": PadIfNeeded,
    "RandomCrop": RandomCrop,
    "CenterCrop": CenterCrop,
    "Rotate": Rotate,
    "RandomBrightnessContrast": RandomBrightnessContrast,
    "HorizontalFlip": HorizontalFlip,
    "VerticalFlip": VerticalFlip,
    "GaussNoise": GaussNoise,
    "GaussianBlur": GaussianBlur,
    "Normalize": Normalize,
    "FactorPad": FactorPad,
}


def create_augmentations(aug_config, norms=None, seed=None):
    """Config list [{'aug': name, **params}, ...] -> Compose, appending
    Normalize(norms) last."""
    transforms = []
    for entry in aug_config or []:
        params = {k: v for k, v in entry.items() if k != "aug"}
        name = entry["aug"]
        if name not in AUGMENTATIONS:
            raise ValueError(f"unknown augmentation {name!r}")
        transforms.append(AUGMENTATIONS[name](**params))
    if norms is not None:
        transforms.append(Normalize(mean=norms["mean"], std=norms["std"]))
    return Compose(transforms, seed=seed)
