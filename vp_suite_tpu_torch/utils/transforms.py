r"""Host-side frame transforms over numpy ``[..., h, w, c]`` arrays (any
leading time and batch axes), and the area resize that shrinks Moving MNIST's
digit templates.

The JAX package's transforms, with its class names, ``reset_rng`` seeds and
order of draws (each random transform draws from its own
``np.random.default_rng``; ``Compose.reset_rng(seed)`` gives the i-th
``seed + i``). Where the JAX package calls OpenCV, which the card's machine
lacks, the arithmetic is OpenCV's, in numpy:

- ``Resize``: ``cv2.resize(INTER_LINEAR)`` on float32, half-pixel centres,
  clamped at the border, the weights from float64 positions;
- ``RandomRotation``: ``cv2.getRotationMatrix2D`` and ``cv2.warpAffine``,
  bilinear with a zero border at the exact source positions, as OpenCV 5
  samples them (OpenCV 4 rounds each position to 1/32 of a pixel);
- ``GaussianBlur``: ``cv2.getGaussianKernel`` (float32 taps) and a
  separable filter with ``BORDER_REFLECT_101``.

``CROPS`` and ``SHAPE_PRESERVING_AUGMENTATIONS`` are the transforms that
datasets accept as ``crop`` and ``augmentations``.
"""
import math

import numpy as np


class Transform:
    r"""Base class; subclasses implement ``__call__(x)`` on ``[..., h, w, c]``."""
    SHAPE_PRESERVING = True

    def reset_rng(self, seed=0):
        self._rng = np.random.default_rng(seed)


class Compose(Transform):
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x

    def reset_rng(self, seed=0):
        for i, t in enumerate(self.transforms):
            t.reset_rng(seed + i)


class Identity(Transform):
    def __call__(self, x):
        return x


def _size(size):
    return (size, size) if isinstance(size, int) else tuple(size)


class CenterCrop(Transform):
    SHAPE_PRESERVING = False

    def __init__(self, size):
        self.size = _size(size)

    def __call__(self, x):
        h, w = x.shape[-3], x.shape[-2]
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return x[..., i:i + th, j:j + tw, :]


class RandomCrop(Transform):
    SHAPE_PRESERVING = False

    def __init__(self, size, seed=0):
        self.size = _size(size)
        self.reset_rng(seed)

    def __call__(self, x):
        h, w = x.shape[-3], x.shape[-2]
        th, tw = self.size
        i = int(self._rng.integers(0, max(h - th, 0) + 1))
        j = int(self._rng.integers(0, max(w - tw, 0) + 1))
        return x[..., i:i + th, j:j + tw, :]


def _linear_taps(ssize: int, dsize: int):
    r"""``(lo, hi, weight of hi)`` of each output position of a linear
    resize axis, as OpenCV's ``resize`` sets them up: the source position
    ``(d + 0.5) * ssize / dsize - 0.5`` and its fraction in float64 (the
    weight then rounded to float32), clamped to the first and last pixel
    with weight 0 past them."""
    f = (np.arange(dsize) + 0.5) * (1.0 / (dsize / ssize)) - 0.5
    lo = np.floor(f).astype(np.int64)
    frac = (f - lo).astype(np.float32)
    frac[lo < 0] = 0
    lo[lo < 0] = 0
    last = lo >= ssize - 1
    frac[last] = 0
    lo[last] = ssize - 1
    return lo, np.minimum(lo + 1, ssize - 1), frac


class Resize(Transform):
    SHAPE_PRESERVING = False

    def __init__(self, size):
        self.size = _size(size)

    def __call__(self, x):
        th, tw = self.size
        h, w = x.shape[-3:-1]
        src = np.asarray(x, dtype=np.float32)
        x0, x1, ax = _linear_taps(w, tw)
        y0, y1, ay = _linear_taps(h, th)
        ax, ay = ax[:, None], ay[:, None, None]
        one = np.float32(1)
        rows = src[..., x0, :] * (one - ax) + src[..., x1, :] * ax
        out = rows[..., y0, :, :] * (one - ay) + rows[..., y1, :, :] * ay
        return out.astype(x.dtype, copy=False)


class RandomHorizontalFlip(Transform):
    def __init__(self, p=0.5, seed=0):
        self.p = p
        self.reset_rng(seed)

    def __call__(self, x):
        if self._rng.random() < self.p:
            return x[..., :, ::-1, :].copy()
        return x


class RandomVerticalFlip(Transform):
    def __init__(self, p=0.5, seed=0):
        self.p = p
        self.reset_rng(seed)

    def __call__(self, x):
        if self._rng.random() < self.p:
            return x[..., ::-1, :, :].copy()
        return x


def rotation_matrix(center, angle: float, scale: float = 1.0) -> np.ndarray:
    r"""``cv2.getRotationMatrix2D(center, angle, scale)``: 2x3, float64."""
    a = angle * math.pi / 180
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def warp_affine(img: np.ndarray, m: np.ndarray) -> np.ndarray:
    r"""``cv2.warpAffine(img, m, (w, h))`` of ``[..., h, w, c]`` float32
    frames: each output pixel samples the source at the inverse of ``m``
    (OpenCV's inversion, in float64), bilinearly with float32 weights, with
    zeros outside the image."""
    h, w = img.shape[-3:-1]
    m = np.asarray(m, dtype=np.float64).reshape(6).copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    m[2], m[5] = -m[0] * m[2] - m[1] * m[5], -m[3] * m[2] - m[4] * m[5]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    fx = m[0] * xs + m[1] * ys + m[2]
    fy = m[3] * xs + m[4] * ys + m[5]
    sx, sy = np.floor(fx), np.floor(fy)
    wx, wy = (fx - sx).astype(np.float32), (fy - sy).astype(np.float32)
    sx, sy = sx.astype(np.int64), sy.astype(np.int64)
    one = np.float32(1)
    weights = ((one - wy) * (one - wx), (one - wy) * wx, wy * (one - wx), wy * wx)

    src = np.asarray(img, dtype=np.float32)
    out = np.zeros(src.shape, dtype=np.float32)
    for (dy, dx), wt in zip(((0, 0), (0, 1), (1, 0), (1, 1)), weights):
        py, px = sy + dy, sx + dx
        inside = (py >= 0) & (py < h) & (px >= 0) & (px < w)
        tap = src[..., np.clip(py, 0, h - 1), np.clip(px, 0, w - 1), :]
        out = out + np.where(inside[..., None], tap, np.float32(0)) * wt[..., None]
    return out


class RandomRotation(Transform):
    r"""Rotates by a random angle in [-degrees, degrees] (bilinear, zero-fill)."""

    def __init__(self, degrees, seed=0):
        self.degrees = degrees
        self.reset_rng(seed)

    def __call__(self, x):
        angle = float(self._rng.uniform(-self.degrees, self.degrees))
        h, w = x.shape[-3:-1]
        return warp_affine(x, rotation_matrix((w / 2, h / 2), angle, 1.0)).astype(x.dtype,
                                                                                 copy=False)


#: OpenCV's fixed kernels for odd sizes up to 9 when sigma <= 0
SMALL_GAUSSIAN = {1: (1.0,), 3: (0.25, 0.5, 0.25), 5: (0.0625, 0.25, 0.375, 0.25, 0.0625),
                  7: (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125),
                  9: tuple(v / 256 for v in (4, 13, 30, 51, 60, 51, 30, 13, 4))}


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    r"""``cv2.getGaussianKernel(ksize, sigma, cv2.CV_32F)``: the taps in
    float64, normalised, then rounded to float32; sigma <= 0 takes OpenCV's
    fixed kernel of that size, else its ``0.3 * ((ksize - 1) * 0.5 - 1) + 0.8``."""
    if sigma <= 0 and ksize in SMALL_GAUSSIAN:
        return np.array(SMALL_GAUSSIAN[ksize], dtype=np.float32)
    sigma = sigma if sigma > 0 else ((ksize - 1) * 0.5 - 1) * 0.3 + 0.8
    scale2 = -0.5 / (sigma * sigma)
    taps = [math.exp(scale2 * (i - (ksize - 1) * 0.5) ** 2) for i in range(ksize)]
    total = sum(taps)
    return np.array([t / total for t in taps], dtype=np.float32)


def _reflect_101(n: int, pad: int):
    r"""Source indices of a ``pad``-wide ``BORDER_REFLECT_101`` border on each
    side of an axis of ``n``."""
    idx = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.abs(idx) % period
    return np.where(idx >= n, period - idx, idx)


class GaussianBlur(Transform):
    def __init__(self, kernel_size=3, sigma=1.0):
        self.kernel_size = kernel_size
        self.sigma = sigma

    def __call__(self, x):
        k = self.kernel_size
        taps = gaussian_kernel(k, self.sigma)
        h, w = x.shape[-3:-1]
        pad = k // 2
        src = np.asarray(x, dtype=np.float32)
        cols = src[..., _reflect_101(w, pad), :]
        rows = taps[0] * cols[..., :, 0:w, :]
        for i in range(1, k):
            rows = rows + taps[i] * cols[..., :, i:i + w, :]
        rows = rows[..., _reflect_101(h, pad), :, :]
        out = taps[0] * rows[..., 0:h, :, :]
        for i in range(1, k):
            out = out + taps[i] * rows[..., i:i + h, :, :]
        return out.astype(x.dtype, copy=False)


class Grayscale(Transform):
    def __call__(self, x):
        gray = x[..., :3] @ np.array([0.299, 0.587, 0.114], dtype=np.float32)
        return np.repeat(gray[..., None], x.shape[-1], axis=-1)


class RandomGrayscale(Transform):
    def __init__(self, p=0.1, seed=0):
        self.p = p
        self._gray = Grayscale()
        self.reset_rng(seed)

    def __call__(self, x):
        if self._rng.random() < self.p:
            return self._gray(x)
        return x


CROPS = [CenterCrop, RandomCrop]
SHAPE_PRESERVING_AUGMENTATIONS = [
    RandomHorizontalFlip, RandomVerticalFlip, RandomRotation, GaussianBlur,
    Grayscale, RandomGrayscale,
]


def _area_weights(ssize: int, dsize: int, scale: float):
    r"""``(dst, src, weight)`` triples of an area-averaging axis, in the order
    and with the float32 weights of OpenCV's ``computeResizeAreaTab``."""
    tab = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx2 = min(math.floor(fsx2), ssize - 1)
        sx1 = min(math.ceil(fsx1), sx2)
        if sx1 - fsx1 > 1e-3:
            tab.append((dx, sx1 - 1, np.float32((sx1 - fsx1) / cell)))
        for sx in range(sx1, sx2):
            tab.append((dx, sx, np.float32(1.0 / cell)))
        if fsx2 - sx2 > 1e-3:
            tab.append((dx, sx2, np.float32(min(fsx2 - sx2, 1.0, cell) / cell)))
    return tab


def area_resize(img: np.ndarray, size) -> np.ndarray:
    r"""Shrinks one ``[h, w]`` uint8 or float64 image to ``size = (h', w')``
    by area averaging, as ``cv2.resize(img, (w', h'), interpolation=
    cv2.INTER_AREA)`` does, with its arithmetic: at integer factors the
    block sums (uint8: int sums times a float32 1/area, rounded half to even;
    at 2x2, ``(sum + 2) >> 2``, which OpenCV's vector path computes), else
    per-axis weight tables (float32 weights, sums in float32 for uint8 and in
    float64 for float64). Only shrinking is supported."""
    src = np.asarray(img)
    if src.ndim != 2 or src.dtype not in (np.uint8, np.float64):
        raise ValueError(f"area_resize takes one [h, w] uint8 or float64 image, "
                         f"not {src.shape} {src.dtype}")
    sh, sw = src.shape
    dh, dw = size
    if dh > sh or dw > sw:
        raise ValueError(f"area_resize only shrinks ({sh}x{sw} -> {dh}x{dw})")
    fy, fx = sh / dh, sw / dw
    u8 = src.dtype == np.uint8
    if fy == int(fy) and fx == int(fx):
        fy, fx = int(fy), int(fx)
        area = fy * fx
        blocks = src.reshape(dh, fy, dw, fx).transpose(0, 2, 1, 3).reshape(dh, dw, area)
        if u8:
            sums = blocks.astype(np.int64).sum(-1)
            if area == 4:
                return ((sums + 2) >> 2).astype(np.uint8)
            out = np.rint(sums.astype(np.float32) * np.float32(1.0 / area))
            return np.clip(out, 0, 255).astype(np.uint8)
        acc = np.zeros((dh, dw))
        k = 0
        while k + 4 <= area:   # OpenCV adds four taps at a time, left to right
            acc = acc + (((blocks[..., k] + blocks[..., k + 1]) + blocks[..., k + 2])
                         + blocks[..., k + 3])
            k += 4
        for k in range(k, area):
            acc = acc + blocks[..., k]
        return acc * float(np.float32(1.0 / area))
    wt = np.float32 if u8 else np.float64
    xtab, ytab = _area_weights(sw, dw, fx), _area_weights(sh, dh, fy)
    out = np.zeros((dh, dw), wt)
    acc = np.zeros(dw, wt)
    prev = ytab[0][0]
    for dy, sy, beta in ytab:
        row = src[sy].astype(wt)
        buf = np.zeros(dw, wt)
        for dx, sx, alpha in xtab:
            buf[dx] = buf[dx] + row[sx] * wt(alpha)
        if dy != prev:
            out[prev] = acc
            acc = wt(beta) * buf
            prev = dy
        else:
            acc = acc + wt(beta) * buf
    out[prev] = acc
    if u8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out
