r"""Host-side frame transforms over numpy ``[..., h, w, c]`` arrays, and the
area resize that shrinks Moving MNIST's digit templates.

Only what the on-the-fly Moving MNIST dataset reaches is ported: ``Compose``,
``Identity`` and ``Resize`` to the frames' own size, which the dataset's base
class puts in the chain when the frame size differs from the class's stored
one (and which is then the identity). A resize to another size, crops and
augmentations arrive with the file-backed datasets.
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


class Resize(Transform):
    SHAPE_PRESERVING = False

    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, x):
        if tuple(x.shape[-3:-1]) != self.size:
            raise NotImplementedError(
                f"resizing {tuple(x.shape[-3:-1])} frames to {self.size} is not ported yet "
                f"(it comes with the file-backed datasets)")
        return x


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
