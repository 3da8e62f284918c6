r"""The port's PNG reader (``vp_suite_tpu_torch/utils/image_io.py``) against
``imageio.v2.imread`` (what the JAX package's KTH reads) and ``cv2.imread``
turned to RGB (KITTI, SynPick), bit for bit.

- Files of this test's own encoder: colour types 0, 2, 3 (with and without a
  transparency chunk), 4 and 6, each with every row filter forced (None, Sub,
  Up, Average, Paeth, and all five in turn), the image data split over
  several IDAT chunks.
- Files written by cv2 and by PIL (their own choices of filters), grey, RGB,
  palette, grey with alpha and RGBA.
- The native un-filtering equals the plain numpy version.
- 16-bit, interlaced, sub-byte, truncated and corrupt files and unknown filter
  types raise ``ValueError``.
"""
import struct
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import torch
from PIL import Image

from vp_suite_tpu_torch.native import png_unfilter_native
from vp_suite_tpu_torch.utils.image_io import read_png, unfilter_reference

torch.set_num_threads(1)

COLOR_TYPES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
FILTERS = {"none": [0], "sub": [1], "up": [2], "average": [3], "paeth": [4],
           "cycle": [0, 1, 2, 3, 4]}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(img: np.ndarray, kinds) -> bytes:
    r"""PNG filtering of ``[h, stride]`` bytes with the per-pixel distance
    ``bpp``: row y gets filter ``kinds[y % len(kinds)]``."""
    h, stride, bpp = img.shape[0], img.shape[1], img.shape[2]
    raw = img.reshape(h, stride * bpp).astype(np.int64)
    out = bytearray()
    prev = np.zeros_like(raw[0])
    for y in range(h):
        x = raw[y]
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        kind = kinds[y % len(kinds)]
        pred = [0, a, prev, (a + prev) >> 1, _paeth(a, prev, c)][kind]
        out.append(kind)
        out += ((x - pred) % 256).astype(np.uint8).tobytes()
        prev = x
    return bytes(out)


def chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def write_png(fp, pixels, ctype, kinds=(0,), palette=None, trns=None, depth=8, interlace=0,
              idat_parts=3):
    r"""Writes ``pixels`` (``[h, w, channels]`` uint8) as a PNG of colour type
    ``ctype`` with the row filters ``kinds``, the IDAT stream in parts."""
    h, w = pixels.shape[:2]
    body = filter_rows(pixels, list(kinds))
    data = zlib.compress(body, 6)
    cut = [len(data) * k // idat_parts for k in range(idat_parts + 1)]
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                           interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    for k in range(idat_parts):
        out += chunk(b"IDAT", data[cut[k]:cut[k + 1]])
    out += chunk(b"IEND", b"")
    with open(fp, "wb") as f:
        f.write(out)


def _image(ctype, h=9, w=13, seed=0):
    rng = np.random.default_rng(seed)
    if ctype == 3:
        return rng.integers(0, 40, (h, w, 1), dtype=np.uint8)
    return rng.integers(0, 256, (h, w, COLOR_TYPES[ctype]), dtype=np.uint8)


@pytest.mark.parametrize("filters", list(FILTERS))
@pytest.mark.parametrize("ctype", [0, 2, 3, 4, 6])
def test_own_encoder_matches_imageio_and_cv2(tmp_path, ctype, filters):
    pixels = _image(ctype, seed=ctype)
    palette = np.random.default_rng(1).integers(0, 256, (40, 3)) if ctype == 3 else None
    fp = tmp_path / f"t{ctype}_{filters}.png"
    write_png(fp, pixels, ctype, FILTERS[filters], palette=palette)
    want = imageio.imread(fp)
    got = read_png(fp)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    want_rgb = cv2.cvtColor(cv2.imread(str(fp)), cv2.COLOR_BGR2RGB)
    got_rgb = read_png(fp, color=True)
    assert got_rgb.shape == want_rgb.shape == (9, 13, 3)
    np.testing.assert_array_equal(got_rgb, want_rgb)
    if ctype != 3:   # what was encoded comes back
        np.testing.assert_array_equal(got.reshape(pixels.shape), pixels)


def test_palette_with_transparency(tmp_path):
    pixels = _image(3, seed=5)
    palette = np.random.default_rng(2).integers(0, 256, (40, 3))
    fp = tmp_path / "p.png"
    write_png(fp, pixels, 3, FILTERS["cycle"], palette=palette, trns=bytes(range(0, 200, 9)))
    np.testing.assert_array_equal(read_png(fp), imageio.imread(fp))
    np.testing.assert_array_equal(read_png(fp, color=True),
                                  cv2.cvtColor(cv2.imread(str(fp)), cv2.COLOR_BGR2RGB))


def test_files_written_by_cv2_and_pil(tmp_path):
    rng = np.random.default_rng(3)
    smooth = np.cumsum(rng.integers(0, 3, (24, 40, 3)), axis=1).astype(np.uint8)
    files = []
    for name, img in (("noise", rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)),
                      ("smooth", smooth)):
        for level in (0, 3, 9):
            fp = tmp_path / f"cv2_{name}_{level}.png"
            cv2.imwrite(str(fp), img, [cv2.IMWRITE_PNG_COMPRESSION, level])
            files.append(fp)
        fp = tmp_path / f"cv2_{name}_grey.png"
        cv2.imwrite(str(fp), img[..., 0])
        files.append(fp)
        for mode, arr in (("L", img[..., 0]), ("RGB", img), ("LA", img[..., :2]),
                          ("RGBA", np.concatenate([img, img[..., :1]], axis=-1))):
            fp = tmp_path / f"pil_{name}_{mode}.png"
            Image.fromarray(arr, mode).save(fp)
            files.append(fp)
        fp = tmp_path / f"pil_{name}_P.png"
        Image.fromarray(img, "RGB").quantize(200).save(fp)   # 8-bit palette
        files.append(fp)
    for fp in files:
        np.testing.assert_array_equal(read_png(fp), imageio.imread(fp), err_msg=str(fp))
        np.testing.assert_array_equal(read_png(fp, color=True),
                                      cv2.cvtColor(cv2.imread(str(fp)), cv2.COLOR_BGR2RGB),
                                      err_msg=str(fp))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_native_unfilter_equals_numpy(bpp):
    rng = np.random.default_rng(bpp)
    h, w = 11, 17
    pixels = rng.integers(0, 256, (h, w, bpp), dtype=np.uint8)
    for kinds in FILTERS.values():
        body = np.frombuffer(filter_rows(pixels, kinds), dtype=np.uint8)
        want = unfilter_reference(body, h, w * bpp, bpp)
        got = png_unfilter_native(body, h, w * bpp, bpp)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got.reshape(h, w, bpp), pixels)
    # arbitrary filtered bytes too, every filter type at random
    body = rng.integers(0, 256, (h, w * bpp + 1), dtype=np.uint8)
    body[:, 0] = rng.integers(0, 5, h)
    np.testing.assert_array_equal(png_unfilter_native(body.reshape(-1), h, w * bpp, bpp),
                                  unfilter_reference(body.reshape(-1), h, w * bpp, bpp))


def test_refuses_what_it_does_not_read(tmp_path):
    grey = _image(0)
    cases = {"bit depth 16": dict(depth=16), "interlaced": dict(interlace=1),
             "bit depth 4": dict(depth=4)}
    for what, kw in cases.items():
        fp = tmp_path / f"{what}.png"
        write_png(fp, grey, 0, **kw)
        with pytest.raises(ValueError, match=what.split()[0]):
            read_png(fp)
    fp16 = tmp_path / "pil16.png"
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000).save(fp16)
    with pytest.raises(ValueError, match="bit depth 16"):
        read_png(fp16)
    fp = tmp_path / "ok.png"
    write_png(fp, grey, 0)
    buf = fp.read_bytes()
    (tmp_path / "crc.png").write_bytes(buf[:40] + bytes([buf[40] ^ 1]) + buf[41:])
    (tmp_path / "short.png").write_bytes(buf[:-20])
    (tmp_path / "none.png").write_bytes(b"GIF89a" + buf)
    for name, match in (("crc", "CRC"), ("short", "IEND|truncated"), ("none", "not a PNG")):
        with pytest.raises(ValueError, match=match):
            read_png(tmp_path / f"{name}.png")
    body = np.frombuffer(filter_rows(grey, [0]), dtype=np.uint8).copy()
    body[(grey.shape[1] + 1) * 2] = 7
    for unfilter in (png_unfilter_native, unfilter_reference):
        with pytest.raises(ValueError, match="filter type 7"):
            unfilter(body, grey.shape[0], grey.shape[1], 1)
