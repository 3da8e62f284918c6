r"""The port's PNG reader: the standard library's ``zlib`` inflates the image
data, and the native library (``native/png_unfilter.c``) undoes the row
filters.

The file-backed datasets of the JAX package decode their frames with
``imageio`` (KTH) and ``cv2`` (KITTI, SynPick); the card's machine has
neither, so :func:`read_png` returns what they return:

- ``read_png(fp)``, as ``imageio.v2.imread(fp)``: greyscale ``[h, w]``, grey
  with alpha ``[h, w, 2]``, RGB and palette images ``[h, w, 3]`` (a palette's
  transparency is dropped), RGBA ``[h, w, 4]``;
- ``read_png(fp, color=True)``, as ``cv2.cvtColor(cv2.imread(fp),
  cv2.COLOR_BGR2RGB)``: always RGB ``[h, w, 3]``, grey repeated, palettes
  expanded, alpha dropped.

Bit depth 8 with colour types 0, 2, 3, 4 and 6, not interlaced, is read;
anything else raises ``ValueError``, as does a chunk whose CRC is wrong.
:func:`unfilter_reference` is the plain numpy version of the un-filtering.
"""
import struct
import zlib

import numpy as np

from vp_suite_tpu_torch.native import png_unfilter_native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: channels of each colour type: grey, RGB, palette index, grey + alpha, RGBA
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(buf: bytes, fp):
    r"""``(type, data)`` of each chunk, the CRC checked."""
    pos = len(SIGNATURE)
    while pos + 12 <= len(buf):
        (length,) = struct.unpack(">I", buf[pos:pos + 4])
        kind = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + length]
        crc = buf[pos + 8 + length:pos + 12 + length]
        if len(crc) != 4 or zlib.crc32(kind + data) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{fp}: PNG chunk {kind!r} is truncated or its CRC is wrong")
        yield kind, data
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError(f"{fp}: PNG ends without an IEND chunk")


def unfilter_reference(data: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    r"""The plain numpy un-filtering: ``[height, stride]`` uint8 image bytes
    from ``height`` rows of a filter-type byte and ``stride`` filtered bytes;
    ``bpp`` is the bytes per pixel (the "left" distance)."""
    rows = np.asarray(data, dtype=np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.int64)
    for y in range(height):
        kind, x = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if kind == 0:
            row = x
        elif kind == 1:   # Sub: a running sum over each byte lane
            lanes = np.zeros(-(-stride // bpp) * bpp, dtype=np.int64)
            lanes[:stride] = x
            row = (lanes.reshape(-1, bpp).cumsum(axis=0).reshape(-1)[:stride]) % 256
        elif kind == 2:   # Up
            row = (x + prev) % 256
        elif kind in (3, 4):   # Average, Paeth: byte by byte
            row = np.zeros(stride, dtype=np.int64)
            for i in range(stride):
                a = row[i - bpp] if i >= bpp else 0
                b = prev[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                row[i] = (x[i] + pred) % 256
        else:
            raise ValueError(f"PNG row {y} has filter type {kind}, not one of 0-4")
        out[y] = row
        prev = row
    return out


def read_png(fp, color: bool = False) -> np.ndarray:
    r"""The uint8 pixels of the PNG file ``fp``: as ``imageio.v2.imread``
    gives them, or with ``color``, as cv2 reads them in colour, turned to RGB
    (see the module's docstring)."""
    with open(fp, "rb") as f:
        buf = f.read()
    if not buf.startswith(SIGNATURE):
        raise ValueError(f"{fp}: not a PNG file")
    header, palette, idat = None, None, []
    for kind, data in _chunks(buf, fp):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            palette = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(data)
    if header is None:
        raise ValueError(f"{fp}: PNG without an IHDR chunk")
    width, height, depth, ctype, compression, filtering, interlace = header
    if depth != 8:
        raise ValueError(f"{fp}: PNG of bit depth {depth}; only 8 is read")
    if ctype not in CHANNELS:
        raise ValueError(f"{fp}: PNG of colour type {ctype}, not one of {sorted(CHANNELS)}")
    if interlace != 0:
        raise ValueError(f"{fp}: interlaced PNG; only non-interlaced files are read")
    if compression != 0 or filtering != 0:
        raise ValueError(f"{fp}: PNG of compression method {compression} and filter method "
                         f"{filtering}; only 0 and 0 are defined")
    if ctype == 3 and palette is None:
        raise ValueError(f"{fp}: palette PNG without a PLTE chunk")
    channels = CHANNELS[ctype]
    stride = width * channels
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    except zlib.error as e:
        raise ValueError(f"{fp}: PNG image data does not inflate ({e})") from None
    if raw.size != height * (stride + 1):
        raise ValueError(f"{fp}: {raw.size} bytes of image data, not {height} rows of "
                         f"1 + {stride}")
    img = png_unfilter_native(raw, height, stride, channels).reshape(height, width, channels)

    if ctype == 3:
        if int(img.max(initial=0)) >= len(palette):
            raise ValueError(f"{fp}: palette index past the {len(palette)} PLTE entries")
        return palette[img[..., 0]]
    if not color:
        return img[..., 0] if channels == 1 else img
    if channels <= 2:
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])
