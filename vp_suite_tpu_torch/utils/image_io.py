r"""The port's image files: a PNG reader (the standard library's ``zlib``
inflates the image data, and the native library (``native/png_unfilter.c``)
undoes the row filters), and the PNG and GIF writers of the visualisations
(:func:`write_png`, :func:`write_gif`, with :func:`read_gif` to read GIFs
back).

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


# ---- writers: PNG and GIF, for the visualisations ---------------------------------------------

PNG_COLOR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}   #: channels -> PNG colour type
GIF_COLORS = 256        #: a GIF frame's colour table holds at most this many
KMEANS_ROUNDS = 4       #: k-means rounds that refine a median-cut palette


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def write_png(fp, img) -> None:
    r"""Writes uint8 pixels ``[h, w]`` or ``[h, w, c]`` (c = 1 grey, 2 grey
    with alpha, 3 RGB, 4 RGBA) to the PNG file ``fp``: 8 bits a sample, every
    row unfiltered, the image data deflated by ``zlib`` into one IDAT chunk.
    :func:`read_png` (and any PNG reader) returns the same pixels."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 pixels, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in PNG_COLOR_TYPES or not img.shape[0] * img.shape[1]:
        raise ValueError(f"write_png takes [h, w] or [h, w, 1-4] pixels, not {img.shape}")
    h, w, c = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, PNG_COLOR_TYPES[c], 0, 0, 0)
    with open(fp, "wb") as f:
        f.write(SIGNATURE + _png_chunk(b"IHDR", header)
                + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _png_chunk(b"IEND", b""))


def quantize(frame):
    r"""``(palette [k, 3] uint8, indices [h, w] uint8)`` of an RGB uint8
    frame with at most ``GIF_COLORS`` colours. A frame with that many distinct
    colours or fewer keeps them exactly; a frame with more gets a palette by
    median cut over its colours (weighted by their pixel counts), refined by
    ``KMEANS_ROUNDS`` rounds of k-means, and each pixel the nearest palette
    entry (no dithering, so each pixel's error is as small as the palette
    allows)."""
    frame = np.asarray(frame, dtype=np.uint8)
    packed = (frame[..., 0].astype(np.int64) << 16) | (frame[..., 1].astype(np.int64) << 8) \
        | frame[..., 2]
    uniq, inverse, counts = np.unique(packed.reshape(-1), return_inverse=True, return_counts=True)
    rgb = np.stack([uniq >> 16, (uniq >> 8) & 255, uniq & 255], axis=1).astype(np.float64)
    if len(uniq) <= GIF_COLORS:
        return rgb.astype(np.uint8), inverse.reshape(frame.shape[:2]).astype(np.uint8)
    def span(box):
        return np.ptp(rgb[box], axis=0) if len(box) > 1 else np.full(3, -1.0)

    boxes = [np.arange(len(uniq))]
    spans = [span(boxes[0])]
    widest = [spans[0].max()]
    while len(boxes) < GIF_COLORS:
        k = int(np.argmax(widest))
        if widest[k] <= 0:
            break
        box, axis = boxes.pop(k), int(np.argmax(spans.pop(k)))
        widest.pop(k)
        box = box[np.argsort(rgb[box, axis], kind="stable")]
        cum = np.cumsum(counts[box])
        cut = int(np.clip(np.searchsorted(cum, cum[-1] / 2.0), 0, len(box) - 2)) + 1
        for part in (box[:cut], box[cut:]):
            boxes.append(part)
            spans.append(span(part))
            widest.append(spans[-1].max())
    palette = np.stack([np.average(rgb[b], axis=0, weights=counts[b]) for b in boxes])
    for step in range(KMEANS_ROUNDS + 1):
        nearest = _nearest(rgb, palette)
        if step == KMEANS_ROUNDS:
            break
        weight = np.bincount(nearest, weights=counts, minlength=len(palette))
        sums = np.stack([np.bincount(nearest, weights=counts * rgb[:, ch], minlength=len(palette))
                         for ch in range(3)], axis=1)
        used = weight > 0
        palette[used] = sums[used] / weight[used, None]
    palette = np.clip(np.rint(palette), 0, 255)
    nearest = _nearest(rgb, palette)
    return palette.astype(np.uint8), nearest[inverse].reshape(frame.shape[:2]).astype(np.uint8)


def _nearest(rgb, palette):
    r"""Index of the nearest palette entry (squared distance) of each colour,
    4096 colours at a time."""
    out = np.empty(len(rgb), dtype=np.int64)
    pp = (palette ** 2).sum(1)
    for s in range(0, len(rgb), 4096):
        part = rgb[s:s + 4096]
        out[s:s + 4096] = np.argmin(pp[None, :] - 2.0 * part @ palette.T, axis=1)
    return out


def _lzw_encode(indices: np.ndarray, min_size: int) -> bytes:
    r"""GIF's variable-width LZW of the palette indices, packed
    least-significant bit first, with a clear code at the start, whenever the
    table reaches 4096 codes, and an end code."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out, acc, nbits = bytearray(), 0, 0
    width = min_size + 1

    def emit(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    table, next_code = {}, end + 1
    emit(clear)
    data = indices.reshape(-1).tolist()
    prefix = data[0]
    for k in data[1:]:
        key = (prefix, k)
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            if next_code > (1 << width) and width < 12:
                width += 1
        else:
            emit(clear)
            table, next_code, width = {}, end + 1, min_size + 1
        prefix = k
    emit(prefix)
    emit(end)
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def write_gif(fp, frames, fps: float = 4) -> None:
    r"""Writes RGB uint8 frames (``[t, h, w, 3]``, or a list of ``[h, w,
    3]``; grey ``[h, w]`` or ``[h, w, 1]`` is repeated) as a looping GIF89a
    animation to ``fp``: a NETSCAPE2.0 block that loops for ever, each frame
    ``1000 / fps`` ms (in GIF's hundredths of a second) with its own colour
    table (:func:`quantize`: exact up to 256 colours) and LZW-compressed
    indices."""
    frames = [np.asarray(f, dtype=np.uint8) for f in frames]
    frames = [np.repeat(f.reshape(*f.shape[:2], -1)[..., :1], 3, axis=-1)
              if f.ndim == 2 or f.shape[-1] == 1 else f[..., :3] for f in frames]
    if not frames or any(f.shape != frames[0].shape for f in frames):
        raise ValueError("write_gif takes one or more frames of one shape")
    h, w, _ = frames[0].shape
    delay = int(round(100.0 / fps))
    out = bytearray(b"GIF89a" + struct.pack("<HHBBB", w, h, 0, 0, 0))
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"
    for frame in frames:
        palette, idx = quantize(frame)
        bits = max(1, int(np.ceil(np.log2(max(len(palette), 2)))))
        table = np.zeros((1 << bits, 3), np.uint8)
        table[:len(palette)] = palette
        out += b"\x21\xf9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00"
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x80 | (bits - 1)) + table.tobytes()
        min_size = max(2, bits)
        data = _lzw_encode(idx, min_size)
        out.append(min_size)
        for s in range(0, len(data), 255):
            block = data[s:s + 255]
            out += bytes([len(block)]) + block
        out.append(0)
    out.append(0x3B)
    with open(fp, "wb") as f:
        f.write(bytes(out))


def _lzw_decode(data: bytes, min_size: int, n: int) -> np.ndarray:
    clear, end = 1 << min_size, (1 << min_size) + 1
    acc = int.from_bytes(data, "little")
    pos, total = 0, len(data) * 8
    width = min_size + 1
    table = [(i,) for i in range(clear)] + [(), ()]
    out, prev = [], None
    while pos + width <= total:
        code = (acc >> pos) & ((1 << width) - 1)
        pos += width
        if code == clear:
            table, width, prev = table[:end + 1], min_size + 1, None
            continue
        if code == end:
            break
        if code < len(table):
            entry = table[code]
            if prev is not None:
                table.append(prev + entry[:1])
        elif prev is not None and code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError(f"GIF LZW code {code} past the table of {len(table)}")
        out.extend(entry)
        prev = entry
        if len(table) == (1 << width) and width < 12:
            width += 1
    if len(out) < n:
        raise ValueError(f"GIF frame data holds {len(out)} pixels, not {n}")
    return np.asarray(out[:n], dtype=np.uint8)


def read_gif(fp):
    r"""``(frames [t, h, w, 3] uint8, info)`` of a GIF file of full-size
    frames with colour tables, as :func:`write_gif` writes them; ``info``
    holds ``loop`` (the NETSCAPE2.0 count, None without the block) and
    ``delays_ms``. Raises ``ValueError`` on anything else."""
    with open(fp, "rb") as f:
        buf = f.read()
    if buf[:6] not in (b"GIF89a", b"GIF87a"):
        raise ValueError(f"{fp}: not a GIF file")
    w, h, packed = struct.unpack("<HHB", buf[6:11])
    pos = 13
    global_table = None
    if packed & 0x80:
        size = 3 << ((packed & 7) + 1)
        global_table = np.frombuffer(buf[pos:pos + size], np.uint8).reshape(-1, 3)
        pos += size
    frames, delays, loop, delay = [], [], None, 0

    def sub_blocks(pos):
        data = bytearray()
        while buf[pos]:
            data += buf[pos + 1:pos + 1 + buf[pos]]
            pos += 1 + buf[pos]
        return bytes(data), pos + 1

    while pos < len(buf):
        kind = buf[pos]
        if kind == 0x3B:
            return np.stack(frames) if frames else np.zeros((0, h, w, 3), np.uint8), \
                {"loop": loop, "delays_ms": delays}
        if kind == 0x21:
            label = buf[pos + 1]
            data, pos = sub_blocks(pos + 2)
            if label == 0xF9:
                delay = struct.unpack("<H", data[1:3])[0] * 10
            elif label == 0xFF and data[:11] == b"NETSCAPE2.0":
                loop = struct.unpack("<H", data[12:14])[0]
            continue
        if kind != 0x2C:
            raise ValueError(f"{fp}: unexpected GIF block 0x{kind:02x}")
        left, top, fw, fh, fpacked = struct.unpack("<HHHHB", buf[pos + 1:pos + 10])
        pos += 10
        if (left, top, fw, fh) != (0, 0, w, h) or fpacked & 0x40:
            raise ValueError(f"{fp}: only full-size, non-interlaced GIF frames are read")
        table = global_table
        if fpacked & 0x80:
            size = 3 << ((fpacked & 7) + 1)
            table = np.frombuffer(buf[pos:pos + size], np.uint8).reshape(-1, 3)
            pos += size
        if table is None:
            raise ValueError(f"{fp}: GIF frame without a colour table")
        min_size = buf[pos]
        data, pos = sub_blocks(pos + 1)
        frames.append(table[_lzw_decode(data, min_size, w * h)].reshape(h, w, 3))
        delays.append(delay)
    raise ValueError(f"{fp}: GIF ends without a trailer")
