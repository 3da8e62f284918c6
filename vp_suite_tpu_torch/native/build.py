r"""Builds and binds the port's native host library.

``native/mmnist_gen.c`` (on-the-fly Moving MNIST's ``backend="native"``
generator) and ``native/png_unfilter.c`` (the PNG reader's row un-filtering)
are compiled together with the system C compiler (``$CC``, else ``cc``) into
one shared library, at first use, into ``native/_build/`` (listed in
``.gitignore``), and bound with :mod:`ctypes`. The library's name carries a
hash of the sources and flags, so an edited source is rebuilt. Concurrent
builds (loader threads, parallel processes) each write a file of their own
and rename it into place. There is no fallback: without a compiler
:func:`load_native` raises.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent
SOURCES = ("mmnist_gen.c", "png_unfilter.c")
BUILD_DIR = NATIVE_DIR / "_build"
CFLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def find_cc() -> str:
    r"""The C compiler: ``$CC``, else ``cc`` on ``PATH``; raises if neither exists."""
    cc = os.environ.get("CC", "cc")
    found = shutil.which(cc)
    if found is None:
        raise RuntimeError(f"no C compiler found ('{cc}'): the port's native library "
                           f"(MMF's backend='native', the PNG reader) is built from "
                           f"vp_suite_tpu_torch/native/*.c at first use")
    return found


def library_path() -> Path:
    r"""Where the library goes; its name hashes the sources and the flags."""
    digest = hashlib.sha256(b"".join((NATIVE_DIR / s).read_bytes() for s in SOURCES)
                            + " ".join(CFLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"vp_native-{digest}.so"


def _build() -> Path:
    so = library_path()
    if so.exists():
        return so
    cc = find_cc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = [cc, *CFLAGS, "-o", str(tmp), *(str(NATIVE_DIR / s) for s in SOURCES)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native library failed ({' '.join(cmd)}):\n"
                           f"{done.stderr}")
    os.replace(tmp, so)
    return so


def load_native():
    r"""The native library with typed signatures, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
            lib.generate_sequence.argtypes = [
                u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_uint64, f32p]
            lib.generate_sequence.restype = ctypes.c_int
            lib.png_unfilter.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                                         u8p]
            lib.png_unfilter.restype = ctypes.c_int64
            _lib = lib
    return _lib


def generate_sequence_native(digit_templates: np.ndarray, seq_len: int, img_size: int,
                             channels: int, num_digits: int, min_speed: int,
                             max_speed: int, seed: int) -> np.ndarray:
    r"""One ``[seq_len, img, img, channels]`` float32 sequence from the C
    generator; ``digit_templates``: ``[n, d, d]`` uint8."""
    digit_templates = np.ascontiguousarray(digit_templates, dtype=np.uint8)
    n, d, d2 = digit_templates.shape
    if d != d2:
        raise ValueError(f"digit templates must be square, not {d}x{d2}")
    out = np.empty((seq_len, img_size, img_size, channels), dtype=np.float32)
    rc = load_native().generate_sequence(digit_templates, n, d, seq_len, img_size, channels,
                                         num_digits, min_speed, max_speed,
                                         np.uint64(seed & 0xFFFFFFFFFFFFFFFF), out)
    if rc != 0:
        raise RuntimeError(f"the native generator failed (rc={rc}: at most 8 digits, "
                           f"no larger than the frame)")
    return out


def png_unfilter_native(data: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    r"""The ``[height, stride]`` uint8 image bytes of inflated PNG data
    (``height`` rows of a filter-type byte and ``stride`` filtered bytes)."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    if data.size != height * (stride + 1):
        raise ValueError(f"PNG data of {data.size} bytes, not {height} rows of 1 + {stride}")
    out = np.empty((height, stride), dtype=np.uint8)
    row = load_native().png_unfilter(data, height, stride, bpp, out)
    if row:
        raise ValueError(f"PNG row {row - 1} has filter type {data[(row - 1) * (stride + 1)]}, "
                         f"not one of 0-4")
    return out
