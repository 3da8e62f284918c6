r"""Builds and loads the port's CUDA C++ kernels.

Each ``csrc/*.cu`` source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with :mod:`ctypes`. The build
happens at first use, into ``kernels/_build/`` (listed in ``.gitignore``); the
library's file name carries a hash of its source and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. Nothing is compiled
while a module is imported. :func:`build_all` starts one ``nvcc`` per source,
all at once, and waits for them together.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")


def find_nvcc() -> str:
    r"""The ``nvcc`` on ``PATH``, else the one under ``$CUDA_HOME`` or
    ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (looked on PATH, in $CUDA_HOME and /usr/local/cuda); "
                       "the port's CUDA kernels are built from source at first use")


def library_path(source: str) -> Path:
    r"""Where the library built from ``csrc/<source>`` goes (the name hashes
    the source, the shared headers ``csrc/*.cuh`` and the flags)."""
    src = CSRC / source
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_all(sources=None, verbose: bool = False) -> dict:
    r"""Compiles each of ``sources`` (names under ``csrc/``; default: every
    ``*.cu`` there) whose library is not built yet, one ``nvcc`` process per
    source, all started together; returns ``{source: library path}``.
    ``verbose`` rebuilds with ``-Xptxas -v`` and prints what the compiler says
    (registers, shared memory, spills)."""
    if sources is None:
        sources = sorted(p.name for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs, jobs = {}, []
    try:
        for source in sources:
            out = outs[source] = library_path(source)
            if out.exists() and not verbose:
                continue
            # build into a private file, then rename: a concurrent build never loads half a library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [find_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
                   "-o", tmp, str(CSRC / source)]
            jobs.append((source, cmd, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        for source, cmd, tmp, proc in jobs:
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {source} ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{log}")
            if verbose:
                print(log, end="")
            os.replace(tmp, outs[source])
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return outs


_VP, _INT = ctypes.c_void_p, ctypes.c_int


def _scan_signature(n_pointers: int) -> list:
    r"""``int fn(int is_bf16, <n_pointers pointers>, int T, int b, int sh, int sw,
    int enc, void* stream)``: the scan kernels' entry points."""
    return [_INT] + [_VP] * n_pointers + [_INT] * 5 + [_VP]


def _warp_signature(n_pointers: int) -> list:
    r"""``int fn(int is_bf16, <n_pointers pointers>, int b, int P, int L, int h,
    int w, int c, void* stream)``: the warp kernels' entry points."""
    return [_INT] + [_VP] * n_pointers + [_INT] * 6 + [_VP]


def _load(source: str, functions: dict) -> ctypes.CDLL:
    r"""Builds ``csrc/<source>`` if needed and loads it, declaring each entry
    point of ``functions`` (``{name: argtypes}``, each returning an ``int``
    cudaError_t) and ``vp_cuda_error_string``."""
    lib = ctypes.CDLL(str(build_all([source])[source]))
    for fn, argtypes in functions.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _INT
    lib.vp_cuda_error_string.argtypes = [_INT]
    lib.vp_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def scan_library() -> ctypes.CDLL:
    r"""The ConvLSTM forward scan library (``csrc/convlstm_scan.cu``: K3 and
    K3s), built on first call."""
    return _load("convlstm_scan.cu", {"vp_convlstm_scan_fwd": _scan_signature(11)})


@functools.cache
def scan_bwd_library() -> ctypes.CDLL:
    r"""The ConvLSTM scan backward library (``csrc/convlstm_scan_bwd.cu``:
    K4), built on first call."""
    return _load("convlstm_scan_bwd.cu", {"vp_convlstm_scan_bwd": _scan_signature(11)})


@functools.cache
def warp_library() -> ctypes.CDLL:
    r"""The multi-flow bilinear warp library (``csrc/warp_sample.cu``: its
    forward and backward), built on first call. ``int fn(int is_bf16,
    <pointers>, int b, int P, int L, int h, int w, int c, int row0, void*
    stream)``."""
    return _load("warp_sample.cu", {"vp_warp_sample_fwd": [_INT] + [_VP] * 4 + [_INT] * 7 + [_VP],
                                    "vp_warp_sample_bwd": [_INT] + [_VP] * 7 + [_INT] * 7 + [_VP]})


@functools.cache
def warp_ret_library() -> ctypes.CDLL:
    r"""The fused warp + ``ret`` library (``csrc/warp_ret.cu``: K8's forward
    and backward), built on first call. ``int fn(int is_bf16, <pointers>,
    [int n_slices,] int b, int P, int L, int h, int w, int f, int O, void*
    stream)``, and ``vp_warp_ret_geometry``, the bf16 kernels' plan."""
    lib = _load("warp_ret.cu", {"vp_warp_ret_fwd": [_INT] + [_VP] * 6 + [_INT] * 7 + [_VP],
                                "vp_warp_ret_bwd": [_INT] + [_VP] * 10 + [_INT] * 8 + [_VP]})
    lib.vp_warp_ret_geometry.argtypes = [_INT] * 8 + [ctypes.POINTER(ctypes.c_int64)]
    lib.vp_warp_ret_geometry.restype = _INT
    return lib


@functools.cache
def warp_contract_library() -> ctypes.CDLL:
    r"""The prebuilt-factor warp library (``csrc/warp_contract.cu``: K9's
    forward and backward), built on first call. ``int fn(int is_bf16,
    <pointers>, int b, int L, int P, int h, int w, int c, void* stream)``, and
    ``vp_warp_contract_geometry``, the bf16 kernels' plan."""
    lib = _load("warp_contract.cu", {"vp_warp_contract_fwd": _warp_signature(4),
                                     "vp_warp_contract_bwd": _warp_signature(8)})
    lib.vp_warp_contract_geometry.argtypes = [_INT] * 6 + [ctypes.POINTER(ctypes.c_int64)]
    lib.vp_warp_contract_geometry.restype = _INT
    return lib


@functools.cache
def sym_eig_library() -> ctypes.CDLL:
    r"""The batched symmetric eigensolver library (``csrc/sym_eig.cu``: E1),
    built on first call. ``int vp_sym_eig(m, w, v, scratch, int batch, int n,
    void* stream)``."""
    return _load("sym_eig.cu", {"vp_sym_eig": [_VP] * 4 + [_INT] * 2 + [_VP]})
