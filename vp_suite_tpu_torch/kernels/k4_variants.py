r"""Variants of K4's bf16 kernel (``csrc/convlstm_scan_bwd.cu``) side by side on one CUDA card.

    python3 -m vp_suite_tpu_torch.kernels.k4_variants [--parent DIR] [VARIANT ...]

Each variant is K4's source with one named edit (:data:`EDITS`), compiled with
:mod:`~vp_suite_tpu_torch.kernels.build`'s flags into ``kernels/_build/variants/``
and called through the same C entry. The script checks every variant against
``convlstm_scan_backward_reference`` (largest error over the largest value of
dz, dh0 and dc0) and times it with CUDA events beside the unedited kernel at the
fused training path's six launch shapes (b=32, bf16, as ``chip_smoke.py``
drives them), in turns: parent, kernel, variants, parent. ``--parent`` names a
checkout of an earlier commit whose K4 is timed too (its C entry may lack
``dh_last``). The timing-only variants (``no_*``, ``products_only``) skip part
of the work and are wrong by design; the fault variants (``unflipped_taps``,
``ring_ahead``, ``ring_no_wait``) show how far a fault moves the result.
"""
import argparse
import ctypes
import subprocess
import time
from pathlib import Path

import torch

from vp_suite_tpu_torch.kernels import build
from vp_suite_tpu_torch.ops.convlstm import convlstm_scan_backward_reference

_MMA_SYNC_HELPERS = r'''
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(convlstm::smem_u32(p)) : "memory");
}
__device__ __forceinline__ void mma_16816(float* c, const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
               "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
'''
_WGMMA_LOOP = '''      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          Wgmma<NC>::mma(acc, a[k][tap],
                         wgmma_desc(sW + (tap * kq_n + 2 * (2 * chunk + k)) * NG * 64, NG * 128, 128));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
'''
_MMA_SYNC_LOOP = '''#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
#pragma unroll
          for (int j = 0; j < NG; ++j) {
            uint32_t b[2];
            ldmatrix_x2(b, sW + ((tap * kq_n + 2 * (2 * chunk + k) + ((lane >> 3) & 1)) * NG + j) * 64
                               + (lane & 7) * 8);
            mma_16816(acc + 4 * j, a[k][tap], b);
          }
'''
_FINISH = '''        if (t > 0)
          lt.finish(p, t - 1, j0, lane, acc);'''
_NO_FINISH = '''        if (t > 0 && p.T < 0)
          lt.finish(p, t - 1, j0, lane, acc);'''
_FETCH = [("      if (s < n_items) fetch(s);", "      if (p.T < 0) fetch(s);"),
          ("      if (it + STAGES - 1 < n_items) fetch(it + STAGES - 1);",
           "      if (p.T < 0) fetch(it + STAGES - 1);")]

#: name -> the (old, new) text replacements that make the variant; each old text
#: occurs exactly once in the kernel's source.
EDITS = {
    # the same fragments and accumulators through mma.sync m16n8k16 instead of wgmma
    "mma_sync": [('#include "convlstm_common.cuh"\n', '#include "convlstm_common.cuh"\n' + _MMA_SYNC_HELPERS),
                 (_WGMMA_LOOP, _MMA_SYNC_LOOP)],
    # no L2 prefetch of the epilogue's rows when a tile starts
    "no_l2_prefetch": [("        if (t > 0) lt.prefetch(p, t - 1, lane);\n", "")],
    # a five-stage ring (which leaves room for only 16 channels of weights at enc=96)
    "stages5": [("constexpr int STAGES = 4;", "constexpr int STAGES = 5;")],
    # timing only: skip the gate-backward epilogue of steps T-2 .. 0
    "no_epilogue": [(_FINISH, _NO_FINISH)],
    # timing only: skip the A fragments and the products
    "no_products": [(_WGMMA_LOOP, "      if (p.T < 0) {\n" + _WGMMA_LOOP + "      }\n"),
                    ("#pragma unroll\n      for (int k = 0; k < 2; ++k)\n#pragma unroll\n        for (int tap = 0; tap < 9; ++tap) load_a_tap",
                     "      if (p.T < 0)\n      for (int k = 0; k < 2; ++k)\n        for (int tap = 0; tap < 9; ++tap) load_a_tap")],
    # timing only: skip the ring's copies (the products read stale stages)
    "no_ring": _FETCH,
    # timing only: neither the ring's copies nor the epilogue
    "products_only": _FETCH + [(_FINISH, _NO_FINISH)],
    # faults: unflipped taps; the stage consumed is the one refilled in the same
    # iteration; the ring's cp.async wait dropped
    "unflipped_taps": [("load_a_tap(a[k][tap], stage, row, tap / 3, tap % 3, 16 * k, lane)",
                        "load_a_tap(a[k][tap], stage, row, 2 - tap / 3, 2 - tap % 3, 16 * k, lane)")],
    "ring_ahead": [("      const bf16* stage = ring + (it % STAGES) * (STAGE_BYTES / sizeof(bf16));",
                    "      const bf16* stage = ring + ((it + STAGES - 1) % STAGES) * (STAGE_BYTES / sizeof(bf16));")],
    "ring_no_wait": [("      cp_async_wait<STAGES - 2>();  // this thread's copies of stage `it` have landed\n", "")],
}

#: the fused training path's K4 launches (T, b, sh, sw, enc), in chip_smoke.py's order
SHAPES = [(5, 32, 64, 64, 64), (5, 32, 32, 32, 96), (5, 32, 16, 16, 96), (10, 32, 16, 16, 96),
          (10, 32, 32, 32, 96), (10, 32, 64, 64, 64)]
#: small shapes with ragged tiles, for the checks, and two of the six
CHECK = [(3, 2, 12, 20, 32), (2, 2, 7, 13, 96), SHAPES[0], SHAPES[1]]


def apply_edits(source: str, edits: dict, name: str) -> str:
    r"""The text of ``csrc/<source>`` with variant ``name``'s edits of ``edits``
    applied (none for a name it lacks); raises if a text to replace does not
    occur exactly once."""
    text = (build.CSRC / source).read_text()
    for old, new in edits.get(name, []):
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: the text to replace occurs {text.count(old)} times")
        text = text.replace(old, new)
    return text


def variant_source(name: str) -> str:
    return apply_edits("convlstm_scan_bwd.cu", EDITS, name)


def _declare_bwd(lib, text):
    n_ptr = 11 if "const void* dh_last" in text else 10
    lib.vp_convlstm_scan_bwd.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * n_ptr \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.vp_convlstm_scan_bwd.restype = ctypes.c_int
    return lib, n_ptr == 11


def build_variants(sources: dict, declare=_declare_bwd, subdir: str = "variants") -> dict:
    r"""``{name: (source text, include dir)}`` -> ``{name: declare(ctypes library,
    source text)}``, one ``nvcc`` per variant, all started together, into
    ``kernels/_build/<subdir>/``."""
    out_dir = build.BUILD_DIR / subdir
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (text, include) in sources.items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(include), "-o",
               str(out_dir / f"{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = declare(ctypes.CDLL(str(out_dir / f"{name}.so")), sources[name][0])
    return libs


def inputs(shape, gen):
    T, b, sh, sw, enc = shape
    dev = torch.device("cuda")

    def rnd(*s, scale=1.0):
        return (torch.randn(*s, generator=gen, device=dev) * scale).to(torch.bfloat16)

    return (rnd(T, b, sh, sw, 4 * enc), rnd(T, b, sh, sw, enc, scale=0.5),
            rnd(T, b, sh, sw, enc, scale=1e-2), rnd(b, sh, sw, enc, scale=1e-2),
            rnd(3, 3, enc, 4 * enc, scale=(9 * enc) ** -0.5),
            *[rnd(sh, sw, enc, scale=0.1) for _ in range(3)], rnd(b, sh, sw, enc, scale=1e-2))


def run(lib, a):
    fn, takes_dh_last = lib
    z, c_prev, dh_seq, dc_last, w, wci, wcf, wco, dh_last = a
    T, b, sh, sw, enc = c_prev.shape
    dc = dc_last.float()
    dz, dh0 = torch.empty_like(z), torch.empty(b, sh, sw, enc, device=z.device)
    ptrs = [z, c_prev, dh_seq] + ([dh_last] if takes_dh_last else []) \
        + [dc, w, wci, wcf, wco, dz, dh0]
    err = fn.vp_convlstm_scan_bwd(1, *[t.data_ptr() for t in ptrs], T, b, sh, sw, enc,
                                  torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K4 variant launch failed ({err})")
    return dz, dh0, dc


def event_ms(fn, warmup=2, iters=10):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="a checkout of an earlier commit, whose K4 is timed too")
    ap.add_argument("variants", nargs="*", help=f"any of {', '.join(EDITS)} (default: all)")
    args = ap.parse_args()
    unknown = [v for v in args.variants if v not in EDITS]
    if unknown:
        ap.error(f"unknown variants {unknown}")
    if not torch.cuda.is_available():
        raise SystemExit("k4_variants: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    sources = {"kernel": (variant_source("kernel"), build.CSRC)}
    sources.update({v: (variant_source(v), build.CSRC) for v in args.variants or EDITS})
    if args.parent:
        pcsrc = args.parent.resolve() / "vp_suite_tpu_torch" / "csrc"
        sources["parent"] = ((pcsrc / "convlstm_scan_bwd.cu").read_text(), pcsrc)
    t0 = time.time()
    libs = build_variants(sources)
    print(f"[build] {len(libs)} variants in {time.time() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in CHECK:
        a = inputs(shape, gen)
        want = convlstm_scan_backward_reference(*a)
        errs = []
        for name, lib in libs.items():
            if name == "parent":
                continue
            got = run(lib, a)
            torch.cuda.synchronize()
            e = [((g.float() - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want)]
            errs.append(f"{name} {max(e):.3g}")
        print(f"[check] {shape} largest error over the largest (dz, dh0, dc0): " + ", ".join(errs))
    order = (["parent"] if args.parent else []) + [n for n in libs if n != "parent"] \
        + (["parent"] if args.parent else [])
    totals = {}
    for shape in SHAPES:
        a = inputs(shape, gen)
        line = []
        for i, name in enumerate(order):
            ms = event_ms(lambda: run(libs[name], a))
            key = f"{name} (again)" if name == "parent" and i else name
            totals[key] = totals.get(key, 0.0) + ms
            line.append(f"{name} {ms:.3f}")
        print(f"[time] {shape} ms per launch: " + ", ".join(line))
    print("[time] per fused train step (the six launches): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in totals.items()))


if __name__ == "__main__":
    main()
