#!/usr/bin/env python3
r"""Runs the PyTorch port's serving path on one NVIDIA H100 and checks it.

    python3 chip_smoke.py        # from the repository root, on a machine with one CUDA card

Needs PyTorch built for CUDA, Triton and ``nvcc``; never imports JAX. It
builds the port's kernels from ``vp_suite_tpu_torch/csrc`` and then:

1. prints the card (``nvidia-smi`` name and power limit) and the versions;
2. holds K1, the ConvLSTM gate kernel (Triton), against
   ``convlstm_gate_reference`` at EF-ConvLSTM's three cell shapes, b=32;
3. holds K3, the whole-recurrence ConvLSTM scan kernel (CUDA C++), against
   ``convlstm_scan_reference`` at the same shapes, in decode mode (T=10) and
   with a precomputed input half (T=5);
4. drives the serving path: ``VPSuite()`` -> ``create_model("convlstm-shi")``
   at 64x64 RGB in bf16 -> ``predict(32 x 5 frames, pred_frames=10)``, once
   per-step (K1) and once with ``use_fused_scan`` (K3), with the kernels'
   launch counts set to 0 just before and read just after; checks the
   predictions, and at b=2 holds them against the same weights run on the CPU
   in f32;
5. times each kernel at the shapes the serving path gives it, beside its
   plain version and its bound, and times ``predict``.

Any failed check exits non-zero before the result lines. The last two lines
of standard output are the kernels' JSON line and the result JSON line.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# One H100 SXM (NVIDIA's data sheet, dense rates at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12
#: f32 operations per element of the gate block: three sigmoids and two tanhs
#: (each counted as 4) plus the peephole products, the cell update and h.
GATE_OPS_PER_ELEMENT = 30

B = 32                      # serving batch
CTX, PRED = 5, 10           # context and predicted frames
IMG = (3, 64, 64)           # (c, h, w)
SEED = 0
#: (side, channels) of EF-ConvLSTM's recurrent cells at 64x64.
CELLS = ((64, 64), (32, 96), (16, 96))
CONFIGS = {
    "per_step": {},
    "fused_scan": dict(use_fused_scan=True, interleaved_encode=False,
                       interleaved_forecast=False),
}

# Tolerances, with their reasons.
#: K1 f32: the same f32 formula; exp/tanh differ between Triton and PyTorch by ulps.
GATE_ATOL_F32 = 1e-5
#: K1 bf16: both compute in f32 and round once, so the two f32 results, which
#: differ by up to GATE_ATOL_F32 (cancellation in f*c + i*tanh(gc) leaves
#: values near 0 with that much absolute error), each round to bf16: 2 bf16
#: ulps of the value plus GATE_ATOL_F32.
GATE_BF16_ULPS = 2
#: K3 f32 (TF32 off): the same products summed in another order over K=9*enc.
SCAN_ATOL_F32 = 1e-4
#: K3 bf16: h is rounded to bf16 every step, and a sum taken in another order
#: flips some roundings by one ulp; those flips feed the next steps.
SCAN_ATOL_BF16 = 3e-2
#: predict in f32 on the card (TF32 off) against the CPU in f32: 15 steps of
#: sums taken in another order; the repo's golden tolerance.
PREDICT_ATOL_F32 = 1e-4
#: predict in bf16 against f32, and per-step against fused in bf16: the
#: per-step path rounds the gate pre-activations and the cell to bf16 every
#: step, the fused path keeps both in f32, over 15 steps and 3 layers.
PREDICT_ATOL_BF16 = 5e-2


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok, msg):
    if not ok:
        fail(msg)


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup=3, iters=10):
    r"""Mean device time of ``fn()`` in ms (CUDA events over ``iters`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=100):
    r"""Mean device time of ``fn()`` in ms, replayed from a CUDA graph of
    ``iters`` calls: the card's time alone, without the host's launch cost."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return cuda_ms(graph.replay, warmup=2, iters=5) / iters


def bf16_ulp(x):
    import torch
    x = x.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(x)) - 7)


def gate_cost(side, ch, itemsize):
    r"""(bytes, ops) of one gate launch: gates, c and peepholes read, h and c' written."""
    n = B * side * side * ch
    return (7 * n + 3 * side * side * ch) * itemsize, GATE_OPS_PER_ELEMENT * n


def scan_cost(side, enc, steps, with_x, itemsize):
    r"""(bytes, ops) of one scan launch: i2h, h0, c0, weights, bias and
    peepholes read, h_seq and c_last written; the 3x3 hidden conv's MACs."""
    px = B * side * side
    elems = (steps * px * 4 * enc if with_x else 0) + 2 * px * enc + 36 * enc * enc \
        + 3 * side * side * enc + steps * px * enc + px * enc
    return elems * itemsize + 16 * enc, 2 * steps * px * 9 * enc * 4 * enc


def bound_ms(nbytes, ops, peak_ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs on a CUDA card")
    sys.path.insert(0, str(ROOT))
    import vp_suite_tpu_torch
    check(Path(vp_suite_tpu_torch.__file__).resolve().is_relative_to(ROOT),
          f"vp_suite_tpu_torch was imported from {vp_suite_tpu_torch.__file__}, not this checkout")
    from vp_suite_tpu_torch import VPSuite
    from vp_suite_tpu_torch.kernels import build
    from vp_suite_tpu_torch.ops.cells import convlstm_gate_fuse, convlstm_gate_reference
    from vp_suite_tpu_torch.ops.convlstm import convlstm_scan_fused, convlstm_scan_reference
    import triton

    t_start = time.time()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = nvidia_smi()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, triton {triton.__version__}, "
          f"python {sys.version.split()[0]}")

    t0 = time.time()
    build.build_all(verbose=True)
    print(f"[build] CUDA kernels built in {time.time() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    # --- 2. K1 against its plain version ---------------------------------------------------
    gate_err = 0.0
    gate_inputs = {}
    for side, ch in CELLS:
        base = [rnd(B, side, side, 4 * ch), rnd(B, side, side, ch)] \
            + [rnd(side, side, ch, scale=0.5) for _ in range(3)]
        for dt in (torch.float32, torch.bfloat16):
            args = [a.to(dt) for a in base]
            gate_inputs[(side, ch, dt)] = args
            got = convlstm_gate_fuse(*args)
            torch.cuda.synchronize()
            want = convlstm_gate_reference(*args)
            errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
            if dt == torch.float32:
                ok = max(errs) <= GATE_ATOL_F32
                tol = f"atol {GATE_ATOL_F32}"
            else:
                ok = all(bool(((g.float() - w.float()).abs()
                               <= GATE_BF16_ULPS * bf16_ulp(w) + GATE_ATOL_F32).all())
                         for g, w in zip(got, want))
                tol = f"{GATE_BF16_ULPS} bf16 ulps + {GATE_ATOL_F32}"
                gate_err = max(gate_err, *errs)
            print(f"[K1] {side}x{side}x{ch} b={B} {str(dt)[6:]}: max |h err| {errs[0]:.3g}, "
                  f"max |c err| {errs[1]:.3g} ({tol}): {'ok' if ok else 'FAIL'}")
            check(ok, f"K1 disagrees with convlstm_gate_reference at {side}x{side}x{ch} {dt}")

    # --- 3. K3 against its plain version ---------------------------------------------------
    scan_err = 0.0
    for side, enc in CELLS:
        for steps, with_x in ((10, False), (5, True)):
            base = [rnd(steps, B, side, side, 4 * enc, scale=0.3) if with_x else None,
                    rnd(B, side, side, enc, scale=0.3), rnd(B, side, side, enc, scale=0.3),
                    rnd(3, 3, enc, 4 * enc, scale=(9 * enc) ** -0.5), rnd(4 * enc, scale=0.1)] \
                + [rnd(side, side, enc, scale=0.1) for _ in range(3)]
            for dt, atol in ((torch.float32, SCAN_ATOL_F32), (torch.bfloat16, SCAN_ATOL_BF16)):
                args = [a if a is None or i == 4 else a.to(dt) for i, a in enumerate(base)]
                seq, (h, c) = convlstm_scan_fused(*args, seq_len=steps)
                torch.cuda.synchronize()
                rseq, (rh, rc) = convlstm_scan_reference(*args, seq_len=steps)
                errs = [(g.float() - w.float()).abs().max().item()
                        for g, w in ((seq, rseq), (h, rh), (c, rc))]
                ok = max(errs) <= atol and seq.dtype == h.dtype == c.dtype == dt
                if dt == torch.bfloat16:
                    scan_err = max(scan_err, *errs)
                print(f"[K3] {side}x{side}x{enc} b={B} T={steps} "
                      f"{'with i2h' if with_x else 'decode'} {str(dt)[6:]}: max err h_seq "
                      f"{errs[0]:.3g}, h_last {errs[1]:.3g}, c_last {errs[2]:.3g} "
                      f"(atol {atol}): {'ok' if ok else 'FAIL'}")
                check(ok, f"K3 disagrees with convlstm_scan_reference at {side}x{side}x{enc} "
                          f"T={steps} with_x={with_x} {dt}")

    # --- 4. the serving path ---------------------------------------------------------------
    model_kw = dict(img_shape=IMG, action_size=0, tensor_value_range=(0.0, 1.0), seed=SEED)
    suite = VPSuite()
    for cfg in CONFIGS.values():
        suite.create_model("convlstm-shi", compute_dtype=torch.bfloat16, **model_kw, **cfg)
    frames = torch.rand((B, CTX, IMG[1], IMG[2], IMG[0]),
                        generator=torch.Generator().manual_seed(SEED))

    convlstm_gate_fuse.launches = 0
    convlstm_scan_fused.launches = 0
    preds = {name: suite.predict(frames, pred_frames=PRED, model_idx=i)
             for i, name in enumerate(CONFIGS)}
    torch.cuda.synchronize()
    launches = {"gate": convlstm_gate_fuse.launches, "scan": convlstm_scan_fused.launches}
    print(f"[predict] kernel launches in one predict per configuration: K1 {launches['gate']}, "
          f"K3 {launches['scan']}")
    check(launches["gate"] > 0, "the per-step serving path launched K1 no time")
    check(launches["scan"] > 0, "the fused-scan serving path launched K3 no time")

    want_shape = (B, PRED, IMG[1], IMG[2], IMG[0])
    for name, p in preds.items():
        check(tuple(p.shape) == want_shape and p.dtype == torch.float32
              and p.device.type == "cuda",
              f"{name}: predict gave {tuple(p.shape)} {p.dtype} on {p.device}")
        check(bool(torch.isfinite(p).all()), f"{name}: predict gave non-finite values")
        print(f"[predict] {name}: {tuple(p.shape)} float32, finite, "
              f"|pred| max {p.abs().max().item():.3g}, mean {p.abs().mean().item():.3g}")
    d_ab = (preds["per_step"] - preds["fused_scan"]).abs().max().item()
    print(f"[predict] per_step vs fused_scan, bf16, b={B}: max diff {d_ab:.3g} "
          f"(atol {PREDICT_ATOL_BF16})")
    check(d_ab <= PREDICT_ATOL_BF16, "per-step and fused-scan predictions disagree")

    cpu_suite, f32_suite = VPSuite(device="cpu"), VPSuite()
    for cfg in CONFIGS.values():
        cpu_suite.create_model("convlstm-shi", **model_kw, **cfg)
        f32_suite.create_model("convlstm-shi", compute_dtype=torch.float32, **model_kw, **cfg)
    for i, name in enumerate(CONFIGS):
        ref = cpu_suite.predict(frames[:2], pred_frames=PRED, model_idx=i)
        d32 = (f32_suite.predict(frames[:2], pred_frames=PRED, model_idx=i).cpu() - ref)
        d32 = d32.abs().max().item()
        d16 = (preds[name][:2].cpu() - ref).abs().max().item()
        print(f"[predict] {name} b=2 against the CPU in f32: card f32 max diff {d32:.3g} "
              f"(atol {PREDICT_ATOL_F32}), card bf16 max diff {d16:.3g} "
              f"(atol {PREDICT_ATOL_BF16})")
        check(d32 <= PREDICT_ATOL_F32, f"{name}: f32 predict on the card disagrees with the CPU")
        check(d16 <= PREDICT_ATOL_BF16, f"{name}: bf16 predict on the card disagrees with the CPU")

    # --- 5. times --------------------------------------------------------------------------
    # K1: the serving path's launches, one per cell and step, in bf16. Device
    # time from CUDA-graph replay; "eager" is back-to-back launches from Python,
    # which the host's launch rate bounds at the small shapes.
    model = suite.models[0].model
    gate_launches = {}
    for rnns, steps in ((model.enc_rnns_list, CTX), (model.dec_rnns_list, PRED)):
        for rnn in rnns:
            shape = (rnn.state_h, rnn.enc_channels)
            gate_launches[shape] = gate_launches.get(shape, 0) + steps
    check(sum(gate_launches.values()) == launches["gate"],
          f"K1 launch shapes {gate_launches} do not add up to the {launches['gate']} launches")
    k1 = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes=0, ops=0)
    for (side, ch), steps in gate_launches.items():
        args = gate_inputs[(side, ch, torch.bfloat16)]
        ms = graph_ms(lambda: convlstm_gate_fuse(*args))
        eager = cuda_ms(lambda: convlstm_gate_fuse(*args), warmup=10, iters=100)
        plain = graph_ms(lambda: convlstm_gate_reference(*args), iters=20)
        nbytes, ops = gate_cost(side, ch, 2)
        bound, _ = bound_ms(nbytes, ops, F32_FLOPS)
        print(f"[time] K1 {side}x{side}x{ch} bf16: {ms * 1e3:.1f} us/launch (eager "
              f"{eager * 1e3:.1f} us, plain {plain * 1e3:.1f} us, bound {bound * 1e3:.1f} us "
              f"by bytes, {nbytes / 1e6:.1f} MB), {steps} launches/predict")
        k1["ms"] += steps * ms
        k1["plain_ms"] += steps * plain
        k1["bytes"] += steps * nbytes
        k1["ops"] += steps * ops
    k1["bound_ms"], k1["bound_by"] = bound_ms(k1["bytes"], k1["ops"], F32_FLOPS)

    # K3: the fused configuration's six launches (staged: whole sequences).
    model = suite.models[1].model
    scan_launches = [(rnn.state_h, rnn.enc_channels, CTX, True) for rnn in model.enc_rnns_list]
    scan_launches += [(rnn.state_h, rnn.enc_channels, PRED, i > 0)
                      for i, rnn in enumerate(model.dec_rnns_list)]
    check(len(scan_launches) == launches["scan"],
          f"{len(scan_launches)} K3 launch shapes against {launches['scan']} launches")
    k3 = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes=0, ops=0)
    for side, enc, steps, with_x in scan_launches:
        dt = torch.bfloat16
        args = [rnd(steps, B, side, side, 4 * enc, scale=0.3, dtype=dt) if with_x else None,
                rnd(B, side, side, enc, scale=0.3, dtype=dt),
                rnd(B, side, side, enc, scale=0.3, dtype=dt),
                rnd(3, 3, enc, 4 * enc, scale=(9 * enc) ** -0.5, dtype=dt), rnd(4 * enc)] \
            + [rnd(side, side, enc, scale=0.1, dtype=dt) for _ in range(3)]
        ms = cuda_ms(lambda: convlstm_scan_fused(*args, seq_len=steps), warmup=2, iters=10)
        plain = cuda_ms(lambda: convlstm_scan_reference(*args, seq_len=steps), warmup=2, iters=5)
        nbytes, ops = scan_cost(side, enc, steps, with_x, 2)
        bound, by = bound_ms(nbytes, ops, BF16_TENSOR_FLOPS)
        print(f"[time] K3 {side}x{side}x{enc} T={steps} {'with i2h' if with_x else 'decode'} "
              f"bf16: {ms:.3f} ms/launch (plain {plain:.3f} ms, bound {bound:.3f} ms by {by}; "
              f"{ops / ms / 1e9:.1f} TFLOP/s)")
        k3["ms"] += ms
        k3["plain_ms"] += plain
        k3["bytes"] += nbytes
        k3["ops"] += ops
    k3["bound_ms"], k3["bound_by"] = bound_ms(k3["bytes"], k3["ops"], BF16_TENSOR_FLOPS)

    for i, name in enumerate(CONFIGS):
        for _ in range(2):
            suite.predict(frames, pred_frames=PRED, model_idx=i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            suite.predict(frames, pred_frames=PRED, model_idx=i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        lat = sorted(times)[len(times) // 2] * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[time] predict {name} bf16 b={B} {CTX}->{PRED} at 64x64: median {lat:.2f} ms "
              f"(runs {', '.join(f'{t * 1e3:.2f}' for t in times)}), "
              f"{B * PRED / lat * 1e3:.0f} frames/s, peak memory {peak:.2f} GiB")
        profile_predict(suite, frames, i, name)

    kernels = [
        dict(name="convlstm_gate_fwd (K1)", route="triton",
             source="vp_suite_tpu_torch/ops/cells.py",
             replaces="vp_suite_tpu/ops/pallas_cells.py:37", launches=launches["gate"],
             max_abs_err=gate_err, ms=k1["ms"], plain_ms=k1["plain_ms"],
             bound_ms=k1["bound_ms"], bound_by=k1["bound_by"], library_ms=None),
        dict(name="convlstm_scan_fwd (K3)", route="cuda",
             source="vp_suite_tpu_torch/csrc/convlstm_scan.cu",
             replaces="vp_suite_tpu/ops/pallas_convlstm.py:102", launches=launches["scan"],
             max_abs_err=scan_err, ms=k3["ms"], plain_ms=k3["plain_ms"],
             bound_ms=k3["bound_ms"], bound_by=k3["bound_by"], library_ms=None),
    ]
    print(f"[done] {time.time() - t_start:.0f} s; kernel times below are per predict "
          f"(all of its launches), in bf16, on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def profile_predict(suite, frames, model_idx, name):
    r"""One ``predict`` under ``torch.profiler``: device busy share and the
    kernels that take most of the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        suite.predict(frames, pred_frames=PRED, model_idx=model_idx)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if not busy:
        print(f"[profile] {name}: device time not measured (the profiler saw no CUDA kernels)")
        return
    print(f"[profile] {name}: {busy:.2f} ms of device time in {wall:.2f} ms under the profiler "
          f"(busy {busy / wall:.0%}), {sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")


if __name__ == "__main__":
    main()
