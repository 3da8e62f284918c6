#!/usr/bin/env python3
r"""Runs the PyTorch port's serving and training paths on one NVIDIA H100 and checks them.

    python3 chip_smoke.py        # from the repository root, on a machine with one CUDA card

Needs PyTorch built for CUDA, Triton and ``nvcc``; never imports JAX. It
builds the port's kernels from ``vp_suite_tpu_torch/csrc`` and then:

1. prints the card (``nvidia-smi`` name and power limit) and the versions;
2. holds K1, the ConvLSTM gate kernel, and K2, its backward (both Triton),
   against ``convlstm_gate_reference`` and ``convlstm_gate_backward_reference``
   at EF-ConvLSTM's three cell shapes, b=32;
3. holds K3, the whole-recurrence ConvLSTM scan kernel, and K3s, its form
   that saves the training residuals (CUDA C++), against
   ``convlstm_scan_forward_reference`` at the same shapes, in decode mode
   (T=10) and with a precomputed input half (T=5); K3s must leave ``h_seq``
   bit for bit as K3 gives it;
4. holds K4, the scan's reverse-time backward (CUDA C++), against
   ``convlstm_scan_backward_reference`` at the fused training path's six
   launch shapes, and the scan's eight input gradients through its autograd
   Function against autograd of the plain forward;
5. drives the serving path: ``VPSuite()`` -> ``create_model("convlstm-shi")``
   at 64x64 RGB in bf16 -> ``predict(32 x 5 frames, pred_frames=10)``, once
   per-step (K1) and once with ``use_fused_scan`` (K3), with the kernels'
   launch counts set to 0 just before and read just after; checks the
   predictions, and at b=2 holds them against the same weights run on the CPU
   in f32;
6. drives the training path: ``create_train_state`` and ``make_train_step``
   (Adam, lr 1e-4, MSE) on the same models' configurations, b=32, 5 -> 10,
   bf16, per-step (K1 + K2) and fused (K3s + K4), with the counts set to 0
   just before the first step and read just after; checks losses, gradients
   and launch counts, and at b=2 holds one f32 SGD step on the card against
   the same step on the CPU;
7. times each kernel at the shapes its path gives it, beside its plain
   version and its bound, and times ``predict`` and the train step.

Any failed check exits non-zero before the result lines. The last two lines
of standard output are the kernels' JSON line and the result JSON line.
"""
import json
import math
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
#: and of its backward: the recomputed forward plus some 25 products and sums.
GATE_BWD_OPS_PER_ELEMENT = 55

B = 32                      # serving and training batch
CTX, PRED = 5, 10           # context and predicted frames
IMG = (3, 64, 64)           # (c, h, w)
SEED = 0
LR = 1e-4                   # Adam's learning rate (the run default)
#: (side, channels) of EF-ConvLSTM's recurrent cells at 64x64.
CELLS = ((64, 64), (32, 96), (16, 96))
CONFIGS = {
    "per_step": {},
    "fused_scan": dict(use_fused_scan=True, interleaved_encode=False,
                       interleaved_forecast=False),
}
#: launches per train step on each path (EF-ConvLSTM, 3 layers, 5 -> 10).
WANT_TRAIN_LAUNCHES = {"per_step": {"K1": 45, "K2": 45, "K3": 0, "K3s": 0, "K4": 0},
                       "fused_scan": {"K1": 0, "K2": 0, "K3": 0, "K3s": 6, "K4": 6}}

# Tolerances, with their reasons.
#: K1/K2 f32: the same f32 formula; exp/tanh differ between Triton and PyTorch by ulps.
GATE_ATOL_F32 = 1e-5
#: K1/K2 bf16: both compute in f32 and round once, so the two f32 results, which
#: differ by up to GATE_ATOL_F32 (cancellation in f*c + i*tanh(gc) leaves
#: values near 0 with that much absolute error), each round to bf16: 2 bf16
#: ulps of the value plus GATE_ATOL_F32.
GATE_BF16_ULPS = 2
#: K3/K3s f32 (TF32 off): the same products summed in another order over K=9*enc.
SCAN_ATOL_F32 = 1e-4
#: K3/K3s bf16: h is rounded to bf16 every step, and a sum taken in another order
#: flips some roundings by one ulp; those flips feed the next steps.
SCAN_ATOL_BF16 = 3e-2
#: K4 and the scan's gradients, f32: sums in another order (the transposed conv
#: over K=9*4enc, cuDNN's weight gradient over T*b*sh*sw), relative to the
#: largest gradient of each kind (max|want|).
GRAD_REL_F32 = 1e-4
#: the hidden kernel's gradient, f32: cuDNN's weight gradient sums T*b*sh*sw
#: (up to 1.3M) products per weight, in one batched call on the kernel path and
#: per step on the plain one; f32 rounding grows like sqrt(N)*2^-24 of the
#: terms' scale, and cancellation makes it larger relative to the result.
GRAD_REL_F32_WEIGHT = 1e-3
#: K4 bf16, relative to the largest gradient of each kind: both sides round dz
#: to bf16 every step; an f32 sum in another order flips some of those
#: roundings by one ulp (2^-8 of the value, 3.9e-3 at the largest), and the
#: flips feed the earlier steps through the transposed conv. Measured on an
#: H100 at the six launch shapes: dz up to 3.8e-3, dh0 1.6e-3, dc0 3.1e-4. A
#: K4 whose bf16 path reads unflipped x-taps gives 0.33 or more, one whose dc
#: carry drops its dzf*wcf term 1.7e-2 (dz) and 5.4e-2 (dc0).
GRAD_REL_BF16 = 1e-2
#: the scan's gradients in bf16 against autograd of the plain forward, which
#: rounds at other places (dh at every step, dz never), relative to the
#: largest: measured up to 7.3e-3 (the faults above give 0.1 or more, and
#: 5.4e-2 at c0).
GRAD_REL_BF16_AUTOGRAD = 2e-2
#: predict in f32 on the card (TF32 off) against the CPU in f32: 15 steps of
#: sums taken in another order; the repo's golden tolerance.
PREDICT_ATOL_F32 = 1e-4
#: predict in bf16 against f32, and per-step against fused in bf16: the
#: per-step path rounds the gate pre-activations and the cell to bf16 every
#: step, the fused path keeps both in f32, over 15 steps and 3 layers.
PREDICT_ATOL_BF16 = 5e-2
#: one f32 SGD step on the card against the CPU, as (p0 - p1) / lr: the
#: JAX package's tolerance for gradients through 15 steps and 3 layers.
STEP_TOL = 5e-4


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


def max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def rel_err(got, want):
    r"""Largest absolute error over the largest |want|."""
    return max_err(got, want) / (want.float().abs().max().item() or 1.0)


def gate_cost(side, ch, itemsize, backward=False):
    r"""(bytes, ops) of one gate launch. Forward: gates, c and peepholes read,
    h and c' written (7n). Backward: gates, c, dh, dc' and peepholes read, the
    four gate gradients and dc written (12n)."""
    n = B * side * side * ch
    streams, ops = (12, GATE_BWD_OPS_PER_ELEMENT) if backward else (7, GATE_OPS_PER_ELEMENT)
    return (streams * n + 3 * side * side * ch) * itemsize, ops * n


def scan_cost(side, enc, steps, with_x, itemsize, save_gates=False):
    r"""(bytes, ops) of one forward scan launch: i2h, h0, c0, weights, bias and
    peepholes read, h_seq and c_last written, and with ``save_gates`` z and
    c_prev written; the 3x3 hidden conv's MACs."""
    px = B * side * side
    elems = (steps * px * 4 * enc if with_x else 0) + 2 * px * enc + 36 * enc * enc \
        + 3 * side * side * enc + steps * px * enc + px * enc
    if save_gates:
        elems += steps * px * 5 * enc
    return elems * itemsize + 16 * enc, 2 * steps * px * 9 * enc * 4 * enc


def scan_bwd_cost(side, enc, steps, itemsize):
    r"""(bytes, ops) of one K4 launch: z, c_prev, dh_seq, dc_last, weights and
    peepholes read, dz written, dh0 and dc0 written in f32; the transposed
    3x3 conv's MACs."""
    px = B * side * side
    elems = steps * px * (4 + 1 + 1 + 4) * enc + px * enc + 36 * enc * enc + 3 * side * side * enc
    return elems * itemsize + 2 * px * enc * 4, 2 * steps * px * 9 * 4 * enc * enc


def bound_ms(nbytes, ops, peak_ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def summed(rows, peak_ops):
    r"""Per-step totals of per-launch rows ``(count, ms, plain_ms, bytes, ops)``."""
    out = dict(ms=sum(n * r[0] for n, *r in rows), plain_ms=sum(n * r[1] for n, *r in rows))
    out["bound_ms"], out["bound_by"] = bound_ms(sum(n * r[2] for n, *r in rows),
                                                sum(n * r[3] for n, *r in rows), peak_ops)
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs on a CUDA card")
    sys.path.insert(0, str(ROOT))
    import vp_suite_tpu_torch
    check(Path(vp_suite_tpu_torch.__file__).resolve().is_relative_to(ROOT),
          f"vp_suite_tpu_torch was imported from {vp_suite_tpu_torch.__file__}, not this checkout")
    from vp_suite_tpu_torch.kernels import build
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

    errs = {}
    suite = serving_suite()
    scan_launches = fused_scan_launches(suite.models[1].model)
    gate_inputs = check_gate_kernels(rnd, errs)
    check_scan_forward(rnd, errs)
    scan_inputs = check_scan_backward(rnd, errs, scan_launches)
    serve = drive_serving(suite, scan_launches)
    train = drive_training()

    kernels = time_kernels(serve, train, gate_inputs, scan_inputs, rnd, errs)
    time_paths(serve, train)
    print(f"[done] {time.time() - t_start:.0f} s; kernel times below are per predict (K1, K3) "
          f"or per train step (K2, K3s, K4), all of their launches, in bf16, on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def check_gate_kernels(rnd, errs):
    r"""K1 and K2 against their plain versions; returns the bf16 inputs by shape."""
    import torch
    from vp_suite_tpu_torch.ops.cells import (convlstm_gate_backward,
                                              convlstm_gate_backward_reference,
                                              convlstm_gate_forward, convlstm_gate_reference)
    errs["K1"] = errs["K2"] = 0.0
    inputs = {}
    for side, ch in CELLS:
        base = [rnd(B, side, side, 4 * ch), rnd(B, side, side, ch)] \
            + [rnd(side, side, ch, scale=0.5) for _ in range(3)] \
            + [rnd(B, side, side, ch, scale=0.1), rnd(B, side, side, ch, scale=0.1)]
        for dt in (torch.float32, torch.bfloat16):
            args = [a.to(dt) for a in base]
            inputs[(side, ch, dt)] = args
            for kid, fn, ref, a in (("K1", convlstm_gate_forward, convlstm_gate_reference, args[:5]),
                                    ("K2", convlstm_gate_backward,
                                     convlstm_gate_backward_reference, args)):
                got = fn(*a)
                torch.cuda.synchronize()
                want = ref(*a)
                e = [max_err(g, w) for g, w in zip(got, want)]
                if dt == torch.float32:
                    ok = max(e) <= GATE_ATOL_F32
                    tol = f"atol {GATE_ATOL_F32}"
                else:
                    ok = all(bool(((g.float() - w.float()).abs()
                                   <= GATE_BF16_ULPS * bf16_ulp(w) + GATE_ATOL_F32).all())
                             for g, w in zip(got, want))
                    tol = f"{GATE_BF16_ULPS} bf16 ulps + {GATE_ATOL_F32}"
                    errs[kid] = max(errs[kid], *e)
                ok = ok and all(g.dtype == dt for g in got)
                names = ("h", "c") if kid == "K1" else ("dgates", "dc_in")
                print(f"[{kid}] {side}x{side}x{ch} b={B} {str(dt)[6:]}: "
                      + ", ".join(f"max |{n} err| {x:.3g}" for n, x in zip(names, e))
                      + f" ({tol}): {'ok' if ok else 'FAIL'}")
                check(ok, f"{kid} disagrees with its plain version at {side}x{side}x{ch} {dt}")
    return inputs


def scan_args(rnd, side, enc, steps, with_x, dt):
    import torch
    args = [rnd(steps, B, side, side, 4 * enc, scale=0.3) if with_x else None,
            rnd(B, side, side, enc, scale=0.3), rnd(B, side, side, enc, scale=0.3),
            rnd(3, 3, enc, 4 * enc, scale=(9 * enc) ** -0.5), rnd(4 * enc, scale=0.1)] \
        + [rnd(side, side, enc, scale=0.1) for _ in range(3)]
    return [a if a is None or i == 4 else a.to(dt) for i, a in enumerate(args)]


def check_scan_forward(rnd, errs):
    r"""K3 and K3s against the plain forward; K3s keeps K3's h_seq bit for bit."""
    import torch
    from vp_suite_tpu_torch.ops.convlstm import (convlstm_scan_forward,
                                                 convlstm_scan_forward_reference)
    errs["K3"] = errs["K3s"] = 0.0
    for side, enc in CELLS:
        for steps, with_x in ((10, False), (5, True)):
            base = scan_args(rnd, side, enc, steps, with_x, torch.float32)
            for dt, atol in ((torch.float32, SCAN_ATOL_F32), (torch.bfloat16, SCAN_ATOL_BF16)):
                args = [a if a is None or i == 4 else a.to(dt) for i, a in enumerate(base)]
                seq, c = convlstm_scan_forward(*args, seq_len=steps)
                s_seq, s_c, z, c_prev = convlstm_scan_forward(*args, seq_len=steps,
                                                              save_gates=True)
                torch.cuda.synchronize()
                want = convlstm_scan_forward_reference(*args, seq_len=steps, save_gates=True)
                e3 = [max_err(g, w) for g, w in zip((seq, c), want[:2])]
                e3s = [max_err(g, w) for g, w in zip((s_seq, s_c, z, c_prev), want)]
                same = torch.equal(seq, s_seq) and torch.equal(c, s_c)
                ok = max(e3 + e3s) <= atol and same \
                    and all(t.dtype == dt for t in (seq, c, z, c_prev))
                if dt == torch.bfloat16:
                    errs["K3"] = max(errs["K3"], *e3)
                    errs["K3s"] = max(errs["K3s"], *e3s)
                print(f"[K3/K3s] {side}x{side}x{enc} b={B} T={steps} "
                      f"{'with i2h' if with_x else 'decode'} {str(dt)[6:]}: max err h_seq "
                      f"{e3[0]:.3g}, c_last {e3[1]:.3g}; K3s z {e3s[2]:.3g}, c_prev {e3s[3]:.3g}; "
                      f"h_seq and c_last bit-identical with and without residuals: {same} "
                      f"(atol {atol}): {'ok' if ok else 'FAIL'}")
                check(ok, f"K3/K3s disagree with convlstm_scan_forward_reference at "
                          f"{side}x{side}x{enc} T={steps} with_x={with_x} {dt}")


def fused_scan_launches(model):
    r"""The scan launches of one forward of the fused configuration, in
    order: ``(side, enc, T, with input half)``. Each encoder cell scans the
    context with its input half; the forecaster's first cell scans the
    predicted frames from the encoder's state alone (decode), the others with
    the cell below as input."""
    return [(r.state_h, r.enc_channels, CTX, True) for r in model.enc_rnns_list] \
        + [(r.state_h, r.enc_channels, PRED, i > 0) for i, r in enumerate(model.dec_rnns_list)]


def check_scan_backward(rnd, errs, scan_launches):
    r"""K4 against the plain backward on K3s's residuals, and the scan's eight
    input gradients through its Function against autograd of the plain
    forward, at the fused path's launch shapes. Returns the bf16 residuals
    and cotangents by launch, for the timings."""
    import torch
    from vp_suite_tpu_torch.ops.convlstm import (convlstm_scan_backward,
                                                 convlstm_scan_backward_reference,
                                                 convlstm_scan_forward, convlstm_scan_fused,
                                                 convlstm_scan_reference)
    errs["K4"] = 0.0
    inputs = {}
    names = ("i2h", "h0", "c0", "h_kernel", "bias", "wci", "wcf", "wco")
    for side, enc, steps, with_x in scan_launches:
        base = scan_args(rnd, side, enc, steps, with_x, torch.float32)
        # a mean-type loss: cotangents of the size a loss over b*T frames hands down
        d_seq = rnd(steps, B, side, side, enc, scale=1e-2)
        d_c = rnd(B, side, side, enc, scale=1e-2)
        for dt in (torch.float32, torch.bfloat16):
            args = [a if a is None or i == 4 else a.to(dt) for i, a in enumerate(base)]
            _, _, z, c_prev = convlstm_scan_forward(*args, seq_len=steps, save_gates=True)
            bwd_args = (z, c_prev, d_seq.to(dt), d_c.to(dt), args[3], *args[5:])
            got = convlstm_scan_backward(*bwd_args)
            torch.cuda.synchronize()
            want = convlstm_scan_backward_reference(*bwd_args)
            e4 = [rel_err(g, w) for g, w in zip(got, want)]
            rel = GRAD_REL_F32 if dt == torch.float32 else GRAD_REL_BF16
            ok = max(e4) <= rel and got[0].dtype == dt

            leaves = [None if a is None else a.detach().clone().requires_grad_() for a in args]
            inputs_ = [a for a in leaves if a is not None]
            grads = []
            for fn in (convlstm_scan_fused, convlstm_scan_reference):
                seq, (h, c) = fn(*leaves, seq_len=steps)
                loss = (seq.float() * d_seq).sum() + (c.float() * d_c).sum()
                grads.append(torch.autograd.grad(loss, inputs_))
            e_all = [rel_err(g, w) for g, w in zip(*grads)]
            present = [n for n, a in zip(names, leaves) if a is not None]
            if dt == torch.float32:
                tols = [GRAD_REL_F32_WEIGHT if n == "h_kernel" else GRAD_REL_F32 for n in present]
            else:
                tols = [GRAD_REL_BF16_AUTOGRAD] * len(present)
            ok_all = all(e <= t for e, t in zip(e_all, tols)) \
                and all(g is not None for g in grads[0])
            if dt == torch.bfloat16:
                errs["K4"] = max(errs["K4"], *(max_err(g, w) for g, w in zip(got, want)))
                inputs[(side, enc, steps, with_x)] = bwd_args
            print(f"[K4] {side}x{side}x{enc} b={B} T={steps} {'with i2h' if with_x else 'decode'} "
                  f"{str(dt)[6:]}: dz {e4[0]:.3g}, dh0 {e4[1]:.3g}, dc0 {e4[2]:.3g} (relative "
                  f"to the largest, tol {rel}); the 8 gradients through the Function against "
                  f"autograd of the plain forward: "
                  + ", ".join(f"{n} {x:.3g}" for n, x in zip(present, e_all))
                  + f" (tol {tols[-1]}, h_kernel {tols[present.index('h_kernel')]}): "
                  f"{'ok' if ok and ok_all else 'FAIL'}")
            check(ok, f"K4 disagrees with convlstm_scan_backward_reference at "
                      f"{side}x{side}x{enc} T={steps} {dt}")
            check(ok_all, f"the scan's gradients disagree with autograd of the plain forward at "
                          f"{side}x{side}x{enc} T={steps} {dt}")
    return inputs


def serving_suite():
    r"""A ``VPSuite`` on the card with EF-ConvLSTM at 64x64 in bf16, one
    model per configuration."""
    import torch
    from vp_suite_tpu_torch import VPSuite
    suite = VPSuite()
    for cfg in CONFIGS.values():
        suite.create_model("convlstm-shi", compute_dtype=torch.bfloat16, img_shape=IMG,
                           action_size=0, tensor_value_range=(0.0, 1.0), seed=SEED, **cfg)
    return suite


def drive_serving(suite, scan_launches):
    r"""``predict`` in both configurations, with K1 and K3 counted."""
    import torch
    from vp_suite_tpu_torch import VPSuite
    model_kw = dict(img_shape=IMG, action_size=0, tensor_value_range=(0.0, 1.0), seed=SEED)
    frames = torch.rand((B, CTX, IMG[1], IMG[2], IMG[0]),
                        generator=torch.Generator().manual_seed(SEED))

    counters = reset_counts()
    preds = {name: suite.predict(frames, pred_frames=PRED, model_idx=i)
             for i, name in enumerate(CONFIGS)}
    torch.cuda.synchronize()
    launches = read_counts(counters)
    print(f"[predict] kernel launches in one predict per configuration: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()))
    check(launches["K1"] > 0, "the per-step serving path launched K1 no time")
    check(launches["K3"] == len(scan_launches),
          f"the fused-scan serving path launched K3 {launches['K3']} times, not once for each "
          f"of its {len(scan_launches)} scans {scan_launches}")
    check(launches["K2"] == launches["K3s"] == launches["K4"] == 0,
          "predict, which needs no gradient, launched a training kernel")

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
    return dict(suite=suite, frames=frames, launches=launches, scan_launches=scan_launches)


def reset_counts():
    r"""Sets every kernel's launch count to 0; returns the counters by kernel id."""
    from vp_suite_tpu_torch.ops.cells import convlstm_gate_backward, convlstm_gate_fuse
    from vp_suite_tpu_torch.ops.convlstm import convlstm_scan_backward, convlstm_scan_fused
    counters = {"K1": (convlstm_gate_fuse, "launches"), "K2": (convlstm_gate_backward, "launches"),
                "K3": (convlstm_scan_fused, "launches"),
                "K3s": (convlstm_scan_fused, "save_gates_launches"),
                "K4": (convlstm_scan_backward, "launches")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    return counters


def read_counts(counters):
    return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}


def drive_training():
    r"""The training path in both configurations: Adam at lr 1e-4 on one fixed
    b=32 batch of 15 frames, 2 warm-up and 5 timed steps, with the kernels'
    launch counts read around the first step; then one f32 SGD step at b=2 on
    the card against the CPU."""
    import torch
    from vp_suite_tpu_torch import VPSuite
    from vp_suite_tpu_torch.training.loop import make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    model_kw = dict(img_shape=IMG, action_size=0, tensor_value_range=(0.0, 1.0), seed=SEED)
    run_config = {"context_frames": CTX, "pred_frames": PRED}
    frames = torch.rand((B, CTX + PRED, IMG[1], IMG[2], IMG[0]),
                        generator=torch.Generator().manual_seed(SEED + 1)).cuda()
    batch = {"frames": frames}
    out = dict(batch=batch, steps={}, launches={})
    suite = VPSuite()
    for name, cfg in CONFIGS.items():
        model = suite.create_model("convlstm-shi", compute_dtype=torch.bfloat16, **model_kw,
                                   **cfg).model
        state = create_train_state(model, lr=LR, seed=SEED)
        step = make_train_step(model, run_config)
        torch.cuda.synchronize()
        counters = reset_counts()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        launches = out["launches"][name] = read_counts(counters)
        print(f"[train] {name}: kernel launches in one train step: "
              + ", ".join(f"{k} {v}" for k, v in launches.items()))
        check(launches == WANT_TRAIN_LAUNCHES[name],
              f"{name}: one train step launched {launches}, not {WANT_TRAIN_LAUNCHES[name]}")
        for pname, p in model.named_parameters():
            check(p.grad is not None and p.grad.dtype == torch.float32
                  and bool(torch.isfinite(p.grad).all()) and bool((p.grad != 0).any()),
                  f"{name}: parameter {pname} has no finite, non-zero f32 gradient after a step")
        losses = [float(metrics["total"])]
        state, metrics = step(state, batch)
        losses.append(float(metrics["total"]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["total"]))   # waits for the card
            times.append(time.perf_counter() - t0)
        peak = (torch.cuda.max_memory_allocated() - live) / 2 ** 30
        check(all(map(math.isfinite, losses)),
              f"{name}: non-finite training loss {losses}")
        check(losses[-1] < losses[0], f"{name}: the loss did not fall over 7 steps: {losses}")
        check(state.step == 7, f"{name}: the state counts {state.step} steps, not 7")
        lat = sorted(times)[len(times) // 2] * 1e3
        fwd = forward_ms(model, batch)
        print(f"[train] {name} bf16 b={B} {CTX}->{PRED} at 64x64, Adam lr {LR}: losses "
              + ", ".join(f"{x:.2f}" for x in losses)
              + f"; median step {lat:.2f} ms (steps {', '.join(f'{t * 1e3:.2f}' for t in times)}), "
              f"{B * (CTX + PRED) / lat * 1e3:.0f} frames/s, peak memory {peak:.2f} GiB above "
              f"what was live before (parameters, gradients, Adam's moments); "
              f"forward and loss alone {fwd:.2f} ms, so backward and update {lat - fwd:.2f} ms")
        out["steps"][name] = dict(model=model, state=state, step=step, lat=lat, peak=peak)

    # one f32 SGD step at b=2 on the card against the CPU, as (p0 - p1) / lr
    lr = 1e-2
    small = {"frames": frames[:2]}
    for name, cfg in CONFIGS.items():
        got = {}
        for device, kw in (("cuda", dict(compute_dtype=torch.float32)), ("cpu", {})):
            model = VPSuite(device=device).create_model("convlstm-shi", **model_kw, **kw,
                                                        **cfg).model
            p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
            state = create_train_state(model, lr=lr, optimizer="sgd")
            _, metrics = make_train_step(model, run_config)(
                state, {"frames": small["frames"].to(device)})
            got[device] = (float(metrics["total"]),
                           {k: ((p0[k] - v.detach()) / lr).cpu()
                            for k, v in model.named_parameters()})
        worst, worst_name = 0.0, ""
        for k, want in got["cpu"][1].items():
            excess = ((got["cuda"][1][k] - want).abs() - STEP_TOL * want.abs()).max().item()
            if excess > worst or not worst_name:
                worst, worst_name = excess, k
        d_loss = abs(got["cuda"][0] - got["cpu"][0])
        ok = worst <= STEP_TOL and d_loss <= 1e-4 * abs(got["cpu"][0])
        print(f"[train] {name} f32 b=2 SGD step, card against CPU: loss {got['cuda'][0]:.6f} vs "
              f"{got['cpu'][0]:.6f}; (p0-p1)/lr: max(|diff| - rtol*|cpu|) {worst:.3g} at "
              f"{worst_name} (rtol {STEP_TOL}, must stay <= atol {STEP_TOL}): "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{name}: one f32 SGD step on the card disagrees with the CPU")
    return out


def forward_ms(model, batch):
    r"""Median host time of the train step's forward and loss alone (grad mode
    on, so the forward saves what the backward needs; no backward)."""
    import torch
    from vp_suite_tpu_torch.measure.loss_provider import PredictionLossProvider
    from vp_suite_tpu_torch.training.loop import _apply_model
    losses = PredictionLossProvider({"losses_and_scales": {"mse": 1.0}})
    frames = batch["frames"]
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds, _ = _apply_model(model, frames[:, :CTX], pred_frames=PRED, train=True)
        float(losses.get_losses(preds, frames[:, CTX:])[1].detach())   # waits for the card
        times.append(time.perf_counter() - t0)
        del preds
    return sorted(times[1:])[1] * 1e3


def time_kernels(serve, train, gate_inputs, scan_inputs, rnd, errs):
    r"""Each kernel at the shapes its path gives it, beside its plain version
    and bound; returns the kernels' JSON entries."""
    import torch
    from vp_suite_tpu_torch.ops.cells import (convlstm_gate_backward,
                                              convlstm_gate_backward_reference,
                                              convlstm_gate_forward, convlstm_gate_reference)
    from vp_suite_tpu_torch.ops.convlstm import (convlstm_scan_backward,
                                                 convlstm_scan_backward_reference,
                                                 convlstm_scan_forward,
                                                 convlstm_scan_forward_reference)
    # K1 and K2: one launch per cell and step, in bf16. Device time from
    # CUDA-graph replay; "eager" is back-to-back launches from Python, which
    # the host's launch rate bounds at the small shapes.
    model = serve["suite"].models[0].model
    gate_launches = {}
    for rnns, steps in ((model.enc_rnns_list, CTX), (model.dec_rnns_list, PRED)):
        for rnn in rnns:
            shape = (rnn.state_h, rnn.enc_channels)
            gate_launches[shape] = gate_launches.get(shape, 0) + steps
    check(sum(gate_launches.values()) == serve["launches"]["K1"],
          f"K1 launch shapes {gate_launches} do not add up to {serve['launches']['K1']} launches")
    rows = {"K1": [], "K2": []}
    for (side, ch), steps in gate_launches.items():
        args = gate_inputs[(side, ch, torch.bfloat16)]
        for kid, fn, ref, a, bwd in (("K1", convlstm_gate_forward, convlstm_gate_reference,
                                      args[:5], False),
                                     ("K2", convlstm_gate_backward,
                                      convlstm_gate_backward_reference, args, True)):
            ms = graph_ms(lambda: fn(*a))
            eager = cuda_ms(lambda: fn(*a), warmup=10, iters=50)
            plain = graph_ms(lambda: ref(*a), iters=20)
            nbytes, ops = gate_cost(side, ch, 2, backward=bwd)
            bound, _ = bound_ms(nbytes, ops, F32_FLOPS)
            print(f"[time] {kid} {side}x{side}x{ch} bf16: {ms * 1e3:.1f} us/launch (eager "
                  f"{eager * 1e3:.1f} us, plain {plain * 1e3:.1f} us, bound {bound * 1e3:.1f} us "
                  f"by bytes, {nbytes / 1e6:.1f} MB), {steps} launches/"
                  f"{'predict' if kid == 'K1' else 'train step'}")
            rows[kid].append((steps, ms, plain, nbytes, ops))
    k1, k2 = summed(rows["K1"], F32_FLOPS), summed(rows["K2"], F32_FLOPS)

    # K3 (predict, no residuals), K3s and K4 (train step): the fused path's six launches.
    rows = {"K3": [], "K3s": [], "K4": []}
    dt = torch.bfloat16
    for side, enc, steps, with_x in serve["scan_launches"]:
        args = scan_args(rnd, side, enc, steps, with_x, dt)
        for kid, save in (("K3", False), ("K3s", True)):
            ms = cuda_ms(lambda: convlstm_scan_forward(*args, seq_len=steps, save_gates=save),
                         warmup=2, iters=10)
            plain = cuda_ms(lambda: convlstm_scan_forward_reference(
                *args, seq_len=steps, save_gates=save), warmup=1, iters=3)
            nbytes, ops = scan_cost(side, enc, steps, with_x, 2, save_gates=save)
            rows[kid].append((1, ms, plain, nbytes, ops))
            report_scan(kid, side, enc, steps, with_x, ms, plain, nbytes, ops)
        bwd_args = scan_inputs[(side, enc, steps, with_x)]
        ms = cuda_ms(lambda: convlstm_scan_backward(*bwd_args), warmup=2, iters=10)
        plain = cuda_ms(lambda: convlstm_scan_backward_reference(*bwd_args), warmup=1, iters=3)
        nbytes, ops = scan_bwd_cost(side, enc, steps, 2)
        rows["K4"].append((1, ms, plain, nbytes, ops))
        report_scan("K4", side, enc, steps, with_x, ms, plain, nbytes, ops)
    k3, k3s, k4 = (summed(rows[k], BF16_TENSOR_FLOPS) for k in ("K3", "K3s", "K4"))

    pred_l, train_l = serve["launches"], train["launches"]
    entries = [
        ("convlstm_gate_fwd (K1)", "triton", "vp_suite_tpu_torch/ops/cells.py",
         "vp_suite_tpu/ops/pallas_cells.py:37", pred_l["K1"], "K1", k1),
        ("convlstm_gate_bwd (K2)", "triton", "vp_suite_tpu_torch/ops/cells.py",
         "vp_suite_tpu/ops/pallas_cells.py:54", train_l["per_step"]["K2"], "K2", k2),
        ("convlstm_scan_fwd (K3)", "cuda", "vp_suite_tpu_torch/csrc/convlstm_scan.cu",
         "vp_suite_tpu/ops/pallas_convlstm.py:102", pred_l["K3"], "K3", k3),
        ("convlstm_scan_fwd save_gates (K3s)", "cuda", "vp_suite_tpu_torch/csrc/convlstm_scan.cu",
         "vp_suite_tpu/ops/pallas_convlstm.py:147", train_l["fused_scan"]["K3s"], "K3s", k3s),
        ("convlstm_scan_bwd (K4)", "cuda", "vp_suite_tpu_torch/csrc/convlstm_scan_bwd.cu",
         "vp_suite_tpu/ops/pallas_convlstm.py:166", train_l["fused_scan"]["K4"], "K4", k4),
    ]
    return [dict(name=name, route=route, source=source, replaces=replaces, launches=launches,
                 max_abs_err=errs[kid], ms=t["ms"], plain_ms=t["plain_ms"],
                 bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None)
            for name, route, source, replaces, launches, kid, t in entries]


def report_scan(kid, side, enc, steps, with_x, ms, plain, nbytes, ops):
    bound, by = bound_ms(nbytes, ops, BF16_TENSOR_FLOPS)
    print(f"[time] {kid} {side}x{side}x{enc} T={steps} {'with i2h' if with_x else 'decode'} "
          f"bf16: {ms:.3f} ms/launch (plain {plain:.3f} ms, bound {bound:.3f} ms by {by}; "
          f"{ops / ms / 1e9:.1f} TFLOP/s)")


def time_paths(serve, train):
    r"""``predict`` and the train step, each under the profiler once more."""
    import torch
    suite, frames = serve["suite"], serve["frames"]
    for i, name in enumerate(CONFIGS):
        suite.predict(frames, pred_frames=PRED, model_idx=i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            suite.predict(frames, pred_frames=PRED, model_idx=i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        lat = sorted(times)[len(times) // 2] * 1e3
        peak = (torch.cuda.max_memory_allocated() - live) / 2 ** 30
        print(f"[time] predict {name} bf16 b={B} {CTX}->{PRED} at 64x64: median {lat:.2f} ms "
              f"(runs {', '.join(f'{t * 1e3:.2f}' for t in times)}), "
              f"{B * PRED / lat * 1e3:.0f} frames/s, peak memory {peak:.2f} GiB above what "
              f"was allocated before")
        profile(f"predict {name}", lambda: suite.predict(frames, pred_frames=PRED, model_idx=i))
    for name, s in train["steps"].items():
        print(f"[time] train step {name} bf16 b={B} {CTX}->{PRED} at 64x64: median "
              f"{s['lat']:.2f} ms, {B * (CTX + PRED) / s['lat'] * 1e3:.0f} frames/s, "
              f"peak memory {s['peak']:.2f} GiB above what was live before")
        profile(f"train step {name}",
                lambda: float(s["step"](s["state"], train["batch"])[1]["total"]))


def profile(name, fn):
    r"""One call of ``fn`` under ``torch.profiler``: device busy share and the
    kernels that take most of the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if not busy:
        print(f"[profile] {name}: device time not measured (the profiler saw no CUDA kernels)")
        return
    print(f"[profile] {name}: {busy:.2f} ms of device time in {wall:.2f} ms under the profiler "
          f"(busy {busy / wall:.0%}), {sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")


if __name__ == "__main__":
    main()
