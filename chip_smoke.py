#!/usr/bin/env python3
r"""Runs the PyTorch port's serving and training paths on one NVIDIA H100 and checks them.

    python3 chip_smoke.py        # from the repository root, on a machine with one CUDA card

Needs PyTorch built for CUDA, Triton and ``nvcc``; never imports JAX. It
builds the port's kernels from ``vp_suite_tpu_torch/csrc`` and then:

1. prints the card (``nvidia-smi`` name and power limit) and the versions,
   and checks that ``-Xptxas -v`` reports no spilled bytes for any
   instantiation of the scan kernels (``csrc/convlstm_scan{,_bwd}.cu``), of
   K8's bf16 kernels (``csrc/warp_ret.cu``) and of K9's bf16 forward and
   general d_A / d_Bm kernel (``csrc/warp_contract.cu``);
2. holds K1, the ConvLSTM gate kernel, and K2, its backward (both Triton),
   against ``convlstm_gate_reference`` and ``convlstm_gate_backward_reference``
   at EF-ConvLSTM's three cell shapes, b=32;
3. holds K3, the whole-recurrence ConvLSTM scan kernel, and K3s, its form
   that saves the training residuals (CUDA C++), against
   ``convlstm_scan_forward_reference`` at the same shapes, in decode mode
   (T=10) and with a precomputed input half (T=5), in f32 and bf16 (the
   bf16 kernel: resident weights, a ``cp.async`` ring of h stages, ``wgmma``);
   K3s must leave ``h_seq`` and ``c_last`` bit for bit as K3 gives them;
4. holds K4, the scan's reverse-time backward (CUDA C++), against
   ``convlstm_scan_backward_reference`` at the fused training path's six
   launch shapes with a nonzero gradient of ``h_last``, and the scan's eight
   input gradients through its autograd Function, of a loss over ``h_seq``,
   ``h_last`` and ``c_last``, against autograd of the plain forward;
5. holds the multi-flow bilinear warp's forward and backward kernels (CUDA
   C++) against ``warp_sample_reference`` and
   ``warp_sample_backward_reference`` at EF-TrajGRU's three layer shapes
   (b=32, L=13), in f32 and bf16, on flows of a few pixels, some of which
   leave the image, and the warp's three gradients through its autograd
   Function against autograd of the plain forward; prints both kernels'
   tilings and the share of the in-image taps that leave their block's band
   at each shape (read from global memory in the forward, sent to global
   atomics in the backward);
6. holds K8, the warp fused with TrajGRU's 1x1 ``ret`` conv (``warp_ret``;
   CUDA C++ forward and backward; in bf16 wgmma kernels on the image's band of
   rows, whose plan it prints beside its Python mirror), against ``warp_ret_reference`` and
   ``warp_ret_backward_reference`` at the same three shapes (O = 3f) in f32
   and bf16, its five gradients through ``WarpRetFunction`` against autograd
   of the plain forward, and ``warp_ret`` against ``warp_flow_ret`` (the warp
   kernel and a cuBLAS GEMM, the unfused path TrajGRU runs) for the output
   and the five gradients, on the same image, flows, weights and bias;
7. holds K9, the warp by prebuilt factor matrices (``warp_contract``; CUDA
   C++ forward and backward), against ``warp_contract_reference`` and
   ``warp_contract_backward_reference`` on dense random factors at the same
   three shapes in f32 and bf16, its three gradients through
   ``WarpContractFunction`` against autograd of the plain forward, and
   ``warp_contract`` on one-hot factors (``_onehot_factor``) against
   ``warp_sample`` in f32; and in bf16 at two shapes beyond the layer shapes,
   w = 200 (d_A / d_Bm in column chunks) and h = 512 (the forward's A tile
   in parts);
8. drives K8's and K9's path, ``warp_ret`` and ``warp_contract`` with their
   gradients once at each shape in bf16, with the launch counts set to 0 just
   before and held exactly just after (three calls of each: 3 launches of
   each forward, 9 of K8's backward and 6 of K9's; nothing else);
9. drives the serving path: ``VPSuite()`` -> ``create_model`` at 64x64 RGB
   in bf16 -> ``predict(32 x 5 frames, pred_frames=10)`` for EF-ConvLSTM
   per-step (K1) and with ``use_fused_scan`` (K3), and for EF-TrajGRU
   (``"trajgru"``: the warp forward), with the kernels' launch counts set to 0
   just before each and read just after (K8 and K9 at 0: no model reaches
   them, as in the JAX package); checks the predictions, and at b=2 holds
   them against the same weights run on the CPU in f32;
10. drives the training path: ``create_train_state`` and ``make_train_step``
    (Adam, lr 1e-4, MSE) on the same models' configurations, b=32, 5 -> 10,
    bf16: EF-ConvLSTM per-step (K1 + K2) and fused (K3s + K4), EF-TrajGRU (the
    warp forward and backward), with the counts set to 0 just before the first
    step and read just after; checks losses, gradients and launch counts,
    prints the share of the warp backward's taps outside their block's band
    for the indices of EF-TrajGRU's second step, and at b=2 holds one f32 SGD
    step on the card against the same step on the CPU;
11. times each kernel at the shapes its path gives it, beside its plain
    version, its bound and the one PyTorch call that computes the same
    function (``F.grid_sample`` for the warp, ``torch.einsum`` for K9's
    forward; for K8, whose fused function no one call computes,
    ``warp_flow_ret`` itself, forward and backward through autograd, on the
    same inputs; beside K9's backward call, as a comparison,
    ``torch.autograd.grad`` through ``torch.einsum``), and times
    ``predict`` and the train step, with the warp forward's device time in
    EF-TrajGRU's ``predict`` and the warp forward's and backward's in its
    train step under the profiler.

Any failed check exits non-zero before the result lines. The last two lines
of standard output are the kernels' JSON line and the result JSON line.
"""
import contextlib
import io
import json
import math
import re
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
#: (side, channels) of EF-ConvLSTM's recurrent cells at 64x64, and of EF-TrajGRU's.
CELLS = ((64, 64), (32, 96), (16, 96))
TRAJ_L = 13                 # EF-TrajGRU's flows per layer
#: the paths driven: name -> (registry id, model configuration).
PATHS = {
    "per_step": ("convlstm-shi", {}),
    "fused_scan": ("convlstm-shi", dict(use_fused_scan=True, interleaved_encode=False,
                                        interleaved_forecast=False)),
    "trajgru": ("trajgru", {}),
}
KERNEL_IDS = ("K1", "K2", "K3", "K3s", "K4", "warp_fwd", "warp_bwd", "warp_ret_fwd", "warp_ret_bwd",
              "warp_contract_fwd", "warp_contract_bwd")


def _launches(**counts):
    return {k: counts.get(k, 0) for k in KERNEL_IDS}


#: launches per predict on each path (3 layers, 5 -> 10: 15 cell steps per
#: layer); the fused path's K3 count is also held against the model's scans.
WANT_PREDICT_LAUNCHES = {"per_step": _launches(K1=45), "fused_scan": _launches(K3=6),
                         "trajgru": _launches(warp_fwd=45)}
#: launches per train step on each path.
WANT_TRAIN_LAUNCHES = {"per_step": _launches(K1=45, K2=45),
                       "fused_scan": _launches(K3s=6, K4=6),
                       "trajgru": _launches(warp_fwd=45, warp_bwd=45)}
#: no model reaches K8 or K9 (the JAX package's TrajGRU runs warp_flow_ret); their
#: path is their entry points, ``warp_ret`` and ``warp_contract`` with their
#: gradients, run once at each of EF-TrajGRU's three layer shapes in bf16. Each
#: backward call is several launches: K8's three, K9's two.
WANT_ENTRY_LAUNCHES = _launches(warp_ret_fwd=len(CELLS), warp_ret_bwd=3 * len(CELLS),
                                warp_contract_fwd=len(CELLS), warp_contract_bwd=2 * len(CELLS))

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
#: the warp forward, f32: the same f32 formula, products summed in another
#: order (FMA on the card), on values of order 1.
WARP_ATOL_F32 = 1e-5
#: the warp forward, bf16: both sides round an f32 sum of the same four
#: products, which differ by WARP_ATOL_F32 at most: one bf16 ulp of the value.
WARP_BF16_ULPS = 1
#: the warp backward and the warp's gradients through its Function, f32,
#: relative to the largest of each kind: sums over c (d_iy, d_ix) and the
#: f32 atomics (d_img) taken in another order.
WARP_GRAD_REL_F32 = 1e-5
#: bf16: d_img is an f32 sum rounded to bf16 on both sides, so one rounding
#: may flip: one bf16 ulp of the largest (2^-7 of it), plus the f32 limit;
#: d_iy and d_ix stay f32 sums of the same bf16 values.
WARP_GRAD_REL_BF16 = 2 ** -7 + WARP_GRAD_REL_F32
#: K8 (warp_ret) in f32 against its plain versions and through its Function,
#: relative to the largest of each kind: sums of L*f products (the forward,
#: g_l) or of b*P products (d_W) taken in another order, d_img by f32 atomics.
RET_REL_F32 = 1e-5
#: K9 (warp_contract) in f32, relative to the largest: sums of h*w products (the
#: forward, d_A, d_Bm) or of L*P*h*w (d_img) taken in another order.
CONTRACT_REL_F32 = 5e-5
#: K8 and K9 in bf16, relative to the largest of each kind: both sides round
#: each result once (one bf16 ulp of the largest is at most 2^-7 of it), and a
#: sum taken in another order flips some of those roundings, and those of K8's
#: samples and g_l, which both sides round; K9's kernel rounds M = A*Bm to
#: bf16 (as the TPU kernel forms it), where the plain version keeps f32.
FACTOR_REL_BF16 = 2 ** -6
#: warp_ret against warp_flow_ret (the warp kernel and a cuBLAS GEMM), relative
#: to the largest of each kind, in f32: sums taken in another order.
FLOW_RET_REL_F32 = 1e-5
#: in bf16: warp_flow_ret also rounds the bias to bf16 and computes d_w and
#: d_bias in bf16 (each rounded once), where warp_ret keeps them in f32.
FLOW_RET_REL_BF16 = 2 ** -5
#: bf16 warp_contract beyond the layer shapes, (b, L, P, h, w, c): w = 200, whose
#: d_A / d_Bm run in two column chunks of 128 with f32 scratch, and h = 512, whose
#: forward stages its A tile in two parts.
CONTRACT_EXTRA = ((1, 1, 400, 2, 200, 8), (1, 1, 128, 512, 16, 8))
#: the one-hot warp_contract against warp_sample in f32: at most four non-zero
#: products per output, summed in another order, on values of order 1.
ONEHOT_ATOL_F32 = 1e-5
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
    r"""(bytes, ops) of one K4 launch: z, c_prev, dh_seq, dh_last, dc_last,
    weights and peepholes read, dz written, dh0 and dc0 written in f32; the
    transposed 3x3 conv's MACs."""
    px = B * side * side
    elems = steps * px * (4 + 1 + 1 + 4) * enc + 2 * px * enc + 36 * enc * enc \
        + 3 * side * side * enc
    return elems * itemsize + 2 * px * enc * 4, 2 * steps * px * 9 * 4 * enc * enc


def warp_cost(side, ch, itemsize, backward=False):
    r"""(bytes, ops) of one warp launch at b=32, L=13, P=side^2. Forward: the
    image and the f32 indices read once, the [b, P, L, c] output written
    once; 4 multiply-adds per output element. Backward: g, the image and the
    indices read once, d_img (in the image's type) and the f32 index
    gradients written once; per element of g 4 products for d_img, 4
    additions into it and 8 operations for d_iy and d_ix."""
    samples = B * side * side * TRAJ_L
    img = B * side * side * ch * itemsize
    if backward:
        return samples * ch * itemsize + 2 * img + 4 * samples * 4, 16 * samples * ch
    return img + 2 * samples * 4 + samples * ch * itemsize, 8 * samples * ch


def warp_ret_cost(side, ch, itemsize, backward=False):
    r"""(bytes, ops) of one K8 call at b=32, L=13, f=ch, O=3ch, P=side^2, with
    the work as the JAX kernels define it. Forward: the image, the f32
    indices, w and the f32 bias read once, the [b, P, O] output written once;
    the contraction's 2*b*P*L*f*O operations and the gather's 8 per sample and
    channel. Backward: g, the image, the indices and w read once, d_img (in
    the image's type), the f32 index gradients and the f32 d_w written once;
    the two contractions the function needs (g_l = g W_l^T and d_W = warp_l^T
    g) and 24 operations per sample and channel for the gathers (the warp
    that d_W needs among them) and the scatter."""
    P, O = side * side, 3 * ch
    samples = B * P * TRAJ_L
    img, w = B * P * ch * itemsize, TRAJ_L * ch * O * itemsize
    mac = 2 * samples * ch * O
    if backward:
        return (B * P * O * itemsize + 2 * img + 4 * samples * 4 + w + TRAJ_L * ch * O * 4,
                2 * mac + 24 * samples * ch)
    return img + 2 * samples * 4 + w + O * 4 + B * P * O * itemsize, mac + 8 * samples * ch


def contract_cost(side, ch, itemsize, backward=False):
    r"""(bytes, ops) of one K9 call at b=32, L=13, an image side x side x ch
    and P = side^2 output pixels. Forward: A [b, L, P, h], Bm [b, L, P, w] and
    the image read once, out [b, L, P, c] written once; 2*b*L*P*h*w*c
    operations. Backward: A, Bm, the image and g read once, d_A, d_Bm and
    d_img written once; twice the forward's operations."""
    P = side * side
    fac, img, out = B * TRAJ_L * P * side * itemsize, B * P * ch * itemsize, \
        B * TRAJ_L * P * ch * itemsize
    ops = 2 * B * TRAJ_L * P * P * ch
    if backward:
        return 4 * fac + 2 * img + out, 2 * ops
    return 2 * fac + img + out, ops


def bound_ms(nbytes, ops, peak_ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def summed(rows, peak_ops):
    r"""Per-step totals of per-launch rows ``(count, ms, plain_ms, bytes, ops)``
    or ``(count, ms, plain_ms, bytes, ops, library_ms)``."""
    out = dict(ms=sum(n * r[0] for n, *r in rows), plain_ms=sum(n * r[1] for n, *r in rows))
    out["bound_ms"], out["bound_by"] = bound_ms(sum(n * r[2] for n, *r in rows),
                                                sum(n * r[3] for n, *r in rows), peak_ops)
    out["library_ms"] = sum(n * r[4] for n, *r in rows) if all(len(r) == 6 for r in rows) \
        else None
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
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        build.build_all(verbose=True)
    print(log.getvalue(), end="")
    print(f"[build] CUDA kernels built in {time.time() - t0:.1f} s")
    check_no_spills(log.getvalue())
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    errs = {}
    suite = serving_suite()
    scan_launches = fused_scan_launches(suite.models[list(PATHS).index("fused_scan")].model)
    gate_inputs = check_gate_kernels(rnd, errs)
    check_scan_forward(rnd, errs)
    scan_inputs = check_scan_backward(rnd, errs, scan_launches)
    warp_inputs = check_warp_kernels(rnd, errs)
    ret_inputs = check_warp_ret(rnd, errs)
    contract_inputs = check_warp_contract(rnd, errs)
    entry_launches = drive_entry_points(ret_inputs, contract_inputs)
    serve = drive_serving(suite, scan_launches)
    train = drive_training()

    kernels = time_kernels(serve, train, gate_inputs, scan_inputs, warp_inputs, rnd, errs)
    kernels += time_factor_kernels(ret_inputs, contract_inputs, entry_launches, errs)
    time_paths(serve, train)
    print(f"[done] {time.time() - t_start:.0f} s; kernel times below are per predict (K1, K3, "
          f"warp_fwd) or per train step (K2, K3s, K4, warp_bwd), all of their launches, or (K8, "
          f"K9) one call at each of the three layer shapes, in bf16, on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


#: the kernels whose every instantiation must build without spilling: the scan
#: kernels, K8's bf16 kernels, and K9's bf16 forward and general d_A / d_Bm kernel
SPILL_CHECKED = (r"scan_(fwd|bwd)_(bf16|f32)_kernel(I[LiE\d]+E)?",
                 r"warp_ret_(fwd|bwd_img|bwd_dw)_bf16_kernelI[LiE\d]+E",
                 r"contract_(fwd|dab_general)_bf16_kernelI[LiE\d]+E")


def check_no_spills(log):
    r"""Every instantiation of :data:`SPILL_CHECKED` builds without spilling
    registers, as ptxas's ``-v`` report in ``log`` says: they keep their
    accumulators (and the bf16 kernels their A fragments) in registers."""
    spilled, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = entry.group(1)
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and name:
            for pattern in SPILL_CHECKED:
                kernel = re.search(pattern, name)
                if kernel:
                    spilled[kernel.group(0)] = int(spill.group(1)) + int(spill.group(2))
            name = None
    print("[build] bytes spilled: " + ", ".join(f"{k} {v}" for k, v in sorted(spilled.items())))
    for prefix in ("scan_fwd_bf16", "scan_bwd_bf16", "warp_ret_fwd_bf16", "warp_ret_bwd_img_bf16",
                   "warp_ret_bwd_dw_bf16", "contract_fwd_bf16", "contract_dab_general_bf16"):
        check(any(k.startswith(prefix) for k in spilled),
              f"no -Xptxas -v report of {prefix}_kernel in the build's output")
    check(not any(spilled.values()),
          f"kernels spill registers: {({k: v for k, v in spilled.items() if v})}")


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
        d_h = rnd(B, side, side, enc, scale=1e-2)
        d_c = rnd(B, side, side, enc, scale=1e-2)
        for dt in (torch.float32, torch.bfloat16):
            args = [a if a is None or i == 4 else a.to(dt) for i, a in enumerate(base)]
            _, _, z, c_prev = convlstm_scan_forward(*args, seq_len=steps, save_gates=True)
            bwd_args = (z, c_prev, d_seq.to(dt), d_c.to(dt), args[3], *args[5:], d_h.to(dt))
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
                loss = (seq.float() * d_seq).sum() + (h.float() * d_h).sum() \
                    + (c.float() * d_c).sum()
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


def warp_args(rnd, side, ch):
    r"""EF-TrajGRU's warp operands at one layer shape, b=32, L=13, f32:
    indices a few pixels off each output pixel (N(0, 2)), a tenth of them
    sent 0.6 of the image out of it; an image and a cotangent of the size a
    mean-type loss hands down."""
    import torch
    P = side * side
    grid = torch.arange(P, device="cuda")
    oy = (grid // side).float().view(1, P, 1)
    ox = (grid % side).float().view(1, P, 1)
    idx = []
    for o in (oy, ox):
        far = (rnd(B, P, TRAJ_L) > 1.2816).float()          # the top tenth of N(0, 1)
        side_sign = torch.sign(rnd(B, P, TRAJ_L))
        idx.append(o + rnd(B, P, TRAJ_L, scale=2.0) + far * side_sign * 0.6 * side)
    return [*idx, rnd(B, side, side, ch), rnd(B, P, TRAJ_L, ch, scale=1e-2)]


def band_share(iy, ix, h, w, c, bf16=True, forward=False):
    r"""``((taps outside their block's band, taps in the image), tiling)`` of
    the warp backward (or, with ``forward``, the forward) on these indices,
    with the tiling its kernel takes for these sizes on this card
    (``vp_warp_bwd_geometry``, ``vp_warp_fwd_geometry``)."""
    from vp_suite_tpu_torch.kernels import build, warp_bwd_variants, warp_fwd_variants
    b, P, L = iy.shape
    tool = warp_fwd_variants if forward else warp_bwd_variants
    geom = tool.geometry(build.warp_library(), b, P, L, h, w, c, bf16)
    return warp_bwd_variants.out_of_band_share(iy, ix, h, w, geom), geom


@contextlib.contextmanager
def recording_band_shares(shares):
    r"""While active, every backward of ``WarpFunction`` first adds its
    indices' ``(outside, in-image)`` tap counts (:func:`band_share`) to
    ``shares[(h, w, c)]``."""
    import torch
    from vp_suite_tpu_torch.ops.warp import WarpFunction
    plain = WarpFunction.backward

    def backward(ctx, g):
        iy, ix, img = ctx.saved_tensors
        _, h, w, c = img.shape
        (outside, taps), _ = band_share(iy, ix, h, w, c, img.dtype == torch.bfloat16)
        acc = shares.setdefault((h, w, c), [0, 0])
        acc[0] += outside
        acc[1] += taps
        return plain(ctx, g)

    WarpFunction.backward = staticmethod(backward)
    try:
        yield shares
    finally:
        WarpFunction.backward = staticmethod(plain)


def check_warp_kernels(rnd, errs):
    r"""The warp's forward and backward kernels against their plain versions,
    and its three gradients through ``WarpFunction`` against autograd of the
    plain forward, at EF-TrajGRU's three layer shapes; returns the bf16
    operands by shape, for the timings."""
    import torch
    from vp_suite_tpu_torch.ops.warp import (warp_sample, warp_sample_backward,
                                             warp_sample_backward_reference,
                                             warp_sample_forward, warp_sample_reference)
    errs["warp_fwd"] = errs["warp_bwd"] = 0.0
    inputs = {}
    names = ("d_iy", "d_ix", "d_img")
    for side, ch in CELLS:
        base = warp_args(rnd, side, ch)
        out_of_image = ((base[0] < 0) | (base[0] > side - 1) | (base[1] < 0)
                        | (base[1] > side - 1)).float().mean().item()
        (outside, taps), geom = band_share(base[0], base[1], side, side, ch)
        print(f"[warp] {side}x{side}x{ch} b={B} L={TRAJ_L}: the backward's tiling in bf16 {geom}; "
              f"{outside} of {taps} in-image taps ({outside / taps:.2%}) fall outside their "
              f"block's band and go to global atomics")
        for dt in (torch.bfloat16, torch.float32):
            (outside, taps), geom = band_share(base[0], base[1], side, side, ch,
                                               dt == torch.bfloat16, forward=True)
            print(f"[warp] {side}x{side}x{ch} b={B} L={TRAJ_L}: the forward's tiling in "
                  f"{str(dt)[6:]} {geom}; {outside} of {taps} in-image taps ({outside / taps:.2%}) "
                  f"fall outside their block's band and are read from global memory")
        for dt in (torch.float32, torch.bfloat16):
            iy, ix, img, g = base[0], base[1], base[2].to(dt), base[3].to(dt)
            got = warp_sample_forward(iy, ix, img)
            torch.cuda.synchronize()
            want = warp_sample_reference(iy, ix, img)
            e_fwd = max_err(got, want)
            if dt == torch.float32:
                ok_fwd = e_fwd <= WARP_ATOL_F32
                tol_fwd = f"atol {WARP_ATOL_F32}"
            else:
                ok_fwd = bool(((got.float() - want.float()).abs()
                               <= WARP_BF16_ULPS * bf16_ulp(want) + WARP_ATOL_F32).all())
                tol_fwd = f"{WARP_BF16_ULPS} bf16 ulp + {WARP_ATOL_F32}"
            ok_fwd = ok_fwd and got.dtype == dt and got.shape == want.shape

            got_b = warp_sample_backward(iy, ix, img, g)
            torch.cuda.synchronize()
            want_b = warp_sample_backward_reference(iy, ix, img, g)
            rel = WARP_GRAD_REL_F32 if dt == torch.float32 else WARP_GRAD_REL_BF16
            e_bwd = [rel_err(q, w) for q, w in zip(got_b, want_b)]
            ok_bwd = max(e_bwd) <= rel and all(q.dtype == w.dtype for q, w in zip(got_b, want_b))

            grads = []
            for fn in (warp_sample, warp_sample_reference):
                leaves = [a.detach().clone().requires_grad_() for a in (iy, ix, img)]
                grads.append(torch.autograd.grad(fn(*leaves), leaves, g))
            e_fn = [rel_err(q, w) for q, w in zip(*grads)]
            ok_fn = max(e_fn) <= rel
            del grads
            if dt == torch.bfloat16:
                errs["warp_fwd"] = max(errs["warp_fwd"], e_fwd)
                errs["warp_bwd"] = max(errs["warp_bwd"], *(max_err(q, w)
                                                           for q, w in zip(got_b, want_b)))
                inputs[(side, ch)] = (iy, ix, img, g)
            print(f"[warp] {side}x{side}x{ch} b={B} L={TRAJ_L} {str(dt)[6:]} "
                  f"({out_of_image:.1%} of the samples out of the image): forward max err "
                  f"{e_fwd:.3g} ({tol_fwd}); backward "
                  + ", ".join(f"{n} {x:.3g}" for n, x in zip(names, e_bwd))
                  + "; through the Function against autograd of the plain forward "
                  + ", ".join(f"{n} {x:.3g}" for n, x in zip(names, e_fn))
                  + f" (relative to the largest, tol {rel:.3g}): "
                  f"{'ok' if ok_fwd and ok_bwd and ok_fn else 'FAIL'}")
            check(ok_fwd, f"the warp forward disagrees with warp_sample_reference at "
                          f"{side}x{side}x{ch} {dt}")
            check(ok_bwd, f"the warp backward disagrees with warp_sample_backward_reference at "
                          f"{side}x{side}x{ch} {dt}")
            check(ok_fn, f"the warp's gradients disagree with autograd of the plain forward at "
                         f"{side}x{side}x{ch} {dt}")
    return inputs


def ret_args(rnd, side, ch):
    r"""K8's operands at one layer shape, b=32, L=13, f32: flows [b, side,
    side, 2L] of a few pixels (N(0, 2)), a tenth of their components sent 0.6
    of the image out of it; an image; ret weights [L, f, 3f] at the scale of
    the conv's init; a bias; a cotangent [b, P, 3f] of the size a mean-type
    loss hands down."""
    import torch
    shape = (B, side, side, 2 * TRAJ_L)
    far = (rnd(*shape) > 1.2816).float()
    flows = rnd(*shape, scale=2.0) + far * torch.sign(rnd(*shape)) * 0.6 * side
    return [flows, rnd(B, side, side, ch), rnd(TRAJ_L, ch, 3 * ch, scale=(TRAJ_L * ch) ** -0.5),
            rnd(3 * ch, scale=0.1), rnd(B, side * side, 3 * ch, scale=1e-2)]


def report(tag, parts, ok):
    r"""One result line: ``parts`` are ``(label, {name: error}, tolerance)``."""
    print(f"[{tag}] " + "; ".join(f"{label} " + ", ".join(f"{n} {e:.3g}" for n, e in es.items())
                                 + f" (tol {tol:.3g})" for label, es, tol in parts)
          + f": {'ok' if ok else 'FAIL'}")


def check_warp_ret(rnd, errs):
    r"""K8's forward and backward kernels against their plain versions, its
    five gradients through ``WarpRetFunction`` against autograd of the plain
    forward, and ``warp_ret`` against ``warp_flow_ret`` (the warp kernel and a
    cuBLAS GEMM, the unfused path TrajGRU runs) for the output and the five
    gradients, at EF-TrajGRU's three layer shapes in f32 and bf16; returns the
    bf16 operands by shape, for the timings."""
    import torch
    from vp_suite_tpu_torch.ops.grid_sample import _flow_to_indices, warp_flow_ret
    from vp_suite_tpu_torch.ops.warp import (warp_ret, warp_ret_backward,
                                             warp_ret_backward_reference, warp_ret_forward,
                                             warp_ret_reference)
    from vp_suite_tpu_torch.kernels import build, k8_variants
    errs["warp_ret_fwd"] = errs["warp_ret_bwd"] = 0.0
    names = ("d_iy", "d_ix", "d_img", "d_w", "d_bias")
    inputs = {}
    props = torch.cuda.get_device_properties(0)
    limits = (props.multi_processor_count,
              getattr(props, "shared_memory_per_block_optin", k8_variants.H100_LIMITS[1]))
    for side, ch in CELLS:
        got = k8_variants.geometry(build.warp_ret_library(), B, side * side, TRAJ_L, side, side, ch,
                                   3 * ch)
        want = k8_variants.plan(B, side * side, TRAJ_L, side, side, ch, 3 * ch, limits=limits)
        print(f"[K8] {side}x{side}x{ch} b={B} L={TRAJ_L} O={3 * ch}: the bf16 kernels' plan {got}")
        check(got == want, f"K8's plan at {side}x{side}x{ch} is not its Python mirror {want}")
        flows, img0, w, bias, g0 = ret_args(rnd, side, ch)
        iy, ix = _flow_to_indices(img0, flows)
        for dt in (torch.float32, torch.bfloat16):
            img, g = img0.to(dt), g0.to(dt)
            got = warp_ret_forward(iy, ix, img, w, bias)
            got_b = warp_ret_backward(iy, ix, img, w, bias, g)
            torch.cuda.synchronize()
            want = warp_ret_reference(iy, ix, img, w, bias)
            want_b = warp_ret_backward_reference(iy, ix, img, w, bias, g)
            e_k = {"out": rel_err(got, want), **{n: rel_err(q, r)
                                                 for n, q, r in zip(names, got_b, want_b)}}
            typed = got.dtype == dt and got.shape == want.shape \
                and all(q.dtype == r.dtype and q.shape == r.shape for q, r in zip(got_b, want_b))

            grads = []
            for fn in (warp_ret, warp_ret_reference):
                leaves = [a.detach().clone().requires_grad_() for a in (iy, ix, img, w, bias)]
                grads.append(torch.autograd.grad(fn(*leaves), leaves, g))
            e_fn = {n: rel_err(q, r) for n, q, r in zip(names, *grads)}

            # the unfused path on the same image, flows, weights and bias; the
            # flows' gradient holds d_ix (its even channels) and d_iy (odd)
            outs, grads = [], []
            for fused in (True, False):
                im, fl, wl, bl = (a.detach().clone().requires_grad_()
                                  for a in (img, flows, w, bias))
                if fused:
                    out = warp_ret(*_flow_to_indices(im, fl), im, wl, bl)
                else:
                    out = warp_flow_ret(im, fl, wl.view(-1, 3 * ch), bl).view(B, -1, 3 * ch)
                d_img, d_fl, d_w, d_b = torch.autograd.grad(out, (im, fl, wl, bl), g)
                outs.append(out.detach())
                grads.append((d_fl[..., 1::2], d_fl[..., 0::2], d_img, d_w, d_b))
            e_flow = {"out": rel_err(*outs), **{n: rel_err(q, r) for n, q, r in zip(names, *grads)}}
            del grads, outs

            f32 = dt == torch.float32
            rel = RET_REL_F32 if f32 else FACTOR_REL_BF16
            rel_flow = FLOW_RET_REL_F32 if f32 else FLOW_RET_REL_BF16
            ok = typed and max(*e_k.values(), *e_fn.values()) <= rel \
                and max(e_flow.values()) <= rel_flow
            if not f32:
                errs["warp_ret_fwd"] = max(errs["warp_ret_fwd"], max_err(got, want))
                errs["warp_ret_bwd"] = max(errs["warp_ret_bwd"], *(max_err(q, r)
                                                                   for q, r in zip(got_b, want_b)))
                inputs[(side, ch)] = (iy, ix, img, w, bias, g, flows)
            report(f"K8 warp_ret {side}x{side}x{ch} b={B} L={TRAJ_L} O={3 * ch} {str(dt)[6:]}",
                   [("kernels against the plain versions", e_k, rel),
                    ("through the Function against autograd of the plain forward", e_fn, rel),
                    ("warp_ret against warp_flow_ret", e_flow, rel_flow)], ok)
            check(ok, f"warp_ret disagrees at {side}x{side}x{ch} {dt} (errors relative to the "
                      f"largest of each kind)")
    return inputs


def check_warp_contract(rnd, errs):
    r"""K9's forward and backward kernels against their plain versions on
    dense random factors, and its three gradients through
    ``WarpContractFunction`` against autograd of the plain forward (on the
    first four batch items: autograd saves a [b, P, w, c] f32 intermediate
    per flow), at EF-TrajGRU's three layer shapes in f32 and bf16; and the
    one-hot route, ``warp_contract`` on ``_onehot_factor``s, against
    ``warp_sample`` (K5) in f32. Returns the bf16 operands by shape."""
    import torch
    from vp_suite_tpu_torch.ops.grid_sample import _onehot_factor
    from vp_suite_tpu_torch.ops.warp import (warp_contract, warp_contract_backward,
                                             warp_contract_backward_reference,
                                             warp_contract_forward, warp_contract_reference,
                                             warp_sample)
    errs["warp_contract_fwd"] = errs["warp_contract_bwd"] = 0.0
    names = ("d_A", "d_Bm", "d_img")
    inputs = {}
    for side, ch in CELLS:
        P = side * side
        # dense factors at the one-hot factors' scale: out is of order 1
        base = [rnd(B, TRAJ_L, P, side, scale=side ** -0.5), rnd(B, TRAJ_L, P, side,
                                                                scale=side ** -0.5),
                rnd(B, side, side, ch), rnd(B, TRAJ_L, P, ch, scale=1e-2)]
        for dt in (torch.float32, torch.bfloat16):
            A, Bm, img, g = (a.to(dt) for a in base)
            got = warp_contract_forward(A, Bm, img)
            got_b = warp_contract_backward(A, Bm, img, g)
            torch.cuda.synchronize()
            want = warp_contract_reference(A, Bm, img)
            want_b = warp_contract_backward_reference(A, Bm, img, g)
            e_k = {"out": rel_err(got, want), **{n: rel_err(q, r)
                                                 for n, q, r in zip(names, got_b, want_b)}}
            typed = got.dtype == dt and got.shape == want.shape \
                and all(q.dtype == dt and q.shape == r.shape for q, r in zip(got_b, want_b))
            e_abs = [max_err(got, want)] + [max_err(q, r) for q, r in zip(got_b, want_b)]
            del want, want_b
            grads = []
            for fn in (warp_contract, warp_contract_reference):
                leaves = [a[:4].detach().clone().requires_grad_() for a in (A, Bm, img)]
                grads.append(torch.autograd.grad(fn(*leaves), leaves, g[:4]))
            e_fn = {n: rel_err(q, r) for n, q, r in zip(names, *grads)}
            del grads
            rel = CONTRACT_REL_F32 if dt == torch.float32 else FACTOR_REL_BF16
            ok = typed and max(*e_k.values(), *e_fn.values()) <= rel
            parts = [("kernels against the plain versions", e_k, rel),
                     ("through the Function against autograd of the plain forward (b=4)", e_fn,
                      rel)]
            if dt == torch.float32:
                iy, ix, im, _ = warp_args(rnd, side, ch)
                onehot = warp_contract(_onehot_factor(iy.transpose(1, 2), side, dt),
                                       _onehot_factor(ix.transpose(1, 2), side, dt), im)
                e_hot = max_err(onehot.transpose(1, 2), warp_sample(iy, ix, im))
                ok = ok and e_hot <= ONEHOT_ATOL_F32
                parts.append(("one-hot warp_contract against warp_sample, absolute",
                              {"out": e_hot}, ONEHOT_ATOL_F32))
                del onehot
            else:
                errs["warp_contract_fwd"] = max(errs["warp_contract_fwd"], e_abs[0])
                errs["warp_contract_bwd"] = max(errs["warp_contract_bwd"], *e_abs[1:])
                inputs[(side, ch)] = (A, Bm, img, g)
            report(f"K9 warp_contract {side}x{side}x{ch} b={B} L={TRAJ_L} {str(dt)[6:]}", parts,
                   ok)
            check(ok, f"warp_contract disagrees at {side}x{side}x{ch} {dt} (errors relative to "
                      f"the largest of each kind)")
    # beyond the layer shapes, bf16: a wide image and a tall one
    for b, Lf, P, h, w, c in CONTRACT_EXTRA:
        A, Bm = rnd(b, Lf, P, h, scale=h ** -0.5, dtype=torch.bfloat16), \
            rnd(b, Lf, P, w, scale=w ** -0.5, dtype=torch.bfloat16)
        img, g = rnd(b, h, w, c, dtype=torch.bfloat16), rnd(b, Lf, P, c, scale=1e-2,
                                                            dtype=torch.bfloat16)
        got = [warp_contract_forward(A, Bm, img), *warp_contract_backward(A, Bm, img, g)]
        torch.cuda.synchronize()
        want = [warp_contract_reference(A, Bm, img), *warp_contract_backward_reference(A, Bm, img, g)]
        e_k = {n: rel_err(q, r) for n, q, r in zip(("out",) + names, got, want)}
        ok = max(e_k.values()) <= FACTOR_REL_BF16 and all(q.dtype == torch.bfloat16
                                                          and q.shape == r.shape
                                                          for q, r in zip(got, want))
        report(f"K9 warp_contract b={b} L={Lf} P={P} {h}x{w}x{c} bf16",
               [("kernels against the plain versions", e_k, FACTOR_REL_BF16)], ok)
        check(ok, f"bf16 warp_contract disagrees at b={b} L={Lf} P={P} {h}x{w}x{c}")
    return inputs


def drive_entry_points(ret_inputs, contract_inputs):
    r"""K8's and K9's path: ``warp_ret`` and ``warp_contract`` forward and
    backward through autograd, once at each layer shape in bf16, with the
    launch counts set to 0 just before and read just after; returns them."""
    import torch
    from vp_suite_tpu_torch.ops.warp import warp_contract, warp_ret
    counters = reset_counts()
    for key, (iy, ix, img, w, bias, g, _) in ret_inputs.items():
        leaves = [a.detach().clone().requires_grad_() for a in (iy, ix, img, w, bias)]
        grads = torch.autograd.grad(warp_ret(*leaves), leaves, g)
        check(all(bool(torch.isfinite(d).all()) for d in grads),
              f"warp_ret at {key}: non-finite gradients")
    for key, (A, Bm, img, g) in contract_inputs.items():
        leaves = [a.detach().clone().requires_grad_() for a in (A, Bm, img)]
        grads = torch.autograd.grad(warp_contract(*leaves), leaves, g)
        check(all(bool(torch.isfinite(d).all()) for d in grads),
              f"warp_contract at {key}: non-finite gradients")
    torch.cuda.synchronize()
    launches = read_counts(counters)
    print("[entry points] warp_ret and warp_contract with their gradients at the three layer "
          "shapes, bf16: kernel launches " + ", ".join(f"{k} {v}" for k, v in launches.items()))
    check(launches == WANT_ENTRY_LAUNCHES,
          f"the entry points launched {launches}, not {WANT_ENTRY_LAUNCHES}")
    return launches


def create_models(suite, **kw):
    r"""One model per path in ``suite``, at 64x64 RGB from the seed; returns
    their indices by path."""
    for model_id, cfg in PATHS.values():
        suite.create_model(model_id, img_shape=IMG, action_size=0, tensor_value_range=(0.0, 1.0),
                           seed=SEED, **kw, **cfg)
    return {name: i for i, name in enumerate(PATHS)}


def serving_suite():
    r"""A ``VPSuite`` on the card with one model per path, in bf16."""
    import torch
    from vp_suite_tpu_torch import VPSuite
    suite = VPSuite()
    create_models(suite, compute_dtype=torch.bfloat16)
    return suite


def drive_serving(suite, scan_launches):
    r"""``predict`` on each path, with the kernels counted around each call."""
    import torch
    from vp_suite_tpu_torch import VPSuite
    frames = torch.rand((B, CTX, IMG[1], IMG[2], IMG[0]),
                        generator=torch.Generator().manual_seed(SEED))

    preds, launches = {}, {}
    for i, name in enumerate(PATHS):
        counters = reset_counts()
        preds[name] = suite.predict(frames, pred_frames=PRED, model_idx=i)
        torch.cuda.synchronize()
        launches[name] = read_counts(counters)
        print(f"[predict] {name}: kernel launches in one predict: "
              + ", ".join(f"{k} {v}" for k, v in launches[name].items()))
        check(launches[name] == WANT_PREDICT_LAUNCHES[name],
              f"{name}: one predict launched {launches[name]}, not {WANT_PREDICT_LAUNCHES[name]}")
    check(launches["fused_scan"]["K3"] == len(scan_launches),
          f"the fused-scan serving path launched K3 {launches['fused_scan']['K3']} times, not "
          f"once for each of its {len(scan_launches)} scans {scan_launches}")

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
    create_models(cpu_suite)
    create_models(f32_suite, compute_dtype=torch.float32)
    for i, name in enumerate(PATHS):
        ref = cpu_suite.predict(frames[:2], pred_frames=PRED, model_idx=i)
        d32 = (f32_suite.predict(frames[:2], pred_frames=PRED, model_idx=i).cpu() - ref)
        d32 = d32.abs().max().item()
        d16 = (preds[name][:2].cpu() - ref).abs().max().item()
        print(f"[predict] {name} b=2 against the CPU in f32: card f32 max diff {d32:.3g} "
              f"(atol {PREDICT_ATOL_F32}), card bf16 max diff {d16:.3g} "
              f"(atol {PREDICT_ATOL_BF16}); |pred| max {ref.abs().max().item():.3g}")
        check(d32 <= PREDICT_ATOL_F32, f"{name}: f32 predict on the card disagrees with the CPU")
        check(d16 <= PREDICT_ATOL_BF16, f"{name}: bf16 predict on the card disagrees with the CPU")
    return dict(suite=suite, frames=frames, launches=launches, scan_launches=scan_launches)


def reset_counts():
    r"""Sets every kernel's launch count to 0; returns the counters by kernel id."""
    from vp_suite_tpu_torch.ops.cells import convlstm_gate_backward, convlstm_gate_fuse
    from vp_suite_tpu_torch.ops.convlstm import convlstm_scan_backward, convlstm_scan_fused
    from vp_suite_tpu_torch.ops.warp import (warp_contract_backward, warp_contract_forward,
                                             warp_ret_backward, warp_ret_forward, warp_sample,
                                             warp_sample_backward)
    counters = {"K1": (convlstm_gate_fuse, "launches"), "K2": (convlstm_gate_backward, "launches"),
                "K3": (convlstm_scan_fused, "launches"),
                "K3s": (convlstm_scan_fused, "save_gates_launches"),
                "K4": (convlstm_scan_backward, "launches"),
                "warp_fwd": (warp_sample, "launches"),
                "warp_bwd": (warp_sample_backward, "launches"),
                "warp_ret_fwd": (warp_ret_forward, "launches"),
                "warp_ret_bwd": (warp_ret_backward, "launches"),
                "warp_contract_fwd": (warp_contract_forward, "launches"),
                "warp_contract_bwd": (warp_contract_backward, "launches")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    return counters


def read_counts(counters):
    return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}


def unused_parameters(model):
    r"""Names of the parameters that no path through ``model`` uses: the
    input-side convs of EF-TrajGRU's first forecaster block, which runs in
    decode mode (zero input), as the JAX package's and the reference's do."""
    decode = model.dec_rnns_list[0]
    convs = [getattr(decode, n) for n in ("i2h", "i2f_conv1") if hasattr(decode, n)]
    ids = {id(p) for conv in convs for p in conv.parameters()}
    return {name for name, p in model.named_parameters() if id(p) in ids}


def drive_training():
    r"""The training path on each path's model: Adam at lr 1e-4 on one fixed
    b=32 batch of 15 frames, 2 warm-up and 5 timed steps, with the kernels'
    launch counts read around the first step; then one f32 SGD step at b=2 on
    the card against the CPU."""
    import torch
    from vp_suite_tpu_torch import VPSuite
    from vp_suite_tpu_torch.training.loop import make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    run_config = {"context_frames": CTX, "pred_frames": PRED}
    frames = torch.rand((B, CTX + PRED, IMG[1], IMG[2], IMG[0]),
                        generator=torch.Generator().manual_seed(SEED + 1)).cuda()
    batch = {"frames": frames}
    out = dict(batch=batch, steps={}, launches={})
    suite = VPSuite()
    create_models(suite, compute_dtype=torch.bfloat16)
    for i, name in enumerate(PATHS):
        model = suite.models[i].model
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
        unused = unused_parameters(model)
        for pname, p in model.named_parameters():
            if pname in unused:
                check(p.grad is None, f"{name}: unused parameter {pname} has a gradient")
                continue
            check(p.grad is not None and p.grad.dtype == torch.float32
                  and bool(torch.isfinite(p.grad).all()) and bool((p.grad != 0).any()),
                  f"{name}: parameter {pname} has no finite, non-zero f32 gradient after a step")
        losses = [float(metrics["total"])]
        with recording_band_shares({}) as shares:
            state, metrics = step(state, batch)
            losses.append(float(metrics["total"]))
        if shares:
            print(f"[train] {name}: taps of the warp backward outside their block's band, from "
                  f"the indices of one train step (not timed): "
                  + ", ".join(f"{h}x{w}x{c} {o} of {n} ({o / n:.2%})"
                              for (h, w, c), (o, n) in shares.items()))
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
    steps = {}
    for device, kw in (("cuda", dict(compute_dtype=torch.float32)), ("cpu", {})):
        models = VPSuite(device=device)
        create_models(models, **kw)
        for i, name in enumerate(PATHS):
            model = models.models[i].model
            p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
            state = create_train_state(model, lr=lr, optimizer="sgd")
            _, metrics = make_train_step(model, run_config)(
                state, {"frames": small["frames"].to(device)})
            steps[(name, device)] = (float(metrics["total"]),
                                     {k: ((p0[k] - v.detach()) / lr).cpu()
                                      for k, v in model.named_parameters()})
    for name in PATHS:
        card, host = steps[(name, "cuda")], steps[(name, "cpu")]
        worst, worst_name = 0.0, ""
        for k, want in host[1].items():
            excess = ((card[1][k] - want).abs() - STEP_TOL * want.abs()).max().item()
            if excess > worst or not worst_name:
                worst, worst_name = excess, k
        d_loss = abs(card[0] - host[0])
        ok = worst <= STEP_TOL and d_loss <= 1e-4 * abs(host[0])
        print(f"[train] {name} f32 b=2 SGD step, card against CPU: loss {card[0]:.6f} vs "
              f"{host[0]:.6f}; (p0-p1)/lr: max(|diff| - rtol*|cpu|) {worst:.3g} at "
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


def time_kernels(serve, train, gate_inputs, scan_inputs, warp_inputs, rnd, errs):
    r"""Each kernel at the shapes its path gives it, beside its plain version,
    its bound and, where there is one, the one PyTorch call that computes the
    same function; returns the kernels' JSON entries."""
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
    gate_launches = cell_launches(serve["suite"].models[list(PATHS).index("per_step")].model,
                                  lambda rnn: rnn.state_h)
    check(sum(gate_launches.values()) == serve["launches"]["per_step"]["K1"],
          f"K1 launch shapes {gate_launches} do not add up to "
          f"{serve['launches']['per_step']['K1']} launches")
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
    warp_fwd, warp_bwd = time_warp(serve, warp_inputs)

    pred_l, train_l = serve["launches"], train["launches"]
    entries = [
        ("convlstm_gate_fwd (K1)", "triton", "vp_suite_tpu_torch/ops/cells.py",
         "vp_suite_tpu/ops/pallas_cells.py:37", pred_l["per_step"]["K1"], "K1", k1),
        ("convlstm_gate_bwd (K2)", "triton", "vp_suite_tpu_torch/ops/cells.py",
         "vp_suite_tpu/ops/pallas_cells.py:54", train_l["per_step"]["K2"], "K2", k2),
        ("convlstm_scan_fwd (K3)", "cuda", "vp_suite_tpu_torch/csrc/convlstm_scan.cu",
         "vp_suite_tpu/ops/pallas_convlstm.py:102", pred_l["fused_scan"]["K3"], "K3", k3),
        ("convlstm_scan_fwd save_gates (K3s)", "cuda", "vp_suite_tpu_torch/csrc/convlstm_scan.cu",
         "vp_suite_tpu/ops/pallas_convlstm.py:147", train_l["fused_scan"]["K3s"], "K3s", k3s),
        ("convlstm_scan_bwd (K4)", "cuda", "vp_suite_tpu_torch/csrc/convlstm_scan_bwd.cu",
         "vp_suite_tpu/ops/pallas_convlstm.py:166", train_l["fused_scan"]["K4"], "K4", k4),
        ("warp_sample_fwd (K5; also K7a, pallas_warp.py:116)", "cuda",
         "vp_suite_tpu_torch/csrc/warp_sample.cu", "vp_suite_tpu/ops/pallas_warp.py:277",
         pred_l["trajgru"]["warp_fwd"], "warp_fwd", warp_fwd),
        ("warp_sample_bwd (K6a, K6b; also K7b, K7c, pallas_warp.py:135, :157)", "cuda",
         "vp_suite_tpu_torch/csrc/warp_sample.cu", "vp_suite_tpu/ops/pallas_warp.py:294",
         train_l["trajgru"]["warp_bwd"], "warp_bwd", warp_bwd),
    ]
    return [dict(name=name, route=route, source=source, replaces=replaces, launches=launches,
                 max_abs_err=errs[kid], ms=t["ms"], plain_ms=t["plain_ms"],
                 bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=t["library_ms"])
            for name, route, source, replaces, launches, kid, t in entries]


def cell_launches(model, side_of):
    r"""``{(side, channels): launches}`` of a per-step kernel that runs once
    per cell step of ``model`` in one predict (5 encoder and 10 forecaster
    steps per layer)."""
    launches = {}
    for rnns, steps in ((model.enc_rnns_list, CTX), (model.dec_rnns_list, PRED)):
        for rnn in rnns:
            shape = (side_of(rnn), rnn.enc_channels)
            launches[shape] = launches.get(shape, 0) + steps
    return launches


def grid_sample_library(iy, ix, img, g):
    r"""The one PyTorch call that computes the warp, and the one that computes
    its backward, in the image's dtype: ``F.grid_sample(align_corners=False,
    padding_mode="zeros")`` of the NCHW image at all b*P*L samples, as a grid
    ``[b, L*h, w, 2]``, and ``grid_sampler_2d_backward`` of it."""
    import torch
    import torch.nn.functional as F
    b, h, w, c = img.shape
    x = img.permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([(2 * ix + 1) / w - 1, (2 * iy + 1) / h - 1], dim=-1) \
        .reshape(b, -1, w, 2).to(img.dtype)
    grad = g.reshape(b, -1, w, c).permute(0, 3, 1, 2).contiguous()
    fwd = lambda: F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                                align_corners=False)
    bwd = lambda: torch.ops.aten.grid_sampler_2d_backward(grad, x, grid, 0, 0, False,
                                                           [True, True])
    return fwd, bwd


def time_warp(serve, warp_inputs):
    r"""The warp's forward (per predict) and backward (per train step) at
    EF-TrajGRU's launch shapes, in bf16: device time from CUDA-graph replay
    (eager: back-to-back launches from Python), beside the plain versions,
    the bounds and ``F.grid_sample``."""
    from vp_suite_tpu_torch.ops.warp import (warp_sample_backward, warp_sample_backward_reference,
                                             warp_sample_forward, warp_sample_reference)
    launches = cell_launches(serve["suite"].models[list(PATHS).index("trajgru")].model,
                             lambda rnn: rnn.sh)
    check(sum(launches.values()) == serve["launches"]["trajgru"]["warp_fwd"],
          f"warp launch shapes {launches} do not add up to "
          f"{serve['launches']['trajgru']['warp_fwd']} launches")
    rows = {"fwd": [], "bwd": []}
    for (side, ch), steps in launches.items():
        iy, ix, img, g = warp_inputs[(side, ch)]
        lib_fwd, lib_bwd = grid_sample_library(iy, ix, img, g)
        for kid, fn, ref, lib, bwd in (
                ("fwd", lambda: warp_sample_forward(iy, ix, img),
                 lambda: warp_sample_reference(iy, ix, img), lib_fwd, False),
                ("bwd", lambda: warp_sample_backward(iy, ix, img, g),
                 lambda: warp_sample_backward_reference(iy, ix, img, g), lib_bwd, True)):
            ms = graph_ms(fn, iters=20)
            eager = cuda_ms(fn, warmup=3, iters=20)
            plain = cuda_ms(ref, warmup=1, iters=3)
            library = graph_ms(lib, iters=20)
            nbytes, ops = warp_cost(side, ch, 2, backward=bwd)
            bound, by = bound_ms(nbytes, ops, F32_FLOPS)
            print(f"[time] warp_{kid} {side}x{side}x{ch} b={B} L={TRAJ_L} bf16: "
                  f"{ms * 1e3:.1f} us/launch (eager {eager * 1e3:.1f} us, plain "
                  f"{plain * 1e3:.1f} us, F.grid_sample{'' if kid == 'fwd' else ' backward'} "
                  f"{library * 1e3:.1f} us, bound {bound * 1e3:.1f} us by {by}, "
                  f"{nbytes / 1e6:.1f} MB, {nbytes / ms / 1e9:.2f} TB/s), {steps} launches/"
                  f"{'predict' if kid == 'fwd' else 'train step'}")
            rows[kid].append((steps, ms, plain, nbytes, ops, library))
    return summed(rows["fwd"], F32_FLOPS), summed(rows["bwd"], F32_FLOPS)


def einsum_library(A, Bm, img):
    r"""``(ms, None)`` of ``torch.einsum("blpy,blpx,byxc->blpc", A, Bm, img)``,
    the one PyTorch call that computes K9's forward, or ``(None, reason)``
    where its intermediate does not fit the card."""
    import torch
    try:
        return cuda_ms(lambda: torch.einsum("blpy,blpx,byxc->blpc", A, Bm, img),
                       warmup=1, iters=3), None
    except torch.cuda.OutOfMemoryError as e:
        torch.cuda.empty_cache()
        return None, str(e).splitlines()[0]


def einsum_grad_comparison(A, Bm, img, g):
    r"""``(ms, None)`` of ``torch.autograd.grad`` through
    ``torch.einsum("blpy,blpx,byxc->blpc", ...)``, forward and backward, on
    K9's backward inputs, or ``(None, reason)`` where it does not fit the card.
    A comparison for K9's backward call, not one PyTorch call that computes
    it: the row's ``library_ms`` stays null."""
    import torch
    leaves = [a.detach().requires_grad_() for a in (A, Bm, img)]
    try:
        return cuda_ms(lambda: torch.autograd.grad(
            torch.einsum("blpy,blpx,byxc->blpc", *leaves), leaves, g), warmup=1, iters=3), None
    except torch.cuda.OutOfMemoryError as e:
        torch.cuda.empty_cache()
        return None, str(e).splitlines()[0]


def time_factor_kernels(ret_inputs, contract_inputs, entry_launches, errs):
    r"""K8 and K9 per call at EF-TrajGRU's three layer shapes in bf16 (CUDA
    events over back-to-back calls; a forward call is one launch, a backward
    call K8's three or K9's two), beside their plain versions (one run each:
    K9's hold a 2 GB f32 intermediate per flow at 64x64), their bounds and:
    for K8, the unfused path TrajGRU runs, ``warp_flow_ret`` itself (the
    index math, the warp kernels and cuBLAS GEMMs), forward and backward
    through autograd on the same image, flows, weights and bias, eager and
    replayed from a CUDA graph, since no one PyTorch call computes the fused
    function; for K9's forward,
    ``torch.einsum``, and beside K9's backward call, as a comparison,
    ``torch.autograd.grad`` through it. Returns the kernels' JSON entries."""
    import torch
    from vp_suite_tpu_torch.ops.grid_sample import warp_flow_ret
    from vp_suite_tpu_torch.ops.warp import (warp_contract_backward,
                                             warp_contract_backward_reference,
                                             warp_contract_forward, warp_contract_reference,
                                             warp_ret_backward, warp_ret_backward_reference,
                                             warp_ret_forward, warp_ret_reference)
    rows = {k: [] for k in ("warp_ret_fwd", "warp_ret_bwd", "warp_contract_fwd",
                            "warp_contract_bwd")}
    #: warp_flow_ret's time summed over the shapes: (eager, on the card alone)
    unfused = {"warp_ret_fwd": [0.0, 0.0], "warp_ret_bwd": [0.0, 0.0]}
    for (side, ch), (iy, ix, img, w, bias, g, flows) in ret_inputs.items():
        def flow_fwd():
            return warp_flow_ret(img, flows, w.view(-1, 3 * ch), bias)

        def flow_fwd_bwd():
            leaves = [a.detach().requires_grad_() for a in (img, flows, w, bias)]
            out = warp_flow_ret(leaves[0], leaves[1], leaves[2].view(-1, 3 * ch), leaves[3])
            return torch.autograd.grad(out, leaves, g.view(out.shape))

        # warp_flow_ret eager (the host's dispatch of its some 15 launches
        # included) and replayed from a CUDA graph (the card alone); its
        # backward is forward and backward less the forward
        fwd = cuda_ms(flow_fwd, warmup=2, iters=10), graph_ms(flow_fwd, iters=20)
        both = cuda_ms(flow_fwd_bwd, warmup=2, iters=10), graph_ms(flow_fwd_bwd, iters=20)
        flow = {"warp_ret_fwd": fwd, "warp_ret_bwd": tuple(x - y for x, y in zip(both, fwd))}
        for kid, fn, ref in (
                ("warp_ret_fwd", lambda: warp_ret_forward(iy, ix, img, w, bias),
                 lambda: warp_ret_reference(iy, ix, img, w, bias)),
                ("warp_ret_bwd", lambda: warp_ret_backward(iy, ix, img, w, bias, g),
                 lambda: warp_ret_backward_reference(iy, ix, img, w, bias, g))):
            ms = cuda_ms(fn, warmup=2, iters=10)
            plain = cuda_ms(ref, warmup=0, iters=1)
            nbytes, ops = warp_ret_cost(side, ch, 2, backward=kid.endswith("bwd"))
            bound, by = bound_ms(nbytes, ops, BF16_TENSOR_FLOPS)
            eager, card = flow[kid]
            print(f"[time] {kid} (K8) {side}x{side}x{ch} b={B} L={TRAJ_L} O={3 * ch} bf16: "
                  f"{ms:.3f} ms/call (plain {plain:.3f} ms, warp_flow_ret's "
                  f"{'backward' if kid.endswith('bwd') else 'forward'} {card:.3f} ms on the "
                  f"card alone, {eager:.3f} ms eager, bound {bound:.3f} ms by {by}, "
                  f"{bound / ms:.1%} of it; {ops / ms / 1e9:.1f} TFLOP/s)")
            rows[kid].append((1, ms, plain, nbytes, ops))
            unfused[kid][0] += eager
            unfused[kid][1] += card
    for (side, ch), (A, Bm, img, g) in contract_inputs.items():
        library, why = einsum_library(A, Bm, img)
        grad_ms, grad_why = einsum_grad_comparison(A, Bm, img, g)
        for kid, fn, ref in (
                ("warp_contract_fwd", lambda: warp_contract_forward(A, Bm, img),
                 lambda: warp_contract_reference(A, Bm, img)),
                ("warp_contract_bwd", lambda: warp_contract_backward(A, Bm, img, g),
                 lambda: warp_contract_backward_reference(A, Bm, img, g))):
            ms = cuda_ms(fn, warmup=1, iters=5)
            plain = cuda_ms(ref, warmup=0, iters=1)
            nbytes, ops = contract_cost(side, ch, 2, backward=kid.endswith("bwd"))
            bound, by = bound_ms(nbytes, ops, BF16_TENSOR_FLOPS)
            lib = library if kid.endswith("fwd") else None
            if kid.endswith("bwd"):
                yard = (f", for comparison (not one call) autograd.grad through torch.einsum "
                        f"{grad_ms:.3f} ms" if grad_ms is not None
                        else f", autograd.grad through torch.einsum: {grad_why}")
            else:
                yard = f", torch.einsum {library:.3f} ms" if lib is not None \
                    else f", torch.einsum: {why}"
            print(f"[time] {kid} (K9) {side}x{side}x{ch} b={B} L={TRAJ_L} bf16: {ms:.3f} ms/call "
                  f"(plain {plain:.3f} ms{yard}, bound {bound:.3f} ms by {by}, "
                  f"{bound / ms:.1%} of it; {ops / ms / 1e9:.1f} TFLOP/s)")
            rows[kid].append((1, ms, plain, nbytes, ops) + (() if lib is None else (lib,)))
    t = {kid: summed(r, BF16_TENSOR_FLOPS) for kid, r in rows.items()}
    for kid in ("warp_contract_fwd", "warp_contract_bwd"):
        print(f"[time] {kid} (K9) over the three shapes: {t[kid]['ms']:.3f} ms, bound "
              f"{t[kid]['bound_ms']:.3f} ms ({t[kid]['bound_ms'] / t[kid]['ms']:.1%} of it)")
    print(f"[time] K8 over the three shapes: warp_ret forward {t['warp_ret_fwd']['ms']:.3f} ms "
          f"against warp_flow_ret's {unfused['warp_ret_fwd'][1]:.3f} ms on the card alone "
          f"({unfused['warp_ret_fwd'][0]:.3f} ms eager), backward {t['warp_ret_bwd']['ms']:.3f} "
          f"ms against {unfused['warp_ret_bwd'][1]:.3f} ms ({unfused['warp_ret_bwd'][0]:.3f} ms)")
    entries = [("warp_ret_fwd (K8a)", "vp_suite_tpu_torch/csrc/warp_ret.cu",
                "vp_suite_tpu/ops/pallas_warp.py:743", "warp_ret_fwd"),
               ("warp_ret_bwd (K8b, K8c; pallas_warp.py:771, :796)",
                "vp_suite_tpu_torch/csrc/warp_ret.cu", "vp_suite_tpu/ops/pallas_warp.py:771",
                "warp_ret_bwd"),
               ("warp_contract_fwd (K9a)", "vp_suite_tpu_torch/csrc/warp_contract.cu",
                "vp_suite_tpu/ops/pallas_warp.py:534", "warp_contract_fwd"),
               ("warp_contract_bwd (K9b, K9c; pallas_warp.py:581, :607)",
                "vp_suite_tpu_torch/csrc/warp_contract.cu", "vp_suite_tpu/ops/pallas_warp.py:581",
                "warp_contract_bwd")]
    return [dict(name=name, route="cuda", source=source, replaces=replaces,
                 launches=entry_launches[kid], max_abs_err=errs[kid], ms=t[kid]["ms"],
                 plain_ms=t[kid]["plain_ms"], bound_ms=t[kid]["bound_ms"],
                 bound_by=t[kid]["bound_by"], library_ms=t[kid]["library_ms"])
            for name, source, replaces, kid in entries]


def report_scan(kid, side, enc, steps, with_x, ms, plain, nbytes, ops):
    bound, by = bound_ms(nbytes, ops, BF16_TENSOR_FLOPS)
    print(f"[time] {kid} {side}x{side}x{enc} T={steps} {'with i2h' if with_x else 'decode'} "
          f"bf16: {ms:.3f} ms/launch (plain {plain:.3f} ms, bound {bound:.3f} ms by {by}; "
          f"{ops / ms / 1e9:.1f} TFLOP/s)")


def time_paths(serve, train):
    r"""``predict`` and the train step, each under the profiler once more."""
    import torch
    suite, frames = serve["suite"], serve["frames"]
    for i, name in enumerate(PATHS):
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
        profile(f"predict {name}", lambda: suite.predict(frames, pred_frames=PRED, model_idx=i),
                pick=("warp_fwd_kernel",) if name == "trajgru" else ())
    for name, s in train["steps"].items():
        print(f"[time] train step {name} bf16 b={B} {CTX}->{PRED} at 64x64: median "
              f"{s['lat']:.2f} ms, {B * (CTX + PRED) / s['lat'] * 1e3:.0f} frames/s, "
              f"peak memory {s['peak']:.2f} GiB above what was live before")
        profile(f"train step {name}",
                lambda: float(s["step"](s["state"], train["batch"])[1]["total"]),
                pick=("warp_fwd_kernel", "warp_bwd_kernel") if name == "trajgru" else ())


def profile(name, fn, pick=()):
    r"""One call of ``fn`` under ``torch.profiler``: device busy share and the
    kernels that take most of the device time, and the device time of the
    kernels whose names hold each string of ``pick``."""
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
    for key in pick:
        hits = [e for e in kernels if key in e.key]
        ms = sum(e.self_device_time_total for e in hits) / 1e3
        print(f"[profile] {name}: {key} {ms:.3f} ms of the {busy:.2f} ms of device time "
              f"({ms / busy:.1%}), {sum(e.count for e in hits)} launches")


if __name__ == "__main__":
    main()
