r"""UNet-3D's Conv3d lowerings and dtype flows side by side on one CUDA card,
and the f32 rounding of its train-mode rollout.

    python3 -m vp_suite_tpu_torch.kernels.unet3d_variants [--steps N] [--skip-timing]
    python3 -m vp_suite_tpu_torch.kernels.unet3d_variants --descent RUNS

Timing: UNet-3D at bench width (features 8/16/32/64, ``temporal_dim`` 3, b=32,
64x64 RGB, 5 -> 10, bf16 over f32 parameters, random weights from seed 0),
the Adam train step (median of ``--steps`` after 2 warm-ups, each ended by a
read of the loss), ``predict`` (median of 3) and the device time of one step
under ``torch.profiler``, for each Conv3d lowering (:data:`LOWERINGS`) under
PyTorch's default TF32 flags and with TF32 off, and with every convolution in
bf16 (:func:`all_bf16_convs`, against the JAX dtype flow, in which flax's
BatchNorm hands f32 to every conv after the first).

Rounding (:func:`rounding`): one f32 SGD step at b=2 (the smoke's card
against CPU gate, lr 1e-2, as ``(p0 - p1) / lr``, the loss and the running
statistics), 5 -> 1 and 5 -> 10, on the card (TF32 off), on the CPU at two
thread counts, and on the CPU in f64, each held against the f64 run and the
card against the CPU: it shows how far two f32 runs of the train-mode
rollout part, whatever runs them.

Descent (:func:`descent`, ``--descent RUNS`` alone): the losses of 7 Adam
steps (lr 1e-4) in bf16 at bench width on the smoke's frames, under PyTorch's
default TF32 flags, ``RUNS`` times from the same seed at 5 -> 10 and at
5 -> 1, and twice at 5 -> 10 with cuDNN's deterministic algorithms: whether
the loss falls, and how far runs of the same step part.

The lowerings compute the same function: ``"cudnn"`` is the library's
:func:`~vp_suite_tpu_torch.nn.functional.conv3d` (``F.conv3d`` on a
``channels_last_3d`` view), ``"banded"`` the JAX package's time-in-channels
lowering (:func:`conv3d_banded`), which covers UNet-3D's two kernel shapes only.
"""
import argparse
import contextlib
import time

import torch

from vp_suite_tpu_torch.nn.functional import conv2d, conv3d
from vp_suite_tpu_torch.nn.layers import BatchNorm, Conv3d

B, CTX, PRED, IMG, SEED = 32, 5, 10, (3, 64, 64), 0
CONFIG = dict(img_shape=IMG, action_size=0, tensor_value_range=(0.0, 1.0), temporal_dim=3,
              features=(8, 16, 32, 64))


def _banded_kernel(weight, td, padding_mode):
    r"""The 2-D kernel ``[td*out, td*in, kh, kw]`` (t-major channel blocks)
    of a depth-3, depth-padding-1, depth-stride-1 3-D conv over ``td`` frames
    (the JAX package's ``_merged_time_kernel_2d``): output block ``t`` reads
    padded depth ``t + dt - 1``, which replicate padding clamps into
    ``[0, td-1]`` and zero padding drops, so input block ``j`` carries the sum
    of ``weight[:, :, dt]`` over the ``dt`` that reach it."""
    place = [[[0.0] * td for _ in range(td)] for _ in range(3)]      # [dt, j, t], on the host
    for t in range(td):
        for dt in range(3):
            j = t + dt - 1
            if padding_mode == "replicate":
                j = min(max(j, 0), td - 1)
            elif not 0 <= j < td:
                continue
            place[dt][j][t] += 1.0
    place = torch.tensor(place, dtype=weight.dtype, device=weight.device)
    out_c, in_c, _, kh, kw = weight.shape
    k2 = torch.einsum("djt,oidhw->tojihw", place, weight)
    return k2.reshape(td * out_c, td * in_c, kh, kw)


def conv3d_banded(x, weight, bias=None, stride=1, padding=0, padding_mode="zeros"):
    r""":func:`~vp_suite_tpu_torch.nn.functional.conv3d` as one 2-D
    conv over ``[n, h, w, d*in]``: the kernels ``(d, 1, 1)`` without padding
    (the time-collapsing skip, a 1x1 conv) and ``(3, kh, kw)`` with depth
    padding 1 (:func:`_banded_kernel`), stride 1."""
    stride = (stride,) * 3 if isinstance(stride, int) else tuple(stride)
    padding = (padding,) * 3 if isinstance(padding, int) else tuple(padding)
    weight = weight.to(x.dtype)
    n, td, h, w, in_c = x.shape
    out_c, _, kt, kh, kw = weight.shape
    xm = x.permute(0, 2, 3, 1, 4).reshape(n, h, w, td * in_c)
    if stride == (1, 1, 1) and (kt, kh, kw, padding[0]) == (td, 1, 1, 0):
        k2 = weight.permute(0, 2, 1, 3, 4).reshape(out_c, td * in_c, 1, 1)
        return conv2d(xm, k2, bias, 1, padding[1:], padding_mode)[:, None]
    if stride == (1, 1, 1) and (kt, padding[0]) == (3, 1):
        y = conv2d(xm, _banded_kernel(weight, td, padding_mode), None, 1, padding[1:],
                   padding_mode)
        y = y.reshape(n, h, w, td, out_c).permute(0, 3, 1, 2, 4)
        if bias is not None:
            y = y + bias.to(y.dtype)
        return y.contiguous()
    raise NotImplementedError(f"the banded conv3d takes kernel (d, 1, 1) unpadded or (3, kh, kw) "
                              f"with depth padding 1, stride 1; got kernel {(kt, kh, kw)}, "
                              f"padding {padding}, stride {stride}")


#: name -> the function a ``Conv3d`` runs
LOWERINGS = {"cudnn": conv3d, "banded": conv3d_banded}


@contextlib.contextmanager
def use_lowering(name):
    r"""Every ``Conv3d`` runs the lowering ``name`` inside the block."""
    fn, forward = LOWERINGS[name], Conv3d.forward
    Conv3d.forward = lambda self, x: fn(x, self.weight, self.bias, self.stride, self.padding,
                                        self.padding_mode)
    try:
        yield
    finally:
        Conv3d.forward = forward


@contextlib.contextmanager
def all_bf16_convs():
    r"""Every ``BatchNorm`` hands back its input's dtype inside the block, so
    a bf16 UNet-3D runs all its convolutions in bf16 (the JAX dtype flow runs
    55 of a rollout step's 56 in f32)."""
    forward = BatchNorm.forward
    BatchNorm.forward = lambda self, x, train=False: forward(self, x, train).to(x.dtype)
    try:
        yield
    finally:
        BatchNorm.forward = forward


@contextlib.contextmanager
def tf32(on):
    r"""cuDNN's and cuBLAS's TF32 flags: PyTorch's defaults (``on=None``) or
    both set to ``on``."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    if on is not None:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _median_ms(fn, n):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2], times


def device_ms(fn):
    r"""``(device ms, wall ms, launches)`` of one call of ``fn`` under
    ``torch.profiler`` (device ms None where it saw no CUDA kernel)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    return (busy or None), wall, sum(e.count for e in kernels)


def frames():
    r"""The smoke's frames: ``[B, CTX + PRED, 64, 64, 3]`` in [0, 1], on the CPU."""
    gen = torch.Generator().manual_seed(SEED + 3)
    return torch.rand((B, CTX + PRED, IMG[1], IMG[2], IMG[0]), generator=gen)


def time_variants(steps):
    r"""Prints and returns ``{label: (train step ms, predict ms, device ms,
    wall ms under the profiler, launches)}`` of every variant, in one process."""
    from vp_suite_tpu_torch import VPSuite
    from vp_suite_tpu_torch.training.loop import make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    x = frames()
    batch = {"frames": x.cuda()}
    suite = VPSuite()
    model = suite.create_model("unet-3d", seed=SEED, compute_dtype=torch.bfloat16,
                               **CONFIG).model
    state = create_train_state(model, seed=SEED)
    step = make_train_step(model, {"context_frames": CTX, "pred_frames": PRED})

    def one_step():
        float(step(state, batch)[1]["total"])

    def one_predict():
        suite.predict(x[:, :CTX], pred_frames=PRED)
        torch.cuda.synchronize()

    variants = [(f"{lowering}, TF32 {'default' if on is None else 'off'}", lowering, on, False)
                for on in (None, False) for lowering in LOWERINGS]
    variants += [(f"all-bf16 convs, cudnn, TF32 {'default' if on is None else 'off'}", "cudnn",
                  on, True) for on in (None, False)]
    out = {}
    for label, lowering, on, bf16 in variants:
        with tf32(on), use_lowering(lowering), \
                (all_bf16_convs() if bf16 else contextlib.nullcontext()):
            for _ in range(2):
                one_step()
            step_ms, step_times = _median_ms(one_step, steps)
            one_predict()
            pred_ms, _ = _median_ms(one_predict, 3)
            dev, wall, launches = device_ms(one_step)
        out[label] = (step_ms, pred_ms, dev, wall, launches)
        fps = B * (CTX + PRED) / step_ms * 1e3
        print(f"[unet3d] {label}: train step median {step_ms:.2f} ms (steps "
              + ", ".join(f"{t:.2f}" for t in step_times) + f"), {fps:.0f} frames/s; "
              f"predict median {pred_ms:.2f} ms; one profiled step "
              + ("device time not measured" if dev is None else f"{dev:.2f} ms of device time")
              + f" in {wall:.2f} ms, {launches} launches", flush=True)
    return out


def _sgd_step(device, dtype, pred, threads, lr=1e-2):
    r"""One SGD step of UNet-3D at b=2 on the smoke's first two sequences:
    ``(loss, {name: (p0 - p1) / lr}, {name: running statistic})`` on the CPU in f64."""
    from vp_suite_tpu_torch.models import build_model
    from vp_suite_tpu_torch.training.loop import make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    if threads:
        torch.set_num_threads(threads)
    model = build_model("unet-3d", SEED, device, **CONFIG).to(dtype)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    state = create_train_state(model, lr=lr, optimizer="sgd")
    step = make_train_step(model, {"context_frames": CTX, "pred_frames": pred})
    _, metrics = step(state, {"frames": frames()[:2].to(device, dtype)})
    delta = {k: ((p0[k] - v.detach()) / lr).cpu().double() for k, v in model.named_parameters()}
    stats = {k: v.detach().cpu().double() for k, v in model.named_buffers()
             if k.endswith(("running_mean", "running_var"))}
    return float(metrics["total"]), delta, stats


def compare(a, b):
    r"""``(worst |a - b| / max(max|b|, 1) over the parameters, its name,
    |loss a - loss b| / |loss b|, max |statistics a - b|)`` of two
    :func:`_sgd_step` results."""
    worst, name = -1.0, ""
    for k, want in b[1].items():
        rel = (a[1][k] - want).abs().max().item() / max(want.abs().max().item(), 1.0)
        if rel > worst:
            worst, name = rel, k
    d_stats = max((a[2][k] - v).abs().max().item() for k, v in b[2].items())
    return worst, name, abs(a[0] - b[0]) / abs(b[0]), d_stats


def rounding(runs, preds=(1, PRED)):
    r""":func:`_sgd_step` for each ``(label, device, dtype, threads)`` of
    ``runs`` (the first the reference) at each predicted-frame count; prints
    each run against the reference and the others' pairs. Returns
    ``{(pred, label, other): compare(...)}``."""
    out = {}
    threads = torch.get_num_threads()
    for pred in preds:
        res = {label: _sgd_step(device, dtype, pred, n) for label, device, dtype, n in runs}
        torch.set_num_threads(threads)
        labels = list(res)
        for i, a in enumerate(labels):
            for other in labels[:i]:
                c = out[(pred, a, other)] = compare(res[a], res[other])
                print(f"[rounding] SGD step b=2 {CTX}->{pred}, {a} against {other}: (p0-p1)/lr "
                      f"max |diff| / max(max|ref|, 1) {c[0]:.3g} at {c[1]}; loss {res[a][0]:.6f} "
                      f"vs {res[other][0]:.6f} (relative {c[2]:.3g}); running statistics max "
                      f"diff {c[3]:.3g}", flush=True)
    return out


def _adam_losses(pred, steps=7, lr=1e-4):
    r"""The losses of ``steps`` Adam steps of a new bf16 UNet-3D at bench
    width, 5 -> ``pred``, on the smoke's frames."""
    from vp_suite_tpu_torch import VPSuite
    from vp_suite_tpu_torch.training.loop import make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    model = VPSuite().create_model("unet-3d", seed=SEED, compute_dtype=torch.bfloat16,
                                   **CONFIG).model
    state = create_train_state(model, lr=lr, seed=SEED)
    step = make_train_step(model, {"context_frames": CTX, "pred_frames": pred})
    batch = {"frames": frames()[:, :CTX + pred].cuda()}
    return [float(step(state, batch)[1]["total"]) for _ in range(steps)]


def descent(runs):
    r"""Prints :func:`_adam_losses` ``runs`` times at 5 -> 10 and 5 -> 1, and
    twice at 5 -> 10 under ``torch.backends.cudnn.deterministic``."""
    cases = [(PRED, False)] * runs + [(1, False)] * runs + [(PRED, True)] * 2
    for pred, det in cases:
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = det
        try:
            losses = _adam_losses(pred)
        finally:
            torch.backends.cudnn.deterministic = saved
        falls = all(b < a for a, b in zip(losses, losses[1:]))
        print(f"[descent] {CTX}->{pred}{', cuDNN deterministic' if det else ''}: losses "
              + ", ".join(f"{x:.2f}" for x in losses)
              + f"; last - first {losses[-1] - losses[0]:+.2f}; falls at every step {falls}",
              flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=5, help="timed train steps per variant")
    ap.add_argument("--skip-timing", action="store_true", help="only the rounding runs")
    ap.add_argument("--descent", type=int, default=0, metavar="RUNS",
                    help="only the Adam descent runs, RUNS of each")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("this script runs on a CUDA card")
    import subprocess
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; PyTorch's TF32 defaults: cuDNN "
          f"{torch.backends.cudnn.allow_tf32}, matmul {torch.backends.cuda.matmul.allow_tf32}")
    if args.descent:
        descent(args.descent)
        return
    if not args.skip_timing:
        time_variants(args.steps)
    n = torch.get_num_threads()
    with tf32(False):
        rounding([("cpu f64", "cpu", torch.float64, n), ("cpu f32", "cpu", torch.float32, n),
                  ("cpu f32 1 thread", "cpu", torch.float32, 1),
                  ("card f32", "cuda", torch.float32, n)])


if __name__ == "__main__":
    main()
