r"""PhyDNet's forward shortcuts against the JAX model's uniform time loop, and
the f32 rounding of its train step, on one CUDA card.

    python3 -m vp_suite_tpu_torch.kernels.phydnet_variants [--pairs N] [--skip-timing]

Timing (:func:`time_shortcuts`): PhyDNet at bench width (its defaults, b=32,
64x64 RGB, 5 -> 10, bf16 over f32 parameters, random weights from seed 0,
PyTorch's default TF32 flags), the library's forward, which encodes the
context in one batch of ``ctx * b`` and, in eval mode, decodes only from step
``ctx - 1`` on, against :class:`UniformPhyDNet`, the JAX model's loop (every
step encodes its own frame and decodes): ``predict`` and the Adam train step
in ``--pairs`` alternating pairs, and the device time and launches of one
profiled call of each.

Rounding (:func:`rounding`): one SGD step at b=2 (``chip_smoke.py``'s card
against CPU gate: its frames, lr 1e-2, as ``(p0 - p1) / lr``), 5 -> 10 and
5 -> 1, on the card in f32 (TF32 off), on the CPU in f32 and on the CPU with
f64 activations, each held against the f64 run, relative to the largest of
each tensor; with the smallest group variance any GroupNorm saw and the
LeakyReLU inputs within 1e-4 of their call's largest in the f64 run.
GroupNorm and the DCGAN blocks alone (:func:`layers`): their f32 gradients
on the card and the CPU against the CPU's f64.
"""
import argparse
import contextlib
import copy
import statistics
import subprocess
import time

import torch
import torch.nn.functional as F

from vp_suite_tpu_torch.model_blocks.conv import DCGANConv, DCGANConvTranspose
from vp_suite_tpu_torch.model_blocks.phydnet import moment_loss
from vp_suite_tpu_torch.models import build_model
from vp_suite_tpu_torch.models.phydnet import PhyDNet
from vp_suite_tpu_torch.nn.layers import GroupNorm
from vp_suite_tpu_torch.training.loop import make_predict_fn, make_train_step
from vp_suite_tpu_torch.training.train_state import create_train_state

B, CTX, PRED, IMG, SEED = 32, 5, 10, (3, 64, 64), 0
CONFIG = dict(img_shape=IMG, action_size=0, tensor_value_range=(0.0, 1.0))


class UniformPhyDNet(PhyDNet):
    r"""PhyDNet with the JAX model's loop: each step encodes its own input
    frame and decodes its output."""

    def forward(self, x, pred_frames=1, actions=None, train=False, teacher_forcing=False,
                **kwargs):
        b, t = x.shape[:2]
        ctx = t - pred_frames if train else t
        g = teacher_forcing if train else 0
        if torch.is_tensor(g):
            g = g.to(x.dtype)
        eh, ew = self.img_h // 4, self.img_w // 4
        phy_h = [x.new_zeros((b, eh, ew, 64)) for _ in range(self.phycell_n_layers)]
        conv_h = [x.new_zeros((b, eh, ew, hid)) for hid in self.convlstm_hidden_dims]
        conv_c = list(conv_h)
        out, outs = x.new_zeros((b, *x.shape[2:])), []
        for step in range(ctx + pred_frames - 1):
            if step < ctx:
                frame = x[:, step]
            elif torch.is_tensor(g) or g:
                frame = g * x[:, step] + (1 - g) * out
            else:       # the JAX model's zero padding, weighted by g = 0
                frame = out
            action = actions[:, step] if self.action_conditional else None
            phy_h, conv_h, conv_c = self._recur(*self._encode(frame), action, phy_h, conv_h,
                                                conv_c)
            out = self._decode(phy_h[-1], conv_h[-1])
            outs.append(out)
        preds = torch.stack(outs, dim=1)
        if not train:
            return preds[:, ctx - 1:], None
        m_loss = moment_loss(self.phycell.cell_list[0].F.conv1.weight, self.moment_constraints,
                             (self.moment_m0, self.moment_m1))
        return preds, {"moment regularization loss": self.moment_loss_scale * m_loss}


def frames():
    r"""``chip_smoke.py``'s frames of its new-model phase: ``[B, 15, 64, 64, 3]``."""
    return torch.rand((B, CTX + PRED, IMG[1], IMG[2], IMG[0]),
                      generator=torch.Generator().manual_seed(SEED + 3))


@contextlib.contextmanager
def tf32(on):
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = on, False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _profiled(fn):
    r"""``(device ms, launches)`` of one call of ``fn`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.self_device_time_total for e in kernels) / 1e3, sum(e.count for e in kernels)


def time_shortcuts(pairs):
    dev = torch.device("cuda")
    batch = {"frames": frames().to(dev)}
    cfg = {"context_frames": CTX, "pred_frames": PRED}
    sides = {}
    for name in ("library", "uniform"):
        model = build_model("phy", SEED, dev, **CONFIG, compute_dtype=torch.bfloat16)
        if name == "uniform":
            model.__class__ = UniformPhyDNet
        state = create_train_state(model, lr=1e-4)
        step, predict = make_train_step(model, cfg), make_predict_fn(model, cfg)
        sides[name] = {"predict": lambda p=predict: (p(batch), torch.cuda.synchronize()),
                       "train": lambda s=step, st=state: float(s(st, batch)[1]["total"])}
    for what in ("predict", "train"):
        for side in sides.values():
            side[what]()
            side[what]()
        times = {name: [] for name in sides}
        for i in range(pairs):
            for name in (list(sides) if i % 2 == 0 else list(sides)[::-1]):
                t0 = time.perf_counter()
                sides[name][what]()
                times[name].append((time.perf_counter() - t0) * 1e3)
        for name, t in times.items():
            q = statistics.quantiles(t, n=4)
            ms, launches = _profiled(sides[name][what])
            print(f"[{what}] {name}: median {statistics.median(t):.2f} ms (quartiles {q[0]:.2f}"
                  f"-{q[2]:.2f}; runs {', '.join(f'{x:.1f}' for x in t)}); one profiled call "
                  f"{ms:.2f} ms of device time, {launches} launches")
        wins = sum(x < y for x, y in zip(times["library"], times["uniform"]))
        print(f"[{what}] the library's forward faster in {wins} of {pairs} pairs")


@contextlib.contextmanager
def conditioning(record):
    r"""Records, while active, the smallest group variance of each
    ``F.group_norm`` call and the LeakyReLU inputs within 1e-4 of their
    call's largest magnitude."""
    group_norm, leaky_relu = F.group_norm, F.leaky_relu

    def gn(x, groups, *args):
        var = x.reshape(x.shape[0], groups, -1).var(dim=-1, unbiased=False).min().item()
        record["min_var"] = min(record.get("min_var", float("inf")), var)
        return group_norm(x, groups, *args)

    def lrelu(x, slope):
        record["near_kink"] = record.get("near_kink", 0) + int(
            (x.abs() < 1e-4 * x.abs().max()).sum())
        return leaky_relu(x, slope)
    F.group_norm, F.leaky_relu = gn, lrelu
    try:
        yield record
    finally:
        F.group_norm, F.leaky_relu = group_norm, leaky_relu


def _sgd_step(device, dtype, pred, lr=1e-2):
    r"""``{name: (p0 - p1) / lr}`` of one SGD step at b=2 on ``device`` with
    ``dtype`` activations (f32 parameters)."""
    model = build_model("phy", SEED, device, **CONFIG, compute_dtype=dtype)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    state = create_train_state(model, lr=lr, optimizer="sgd")
    make_train_step(model, {"context_frames": CTX, "pred_frames": pred})(
        state, {"frames": frames()[:2].to(device)})
    return {k: ((p0[k] - v.detach()) / lr).cpu().double() for k, v in model.named_parameters()}


def _worst(got, want):
    return max(((got[k] - w).abs().max().item() / max(w.abs().max().item(), 1.0), k)
               for k, w in want.items())


def rounding():
    with tf32(False):
        for pred in (PRED, 1):
            with conditioning({}) as record:
                ref = _sgd_step("cpu", torch.float64, pred)
            runs = {"card f32": _sgd_step("cuda", torch.float32, pred),
                    "CPU f32": _sgd_step("cpu", torch.float32, pred)}
            for name, got in runs.items():
                rel, at = _worst(got, ref)
                print(f"[rounding] {CTX} -> {pred}: {name} against the CPU with f64 activations "
                      f"{rel:.3g} of the largest (p0-p1)/lr, at {at}")
            rel, at = _worst(runs["card f32"], runs["CPU f32"])
            print(f"[rounding] {CTX} -> {pred}: card f32 against CPU f32 {rel:.3g}, at {at}; in "
                  f"the f64 run the smallest GroupNorm group variance {record['min_var']:.3g}, "
                  f"{record['near_kink']} LeakyReLU inputs within 1e-4 of their call's largest")


def layers():
    r"""GroupNorm and the DCGAN blocks: f32 gradients (input, then each
    parameter) on the card and the CPU against the CPU's f64, relative to the
    largest."""
    g = torch.Generator().manual_seed(SEED)
    cases = [("GroupNorm 32x32x32, 16 groups", lambda: GroupNorm(16, 32), (2, 32, 32, 32)),
             ("GroupNorm 16x16x49, 7 groups", lambda: GroupNorm(7, 49), (2, 16, 16, 49)),
             ("DCGANConv 32 -> 32", lambda: DCGANConv(32, 32, 1), (2, 32, 32, 32)),
             ("DCGANConv 3 -> 32, stride 2", lambda: DCGANConv(3, 32, 2), (2, 64, 64, 3)),
             ("DCGANConvTranspose 64 -> 32, stride 2", lambda: DCGANConvTranspose(64, 32, 2),
              (2, 16, 16, 64))]
    with tf32(False):
        for name, make, shape in cases:
            block = make()
            for m in block.modules():
                if hasattr(m, "reset_parameters"):
                    m.reset_parameters(torch.Generator().manual_seed(SEED + 1))
            x = torch.randn(*shape, generator=g) * 2 + 0.5
            out = {}
            for side, device, dtype in (("card", "cuda", torch.float32),
                                        ("CPU", "cpu", torch.float32),
                                        ("f64", "cpu", torch.float64)):
                b = copy.deepcopy(block).to(device, dtype)
                xx = x.to(device, dtype).requires_grad_()
                y = b(xx)
                go = torch.ones_like(y) + torch.linspace(-1, 1, y.numel(), dtype=dtype,
                                                         device=device).view(y.shape)
                out[side] = [t.cpu().double() for t in
                             torch.autograd.grad(y, [xx, *b.parameters()], go)]
            rel = {side: max((a - r).abs().max().item() / r.abs().max().item()
                             for a, r in zip(out[side], out["f64"])) for side in ("card", "CPU")}
            print(f"[layers] {name}: gradients against f64, card {rel['card']:.3g}, "
                  f"CPU {rel['CPU']:.3g}")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--skip-timing", action="store_true")
    args = parser.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    if not args.skip_timing:
        with tf32(True):
            time_shortcuts(args.pairs)
    rounding()
    layers()


if __name__ == "__main__":
    main()
