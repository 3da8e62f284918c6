r"""The host's cost of the kernels' operator dispatch, against another tree.

    python3 -m vp_suite_tpu_torch.kernels.dispatch_ab --parent _chip_dev/parent

Times, on one CUDA card, ``VPSuite.predict`` and the Adam train step of
EF-ConvLSTM per-step (path (a): 45 K1 launches a predict, 45 K1 + 45 K2 a
step), fused (b) and EF-TrajGRU (c) at b=32, 64x64, 5 -> 10, bf16, each the
median of 15 after 2 warm-ups, host clock ending in a read of the card; and
the host time of one call of the gate forward and of the warp forward at a
tiny shape (b=1, 4x4), where the call's dispatch is all there is to time,
each also over the host time of one ``torch.add`` of the same tiny tensors in
the same process (``*_per_add``), which cancels the host's speed from one
process to the next. Each tree is measured in a process of its own that
imports that tree's package (its kernels built there), in turns: the other
tree, this one, this one, the other, ``--rounds`` times. Prints each run's
numbers and, per number, each tree's median and range and this tree's median
over the other's. Paths (a) and (c) are host-bound (PERF.md §5), so the
operators' dispatch shows there first.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

B, CTX, PRED, IMG, SEED = 32, 5, 10, (3, 64, 64), 0
PATHS = {"per_step": {}, "fused_scan": dict(use_fused_scan=True, interleaved_encode=False,
                                            interleaved_forecast=False),
         "trajgru": None}
REPEATS, WARMUP, MICRO_CALLS = 15, 2, 2000


def _median_ms(fn):
    import torch
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2] * 1e3


def _per_call_us(fn):
    r"""Host time of one call of ``fn``: the median over 10 blocks of
    ``MICRO_CALLS / 10`` calls, each block ending in a synchronisation."""
    import torch
    fn()
    torch.cuda.synchronize()
    n = MICRO_CALLS // 10
    blocks = []
    for _ in range(10):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        blocks.append((time.perf_counter() - t0) / n * 1e6)
    return sorted(blocks)[5]


def measure():
    r"""This process's package on the card: the latencies and per-call host
    times, as a dict."""
    import torch
    import vp_suite_tpu_torch
    from vp_suite_tpu_torch import VPSuite
    from vp_suite_tpu_torch.kernels import build
    from vp_suite_tpu_torch.ops import cells, warp
    from vp_suite_tpu_torch.training.loop import make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    build.build_all()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = {"package": str(Path(vp_suite_tpu_torch.__file__).resolve().parent)}
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    frames = torch.rand((B, CTX, IMG[1], IMG[2], IMG[0]), generator=gen)
    batch = {"frames": torch.rand((B, CTX + PRED, IMG[1], IMG[2], IMG[0]), generator=gen).to(dev)}
    for name, cfg in PATHS.items():
        suite = VPSuite()
        model = suite.create_model("trajgru" if cfg is None else "convlstm-shi", img_shape=IMG,
                                   action_size=0, tensor_value_range=(0.0, 1.0), seed=SEED,
                                   compute_dtype=torch.bfloat16, **(cfg or {})).model
        out[f"predict_ms {name}"] = _median_ms(lambda: suite.predict(frames, pred_frames=PRED))
        state = create_train_state(model, lr=1e-4, seed=SEED)
        step = make_train_step(model, {"context_frames": CTX, "pred_frames": PRED})
        out[f"step_ms {name}"] = _median_ms(lambda: float(step(state, batch)[1]["total"]))
    c = torch.rand((1, 4, 4, 16), device=dev, dtype=torch.bfloat16)
    gates = torch.rand((1, 4, 4, 64), device=dev, dtype=torch.bfloat16)
    peep = [torch.rand((4, 4, 16), device=dev, dtype=torch.bfloat16) for _ in range(3)]
    out["gate_forward_us"] = _per_call_us(lambda: cells.convlstm_gate_forward(gates, c, *peep))
    iy = torch.rand((1, 16, 3), device=dev) * 4
    out["warp_forward_us"] = _per_call_us(lambda: warp.warp_sample_forward(iy, iy, c))
    add_us = _per_call_us(lambda: torch.add(c, c))
    out["gate_forward_per_add"] = out["gate_forward_us"] / add_us
    out["warp_forward_per_add"] = out["warp_forward_us"] / add_us
    out["card"] = torch.cuda.get_device_name(0)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", help="the other tree's root (holding vp_suite_tpu_torch)")
    parser.add_argument("--measure", action="store_true", help="measure this process's package")
    parser.add_argument("--rounds", type=int, default=1,
                        help="times to run the other tree, this one, this one, the other")
    args = parser.parse_args(argv)
    if args.measure:
        print(json.dumps(measure()))
        return
    here = Path(__file__).resolve().parents[2]
    other = Path(args.parent).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    runs = []
    order = (("parent", other), ("change", here), ("change", here), ("parent", other))
    for tag, tree in order * args.rounds:
        env = {**os.environ, "PYTHONPATH": str(tree)}
        done = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--measure"],
                              cwd=str(tree), env=env, capture_output=True, text=True,
                              timeout=900)
        if done.returncode:
            sys.exit(f"{tag} run failed:\n{done.stdout[-3000:]}\n{done.stderr[-3000:]}")
        result = json.loads(done.stdout.strip().splitlines()[-1])
        if Path(result["package"]) != tree / "vp_suite_tpu_torch":
            sys.exit(f"{tag} run imported {result['package']}, not {tree}")
        print(f"{tag}: " + json.dumps(result))
        runs.append((tag, result))
    keys = [k for k in runs[0][1] if k not in ("package", "card")]
    for key in keys:
        vals = {t: sorted(r[key] for tt, r in runs if tt == t) for t in ("parent", "change")}
        med = {t: v[len(v) // 2] for t, v in vals.items()}
        print(f"{key}: parent median {med['parent']:.3f} (range {vals['parent'][0]:.3f}-"
              f"{vals['parent'][-1]:.3f}), change median {med['change']:.3f} (range "
              f"{vals['change'][0]:.3f}-{vals['change'][-1]:.3f}), change / parent "
              f"{med['change'] / med['parent']:.4f}")


if __name__ == "__main__":
    main()
