r"""One process of a two-process gloo world on the CPU, for
``tests/test_torch_parallel.py``: it imports torch and the port only.

    RANK=r WORLD_SIZE=2 LOCAL_RANK=0 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \
        python torch_parallel_worker.py {steps|fvd|facade} <out_dir>

``steps``: one train step of each case of ``CASES`` through
``make_train_step(..., mesh=make_mesh())`` (the default ``use_jit``, as the
facade builds it in a group) on this process's half of a
global batch (numpy, from a seed), from the weights a model of the registry
draws from seed 0; writes ``steps_{rank}.pt``: per case the loss, the
parameters and buffers after the step (whole, gathered under FSDP), the
names of the parameters left without a gradient, FSDP's per-process shares
and the scheduled-sampling masks drawn.

``fvd`` (for ``tests/test_torch_fvd_loss.py``): EF-ConvLSTM with the
weights of ``<out_dir>/fvd_weights.pt`` (a ``state_dict``) and the losses
``FVD_LOSSES`` on this process's half of ``fvd_frames()``: the
eval step on the mesh, the facade's validation (an eval step without the mesh
inside ``fvd_in_step(mesh)``, then ``mean_over``) and one SGD train step on
the mesh with :func:`standin_features` for I3D; writes ``fvd_{rank}.pt``:
their metrics and the parameters after the step.

``facade``: ``VPSuite(device="cpu")`` -> ``load_dataset("MMF")`` ->
``create_model("convlstm-shi")`` -> ``train(multihost=True)`` once per run of
``FACADE_RUNS``; writes ``facade_{rank}.json``: per run the parameters'
checksum, the steps, the learning rate and the ``torch.save`` calls that
wrote a ``checkpoint.pt``.

On a CUDA card (``tests/test_torch_parallel_cuda.py``): ``card_pair`` is
``steps``' SGD step of EF-ConvLSTM per step and fused (under FSDP) in f32,
both processes on card 0 over gloo, with the kernels' launches
(``card_pair_{rank}.pt``); ``card_facade`` a world of one over NCCL: the
facade's f32 run at b=8 (fused, ``fsdp=True``, the sharded checkpoint) in the
group and again without it, under cuDNN's deterministic algorithms
(``card_facade.json``: the largest relative difference of the parameters).
"""
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)

EF = dict(img_shape=(3, 16, 16), action_size=0, tensor_value_range=(0.0, 1.0))
#: case -> (registry id, model configuration, optimizer, accum_steps, fsdp,
#: (context, predicted) frames, global batch)
CASES = {
    "sgd": ("convlstm-shi", {}, "sgd", 1, False, (2, 2), 4),
    "adam": ("convlstm-shi", {}, "adam", 1, False, (2, 2), 4),
    "fsdp": ("convlstm-shi", {}, "sgd", 1, True, (2, 2), 4),
    "accum_steps_2": ("convlstm-shi", {}, "sgd", 2, False, (2, 2), 8),
    "unet3d": ("unet-3d", dict(temporal_dim=3, features=(4, 8)), "sgd", 1, False, (3, 2), 4),
    "predrnn": ("predrnn-pp", dict(num_hidden=(8, 8, 8)), "sgd", 1, False, (3, 3), 4),
    "st_phy": ("st-phy", dict(img_shape=(3, 32, 32), num_layers=2, st_cell_channels=8,
                              phycell_channels=9, phycell_kernel_size=(3, 3)),
               "sgd", 1, False, (2, 2), 4),
}
LR = 1e-2
FSDP_MIN_SIZE = 1024
#: PredRNN++'s schedule at the step: a sampling probability of one half, so
#: that the masks are random
PREDRNN_STATE = {"training_iteration": 1, "sampling_eta": 0.5}
#: the ``fvd`` task: its losses, frames config and global batch
FVD_LOSSES = {"mse": 1.0, "fvd": 1.0}
FVD_RUN = {"context_frames": 2, "pred_frames": 9}   # FVD needs 9 frames
FVD_B = 4
#: the facade's runs: (name, checkpoint backend, fsdp)
FACADE_RUNS = (("msgpack", "msgpack", False), ("orbax", "orbax", True))


#: the fused path's configuration of EF-ConvLSTM
FUSED = dict(use_fused_scan=True, interleaved_encode=False, interleaved_forecast=False)


class World:
    r"""The processes of one task of this script (or of ``script``), started at once with
    torchrun's variables on a free loopback port (all on card 0), and waited
    for within ``timeout`` seconds of their start by :meth:`wait`, which
    raises if one fails or is late (killing the others)."""

    def __init__(self, task, out_dir, size=2, timeout=120, script=__file__):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        root = Path(__file__).resolve().parent.parent.parent
        env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
        env.update(PYTHONPATH=str(root), WORLD_SIZE=str(size), LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        self.task, self.out_dir, self.timeout = task, Path(out_dir), timeout
        self.t0, self.done = time.time(), False
        self.logs = [open(self.out_dir / f"log_{task}_{r}.txt", "w") for r in range(size)]
        self.procs = [subprocess.Popen([sys.executable, str(script), task, str(out_dir)],
                                       env={**env, "RANK": str(r)}, stdout=log,
                                       stderr=subprocess.STDOUT)
                      for r, log in enumerate(self.logs)]

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in self.logs:
            log.close()
        self.done = True

    def wait(self):
        if not self.done:
            try:
                for p in self.procs:
                    p.wait(timeout=max(1.0, self.timeout - (time.time() - self.t0)))
            except subprocess.TimeoutExpired:
                pass
            self.stop()
        for r, p in enumerate(self.procs):
            log = (self.out_dir / f"log_{self.task}_{r}.txt").read_text(errors="replace")
            if p.returncode != 0:
                raise AssertionError(f"{self.task} rank {r} ended with {p.returncode} (killed "
                                     f"after {self.timeout} s if negative):\n{log[-3000:]}")


def launch_counters():
    r"""``{name: (function, attribute)}`` of the kernels' launch counters."""
    from vp_suite_tpu_torch.ops.cells import convlstm_gate_backward, convlstm_gate_fuse
    from vp_suite_tpu_torch.ops.convlstm import convlstm_scan_backward, convlstm_scan_fused
    return {"K1": (convlstm_gate_fuse, "launches"), "K2": (convlstm_gate_backward, "launches"),
            "K3": (convlstm_scan_fused, "launches"),
            "K3s": (convlstm_scan_fused, "save_gates_launches"),
            "K4": (convlstm_scan_backward, "launches")}


def read_launches():
    return {k: getattr(fn, attr) for k, (fn, attr) in launch_counters().items()}


def case_frames(name):
    r"""The global batch of a case: ``[b, ctx + pred, h, w, 3]`` in [0, 1)."""
    model_id, cfg, _, _, _, (ctx, pred), b = CASES[name]
    h, w = {**EF, **cfg}["img_shape"][1:]
    seed = list(CASES).index(name)
    return np.random.default_rng(seed).random((b, ctx + pred, h, w, 3), dtype=np.float32)


def fvd_frames():
    r"""The ``fvd`` task's global batch: ``[4, 11, 16, 16, 3]`` in [0, 1)."""
    return np.random.default_rng(26).random((FVD_B, 11, 16, 16, 3), dtype=np.float32)


def standin_weight():
    r"""The projection of :func:`standin_features`: ``[9 * 7 * 7 * 3, 400]``
    f32 from a numpy seed."""
    n = 9 * 7 * 7 * 3
    return (np.random.default_rng(400).standard_normal((n, 400)) / np.sqrt(n)).astype(np.float32)


def standin_features(x, params=None):
    r"""A cheap stand-in for ``i3d_features`` in the ``fvd`` task's train
    step, ``[b, 9, 224, 224, 3]`` -> ``[b, 400]``: the means of each frame's
    32x32 blocks through one fixed projection and tanh. I3D's backward takes
    minutes a call in JAX on the CPU; ``tests/test_torch_fvd_loss.py`` runs
    the same function in JAX."""
    b, t, _, _, c = x.shape
    pooled = x.reshape(b, t, 7, 32, 7, 32, c).mean(dim=(3, 5))
    return torch.tanh(pooled.reshape(b, -1) @ torch.from_numpy(standin_weight()))


def case_model(name, device="cpu"):
    r"""The case's model, drawn from seed 0."""
    from vp_suite_tpu_torch.models import build_model
    model_id, cfg, *_ = CASES[name]
    return build_model(model_id, 0, device, **{**EF, **cfg})


def full_state_dict(model):
    r"""The whole ``state_dict`` on every process (gathered under FSDP)."""
    from vp_suite_tpu_torch.parallel.mesh import is_fsdp
    if not is_fsdp(model):
        return {k: v.detach().clone() for k, v in model.state_dict().items()}
    from torch.distributed.checkpoint.state_dict import StateDictOptions, get_model_state_dict
    return get_model_state_dict(model, options=StateDictOptions(full_state_dict=True))


def run_steps(out_dir, rank):
    from torch.distributed.tensor import DTensor
    from vp_suite_tpu_torch.parallel import make_mesh, shard_batch, shard_params, shard_params_fsdp
    from vp_suite_tpu_torch.training.loop import make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    mesh = make_mesh(0, "data", "cpu")
    results = {}
    for name, (model_id, cfg, opt, k, fsdp, (ctx, pred), _) in CASES.items():
        model = shard_params(case_model(name), mesh)
        if fsdp:
            shard_params_fsdp(model, mesh, min_size=FSDP_MIN_SIZE)
        state = create_train_state(model, lr=LR, optimizer=opt)
        masks = []
        if name == "predrnn":
            state.model_state = dict(PREDRNN_STATE)
            draw = model.scheduled_sampling_mask

            def recording(*args, **kwargs):
                mask, ms = draw(*args, **kwargs)
                masks.append(mask.clone())
                return mask, ms
            model.scheduled_sampling_mask = recording
        step = make_train_step(model, {"context_frames": ctx, "pred_frames": pred}, accum_steps=k,
                               mesh=mesh)
        batch = shard_batch({"frames": torch.from_numpy(case_frames(name))}, mesh)
        _, metrics = step(state, batch)
        results[name] = {
            "loss": float(metrics["total"]),
            "state_dict": full_state_dict(model),
            "no_grad": [n for n, p in model.named_parameters() if p.grad is None],
            "shares": {n: (isinstance(p, DTensor), p.to_local().numel()
                           if isinstance(p, DTensor) else p.numel(), p.numel(), p.shape[0])
                       for n, p in model.named_parameters()},
            "masks": masks,
            "moments": {n: state.optimizer.state[p]["exp_avg"].detach().clone()
                        for n, p in model.named_parameters() if opt == "adam"},
            "model_state": dict(state.model_state),
            "lr": state.optimizer.param_groups[0]["lr"],
        }
    torch.save(results, os.path.join(out_dir, f"steps_{rank}.pt"))


def run_fvd(out_dir, rank):
    from vp_suite_tpu_torch.measure.loss_provider import PredictionLossProvider
    from vp_suite_tpu_torch.models import build_model
    from vp_suite_tpu_torch.parallel import make_mesh, shard_batch, shard_params
    from vp_suite_tpu_torch.parallel.mesh import mean_over
    from vp_suite_tpu_torch.training.loop import fvd_in_step, make_eval_step, make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    mesh = make_mesh(0, "data", "cpu")
    model = build_model("convlstm-shi", 0, "cpu", **EF)
    model.load_state_dict(torch.load(os.path.join(out_dir, "fvd_weights.pt")))
    model = shard_params(model, mesh)
    losses = PredictionLossProvider({"losses_and_scales": FVD_LOSSES, "img_c": 3})
    batch = shard_batch({"frames": torch.from_numpy(fvd_frames())}, mesh)
    state = create_train_state(model, lr=LR, optimizer="sgd")
    val = make_eval_step(model, FVD_RUN, losses, mesh=mesh)(state, batch)
    with fvd_in_step(mesh):
        local = make_eval_step(model, FVD_RUN, losses, use_jit=False)(state, batch)
    facade = mean_over({k: float(v) for k, v in local.items()}, mesh)
    step = make_train_step(model, FVD_RUN, losses, mesh=mesh)
    from vp_suite_tpu_torch.measure.fvd import fvd
    real, fvd.i3d_features = fvd.i3d_features, standin_features
    try:
        _, metrics = step(state, batch)
    finally:
        fvd.i3d_features = real
    torch.save({"val": {k: float(v) for k, v in val.items()}, "facade": facade,
                "train": {k: float(v) for k, v in metrics.items()},
                "state_dict": full_state_dict(model)}, os.path.join(out_dir, f"fvd_{rank}.pt"))


def run_facade(out_dir, rank):
    from vp_suite_tpu_torch import VPSuite
    saved = []
    torch_save = torch.save

    def recording_save(obj, f, *args, **kwargs):
        if str(f).endswith("checkpoint.pt"):
            saved.append(str(f))
        return torch_save(obj, f, *args, **kwargs)
    torch.save = recording_save
    results = {}
    for name, backend, fsdp in FACADE_RUNS:
        suite = VPSuite(device="cpu")
        suite.load_dataset("MMF", img_size=16, digit_source="synthetic", n_seqs=8)
        entry = suite.create_model("convlstm-shi")
        saved.clear()
        suite.train(out_dir=os.path.join(out_dir, f"run_{name}"), epochs=1, batch_size=4,
                    context_frames=2, pred_frames=2, steps_per_epoch=2, no_wandb=True,
                    no_vis=True, metrics=["mse"], multihost=True, ckpt_backend=backend,
                    fsdp=fsdp)
        sd = full_state_dict(entry.model)
        results[name] = {"checksum": float(sum(v.abs().sum() for k, v in sd.items()
                                               if "running" not in k)),
                         "steps": entry.state.step,
                         "lr": entry.state.optimizer.param_groups[0]["lr"],
                         "checkpoint_writes": list(saved),
                         "process_count": torch.distributed.get_world_size()}
    with open(os.path.join(out_dir, f"facade_{rank}.json"), "w") as f:
        json.dump(results, f)


def card_step(path, device, mesh=None):
    r"""``(model, p0, loss, launches)`` of one f32 SGD step of EF-ConvLSTM
    (``path`` "per_step" or "fused") on the ``sgd`` case's batch, on this
    process's half of it with a ``mesh`` (the fused path under FSDP)."""
    from vp_suite_tpu_torch.models import build_model
    from vp_suite_tpu_torch.parallel import shard_batch, shard_params, shard_params_fsdp
    from vp_suite_tpu_torch.training.loop import make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    model = build_model("convlstm-shi", 0, device, **EF, **(FUSED if path == "fused" else {}))
    p0 = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    batch = {"frames": torch.from_numpy(case_frames("sgd")).to(device)}
    if mesh is not None:
        shard_params(model, mesh)
        if path == "fused":
            shard_params_fsdp(model, mesh, min_size=FSDP_MIN_SIZE)
        batch = shard_batch(batch, mesh)
    state = create_train_state(model, lr=LR, optimizer="sgd")
    step = make_train_step(model, {"context_frames": 2, "pred_frames": 2}, mesh=mesh,
                           use_jit=False)
    before = read_launches()
    _, metrics = step(state, batch)
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in read_launches().items()}
    return model, p0, float(metrics["total"]), launches


def run_card_pair(out_dir, rank):
    from vp_suite_tpu_torch.parallel import make_mesh
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(0, "data", "cuda")
    out = {}
    from torch.distributed.tensor import DTensor
    for path in ("per_step", "fused"):
        model, _, loss, launches = card_step(path, "cuda", mesh)
        # each process's rows of the sharded parameters: gathering them whole
        # (DTensor.full_tensor) crashes gloo on CUDA tensors
        out[path] = {"loss": loss, "launches": launches,
                     "sharded": [k for k, v in model.named_parameters() if isinstance(v, DTensor)],
                     "state_dict": {k: (v.to_local() if isinstance(v, DTensor) else v)
                                    .detach().cpu() for k, v in model.named_parameters()}}
    torch.save(out, os.path.join(out_dir, f"card_pair_{rank}.pt"))


def run_card_facade(out_dir, rank):
    from vp_suite_tpu_torch import VPSuite
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    params = []
    for grouped in (True, False):
        suite = VPSuite()
        suite.load_dataset("MMF", img_size=16, digit_source="synthetic", backend="device",
                           n_seqs={"train": 16, "val": 8, "test": 8})
        entry = suite.create_model("convlstm-shi", **FUSED)
        suite.train(out_dir=os.path.join(out_dir, f"run_{grouped}"), epochs=1, batch_size=8,
                    context_frames=2, pred_frames=2, steps_per_epoch=2, no_wandb=True,
                    no_vis=True, fsdp=True, ckpt_backend="orbax", multihost=grouped)
        assert entry.state.step == 2
        params.append({k: v.detach().clone() for k, v in entry.model.named_parameters()})
        if grouped:
            assert torch.distributed.get_backend() == "nccl"
            torch.distributed.destroy_process_group()
    rel = max(((params[0][k] - v).abs().max() / v.abs().max().clamp_min(1e-30)).item()
              for k, v in params[1].items())
    with open(os.path.join(out_dir, "card_facade.json"), "w") as f:
        json.dump({"rel": rel}, f)


def main():
    task, out_dir = sys.argv[1], sys.argv[2]
    from vp_suite_tpu_torch.parallel import initialize_multihost
    if task == "card_facade":
        initialize_multihost()
        return run_card_facade(out_dir, 0)
    rank, world = initialize_multihost(device="cuda" if task == "card_pair" else "cpu",
                                       backend="gloo")
    assert world == 2, world
    try:
        {"steps": run_steps, "facade": run_facade, "fvd": run_fvd,
         "card_pair": run_card_pair}[task](out_dir, rank)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
