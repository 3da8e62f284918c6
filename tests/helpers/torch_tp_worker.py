r"""One process of a gloo world on the CPU for
``tests/test_torch_tensor_parallel.py``: it imports torch and the port only.

    RANK=r WORLD_SIZE=n LOCAL_RANK=0 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \
        python torch_tp_worker.py {tp|data_tp} <out_dir>

``tp`` (2 processes, the mesh ``{"tp": 2}``): EF-ConvLSTM's tp-sharded leaves
and their local shards; ``predict`` (``make_predict_fn``) and
``make_eval_step`` on both paths, recording what each computed; the
``msgpack`` and ``orbax`` checkpoints of a tp-sharded model after an Adam
step, with its whole parameters, and the refused restore into it; and one
SGD step of every other registry model with parameters, tp-sharded, beside
the same model's one-process step in this process. Writes ``tp_{rank}.pt``.

``data_tp`` (4 processes, the mesh ``{"data": 2, "sp": 1, "tp": 2}``): one
train step of EF-ConvLSTM per case of ``STEPS`` (per-step and fused, SGD and
Adam, and ``shard_params_tp_fsdp`` at ``TP_FSDP_MIN_SIZE``) on this process's
rows of the global batch, recording what each computed, with the whole
parameters (and Adam's first moments) after it and, for the 2-D cases, every
parameter's per-process element count; the ``msgpack`` and ``orbax`` checkpoints
of a ``shard_params_tp_fsdp`` model after an Adam step, with its whole
parameters and first moments; ``make_eval_step(..., mesh=)`` on each
process's rows of the tp world's batch; and the refusals on real meshes
(``sp`` x ``tp``; ``check_train_mesh`` at ``sp`` > 1 outside a spatial context;
``shard_video_batch`` of a height that does not divide by ``sp``).
Writes ``data_tp_{rank}.pt``.

On a CUDA card (``tests/test_torch_tensor_parallel_cuda.py``): ``card_one``
is a world of one over NCCL on the mesh ``{"data": 1, "sp": 1, "tp": 1}``:
each path's f32 SGD step and ``predict`` in the group and again without it,
under cuDNN's deterministic algorithms, with the kernels' launches
(``card_one.pt``).
"""
import importlib.util
import os
import sys
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "torch_parallel_worker", Path(__file__).resolve().parent / "torch_parallel_worker.py")
P = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(P)

EF = P.EF                                   # 16x16 RGB
RUN = {"context_frames": 2, "pred_frames": 2}
B, LR = 4, 1e-2
PATHS = {"per_step": {}, "fused": P.FUSED}
#: the data x tp steps: case -> (path, optimizer, shard_params_tp_fsdp)
STEPS = {"per_step_sgd": ("per_step", "sgd", False), "fused_sgd": ("fused", "sgd", False),
         "per_step_adam": ("per_step", "adam", False), "fused_adam": ("fused", "adam", False),
         "per_step_2d": ("per_step", "sgd", True), "fused_2d": ("fused", "sgd", True)}
TP_FSDP_MIN_SIZE = 1024
SMALL_TRAJGRU = dict(
    num_layers=2, enc_c=(4, 8, 8, 8), dec_c=(8, 8, 8, 4),
    enc_conv_names=("conv1_leaky_1", "conv2_leaky_1"), enc_conv_k=(3, 3), enc_conv_s=(1, 2),
    enc_conv_p=(1, 1), dec_conv_names=("deconv1_leaky_1", "deconv2_leaky_1"),
    dec_conv_k=(4, 3), dec_conv_s=(2, 1), dec_conv_p=(1, 1), final_conv_1_c=4,
    **{f"{kind}_rnn_{name}": v for kind in ("enc", "dec")
       for name, v in (("z", (0.0, 0.0)), ("L", (3, 3)), ("i2h_k", ((3, 3), (3, 3))),
                       ("i2h_s", ((1, 1), (1, 1))), ("i2h_p", ((1, 1), (1, 1))),
                       ("h2h_k", ((5, 5), (5, 5))), ("h2h_d", ((1, 1), (1, 1))))})
#: every other registry model with parameters at a small size: id ->
#: (configuration over EF's, (context, predicted) frames)
OTHERS = {
    "trajgru": (SMALL_TRAJGRU, (2, 2)),
    "unet-3d": (dict(temporal_dim=3, features=(4, 8)), (3, 2)),
    "predrnn-pp": (dict(num_hidden=(8, 8, 8)), (3, 3)),
    "phy": (dict(convlstm_hidden_dims=(16, 64)), (2, 2)),
    "min-conv-rnn": (dict(hidden_dim=16, num_layers=2), (2, 2)),
    "simvp": (dict(hid_s=8, hid_t=16, n_trans=2, in_frames=2, out_frames=2), (2, 2)),
    "pred-former": (dict(img_shape=(3, 16, 24), patch_size=8, dim=32, depth=2, heads=2), (2, 2)),
    "st-phy": (dict(img_shape=(3, 32, 32), num_layers=2, st_cell_channels=8, phycell_channels=9,
                    phycell_kernel_size=(3, 3)), (2, 2)),
    "lstm": (dict(img_shape=(3, 32, 32), bottleneck_dim=32, lstm_hidden_dim=32,
                  lstm_num_layers=2), (2, 2)),
}
#: PredRNN++'s schedule at the step: a sampling probability of one half
PREDRNN_STATE = P.PREDRNN_STATE


def frames(seed, shape=(B, 4, 16, 16, 3)):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def ef_model(path):
    from vp_suite_tpu_torch.models import build_model
    return build_model("convlstm-shi", 0, "cpu", **EF, **PATHS[path])


def whole_state(model):
    r"""Every parameter and buffer whole (FSDP's shards and the tp shards
    gathered), on every process."""
    from vp_suite_tpu_torch.parallel.tensor import sharded_params, whole
    specs = sharded_params(model)
    return {k: whole(k, v, specs).clone() for k, v in P.full_state_dict(model).items()}


def whole_moments(model, state):
    r"""Adam's first moment of every parameter, whole (FSDP's shards and the
    tp shards gathered), on every process."""
    from torch.distributed.tensor import DTensor
    from vp_suite_tpu_torch.parallel.tensor import sharded_params, whole
    specs = sharded_params(model)
    out = {}
    for n, p in model.named_parameters():
        m = state.optimizer.state[p]["exp_avg"]
        out[n] = whole(n, m.full_tensor() if isinstance(m, DTensor) else m, specs).clone()
    return out


def save_both(out_dir, tag, model, state):
    r"""``state`` saved with the ``msgpack`` and the ``orbax`` backend into
    ``ckpt_{backend}{tag}``; returns its whole parameters, first moments and
    step."""
    from vp_suite_tpu_torch.checkpoint import save_checkpoint
    from vp_suite_tpu_torch.checkpoint.orbax_backend import save_checkpoint_orbax
    for backend, save in (("msgpack", save_checkpoint), ("orbax", save_checkpoint_orbax)):
        save(os.path.join(out_dir, f"ckpt_{backend}{tag}"), state, "convlstm-shi", model.config,
             RUN)
    return {"params": whole_state(model), "moments": whole_moments(model, state),
            "step": state.step}


def kinds(log):
    r"""What a step computed: per weight, the local out-channels of each
    column-parallel output; the parameters gathered at use."""
    column = {}
    for kind, name, shape, _ in log:
        if kind == "column":
            column.setdefault(name, set()).add(shape[-1])
    return {"column": {k: sorted(v) for k, v in column.items()},
            "use": sorted({name for kind, name, *_ in log if kind == "use"})}


def run_tp(out_dir, rank):
    from vp_suite_tpu_torch.checkpoint.orbax_backend import restore_checkpoint_orbax
    from vp_suite_tpu_torch.models import build_model
    from vp_suite_tpu_torch.parallel import make_mesh_nd, shard_params_tp
    from vp_suite_tpu_torch.parallel.tensor import record, sharded_params
    from vp_suite_tpu_torch.training.loop import make_eval_step, make_predict_fn, make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    mesh = make_mesh_nd({"tp": 2}, "cpu")
    out = {}
    whole = ef_model("per_step").state_dict()
    model = shard_params_tp(ef_model("per_step"), mesh)
    specs = sharded_params(model)
    out["local_shapes"] = {n: tuple(p.shape) for n, p in model.named_parameters()}
    out["shards_exact"] = all(
        torch.equal(p, whole[n].narrow(specs[n].dim, rank * specs[n].local, specs[n].local))
        if n in specs else torch.equal(p, whole[n]) for n, p in model.named_parameters())
    batch = {"frames": torch.from_numpy(frames(1))}
    for path in PATHS:
        model = shard_params_tp(ef_model(path), mesh)
        with record() as log:
            preds, _ = make_predict_fn(model, RUN)(batch)
        metrics = make_eval_step(model, RUN)(None, batch)
        out[path] = {"preds": preds, "eval": float(metrics["total"]), "predict": kinds(log)}

    # the checkpoints of a tp-sharded model after one Adam step
    model = shard_params_tp(ef_model("fused"), mesh)
    state = create_train_state(model, lr=LR, optimizer="adam")
    make_train_step(model, RUN, mesh=mesh)(state, batch)
    out["ckpt"] = save_both(out_dir, "", model, state)
    try:
        restore_checkpoint_orbax(os.path.join(out_dir, "ckpt_orbax"), state)
        out["restore_refused"] = None
    except NotImplementedError as e:
        out["restore_refused"] = str(e)

    # every other registry model: its tp=2 SGD step beside its one-process step
    out["others"] = {}
    for model_id, (cfg, (ctx, pred)) in OTHERS.items():
        kw = {**EF, **cfg}
        h, w = kw["img_shape"][1:]
        x = {"frames": torch.from_numpy(frames(2, (2, ctx + pred, h, w, 3)))}
        run = {"context_frames": ctx, "pred_frames": pred}
        got = {}
        for tp in (False, True):
            model = build_model(model_id, 0, "cpu", **kw)
            if tp:
                shard_params_tp(model, mesh)
            state = create_train_state(model, lr=LR, optimizer="sgd")
            if model_id == "predrnn-pp":
                state.model_state = dict(PREDRNN_STATE)
            _, metrics = make_train_step(model, run, mesh=mesh if tp else None)(state, x)
            got[tp] = {"loss": float(metrics["total"]), "state_dict": whole_state(model),
                       "sharded": sorted(sharded_params(model))}
        out["others"][model_id] = got
    torch.save(out, os.path.join(out_dir, f"tp_{rank}.pt"))


def run_data_tp(out_dir, rank):
    from torch.distributed.tensor import DTensor
    from vp_suite_tpu_torch.parallel import (check_train_mesh, make_mesh_nd, shard_params_tp,
                                             shard_params_tp_fsdp, shard_video_batch)
    from vp_suite_tpu_torch.parallel.tensor import record, sharded_params
    from vp_suite_tpu_torch.training.loop import make_eval_step, make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    mesh = make_mesh_nd({"data": 2, "sp": 1, "tp": 2}, "cpu")
    batch = shard_video_batch({"frames": torch.from_numpy(frames(0))}, mesh)
    out = {"rows": batch["frames"][:, 0, 0, 0, 0].clone()}
    for name, (path, opt, two_d) in STEPS.items():
        model = ef_model(path)
        if two_d:
            shard_params_tp_fsdp(model, mesh, min_size=TP_FSDP_MIN_SIZE)
        else:
            shard_params_tp(model, mesh)
        specs = sharded_params(model)
        state = create_train_state(model, lr=LR, optimizer=opt)
        with record() as log:
            _, metrics = make_train_step(model, RUN, mesh=mesh)(state, batch)
        out[name] = {"loss": float(metrics["total"]), "state_dict": whole_state(model),
                     "step": kinds(log),
                     "counts": {n: ((p.to_local() if isinstance(p, DTensor) else p).numel(),
                                    n in specs and isinstance(p, DTensor))
                                for n, p in model.named_parameters()}}
        if opt == "adam":
            out[name]["moments"] = whole_moments(model, state)
    # the checkpoints of a 2-D model after one Adam step
    model = shard_params_tp_fsdp(ef_model("fused"), mesh, min_size=TP_FSDP_MIN_SIZE)
    state = create_train_state(model, lr=LR, optimizer="adam")
    make_train_step(model, RUN, mesh=mesh)(state, batch)
    out["ckpt"] = save_both(out_dir, "_2d", model, state)
    # the evaluation of tp-sharded models on each process's rows, averaged over data
    eval_batch = shard_video_batch({"frames": torch.from_numpy(frames(1))}, mesh)
    out["eval"] = {path: float(make_eval_step(shard_params_tp(ef_model(path), mesh), RUN,
                                              mesh=mesh)(None, eval_batch)["total"])
                   for path in PATHS}

    refused = {}
    for what, axes, fn in (
            ("check_train_mesh", {"data": 2, "sp": 2}, check_train_mesh),
            ("shard_video_batch", {"data": 2, "sp": 2},
             lambda m: shard_video_batch({"frames": torch.zeros(4, 1, 3, 2, 3)}, m)),
            ("shard_params_tp", {"sp": 2, "tp": 2},
             lambda m: shard_params_tp(ef_model("fused"), m)),
            ("shard_params_tp_fsdp", {"sp": 2, "tp": 2},
             lambda m: shard_params_tp_fsdp(ef_model("fused"), m)),
            ("make_mesh_nd", {"tp": 2}, None)):
        try:
            m = make_mesh_nd(axes, "cpu")
            fn(m)
            refused[what] = None
        except ValueError as e:
            refused[what] = str(e)
    out["refused"] = refused
    torch.save(out, os.path.join(out_dir, f"data_tp_{rank}.pt"))


def run_card_one(out_dir):
    from vp_suite_tpu_torch.models import build_model
    from vp_suite_tpu_torch.parallel import make_mesh_nd, shard_params, shard_params_tp
    from vp_suite_tpu_torch.training.loop import make_predict_fn, make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh_nd({"data": 1, "sp": 1, "tp": 1}, "cuda")
    batch = {"frames": torch.from_numpy(frames(0)).cuda()}
    out = {"backend": torch.distributed.get_backend()}
    for path in PATHS:
        for grouped in (True, False):
            model = build_model("convlstm-shi", 0, "cuda", **EF, **PATHS[path])
            if grouped:
                shard_params_tp(shard_params(model, mesh), mesh)
            state = create_train_state(model, lr=LR, optimizer="sgd")
            step = make_train_step(model, RUN, mesh=mesh if grouped else None)
            before = P.read_launches()
            step(state, batch)
            torch.cuda.synchronize()
            train = {k: v - before[k] for k, v in P.read_launches().items()}
            before = P.read_launches()
            make_predict_fn(model, RUN)(batch)
            torch.cuda.synchronize()
            predict = {k: v - before[k] for k, v in P.read_launches().items()}
            out[(path, grouped)] = {"train": train, "predict": predict, "params": {
                k: v.detach().cpu().clone() for k, v in model.named_parameters()}}
    torch.save(out, os.path.join(out_dir, "card_one.pt"))


def main():
    task, out_dir = sys.argv[1], sys.argv[2]
    from vp_suite_tpu_torch.parallel import initialize_multihost
    if task == "card_one":
        initialize_multihost()
        try:
            return run_card_one(out_dir)
        finally:
            torch.distributed.destroy_process_group()
    rank, world = initialize_multihost(device="cpu", backend="gloo")
    assert world == {"tp": 2, "data_tp": 4}[task], world
    try:
        {"tp": run_tp, "data_tp": run_data_tp}[task](out_dir, rank)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
