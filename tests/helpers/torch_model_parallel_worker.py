r"""One process of a gloo world on the CPU for ``tests/test_torch_spatial.py``,
``test_torch_scan_parallel.py`` and ``test_torch_pipeline.py``: it imports
torch and the port only.

    RANK=r WORLD_SIZE=n LOCAL_RANK=0 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \
        python torch_model_parallel_worker.py {sp|data_sp|seq|seq_data|pp} <out_dir>

``sp`` (2 processes, ``{"sp": 2}``): ``halo_conv2d`` / ``halo_conv_transpose2d``
on each process's slab of rows at every geometry of ``CONV_GEOMS`` /
``CONVT_GEOMS`` (outputs and the gradients of ``sum(y * c)``), their
refusals, and EF-ConvLSTM's ``make_predict_fn`` and ``make_eval_step`` on the
mesh, per step and fused.

``data_sp`` (4 processes, ``{"data": 2, "sp": 2}``): each process's share of
a batch (``shard_video_batch``); one SGD step of EF-ConvLSTM per path, built
inside ``spatial_halo_convs``, with the parameters after it and the halo
exchanges it ran; the refusals (``check_train_mesh`` outside the context,
another model on the mesh, a loss that does not add up over slabs, FSDP).

``seq`` (2 processes, ``{"seq": 2}``): ``linear_recurrence_scan_sharded`` on
each process's time block, with and without ``h0``, and its gradients; its
refusals; MinConvRNN with ``context_mesh`` (``predict`` and one SGD step at a
context that divides by 2 and at one that does not, with the all-gathers
each ran) beside the same model without one.

``seq_data`` (4 processes, ``{"seq": 2, "data": 2}``): the scan with
``spec=("seq", "data")``.

``pp`` (2 processes, ``{"pp": 2}``): ``gpipe_apply`` of a 3x3 conv + tanh
stage, forward and the gradients of the stacked parameters and the input;
``make_mesh_nd``'s axis names.

Each writes ``{task}_{rank}.pt``.
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
WORLDS = {"sp": {"sp": 2}, "data_sp": {"data": 2, "sp": 2}, "seq": {"seq": 2},
          "seq_data": {"seq": 2, "data": 2}, "pp": {"pp": 2}}
#: (kh, stride, padding) and (kh, stride, padding, output_padding): the JAX
#: package's tests/test_spatial.py geometries
CONV_GEOMS = [(3, 1, 1), (3, 2, 1), (4, 2, 1), (1, 1, 0), (5, 1, 2), (5, 2, 2), (2, 2, 0)]
CONVT_GEOMS = [(3, 2, 1, 1), (4, 2, 1, 0), (3, 1, 1, 0), (2, 2, 0, 0)]
HALO_X = (2, 16, 8, 3)                      # the whole image [n, h, w, c] the slabs cut
SCAN = (8, 2, 4, 4, 3)                      # [t, b, h, w, c]
SCAN_DATA = (8, 4, 4, 4, 3)
MCR = dict(EF, hidden_dim=16, num_layers=2)
MCR_CONTEXTS = (4, 3)                       # divides by seq = 2, and does not
PP = dict(S=2, M=4, MB=2, IMG=8, C=4)


def rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def frames(seed, shape=(B, 4, 16, 16, 3)):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def halo_case(transposed, geom):
    r"""``(x, weight, bias, cotangent seed)`` of a halo-conv case, numpy."""
    kh = geom[0]
    w = rand(11, (3, 4, kh, kh) if transposed else (4, 3, kh, kh), 0.3)
    return rand(10, HALO_X), w, rand(12, (4,), 0.1)


def scan_inputs(shape, seed=0):
    f = 1.0 / (1.0 + np.exp(-rand(seed, shape)))
    return f.astype(np.float32), rand(seed + 1, shape, 0.3), rand(seed + 2, shape[1:])


def ef_model(path):
    from vp_suite_tpu_torch.models import build_model
    return build_model("convlstm-shi", 0, "cpu", **EF, **PATHS[path])


def refusal(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def run_sp(mesh, rank):
    from vp_suite_tpu_torch.parallel import halo_conv2d, halo_conv_transpose2d
    from vp_suite_tpu_torch.training.loop import make_eval_step, make_predict_fn
    out = {"halo": {}}
    rows = slice(rank * HALO_X[1] // 2, (rank + 1) * HALO_X[1] // 2)
    for transposed, geoms in ((False, CONV_GEOMS), (True, CONVT_GEOMS)):
        for geom in geoms:
            x, w, b = (torch.from_numpy(a) for a in halo_case(transposed, geom))
            x = x[:, rows].clone().requires_grad_(True)
            w.requires_grad_(True)
            b.requires_grad_(True)
            if transposed:
                y = halo_conv_transpose2d(x, w, b, geom[1], geom[2], geom[3], mesh)
            else:
                y = halo_conv2d(x, w, b, geom[1], geom[2], mesh)
            # this slab's rows of the whole output's cotangent
            c = torch.from_numpy(rand(13, (HALO_X[0], 2 * y.shape[1], y.shape[2], 4)))
            c = c[:, rank * y.shape[1]:(rank + 1) * y.shape[1]]
            (y * c).sum().backward()
            out["halo"][(transposed, geom)] = {"y": y.detach(), "dx": x.grad, "dw": w.grad,
                                               "db": b.grad}
    x = torch.zeros(2, 8, 8, 3)
    k = torch.zeros(4, 3, 3, 3)
    out["refused"] = {
        "conv_geometry": refusal(lambda: halo_conv2d(x, k, None, 2, 0, mesh)),
        "convT_geometry": refusal(lambda: halo_conv_transpose2d(x, k.transpose(0, 1), None, 2,
                                                                1, 0, mesh)),
        "too_fine": refusal(lambda: halo_conv2d(x[:, :1], k, None, 1, 1, mesh)),
        "stride": refusal(lambda: halo_conv2d(x[:, :3], k, None, 2, 1, mesh))}
    from vp_suite_tpu_torch.parallel import shard_video_batch
    batch = shard_video_batch({"frames": torch.from_numpy(frames(1))}, mesh)
    for path in PATHS:
        model = ef_model(path)
        preds, targets = make_predict_fn(model, RUN, mesh=mesh)(batch)
        metrics = make_eval_step(model, RUN, mesh=mesh)(None, batch)
        out[path] = {"preds": preds, "targets": targets, "eval": float(metrics["total"])}
    return out


def run_data_sp(mesh, rank):
    from vp_suite_tpu_torch.models import build_model
    from vp_suite_tpu_torch.parallel import (check_train_mesh, shard_params_fsdp,
                                             shard_video_batch, spatial_halo_convs)
    from vp_suite_tpu_torch.parallel import spatial
    from vp_suite_tpu_torch.training.loop import make_eval_step, make_predict_fn, make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    batch = shard_video_batch({"frames": torch.from_numpy(frames(0)),
                               "actions": torch.arange(B, dtype=torch.float32)[:, None]}, mesh)
    out = {"frames": batch["frames"].clone(), "actions": batch["actions"].clone()}
    for path in PATHS:
        model = ef_model(path)
        state = create_train_state(model, lr=LR, optimizer="sgd")
        with spatial_halo_convs(mesh):
            check_train_mesh(mesh)
            step = make_train_step(model, RUN, mesh=mesh)
        with spatial.record() as log:
            _, metrics = step(state, batch)
        out[path] = {"loss": float(metrics["total"]), "exchanges": len(log),
                     "state_dict": {k: v.detach().clone() for k, v in model.state_dict().items()}}
    other = build_model("min-conv-rnn", 0, "cpu", **MCR)
    out["refused"] = {
        "check_train_mesh": refusal(lambda: check_train_mesh(mesh)),
        "make_train_step": refusal(lambda: make_train_step(ef_model("per_step"), RUN, mesh=mesh)),
        "other_model_train": refusal(lambda: _train_in_context(other, mesh)),
        "other_model_predict": refusal(lambda: make_predict_fn(other, RUN, mesh=mesh)),
        "loss": refusal(lambda: make_eval_step(ef_model("per_step"),
                                               {**RUN, "losses_and_scales": {"ssim": 1.0}},
                                               mesh=mesh)),
        "height": refusal(lambda: shard_video_batch({"frames": torch.zeros(4, 1, 3, 2, 3)},
                                                    mesh)),
        "fsdp": refusal(lambda: _train_in_context(shard_params_fsdp(ef_model("per_step"), mesh),
                                                  mesh))}
    return out


def _train_in_context(model, mesh):
    from vp_suite_tpu_torch.parallel import spatial_halo_convs
    from vp_suite_tpu_torch.training.loop import make_train_step
    with spatial_halo_convs(mesh):
        make_train_step(model, RUN, mesh=mesh)


def _scan_case(mesh, f, u, h0, spec=None, h0_rows=slice(None)):
    from vp_suite_tpu_torch.ops.scan_parallel import (linear_recurrence_scan_sharded,
                                                      sequence_sharding)
    shard = sequence_sharding(mesh, "seq", spec)
    fb, ub = (shard(torch.from_numpy(a)).clone().requires_grad_(True) for a in (f, u))
    c = shard(torch.from_numpy(rand(7, f.shape)))
    h0t = None if h0 is None else torch.from_numpy(h0)[h0_rows].clone().requires_grad_(True)
    h = linear_recurrence_scan_sharded(fb, ub, mesh, "seq", h0=h0t, spec=spec)
    (h * c).sum().backward()
    return {"h": h.detach(), "df": fb.grad, "du": ub.grad,
            "dh0": None if h0t is None else h0t.grad}


class _CountGathers:
    r"""Counts ``all_gather_into_tensor`` calls while open."""

    def __enter__(self):
        self.n, self.orig = 0, torch.distributed.all_gather_into_tensor

        def counted(*a, **k):
            self.n += 1
            return self.orig(*a, **k)
        torch.distributed.all_gather_into_tensor = counted
        return self

    def __exit__(self, *exc):
        torch.distributed.all_gather_into_tensor = self.orig


def run_seq(mesh, rank):
    from vp_suite_tpu_torch.models import build_model
    from vp_suite_tpu_torch.ops.scan_parallel import (linear_recurrence_scan_sharded,
                                                      sequence_sharding)
    from vp_suite_tpu_torch.training.loop import make_predict_fn, make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    f, u, h0 = scan_inputs(SCAN)
    out = {"scan": _scan_case(mesh, f, u, None), "scan_h0": _scan_case(mesh, f, u, h0)}
    z = torch.zeros(6, 2)
    out["refused"] = {
        "indivisible": refusal(lambda: sequence_sharding(mesh)(z[:5])),
        "spec": refusal(lambda: linear_recurrence_scan_sharded(z, z, mesh, spec=("data", "seq")))}
    out["mcr"] = {}
    for ctx in MCR_CONTEXTS:
        run = {"context_frames": ctx, "pred_frames": 3}
        x = {"frames": torch.from_numpy(frames(3, (2, ctx + 3, 16, 16, 3)))}
        got = {}
        for sharded in (True, False):
            model = build_model("min-conv-rnn", 0, "cpu", **MCR,
                                **({"context_mesh": mesh} if sharded else {}))
            with _CountGathers() as count:
                preds, _ = make_predict_fn(model, run)(x)
                state = create_train_state(model, lr=LR, optimizer="sgd")
                _, metrics = make_train_step(model, run)(state, x)
            got[sharded] = {"preds": preds, "loss": float(metrics["total"]), "gathers": count.n,
                            "state_dict": {k: v.clone() for k, v in model.state_dict().items()},
                            "config": sorted(model.config)}
        out["mcr"][ctx] = got
    return out


def run_seq_data(mesh, rank):
    f, u, h0 = scan_inputs(SCAN_DATA, seed=4)
    d = mesh.get_local_rank("data")
    return {"scan": _scan_case(mesh, f, u, h0, spec=("seq", "data"),
                               h0_rows=slice(2 * d, 2 * d + 2))}


def pp_stage(params, x):
    from vp_suite_tpu_torch.nn.functional import conv2d
    return torch.tanh(conv2d(x, params["w"], params["b"], 1, 1))


def pp_inputs():
    S, M, MB, IMG, C = (PP[k] for k in ("S", "M", "MB", "IMG", "C"))
    params = [{"w": rand(20 + i, (C, C, 3, 3), 0.3), "b": rand(30 + i, (C,), 0.1)}
              for i in range(S)]
    return params, rand(40, (M * MB, IMG, IMG, C)), rand(41, (M * MB, IMG, IMG, C))


def run_pp(mesh, rank):
    from vp_suite_tpu_torch.parallel import (gpipe_apply, make_mesh_nd, microbatch,
                                             stack_stage_params)
    params, x, tgt = pp_inputs()
    stacked = stack_stage_params([{k: torch.from_numpy(v) for k, v in p.items()}
                                  for p in params])
    for v in stacked.values():
        v.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = gpipe_apply(pp_stage, stacked, microbatch(xt, PP["M"]), mesh)
    loss = ((y.reshape(xt.shape) - torch.from_numpy(tgt)) ** 2).mean()
    loss.backward()
    names = {}
    for axes in ({"pp": 2}, {"seq": 2, "data": 1}, {"data": 1, "pp": 2}):
        m = make_mesh_nd(axes, "cpu")
        names[tuple(axes)] = (tuple(m.mesh_dim_names), tuple(m.shape))
    return {"y": y.detach(), "loss": float(loss), "dx": xt.grad,
            "grads": {k: v.grad for k, v in stacked.items()}, "names": names}


def main():
    task, out_dir = sys.argv[1], sys.argv[2]
    from vp_suite_tpu_torch.parallel import initialize_multihost, make_mesh_nd
    rank, world = initialize_multihost(device="cpu", backend="gloo")
    axes = WORLDS[task]
    assert world == int(np.prod(list(axes.values()))), world
    try:
        mesh = make_mesh_nd(axes, "cpu")
        run = {"sp": run_sp, "data_sp": run_data_sp, "seq": run_seq, "seq_data": run_seq_data,
               "pp": run_pp}[task]
        torch.save(run(mesh, rank), os.path.join(out_dir, f"{task}_{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
