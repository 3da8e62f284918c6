r"""The compiled steps (``use_jit=True``: CUDA-graph capture) on a CUDA card.

These tests need an NVIDIA card with ``nvcc`` and Triton, and skip without
one. They import neither JAX nor the JAX package, so they run on a machine
that has neither:

    python -m pytest tests/test_torch_graphs_cuda.py -q --noconftest -p no:cacheprovider

For every registry model at a small size (b=2, 16x16 or 32x32, 3 -> 3, f32,
TF32 off, cuDNN's deterministic algorithms), the graphed train step (plain
SGD), ``predict`` and eval step against the eager ones on a copy of the same
model: losses step by step (1e-5 relative) and the first replay's update
from the eager model's parameters and buffers, as ``(p0 - p1) / lr`` within
``chip_smoke.py``'s SGD gate (5e-4 relative plus 5e-4; from states of their
own UNet-3D's steps part further, as two eager runs do: its backward is not
bit-reproducible on the card), the
predictions within its f32 ``predict`` gate (1e-4); PhyDNet across the epoch
where its teacher-forcing ratio falls to 0, PredRNN++ across the iteration
where its sampling rate does; one graph per batch shape; the outputs of
every call new tensors; a learning rate cut after the capture reaching the
next replay; the refusal on a gloo mesh; the mesh steps of a world of one over
NCCL captured, bit-identical to the eager mesh steps; an FVD loss captured; a
capturable state through a checkpoint.
"""
import math
import socket

import pytest
import torch
from torch.utils import _pytree as pytree

from vp_suite_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from vp_suite_tpu_torch.measure.loss_provider import PredictionLossProvider
from vp_suite_tpu_torch.models import build_model
from vp_suite_tpu_torch.training.loop import make_eval_step, make_predict_fn, make_train_step
from vp_suite_tpu_torch.training.schedule import set_learning_rate
from vp_suite_tpu_torch.training.train_state import create_train_state

pytestmark = pytest.mark.cuda

RUN = {"context_frames": 3, "pred_frames": 3}
LR = 1e-4     # four steps on one batch stay finite at every model's summed losses
STEP_TOL = 5e-4
PREDICT_ATOL = 1e-4
#: every registry model at a small size: name -> (registry id, configuration)
SMALL = {
    "copy": ("copy", {}),
    "per_step": ("convlstm-shi", {}),
    "fused_scan": ("convlstm-shi", dict(use_fused_scan=True, interleaved_encode=False,
                                        interleaved_forecast=False)),
    "trajgru": ("trajgru", {}),
    "unet3d": ("unet-3d", dict(temporal_dim=3, features=(4, 8))),
    "predrnn": ("predrnn-pp", dict(num_hidden=(8, 8, 8))),
    "phydnet": ("phy", dict(convlstm_hidden_dims=(16, 64))),
    "min_conv_rnn": ("min-conv-rnn", dict(hidden_dim=16)),
    "simvp": ("simvp", dict(hid_s=8, hid_t=16, n_trans=2, in_frames=3)),
    "pred_former": ("pred-former", dict(patch_size=8, dim=32, depth=2, heads=2)),
    "st_phy": ("st-phy", dict(img_shape=(3, 32, 32), num_layers=2, st_cell_channels=8,
                              phycell_channels=9, phycell_kernel_size=(3, 3))),
    "lstm": ("lstm", dict(img_shape=(3, 32, 32), bottleneck_dim=32, lstm_hidden_dim=32,
                          lstm_num_layers=2)),
}
#: the epochs of the steps: PhyDNet's ratio is 1 at epoch 0 (the capture's) and
#: 0 from epoch 334 on, so a ratio frozen into the graph would keep the coin 1
EPOCHS = (0, 0, 334, 334)


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = flags


def _model(name):
    model_id, kw = SMALL[name]
    kw = {"img_shape": (3, 16, 16), "action_size": 0, "tensor_value_range": (0.0, 1.0), **kw}
    return build_model(model_id, 0, "cuda", **kw)


def _batch(model, b=2, seed=1):
    c, h, w = model.img_shape
    g = torch.Generator().manual_seed(seed)
    return {"frames": torch.rand((b, 6, h, w, c), generator=g).cuda(),
            "actions": torch.zeros((b, 6, 1)).cuda()}


def _state(model):
    state = create_train_state(model, lr=LR, optimizer="sgd")
    if "sampling_eta" in state.model_state:   # two draws from the stop: the rate falls to 0
        state.model_state = {"training_iteration": model.sampling_stop_iter - 2,
                             "sampling_eta": 0.5}
    return state


def _excess(got, want):
    r"""The SGD gate's ``max(|got - want| - rtol * |want|)`` over tensors."""
    return max(((g - w).abs() - STEP_TOL * w.abs()).max().item() for g, w in zip(got, want))


@pytest.mark.parametrize("name", list(SMALL))
def test_graphed_steps_match_eager(card, name):
    eager_model, graph_model = _model(name), _model(name)
    batch = _batch(eager_model)
    if eager_model.TRAINABLE:
        se, sg = _state(eager_model), _state(graph_model)
        eager = make_train_step(eager_model, RUN, use_jit=False)
        graph = make_train_step(graph_model, RUN)
        kept = []
        for n, epoch in enumerate(EPOCHS):
            if n == 1:   # the first replay starts from the eager model's parameters and buffers
                with torch.no_grad():
                    for mine, theirs in zip(graph_model.state_dict().values(),
                                            eager_model.state_dict().values()):
                        mine.copy_(theirs)
                p0 = [p.detach().clone() for p in eager_model.parameters()]
            _, want = eager(se, batch, epoch)
            _, got = graph(sg, batch, epoch)
            kept.append(got["total"])
            assert set(got) == set(want) and math.isfinite(float(want["total"]))
            for k in want:
                assert abs(float(got[k]) - float(want[k])) <= 1e-5 * abs(float(want[k])) + 1e-6, \
                    f"{name} epoch {epoch}: {k} {float(got[k])} against {float(want[k])}"
            if n == 1:
                deltas = [[(a - p.detach()) / LR for a, p in zip(p0, m.parameters())]
                          for m in (graph_model, eager_model)]
                assert _excess(*deltas) <= STEP_TOL
        assert len(graph.compiled.graphs) == 1 and se.step == sg.step == len(EPOCHS)
        assert se.model_state == sg.model_state
        assert len({t.data_ptr() for t in kept}) == len(kept), "the metrics share storage"
    for make in (make_predict_fn, make_eval_step):
        eager, graph = make(eager_model, RUN, use_jit=False), make(graph_model, RUN)

        def args(batch):   # predict takes the batch, the eval step a state and the batch
            return (batch,) if make is make_predict_fn else (None, batch)
        want = pytree.tree_flatten(eager(*args(batch)))[0]
        outs = [pytree.tree_flatten(graph(*args(batch)))[0] for _ in range(3)]
        assert len(graph.graphs) == 1
        for got in outs:
            for g, w in zip(got, want):
                assert (g - w).abs().max().item() <= PREDICT_ATOL
        assert outs[1][0].data_ptr() != outs[2][0].data_ptr(), "the outputs share storage"
        for _ in range(2):
            graph(*args(_batch(eager_model, b=4)))
        assert len(graph.graphs) == 2, "a second batch shape is a second graph"


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_a_learning_rate_cut_reaches_the_next_replay(card, optimizer):
    eager_model, graph_model = _model("per_step"), _model("per_step")
    batch = _batch(eager_model)
    p0 = [p.detach().clone() for p in eager_model.parameters()]
    states = [create_train_state(m, lr=LR, optimizer=optimizer)
              for m in (eager_model, graph_model)]
    assert torch.is_tensor(states[1].optimizer.param_groups[0]["lr"])
    steps = make_train_step(eager_model, RUN, use_jit=False), make_train_step(graph_model, RUN)
    for i in range(4):
        if i == 2:   # after the capture: a frozen rate would move the last two steps 5x as far
            for s in states:
                set_learning_rate(s, LR * 0.2)
        for step, s in zip(steps, states):
            step(s, batch)
    deltas = [[(a - p.detach()) / LR for a, p in zip(p0, m.parameters())]
              for m in (graph_model, eager_model)]
    assert _excess(*deltas) <= STEP_TOL


def _world_of_one(backend):
    from vp_suite_tpu_torch.parallel import initialize_multihost
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize_multihost(f"127.0.0.1:{port}", 1, 0, device="cuda", backend=backend)


def test_a_mesh_refuses_the_compiled_step(card):
    r"""A gloo group on the card: its collectives run on the host, so the
    builders refuse ``use_jit=True`` and name gloo."""
    from vp_suite_tpu_torch.parallel import make_mesh
    _world_of_one("gloo")
    try:
        mesh = make_mesh(0, "data", "cuda")
        model = _model("per_step")
        for make in (make_train_step, make_eval_step, make_predict_fn):
            with pytest.raises(NotImplementedError, match="runs gloo on the card.*use_jit=False"):
                make(model, RUN, mesh=mesh)
        state = create_train_state(model, lr=LR, optimizer="sgd")
        make_train_step(model, RUN, mesh=mesh, use_jit=False)(state, _batch(model))
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("name", ["per_step", "fused_scan"])
def test_an_nccl_world_of_one_captures_its_mesh_steps(card, name):
    r"""A world of one over NCCL: the train, eval and predict steps built
    with ``mesh=`` and ``use_jit=True`` capture (the all-reduce inside the
    train and eval graphs) and their replays, under the sync debug mode's
    "error", equal the eager mesh steps bit for bit, the train step's
    parameters after 4 steps included."""
    from vp_suite_tpu_torch.parallel import make_mesh
    _world_of_one("nccl")
    try:
        mesh = make_mesh(0, "data", "cuda")
        models = [_model(name), _model(name)]
        batch = _batch(models[0])
        states = [create_train_state(m, lr=LR, optimizer="sgd") for m in models]
        steps = [make_train_step(m, RUN, mesh=mesh, use_jit=j == 1) for j, m in enumerate(models)]
        for n in range(4):
            _, want = steps[0](states[0], batch)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error" if n >= 2 else 0)
            try:
                _, got = steps[1](states[1], batch)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            assert all(torch.equal(got[k], want[k]) for k in want)
        assert len(steps[1].compiled.graphs) == 1
        for a, b in zip(*(m.parameters() for m in models)):
            assert torch.equal(a, b)
        for make in (make_eval_step, make_predict_fn):
            eager, graph = (make(models[1], RUN, mesh=mesh, use_jit=j) for j in (False, True))
            args = (batch,) if make is make_predict_fn else (None, batch)
            want = pytree.tree_flatten(eager(*args))[0]
            for n in range(3):
                torch.cuda.set_sync_debug_mode("error" if n == 2 else 0)
                try:
                    got = pytree.tree_flatten(graph(*args))[0]
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                assert all(torch.equal(g, w) for g, w in zip(got, want))
            assert len(graph.graphs) == 1
    finally:
        torch.distributed.destroy_process_group()


def test_an_fvd_loss_captures(card):
    r"""An FVD loss inside the captured train and eval steps: its device
    distance (E1) reads nothing back (replays under the sync debug mode's
    "error"), E1 launches once a call that launches (the eager call and the
    capture), and the replays give the eager steps' losses and update; the
    eager eval step takes the same device distance inside ``fvd_in_step``.
    The host distance still refuses a capture."""
    from vp_suite_tpu_torch.measure.fvd import fvd
    from vp_suite_tpu_torch.ops.sym_eig import sym_eig
    from vp_suite_tpu_torch.training.loop import fvd_in_step
    run = {"context_frames": 2, "pred_frames": 9}   # FVD needs 9 frames
    losses = PredictionLossProvider({"losses_and_scales": {"mse": 1.0, "fvd": 1.0}, "img_c": 3})
    assert "fvd" in losses.losses
    eager_model, graph_model = _model("per_step"), _model("per_step")
    c, h, w = eager_model.img_shape
    g = torch.Generator().manual_seed(3)
    batch = {"frames": torch.rand((4, 11, h, w, c), generator=g).cuda()}
    se, sg = (create_train_state(m, lr=LR, optimizer="sgd") for m in (eager_model, graph_model))
    eager = make_train_step(eager_model, run, losses, use_jit=False)
    graph = make_train_step(graph_model, run, losses)
    sym_eig.launches = 0
    for n in range(3):
        if n == 1:
            with torch.no_grad():
                for mine, theirs in zip(graph_model.state_dict().values(),
                                        eager_model.state_dict().values()):
                    mine.copy_(theirs)
            p0 = [p.detach().clone() for p in eager_model.parameters()]
        _, want = eager(se, batch)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error" if n == 2 else 0)
        try:
            _, got = graph(sg, batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for k in want:
            assert abs(float(got[k]) - float(want[k])) <= 1e-5 * abs(float(want[k])) + 1e-6, \
                f"step {n}: {k} {float(got[k])} against {float(want[k])}"
        if n == 1:
            deltas = [[(a - p.detach()) / LR for a, p in zip(p0, m.parameters())]
                      for m in (graph_model, eager_model)]
            assert _excess(*deltas) <= STEP_TOL
    assert sym_eig.launches == 3 + 2
    eval_eager = make_eval_step(eager_model, run, losses, use_jit=False)
    eval_graph = make_eval_step(eager_model, run, losses)
    with fvd_in_step():
        want = eval_eager(None, batch)
    outs = [eval_graph(None, batch) for _ in range(3)]
    for got in outs:
        for k in want:
            assert abs(float(got[k]) - float(want[k])) <= 1e-5 * abs(float(want[k])) + 1e-6, k
    measure, frames = fvd.FrechetVideoDistance(), batch["frames"][:, 2:]
    with pytest.raises(RuntimeError, match="host distance"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()), torch.inference_mode():
            measure(frames, frames)


def test_a_capturable_state_goes_through_a_checkpoint(card, tmp_path):
    model = _model("per_step")
    state = create_train_state(model, lr=LR)
    step = make_train_step(model, RUN)
    for _ in range(3):
        step(state, _batch(model))
    set_learning_rate(state, 3e-3)
    save_checkpoint(tmp_path, state, "convlstm-shi", model.config)
    for device in ("cuda", "cpu"):
        loaded, got, _ = load_checkpoint(tmp_path, device=device)
        group = got.optimizer.param_groups[0]
        assert float(group["lr"]) == pytest.approx(3e-3)
        assert torch.is_tensor(group["lr"]) == (device == "cuda")
        assert group["capturable"] == (device == "cuda")
        for p, q in zip(model.parameters(), loaded.parameters()):
            a, b = state.optimizer.state[p], got.optimizer.state[q]
            assert torch.equal(a["exp_avg"].cpu(), b["exp_avg"].cpu())
            assert float(a["step"]) == float(b["step"]) == 3.0
            assert b["step"].device.type == device
        step = make_train_step(loaded, RUN)
        for _ in range(2):   # eager, then captured on the card
            step(got, {k: v.to(device) for k, v in _batch(model).items()})
