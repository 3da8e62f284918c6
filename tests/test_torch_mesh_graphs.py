r"""The compiled steps on a mesh (``use_jit=True`` with ``mesh=``) on the CPU.

- The capture rule (``training.graphs.capture_refusal``) on stand-in groups:
  on the card every group's CUDA backend must be NCCL, and a group over gloo
  is refused with a message that names gloo and says to build the step with
  ``use_jit=False``; off the card every backend runs (eagerly). The builders
  raise ``NotImplementedError`` with that message for a gloo mesh when the
  model lies on the card (a stand-in model says so), before any work.
- In a gloo world of one on the CPU the three builders take ``mesh=`` with
  ``use_jit=True`` (a data mesh and a 1x1x1 data x sp x tp mesh), and their
  results are bit-identical to ``use_jit=False``'s on EF-ConvLSTM per step,
  as the JAX package's jitted mesh steps equal its unjitted ones.
- Under FSDP2 the eval step and ``predict`` free the parameters their
  forward gathered (FSDP2 frees its root's only after a backward), and
  match the model without FSDP2, a train step after them included.
- ``VPSuite.train(multihost=True)`` builds its steps with ``use_jit=True``
  where the group runs NCCL, and with ``use_jit=False`` where it runs gloo on
  the card, which it prints (the rule's inputs faked: this host has no card).
"""
import socket
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

import vp_suite_tpu_torch.vpsuite as port_vpsuite
from vp_suite_tpu_torch import VPSuite
from vp_suite_tpu_torch.models import build_model
from vp_suite_tpu_torch.parallel import make_mesh, make_mesh_nd, shard_params
from vp_suite_tpu_torch.training import graphs, loop
from vp_suite_tpu_torch.training.loop import make_eval_step, make_predict_fn, make_train_step
from vp_suite_tpu_torch.training.train_state import create_train_state

torch.set_num_threads(1)

EF = dict(img_shape=(3, 16, 16), action_size=0, tensor_value_range=(0.0, 1.0))
RUN = {"context_frames": 2, "pred_frames": 2}
LR = 1e-2
BUILDERS = {"train": make_train_step, "eval": make_eval_step, "predict": make_predict_fn}


class Group:
    r"""A stand-in process group: only its backend's name."""

    def __init__(self, backend):
        self.backend = backend


@pytest.fixture()
def stand_in_backends(monkeypatch):
    r"""``dist.get_backend`` as the capture rule calls it, read from the
    stand-in groups."""
    monkeypatch.setattr(graphs, "dist", types.SimpleNamespace(get_backend=lambda g: g.backend))


@pytest.fixture()
def gloo_world_of_one():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("backends", [("nccl",), ("nccl", "nccl", "nccl"),
                                      ("cpu:gloo,cuda:nccl",), ()],
                         ids=["nccl", "nccl_sub_groups", "per_device", "no_group"])
def test_nccl_groups_capture(stand_in_backends, backends):
    assert graphs.capture_refusal([Group(b) for b in backends], on_card=True) is None


@pytest.mark.parametrize("backends", [("gloo",), ("nccl", "gloo"), ("cuda:gloo,cpu:gloo",)],
                         ids=["gloo", "gloo_sub_group", "per_device"])
def test_gloo_on_the_card_is_refused(stand_in_backends, backends):
    msg = graphs.capture_refusal([Group(b) for b in backends], on_card=True)
    assert "gloo" in msg and "on the host" in msg and "use_jit=False" in msg
    assert "nccl" not in msg


@pytest.mark.parametrize("backend", ["gloo", "nccl", "mpi"])
def test_off_the_card_any_backend_runs(stand_in_backends, backend):
    assert graphs.capture_refusal([Group(backend)], on_card=False) is None


def test_another_backend_on_the_card_is_refused(stand_in_backends):
    msg = graphs.capture_refusal([Group("mpi")], on_card=True)
    assert "mpi" in msg and "NCCL alone" in msg and "use_jit=False" in msg


class CardModel:
    r"""A stand-in model whose one parameter lies on the card."""

    def parameters(self):
        return iter([types.SimpleNamespace(is_cuda=True)])

    def buffers(self):
        return iter([])


@pytest.mark.parametrize("name", list(BUILDERS))
def test_builders_refuse_a_gloo_mesh_on_the_card(gloo_world_of_one, name):
    mesh = make_mesh(0, "data", "cpu")
    with pytest.raises(NotImplementedError, match="runs gloo on the card.*use_jit=False"):
        BUILDERS[name](CardModel(), RUN, mesh=mesh)
    assert loop.compile_refusal(CardModel()) is None, "no mesh: nothing to refuse"
    model = build_model("convlstm-shi", 0, "cpu", **EF)
    assert loop.compile_refusal(model, mesh) is None, "the CPU: every step runs eagerly"


def _frames(b=2, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((b, 4, 16, 16, 3), dtype=np.float32))


@pytest.mark.parametrize("axes", [None, {"data": 1, "sp": 1, "tp": 1}], ids=["data", "data_sp_tp"])
@pytest.mark.parametrize("name", list(BUILDERS))
def test_mesh_steps_take_use_jit(gloo_world_of_one, axes, name):
    mesh = make_mesh(0, "data", "cpu") if axes is None else make_mesh_nd(axes, "cpu")
    batch = {"frames": _frames()}
    out = []
    for use_jit in (True, False):
        model = shard_params(build_model("convlstm-shi", 0, "cpu", **EF), mesh)
        fn = BUILDERS[name](model, RUN, mesh=mesh, use_jit=use_jit)
        if name == "train":
            state = create_train_state(model, lr=LR, optimizer="sgd")
            metrics = [fn(state, batch)[1] for _ in range(2)]
            out.append([m["total"] for m in metrics] + [p.detach() for p in model.parameters()])
        elif name == "eval":
            out.append(list(fn(None, batch).values()))
        else:
            out.append(list(fn(batch)))
    assert len(out[0]) == len(out[1])
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["eval", "predict"])
def test_fsdp_eval_and_predict_free_the_gathered_parameters(gloo_world_of_one, name):
    r"""FSDP2 keeps its root's gathered parameters after a forward and frees
    them after a backward only: the eval step and ``predict`` free them
    themselves, so that a graph of either gathers the present parameters
    (FSDP2 in a world of one, whose gathers are copies), and the train step
    after them trains on the sharded parameters as without them."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import DTensor
    mesh = make_mesh(0, "data", "cpu")
    plain, sharded = (build_model("convlstm-shi", 0, "cpu", **EF) for _ in range(2))
    fully_shard(sharded, mesh=mesh, ignored_params={p for p in sharded.parameters()
                                                    if p.numel() < 4096})
    large = [n for n, p in sharded.named_parameters() if isinstance(p, DTensor)]
    assert large
    batch = {"frames": _frames()}
    outs = []
    for model in (plain, sharded):   # a train step, eval or predict, a train step
        state = create_train_state(model, lr=LR, optimizer="sgd")
        step = make_train_step(model, RUN, mesh=mesh)
        step(state, batch)
        fn = BUILDERS[name](model, RUN, mesh=mesh)
        outs.append(list(fn(None, batch).values()) if name == "eval" else list(fn(batch)))
        assert model is plain or all(isinstance(p, DTensor) for n, p in model.named_parameters()
                                     if n in large), "the gathered parameters are kept"
        step(state, batch)
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    for (n, a), b in zip(plain.named_parameters(), sharded.parameters()):
        assert torch.equal(a, b.full_tensor() if isinstance(b, DTensor) else b), n


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_train_in_a_group_compiles_unless_the_rule_refuses(backend, monkeypatch, tmp_path,
                                                           capsys):
    asked = []
    for builder in ("make_train_step", "make_eval_step", "make_predict_fn"):
        def recording(*args, _make=getattr(port_vpsuite, builder), **kwargs):
            asked.append(kwargs["use_jit"])
            return _make(*args, **kwargs)
        monkeypatch.setattr(port_vpsuite, builder, recording)
    # the rule as on the card, over a group of ``backend``
    real = graphs.capture_refusal
    monkeypatch.setattr(loop, "capture_refusal", lambda groups, on_card: real(
        [Group(backend) for _ in groups], True))
    monkeypatch.setattr(graphs, "dist", types.SimpleNamespace(get_backend=lambda g: g.backend))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK=0, WORLD_SIZE=1, LOCAL_RANK=0, MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=port).items():
        monkeypatch.setenv(k, str(v))
    suite = VPSuite(device="cpu")
    suite.load_dataset("MMF", img_size=16, digit_source="synthetic",
                       n_seqs={"train": 4, "val": 2, "test": 2})
    entry = suite.create_model("convlstm-shi")
    try:
        suite.train(epochs=1, batch_size=2, context_frames=2, pred_frames=2, steps_per_epoch=2,
                    no_vis=True, no_wandb=True, out_dir=str(tmp_path), multihost=True)
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert asked == [backend == "nccl"] * 3
    said = "the train, eval and predict steps run eagerly: use_jit=True on a mesh whose process " \
           "group runs gloo on the card"
    assert (said in capsys.readouterr().out) == (backend == "gloo")
    assert entry.state.step == 2
