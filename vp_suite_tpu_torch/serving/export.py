r"""Ahead-of-time export of a model's inference path with ``torch.export``.

The port's counterpart of the JAX package's ``serving/export.py``: the
predictor (the parameters held in the program) is traced once into an
``ExportedProgram`` and written to one ``.pt2`` file, which a serving
process loads and calls without the model class or the checkpoint::

    from vp_suite_tpu_torch.serving import export_predictor, save_predictor, load_predictor
    exported = export_predictor(model, state, context_frames=5, pred_frames=10, batch_size=8)
    save_predictor(exported, "predictor.pt2")
    # ... in the serving process (torch and the port's operators):
    predict = load_predictor("predictor.pt2")
    preds = predict(frames)   # [b, ctx, h, w, c] -> [b, pred, h, w, c]

The graph holds the port's kernels as the ``torch.library`` operators of
:mod:`vp_suite_tpu_torch.ops` (``vp_suite_tpu_torch::convlstm_gate_forward``,
``::convlstm_scan_forward``, ``::warp_sample_forward``), not their plain
decomposition, so the loaded program launches K1, K3 or the warp forward on
the card. One divergence from the JAX package: its StableHLO artifact loads
with ``jax`` alone, while the port's loads with ``torch`` plus the port's
operator registrations (``import vp_suite_tpu_torch.ops``, which
:func:`load_predictor` does), since the kernels are the port's own.
"""
from pathlib import Path

import torch

import vp_suite_tpu_torch.ops  # noqa: F401  (the kernels' operators, which the graphs call)
from vp_suite_tpu_torch.training.loop import _apply_model
from vp_suite_tpu_torch.utils.utils import torch_dtype


class _Predictor(torch.nn.Module):
    r"""The model's inference path: ``frames -> preds`` (``(frames, actions)
    -> preds`` for an action-conditional model), predictions in f32."""

    def __init__(self, model, pred_frames):
        super().__init__()
        self.model = model
        self.pred_frames = pred_frames

    def forward(self, frames, actions=None):
        kw = {} if actions is None else {"actions": actions}
        preds, _ = _apply_model(self.model, frames, pred_frames=self.pred_frames, train=False,
                                **kw)
        return preds.float()


def export_predictor(model, state, context_frames: int, pred_frames: int,
                     batch_size: int = 1, compute_dtype=None):
    r"""Traces the model's inference path into a ``torch.export.ExportedProgram``.

    The input is ``[batch_size, T, h, w, c]`` f32 frames on the model's device,
    with ``T = context_frames`` (plus ``pred_frames`` zero-padded frames for
    ``NEEDS_COMPLETE_INPUT`` models, which take the whole window), and for an
    action-conditional model also ``[batch_size, context_frames + pred_frames,
    action_size]`` f32 actions; the output is the ``[batch_size, pred_frames, h,
    w, c]`` f32 prediction. The parameters ride along in the program.
    ``batch_size=None`` exports one program whose batch dimension is symbolic
    (``torch.export.Dim``), which serves any batch. ``compute_dtype`` (e.g.
    ``torch.bfloat16``) bakes that activation dtype into the graph, whatever
    the model trains in; input and output stay f32. ``state`` (the model's
    :class:`~vp_suite_tpu_torch.training.train_state.TrainState`, or None) is
    taken for the JAX package's signature: the parameters live in ``model``.
    """
    del state
    c, h, w = model.img_shape
    t_in = context_frames + (pred_frames if model.NEEDS_COMPLETE_INPUT else 0)
    device = next(iter(model.parameters()), torch.empty(0)).device
    b = 2 if batch_size is None else batch_size
    args = (torch.zeros((b, t_in, h, w, c), device=device),)
    dynamic = None
    if model.action_conditional:
        args += (torch.zeros((b, context_frames + pred_frames, max(model.action_size, 1)),
                             device=device),)
    if batch_size is None:
        batch = torch.export.Dim("batch", min=1)
        dynamic = ({0: batch},) + (({0: batch},) if model.action_conditional else ())
    kept, was_training = model.compute_dtype, model.training
    if compute_dtype is not None:
        model.compute_dtype = torch_dtype(compute_dtype)
    try:
        with torch.no_grad():
            exported = torch.export.export(_Predictor(model.eval(), pred_frames), args,
                                           dynamic_shapes=dynamic)
    finally:
        model.compute_dtype = kept
        model.train(was_training)
    # export puts a metadata assert before each dtype conversion (381 in EF-ConvLSTM's graph:
    # the weights are cast at each use), a host-side check at every call of the program
    graph = exported.graph_module.graph
    asserts = torch.ops.aten._assert_tensor_metadata.default
    for node in list(graph.nodes):
        if node.op == "call_function" and node.target == asserts:
            graph.erase_node(node)
    exported.graph_module.recompile()
    return exported


def save_predictor(exported, path):
    r"""Writes an ``ExportedProgram`` to one ``.pt2`` file; returns its path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(exported, str(path))
    return path


def load_predictor(path):
    r"""Loads a saved program into a callable ``frames -> preds`` (``(frames,
    actions) -> preds`` for an action-conditional one); the program is kept as
    ``predict.exported``. Its tensors load onto the device they were saved
    from, so inputs go there too. Needs torch and the port's operators."""
    exported = torch.export.load(str(path))
    module = exported.module()

    def predict(*args):
        with torch.no_grad():
            return module(*args)

    predict.exported = exported
    return predict
