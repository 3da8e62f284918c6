r"""MinConvRNN (the JAX package's ``models/min_conv_rnn.py``): a convolutional
RNN whose gates read only the input, so that the recurrence is linear in the
hidden state and the whole context window is encoded as one batch.

A strided conv encoder (two 3x3 stride-2 convs with ReLU) takes each frame
to ``h/4 x w/4 x hidden_dim``; each of ``num_layers`` layers computes the
gates ``f = sigmoid(conv3x3(z))`` and ``u = (1 - f) * tanh(conv3x3(z))`` of
all context frames at once, runs ``h_t = f_t * h_{t-1} + u_t`` over time
(:func:`linear_recurrence_scan`) and adds a 1x1 ``out`` conv of ``h`` to its
input; two k4 s2 p1 transposed convs (ReLU between) decode a frame. The
first prediction decodes the last context step; each later one encodes the
previous prediction and advances every layer's state by one step.

The model has no dtype of its own: it computes in its input's dtype (the
train step casts the input to ``compute_dtype``), so under bf16 the gates,
``1 - f`` and the recurrence run in bf16, as in the JAX package. Parameters:
``enc1``, ``enc2``, ``layers.{i}.f`` / ``.g`` / ``.out``, ``dec1``, ``dec2``
(torch layouts). ``remat`` checkpoints each step of the rollout under
training, as the JAX model does (``min_conv_rnn.py:146-147``); the context
scan is not checkpointed.

``context_mesh`` (a ``DeviceMesh`` with a ``seq`` axis, as in the JAX
package) shards each layer's context scan over ``seq``
(:mod:`vp_suite_tpu_torch.ops.scan_parallel`) where the context length
divides by its size, and runs it unsharded otherwise, as the JAX model does.
Every ``seq`` process computes the encoder, the gates and the rollout whole;
it scans its block of the time steps, and the blocks are gathered back.
The gradients are the one-process model's on every process: each block's
gradient is gathered whole, and the aggregates' gather sums its cotangents
over ``seq``. It stays out of the model's ``config``.
"""
import torch
import torch.nn.functional as F
from torch import nn

from vp_suite_tpu_torch.base.base_model import VPModel
from vp_suite_tpu_torch.nn import remat
from vp_suite_tpu_torch.nn.layers import Conv2d, ConvTranspose2d


def linear_recurrence_scan(f, u, h0=None):
    r"""``h_t = f_t * h_{t-1} + u_t`` over the first axis of ``f`` and ``u``
    (``[t, ...]``), ``h_{-1} = h0`` (zeros by default); returns ``h``
    ``[t, ...]``. A t-step loop: the JAX package's log-depth
    ``associative_scan`` computes the same values with another rounding."""
    h = u[0] if h0 is None else u[0] + f[0] * h0
    hs = [h]
    for t in range(1, f.shape[0]):
        h = u[t] + f[t] * h
        hs.append(h)
    return torch.stack(hs)


class _GatedLayer(nn.Module):
    r"""One linear-recurrence layer: the gate convs ``f``, ``g`` and the 1x1 ``out``."""

    def __init__(self, hd):
        super().__init__()
        self.f = Conv2d(hd, hd, 3, 1, 1)
        self.g = Conv2d(hd, hd, 3, 1, 1)
        self.out = Conv2d(hd, hd, 1)

    def gates(self, z):
        f = torch.sigmoid(self.f(z))
        return f, (1.0 - f) * torch.tanh(self.g(z))


class MinConvRNN(VPModel):
    NAME = "MinConvRNN (time-parallel)"
    PAPER_REFERENCE = "https://arxiv.org/abs/2006.12077"
    MATCHES_REFERENCE = "N/A (no reference analog; TPU-native extra)"

    num_layers = 2
    hidden_dim = 64
    context_mesh = None             #: a DeviceMesh whose ``seq`` axis the context scan shards over

    def __init__(self, **hparams):
        super().__init__(**hparams)
        from torch.distributed.device_mesh import DeviceMesh
        if self.context_mesh is not None and not isinstance(self.context_mesh, DeviceMesh):
            raise ValueError(f"context_mesh must be a DeviceMesh with a 'seq' axis, not "
                             f"{type(self.context_mesh).__name__}")
        c, hd = self.img_c, self.hidden_dim
        self.enc1 = Conv2d(c, hd // 2, 3, 2, 1)
        self.enc2 = Conv2d(hd // 2, hd, 3, 2, 1)
        self.layers = nn.ModuleList([_GatedLayer(hd) for _ in range(self.num_layers)])
        self.dec1 = ConvTranspose2d(hd, hd // 2, 4, 2, 1)
        self.dec2 = ConvTranspose2d(hd // 2, c, 4, 2, 1)

    @property
    def config(self) -> dict:
        cfg = super().config
        cfg.pop("context_mesh")
        return cfg

    def _context_scan(self, f, u):
        r"""``linear_recurrence_scan(f, u)`` of the context ``[t, ...]``, its
        time split over ``context_mesh``'s ``seq`` axis where that divides t."""
        from vp_suite_tpu_torch.parallel.mesh import axis_size
        mesh = self.context_mesh
        n = axis_size(mesh, "seq")
        if n < 2 or f.shape[0] % n:
            return linear_recurrence_scan(f, u)
        from vp_suite_tpu_torch.ops.scan_parallel import (linear_recurrence_scan_sharded,
                                                          sequence_block, whole_sequence)
        h = linear_recurrence_scan_sharded(sequence_block(f, mesh), sequence_block(u, mesh), mesh)
        return whole_sequence(h, mesh)

    def _encode(self, frames):      # [n, h, w, c] -> [n, h/4, w/4, hd]
        return F.relu(self.enc2(F.relu(self.enc1(frames))))

    def _decode(self, z):           # [n, h/4, w/4, hd] -> [n, h, w, c]
        return self.dec2(F.relu(self.dec1(z)))

    def forward(self, x, pred_frames: int = 1, actions=None, train: bool = False, **kwargs):
        b, t_in = x.shape[:2]
        c, ih, iw = self.img_shape
        if tuple(x.shape[2:]) != (ih, iw, c):
            raise ValueError(f"input image does not match specified size "
                             f"(input: {tuple(x.shape[2:])}, required: {(ih, iw, c)})")
        # the context, all steps at once, time-major [t, b, h/4, w/4, hd]
        z = self._encode(x.reshape(b * t_in, ih, iw, c))
        z = z.reshape(b, t_in, *z.shape[1:]).transpose(0, 1)
        shape, flat = z.shape, (t_in * b, *z.shape[2:])
        hs = []
        for layer in self.layers:
            f, u = layer.gates(z.reshape(flat))
            h = self._context_scan(f.reshape(shape), u.reshape(shape))
            hs.append(h[-1])
            z = z + layer.out(h.reshape(flat)).reshape(shape)
        # the rollout: one step of every layer per predicted frame
        frame = self._decode(z[-1])
        preds = [frame]
        for _ in range(pred_frames - 1):
            if self.remat:
                hs, frame = remat.checkpoint(self._ar_step, hs, frame)
            else:
                hs, frame = self._ar_step(hs, frame)
            preds.append(frame)
        return torch.stack(preds, dim=1), None

    def _ar_step(self, hs, frame):
        r"""One step of every layer on the encoded previous frame; returns the
        new states and the next frame (JAX's ``step``, the region that
        ``remat`` checkpoints)."""
        zz, new = self._encode(frame), []
        for h, layer in zip(hs, self.layers):
            f, u = layer.gates(zz)
            new.append(f * h + u)
            zz = zz + layer.out(new[-1])
        return new, self._decode(zz)
