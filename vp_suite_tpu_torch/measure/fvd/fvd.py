r"""Fréchet Video Distance, the JAX package's: I3D features of videos resized
to 224x224, chunks for sequences longer than 16 frames, and the
2-Wasserstein distance between the two feature distributions by the
eigenvalue method of arXiv:2009.14075.

Two paths, as in the JAX package: a metric copies the features to the host
and takes the eigenvalues of a nonsymmetric product in f64 with numpy
(:func:`wasserstein2_numpy`); a loss stays on the device and takes the
eigenvalues of the symmetric form in f32 (:func:`wasserstein2_torch`; on the
card from E1, ``ops/sym_eig.py``, which reads nothing back, so the loss runs
inside a captured step). The JAX package picks the second path when its
features are tracers: always in the train step, in the eval step when it is
jitted, never in ``test``'s metrics. The port's step builders say so with
:func:`step_distance`; outside one, FVD takes the device path when autograd
records and the prediction requires grad, else the host's.
"""
import contextlib

import numpy as np
import torch

from vp_suite_tpu_torch.base.base_measure import VPMeasure, full_precision, placed
from vp_suite_tpu_torch.measure.fvd.i3d import i3d_features, load_params
from vp_suite_tpu_torch.ops.image import resize_bilinear
from vp_suite_tpu_torch.ops.sym_eig import sym_eigvals

#: the ``gather`` of each open :func:`step_distance` context, innermost last
_STEPS = []


@contextlib.contextmanager
def step_distance(gather=None):
    r"""Within the context, FVD computes the device distance
    (:func:`wasserstein2_torch`), as inside a traced (jitted or
    differentiated) step of the JAX package, whatever autograd records.
    ``gather`` (a function from this process's I3D features ``[b, 400]`` to
    the global batch's, or None) joins the features over a data mesh first,
    so that each process computes the global batch's distance, as JAX's step
    on a sharded batch does. The innermost context holds."""
    _STEPS.append(gather)
    try:
        yield
    finally:
        _STEPS.pop()


def calculate_n_chunks(num_frames, min_t=9, max_t=16):
    r"""``(n_chunks, drop_last_chunk)``: the chunking plan for I3D's
    9 <= T <= 16 window; ``n_chunks`` is -1 below ``min_t`` frames."""
    n_chunks, drop_last_chunk = 1, False
    if num_frames < min_t:
        print(f"The I3D Module used for FVD needs at least {min_t} input frames "
              f"(given: {num_frames}) -> returning None as loss value!")
        n_chunks = -1
    elif num_frames > max_t:
        possible_chunk_l = range(max_t, min_t - 1, -1)
        n_chunks = None
        for chunk_l in possible_chunk_l:
            if num_frames % chunk_l >= min_t:
                n_chunks = num_frames // chunk_l + 1
        if n_chunks is None:
            missed_frames = [num_frames % chunk_l for chunk_l in possible_chunk_l]
            best_chunk_l = sorted(zip(possible_chunk_l, missed_frames),
                                  key=lambda x: x[1])[-1]
            n_chunks = num_frames // best_chunk_l[0] + 1
            drop_last_chunk = True
        print(f"The I3D Module used for FVD handles at most {max_t} input frames "
              f"(given: {num_frames}) -> input video will be consumed in {n_chunks} chunks!")
    return n_chunks, drop_last_chunk


def wasserstein2_numpy(pred, target):
    r"""2-Wasserstein distance between two feature sets ``[b, n]``, on the
    host in f64 (eigenvalues of the nonsymmetric product)."""
    pred = np.asarray(pred, dtype=np.float64).T     # [n, b]
    target = np.asarray(target, dtype=np.float64).T
    mu_p = pred.mean(axis=1, keepdims=True)
    mu_t = target.mean(axis=1, keepdims=True)
    n, b = pred.shape
    fact = 1.0 if b < 2 else 1.0 / (b - 1)
    e_p = pred - mu_p
    e_t = target - mu_t
    cov_p = e_p @ e_p.T * fact
    cov_t = e_t @ e_t.T * fact
    c_p = e_p * np.sqrt(fact)
    c_t = e_t * np.sqrt(fact)
    m = (c_p.T @ c_t) @ (c_t.T @ c_p)
    s = np.linalg.eigvals(m) + 1e-15
    sq_tr_cov = np.abs(np.sqrt(s.astype(np.complex128))).sum()
    trace_term = np.trace(cov_p + cov_t) - 2.0 * sq_tr_cov
    diff = mu_t - mu_p
    mean_term = float((diff * diff).sum())
    return float(trace_term + mean_term)


def wasserstein2_torch(pred, target):
    r"""Differentiable f32 2-Wasserstein distance between feature sets
    ``[b, n]``, on their device. ``A A^T`` with ``A = c_p^T c_t`` is
    symmetric positive semi-definite, so its eigenvalues, which the host
    path takes from a nonsymmetric product, come from a symmetric
    eigensolver (:func:`~vp_suite_tpu_torch.ops.sym_eig.sym_eigvals`: E1 on
    CUDA tensors, ``torch.linalg.eigh`` on CPU tensors); they are clamped at 0
    and floored so that the square root's gradient stays finite where the
    covariance is rank-deficient (b < n)."""
    pred = pred.T.float()
    target = target.T.float()
    n, b = pred.shape
    fact = 1.0 if b < 2 else 1.0 / (b - 1)
    mu_p = pred.mean(dim=1, keepdim=True)
    mu_t = target.mean(dim=1, keepdim=True)
    e_p = pred - mu_p
    e_t = target - mu_t
    with full_precision():
        cov_p = e_p @ e_p.T * fact
        cov_t = e_t @ e_t.T * fact
        a = (e_p.T @ e_t) * fact                  # [b, b]: c_p^T c_t
        m = a @ a.T
    s = sym_eigvals(m)
    sq_tr_cov = torch.sqrt(s.clamp_min(0.0) + 1e-15).sum()
    # the diagonal's sum, not torch.trace, whose backward on the card reads the
    # cotangent back to the host (index_fill_ of a tensor value), which a capture forbids
    trace_term = torch.diagonal(cov_p + cov_t).sum() - 2.0 * sq_tr_cov
    diff = mu_t - mu_p
    return trace_term + (diff * diff).sum()


class FrechetVideoDistance(VPMeasure):
    r"""FVD of ``[b, t, h, w, c]`` videos in the model's value range; frames
    are resized on their device to 224x224. ``None`` below 9 frames."""
    NAME = "Fréchet Video Distance (FVD)"
    REFERENCE = "https://arxiv.org/abs/1812.01717"

    _MIN_T = 9
    _MAX_T = 16
    _I3D_IN_SIZE = (224, 224)

    def __init__(self, device=None, in_channels: int = 3):
        super().__init__(device)
        self.in_channels = in_channels
        self.params, self.pretrained = load_params(in_channels)
        self._placed = {}

    def forward(self, pred, target):
        if pred.shape != target.shape:
            raise ValueError("FVD: vid shapes not equal!")
        n_chunks, drop_last_chunk = calculate_n_chunks(pred.shape[1], self._MIN_T, self._MAX_T)
        if n_chunks < 1:
            return None
        pred = resize_bilinear(pred, self._I3D_IN_SIZE)
        target = resize_bilinear(target, self._I3D_IN_SIZE)
        pred_chunks = torch.tensor_split(pred, n_chunks, dim=1)
        target_chunks = torch.tensor_split(target, n_chunks, dim=1)
        n_valid = (n_chunks - 1) if drop_last_chunk else n_chunks
        dists = [self.get_distance(pred_chunks[i], target_chunks[i]) for i in range(n_valid)]
        dist = sum(dists) / n_valid
        return dist if torch.is_tensor(dist) \
            else torch.tensor(dist, dtype=torch.float32, device=pred.device)

    def get_distance(self, pred, target):
        device, gather = (True, _STEPS[-1]) if _STEPS else \
            (torch.is_grad_enabled() and pred.requires_grad, None)
        if not device and pred.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the FVD measure's host distance cannot run inside a captured CUDA graph: "
                "wasserstein2_numpy reads the I3D features back to the host; build the step "
                "with use_jit=False")
        params = placed(self.params, self._placed, pred)
        logits_pred = i3d_features(pred, params)
        logits_target = i3d_features(target, params)
        if gather is not None:
            logits_pred, logits_target = gather(logits_pred), gather(logits_target)
        if device:
            return wasserstein2_torch(logits_pred, logits_target)
        return wasserstein2_numpy(logits_pred.detach().cpu().numpy(),
                                  logits_target.detach().cpu().numpy())
