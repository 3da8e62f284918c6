r"""E1, the batched symmetric eigensolver: a CUDA kernel (cyclic Jacobi), its
plain version, and the autograd Function that FVD's loss takes its
eigenvalues from.

For symmetric f32 matrices ``m`` ``[..., n, n]`` (their lower triangle read)
it gives the ascending eigenvalues ``w`` ``[..., n]`` and the eigenvectors
``v`` ``[..., n, n]`` (column j belongs to ``w[j]``), what
``torch.linalg.eigh`` gives. The plain version is ``torch.linalg.eigh``
itself; the kernel (``csrc/sym_eig.cu``, whose header gives its algorithm,
bound and design) exists because ``torch.linalg.eigh`` on a CUDA tensor
reaches cuSOLVER and then reads its status back to the host, which a CUDA-graph
capture forbids: with the kernel, an FVD loss runs inside the compiled train
and eval steps, as ``jnp.linalg.eigh`` runs inside the JAX package's jitted
ones (its ``measure/fvd/fvd.py``, ``wasserstein2_jax``). It replaces no
Pallas kernel: the JAX package leaves ``eigh`` to XLA.

:func:`sym_eigvals` is differentiable in ``m``: for a gradient ``g`` of the
eigenvalues the Function returns ``v diag(g) v^T``, the eigenvalue part of
``eigh``'s VJP (JAX's rule, whose eigenvector part is 0 here); it also runs
under ``torch.inference_mode()``, where it records nothing.
"""
import torch
from torch import Tensor

from vp_suite_tpu_torch.kernels import build
from vp_suite_tpu_torch.ops.library import check_device, define_op


def _check(m):
    if m.dim() < 2 or m.shape[-1] != m.shape[-2]:
        raise ValueError(f"m must be [..., n, n], got shape {tuple(m.shape)}")


def sym_eig_reference(m):
    r"""Plain version: ``torch.linalg.eigh(m)`` as ``(w, v)``."""
    _check(m)
    w, v = torch.linalg.eigh(m)
    return w, v


def _sym_eig_cpu(m: Tensor) -> tuple[Tensor, Tensor]:
    return sym_eig_reference(m)


def _sym_eig_cuda(m):
    _check(m)
    if m.dtype != torch.float32:
        raise TypeError(f"sym_eig takes float32 matrices, not {m.dtype}")
    if not m.is_contiguous():
        raise ValueError("sym_eig needs a contiguous tensor")
    n = m.shape[-1]
    w = m.new_empty(m.shape[:-1])
    v = torch.empty_like(m)
    batch = m.numel() // (n * n) if n else 0
    if not batch:
        return w, v
    if batch >= 2 ** 31 or n > 46340:
        raise ValueError(f"sym_eig takes fewer than 2^31 matrices of n <= 46340, got {batch} of "
                         f"{n}")
    n2 = n + n % 2
    scratch = m.new_empty((batch, 2, n2, n2))   # A and V where they do not fit in shared memory
    lib = build.sym_eig_library()
    with torch.cuda.device(m.device):
        err = lib.vp_sym_eig(m.data_ptr(), w.data_ptr(), v.data_ptr(), scratch.data_ptr(), batch,
                             n, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"sym_eig: kernel launch failed: "
                           f"{lib.vp_cuda_error_string(err).decode()} ({err})")
    sym_eig.launches += 1
    return w, v


def _sym_eig_fake(m):
    _check(m)
    return m.new_empty(m.shape[:-1]), torch.empty_like(m)


def _sym_eig_flops(m, *, out_shape=None, **kwargs):
    r"""Some ``9 n^3`` per matrix: the rotations of ``A`` and ``V`` over the
    few sweeps Jacobi takes (the count the card's bound uses)."""
    n = m[-1]
    batch = 1
    for d in m[:-2]:
        batch *= d
    return 9 * batch * n ** 3


_SYM_EIG = define_op("sym_eig", _sym_eig_cpu, _sym_eig_cuda, _sym_eig_fake, _sym_eig_flops)


def sym_eig(m):
    r"""``(w, v)``, the ascending eigenvalues and the eigenvectors of the
    symmetric ``m`` ``[..., n, n]``, with no autograd. The operator
    ``vp_suite_tpu_torch::sym_eig``: on CPU tensors it computes
    :func:`sym_eig_reference`; on CUDA tensors it launches E1, which takes a
    contiguous f32 tensor, and raises on anything else."""
    check_device("sym_eig", m)
    return tuple(_SYM_EIG(m))


class SymEigFunction(torch.autograd.Function):
    r"""The eigenvalues under autograd: :func:`sym_eig` forward (E1 on the
    card), ``v diag(g) v^T`` backward. Saves the eigenvectors."""

    @staticmethod
    def forward(ctx, m):
        w, v = sym_eig(m)
        ctx.save_for_backward(v)
        return w

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        return torch.matmul(v * g.unsqueeze(-2), v.transpose(-1, -2))


def sym_eigvals(m):
    r"""The ascending eigenvalues ``[..., n]`` of the symmetric ``m`` ``[...,
    n, n]`` (its lower triangle), differentiable in ``m``: E1 on CUDA tensors
    (it raises on what it does not take), ``torch.linalg.eigh`` on CPU
    tensors."""
    _check(m)
    return SymEigFunction.apply(m.contiguous())


#: Launches of E1 since the count was last set to 0.
sym_eig.launches = 0
