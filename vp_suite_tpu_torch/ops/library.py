r"""What the kernel modules share to register their entry points as
``torch.library`` operators in the ``vp_suite_tpu_torch`` namespace.

Each kernel entry point is an operator (:func:`define_op`) with three
implementations: the plain PyTorch version for CPU tensors, the hand-written
kernel's launch for CUDA tensors, and a fake one that gives only the outputs'
shapes and dtypes (for ``torch.export`` and FakeTensors; a symbolic batch
dimension passes through it). Being operators, the kernels are what
``torch.export`` records in its graph and what
``torch.utils.flop_counter.FlopCounterMode`` sees: an operator with
matrix-product content carries its FLOP formula (2 per multiply-add), the
others count 0, so a count is the same whichever device runs it.

The operators are defined through a ``torch.library.Library`` with the two
backend kernels registered at the dispatcher's CPU and CUDA keys, not through
``torch.library.custom_op``, whose Python layers (an autograd wrapper,
aliasing checks, a compiler guard) cost tens of microseconds of host time a
call; the port's autograd stays in the ``torch.autograd.Function`` s around the
operators, which call them with gradients off.
"""
import torch
from torch.utils.flop_counter import register_flop_formula

#: the operators' namespace: ``torch.ops.vp_suite_tpu_torch.<name>``
NAMESPACE = "vp_suite_tpu_torch"
_LIBRARY = torch.library.Library(NAMESPACE, "DEF")


def check_device(name, t):
    r"""Raises ``ValueError`` unless ``t`` lies on the CPU or a CUDA card:
    an operator has no implementation for any other device, and a meta
    tensor would otherwise reach its fake one."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CPU or CUDA tensors, not {t.device}")


def _zero_flops(*args, out_shape=None, **kwargs):
    r"""Gathers and elementwise work carry no matrix product (the JAX
    package's counter counts only products and convolutions, too)."""
    return 0


def define_op(name, cpu, cuda, fake, flops=_zero_flops):
    r"""Defines the operator ``vp_suite_tpu_torch::name``, its schema from
    ``cpu``'s annotations, with ``cpu`` and ``cuda`` as its CPU and CUDA
    kernels, ``fake`` as its fake implementation and ``flops`` as its FLOP
    formula (called with the operator's arguments, tensors as their shapes);
    returns the operator's overload, to call."""
    _LIBRARY.define(name + torch.library.infer_schema(cpu, mutates_args=()))
    _LIBRARY.impl(name, cpu, "CPU")
    _LIBRARY.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIBRARY)
    packet = getattr(torch.ops.vp_suite_tpu_torch, name)
    register_flop_formula(packet)(flops)
    return packet.default
