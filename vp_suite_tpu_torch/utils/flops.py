r"""FLOP counting of one call, the port's counterpart of the JAX package's
jaxpr walker (its ``utils/flops.py``).

:func:`count_flops` runs the call once under
``torch.utils.flop_counter.FlopCounterMode`` and returns the executed matrix
product and convolution FLOPs at 2 per multiply-add; elementwise work is not
counted, as in the JAX counter. Run on a train step it counts the backward
too (every product autograd runs). The port's kernels are ``torch.library``
operators (:mod:`vp_suite_tpu_torch.ops`), each with its own formula: the
ConvLSTM scan (K3, K3s) counts its hidden 3x3 convolution, its backward (K4)
the same product transposed, ``warp_ret`` (K8) and ``warp_contract`` (K9)
their contractions (twice that for their backward calls), and the gate
kernels (K1, K2) and the warp (a gather) 0. The operator, not its
implementation, is what the counter sees, so a model and its shapes give the
same count on the CPU and on the card.

A train step's count includes the recompute of the regions that ``remat``
checkpoints (:mod:`vp_suite_tpu_torch.nn.remat`): the backward runs them
again under the counter, as the JAX counter counts the recompute of its
``remat`` (``flops.py:13-16, 97``); an op whose output a region keeps by name
does not run again and is not counted again. Where the count differs from
the JAX package's on the CPU: the JAX counter counts a transposed
convolution as the convolution XLA lowers it to, over the input dilated with
zeros (``flops.py:36-43``); PyTorch counts the transposed convolution's own
products.
"""
from torch.utils.flop_counter import FlopCounterMode

import vp_suite_tpu_torch.ops  # noqa: F401  (registers the kernels' FLOP formulas)


def count_flops(fn, *args, **kwargs):
    r"""Executed matmul and convolution FLOPs (2 per multiply-add) of one
    call ``fn(*args, **kwargs)``, which runs. For a train step this includes
    the backward; divide by the step's time and the card's peak rate for its
    utilisation."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return counter.get_total_flops()
