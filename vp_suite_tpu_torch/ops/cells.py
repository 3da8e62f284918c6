r"""ConvLSTM gate/peephole block: Triton kernels for its forward (K1) and
backward (K2), their plain versions, and the autograd Function that joins them.

Math (Shi ConvLSTM), on pre-activations ``gates`` ``[b, h, w, 4c]`` in gate
order i, f, c, o, the cell ``c`` ``[b, h, w, c]`` and peepholes ``[h, w, c]``::

    i = s(gi + wci*c);  f = s(gf + wcf*c)
    c' = f*c + i*tanh(gc)
    o = s(go + wco*c');  h = o*tanh(c')

computed in f32 and rounded to the dtype of ``c`` (bf16 or f32). The backward
recomputes the activations from the saved inputs and, from ``(dh, dc')``,
gives the gradients of the four pre-activations and of ``c``::

    dzo = dh*tanh(c')*o*(1-o);  dc2 = dc' + dh*o*(1-tanh(c')^2) + dzo*wco
    dzi = dc2*tanh(gc)*i*(1-i); dzf = dc2*c*f*(1-f); dgc = dc2*i*(1-tanh(gc)^2)
    dc  = dc2*f + dzi*wci + dzf*wcf

also in f32 and rounded to ``c.dtype``; the peephole gradients are the batch
sums of ``dzi*c``, ``dzf*c`` and ``dzo*c'`` (``c'`` as the forward rounded it).

K1 replaces the JAX package's TPU kernel ``ops/pallas_cells.py:_fwd_kernel``
(through ``_fwd_call``), K2 its ``_bwd_kernel`` (through ``_vjp_bwd``); the
JAX ``custom_vjp`` becomes :class:`GateFunction`. Bound: both are pure
elementwise passes, memory-bound: K1 reads five ``[b, h, w, c]`` streams (the
four gates and c) and writes two; K2 reads seven (the gates, c, dh, dc') and
writes five (the four gate gradients and dc); the peepholes stay in L2 across
the batch. Design: one flat pass over ``b*h*w*c`` elements in blocks of 1024;
each program reads the four gates straight out of the ``[..., 4c]`` tensor by
offset, and K2 writes the four gate gradients straight into a ``[..., 4c]``
tensor the same way, so no split or concatenated copies are made (the TPU
version split them outside its kernels and concatenated the gradients after),
and every intermediate stays in registers. Triton fits K2 as well as CUDA C++
would: it is one fused elementwise pass with no reduction (the peephole sums
stay a ``torch.sum`` outside, as the JAX package leaves them to XLA), and it
shares K1's gate addressing.
"""
import functools

import torch
from torch import Tensor

from vp_suite_tpu_torch.ops.library import check_device, define_op

#: ``triton.language``, bound at the first launch (Triton is imported only then).
tl = None

_BLOCK = 1024


def _check(gates, c, wci, wcf, wco, *grads):
    if c.dim() != 4:
        raise ValueError(f"c must be [b, h, w, c], got shape {tuple(c.shape)}")
    b, h, w, ch = c.shape
    if tuple(gates.shape) != (b, h, w, 4 * ch):
        raise ValueError(f"gates must be [b, h, w, 4c] = {(b, h, w, 4 * ch)}, "
                         f"got {tuple(gates.shape)}")
    for name, p in (("wci", wci), ("wcf", wcf), ("wco", wco)):
        if tuple(p.shape) != (h, w, ch):
            raise ValueError(f"{name} must be [h, w, c] = {(h, w, ch)}, got {tuple(p.shape)}")
    for g in grads:
        if tuple(g.shape) != tuple(c.shape):
            raise ValueError(f"dh and dc_out must match c {tuple(c.shape)}, got {tuple(g.shape)}")
    tensors = (gates, c, wci, wcf, wco, *grads)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("gates, c, the peepholes and the gradients must lie on one device")


def _check_kernel_operands(name, c, tensors):
    r"""What the Triton kernels take: all float32 or all bfloat16,
    contiguous, with int32 offsets."""
    if c.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != c.dtype for t in tensors):
        raise TypeError(f"{name} needs all its tensors float32 or all bfloat16, "
                        f"got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    if 4 * c.numel() >= 2 ** 31:
        raise ValueError(f"{name} indexes with int32: {4 * c.numel()} gate elements is too many")


def convlstm_gate_reference(gates, c, wci, wcf, wco):
    r"""Plain PyTorch version of the gate block: f32 math, outputs rounded to
    ``c.dtype``. Returns ``(h_new, c_new)``."""
    _check(gates, c, wci, wcf, wco)
    dt = c.dtype
    gi, gf, gc, go = gates.float().chunk(4, dim=-1)
    cf = c.float()
    i = torch.sigmoid(gi + wci.float() * cf)
    f = torch.sigmoid(gf + wcf.float() * cf)
    c_new = f * cf + i * torch.tanh(gc)
    o = torch.sigmoid(go + wco.float() * c_new)
    return (o * torch.tanh(c_new)).to(dt), c_new.to(dt)


def convlstm_gate_backward_reference(gates, c, wci, wcf, wco, dh, dc_out):
    r"""Plain PyTorch version of the gate backward: recomputes the
    activations, f32 math, outputs rounded to ``c.dtype``. Returns
    ``(dgates [b, h, w, 4c], dc_in [b, h, w, c])``."""
    _check(gates, c, wci, wcf, wco, dh, dc_out)
    dt = c.dtype
    gi, gf, gc, go = gates.float().chunk(4, dim=-1)
    cf, wci, wcf, wco = c.float(), wci.float(), wcf.float(), wco.float()
    dh, dc_out = dh.float(), dc_out.float()
    i = torch.sigmoid(gi + wci * cf)
    f = torch.sigmoid(gf + wcf * cf)
    g = torch.tanh(gc)
    c_new = f * cf + i * g
    o = torch.sigmoid(go + wco * c_new)
    t2 = torch.tanh(c_new)
    dzo = dh * t2 * o * (1.0 - o)
    dc2 = dc_out + dh * o * (1.0 - t2 * t2) + dzo * wco
    dzi = dc2 * g * i * (1.0 - i)
    dzf = dc2 * cf * f * (1.0 - f)
    dgc = dc2 * i * (1.0 - g * g)
    dc_in = dc2 * f + dzi * wci + dzf * wcf
    return torch.cat([dzi, dzf, dgc, dzo], dim=-1).to(dt), dc_in.to(dt)


@functools.cache
def _gate_kernels():
    r"""Imports Triton and defines the K1 and K2 kernels (first launch only)."""
    global tl
    import triton
    import triton.language as language
    tl = language

    @triton.jit
    def _convlstm_gate_fwd(g_ptr, c_ptr, wci_ptr, wcf_ptr, wco_ptr, h_out_ptr, c_out_ptr,
                           n, C, HWC, BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        pix = offs // C
        gbase = pix * (4 * C) + (offs - pix * C)
        pk = offs % HWC
        c = tl.load(c_ptr + offs, mask=mask).to(tl.float32)
        gi = tl.load(g_ptr + gbase, mask=mask).to(tl.float32)
        gf = tl.load(g_ptr + gbase + C, mask=mask).to(tl.float32)
        gc = tl.load(g_ptr + gbase + 2 * C, mask=mask).to(tl.float32)
        go = tl.load(g_ptr + gbase + 3 * C, mask=mask).to(tl.float32)
        wci = tl.load(wci_ptr + pk, mask=mask).to(tl.float32)
        wcf = tl.load(wcf_ptr + pk, mask=mask).to(tl.float32)
        wco = tl.load(wco_ptr + pk, mask=mask).to(tl.float32)
        i = 1.0 / (1.0 + tl.exp(-(gi + wci * c)))
        f = 1.0 / (1.0 + tl.exp(-(gf + wcf * c)))
        # tanh(x) = sign(x) * (1 - e) / (1 + e) with e = exp(-2|x|): no overflow for large |x|
        eg = tl.exp(-2.0 * tl.abs(gc))
        tg = (1.0 - eg) / (1.0 + eg)
        tg = tl.where(gc < 0, -tg, tg)
        c_new = f * c + i * tg
        o = 1.0 / (1.0 + tl.exp(-(go + wco * c_new)))
        ec = tl.exp(-2.0 * tl.abs(c_new))
        tc = (1.0 - ec) / (1.0 + ec)
        tc = tl.where(c_new < 0, -tc, tc)
        tl.store(h_out_ptr + offs, (o * tc).to(h_out_ptr.dtype.element_ty), mask=mask)
        tl.store(c_out_ptr + offs, c_new.to(c_out_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def _convlstm_gate_bwd(g_ptr, c_ptr, wci_ptr, wcf_ptr, wco_ptr, dh_ptr, dco_ptr,
                           dg_ptr, dci_ptr, n, C, HWC, BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        pix = offs // C
        gbase = pix * (4 * C) + (offs - pix * C)
        pk = offs % HWC
        c = tl.load(c_ptr + offs, mask=mask).to(tl.float32)
        gi = tl.load(g_ptr + gbase, mask=mask).to(tl.float32)
        gf = tl.load(g_ptr + gbase + C, mask=mask).to(tl.float32)
        gc = tl.load(g_ptr + gbase + 2 * C, mask=mask).to(tl.float32)
        go = tl.load(g_ptr + gbase + 3 * C, mask=mask).to(tl.float32)
        wci = tl.load(wci_ptr + pk, mask=mask).to(tl.float32)
        wcf = tl.load(wcf_ptr + pk, mask=mask).to(tl.float32)
        wco = tl.load(wco_ptr + pk, mask=mask).to(tl.float32)
        dh = tl.load(dh_ptr + offs, mask=mask).to(tl.float32)
        dco = tl.load(dco_ptr + offs, mask=mask).to(tl.float32)
        i = 1.0 / (1.0 + tl.exp(-(gi + wci * c)))
        f = 1.0 / (1.0 + tl.exp(-(gf + wcf * c)))
        eg = tl.exp(-2.0 * tl.abs(gc))
        g = (1.0 - eg) / (1.0 + eg)
        g = tl.where(gc < 0, -g, g)
        c_new = f * c + i * g
        o = 1.0 / (1.0 + tl.exp(-(go + wco * c_new)))
        ec = tl.exp(-2.0 * tl.abs(c_new))
        t2 = (1.0 - ec) / (1.0 + ec)
        t2 = tl.where(c_new < 0, -t2, t2)
        dzo = dh * t2 * o * (1.0 - o)
        dc2 = dco + dh * o * (1.0 - t2 * t2) + dzo * wco
        dzi = dc2 * g * i * (1.0 - i)
        dzf = dc2 * c * f * (1.0 - f)
        dgc = dc2 * i * (1.0 - g * g)
        out_ty = dg_ptr.dtype.element_ty
        tl.store(dg_ptr + gbase, dzi.to(out_ty), mask=mask)
        tl.store(dg_ptr + gbase + C, dzf.to(out_ty), mask=mask)
        tl.store(dg_ptr + gbase + 2 * C, dgc.to(out_ty), mask=mask)
        tl.store(dg_ptr + gbase + 3 * C, dzo.to(out_ty), mask=mask)
        tl.store(dci_ptr + offs, (dc2 * f + dzi * wci + dzf * wcf).to(out_ty), mask=mask)

    return _convlstm_gate_fwd, _convlstm_gate_bwd


def _launch(kernel, c, *args):
    n, ch = c.numel(), c.shape[-1]
    with torch.cuda.device(c.device):
        kernel[(-(-n // _BLOCK),)](*args, n, ch, c.shape[1] * c.shape[2] * ch,
                                   BLOCK=_BLOCK, num_warps=4)


def _gate_forward_cpu(gates: Tensor, c: Tensor, wci: Tensor, wcf: Tensor,
                      wco: Tensor) -> tuple[Tensor, Tensor]:
    return convlstm_gate_reference(gates, c, wci, wcf, wco)


def _gate_forward_cuda(gates, c, wci, wcf, wco):
    _check(gates, c, wci, wcf, wco)
    tensors = (gates, c, wci, wcf, wco)
    _check_kernel_operands("convlstm_gate_fuse", c, tensors)
    h_out = torch.empty_like(c)
    c_out = torch.empty_like(c)
    if c.numel():
        _launch(_gate_kernels()[0], c, *tensors, h_out, c_out)
        convlstm_gate_fuse.launches += 1
    return h_out, c_out


def _gate_forward_fake(gates, c, wci, wcf, wco):
    _check(gates, c, wci, wcf, wco)
    return torch.empty_like(c), torch.empty_like(c)


def _gate_backward_cpu(gates: Tensor, c: Tensor, wci: Tensor, wcf: Tensor, wco: Tensor,
                       dh: Tensor, dc_out: Tensor) -> tuple[Tensor, Tensor]:
    return convlstm_gate_backward_reference(gates, c, wci, wcf, wco, dh, dc_out)


def _gate_backward_cuda(gates, c, wci, wcf, wco, dh, dc_out):
    _check(gates, c, wci, wcf, wco, dh, dc_out)
    tensors = (gates, c, wci, wcf, wco, dh, dc_out)
    _check_kernel_operands("convlstm_gate_backward", c, tensors)
    dgates = torch.empty_like(gates)
    dc_in = torch.empty_like(c)
    if c.numel():
        _launch(_gate_kernels()[1], c, *tensors, dgates, dc_in)
        convlstm_gate_backward.launches += 1
    return dgates, dc_in


def _gate_backward_fake(gates, c, wci, wcf, wco, dh, dc_out):
    _check(gates, c, wci, wcf, wco, dh, dc_out)
    return torch.empty_like(gates), torch.empty_like(c)


# elementwise work: their FLOP formula is 0
_GATE_FWD = define_op("convlstm_gate_forward", _gate_forward_cpu, _gate_forward_cuda,
                      _gate_forward_fake)
_GATE_BWD = define_op("convlstm_gate_backward", _gate_backward_cpu, _gate_backward_cuda,
                      _gate_backward_fake)


def convlstm_gate_forward(gates, c, wci, wcf, wco):
    r"""The gate block's forward with no autograd: ``(h_new, c_new)`` in
    ``c.dtype``. The operator ``vp_suite_tpu_torch::convlstm_gate_forward``:
    on CPU tensors it computes :func:`convlstm_gate_reference`; on CUDA
    tensors it launches K1, which takes contiguous bf16 or f32 tensors of one
    dtype, and raises on anything else."""
    check_device("convlstm_gate_fuse", c)
    return _GATE_FWD(gates, c, wci, wcf, wco)


def convlstm_gate_backward(gates, c, wci, wcf, wco, dh, dc_out):
    r"""The gate block's backward: ``(dgates [b, h, w, 4c], dc_in)`` in
    ``c.dtype``. The operator ``vp_suite_tpu_torch::convlstm_gate_backward``:
    on CPU tensors it computes :func:`convlstm_gate_backward_reference`; on
    CUDA tensors it launches K2, which takes contiguous bf16 or f32 tensors
    of one dtype, and raises on anything else."""
    check_device("convlstm_gate_backward", c)
    return _GATE_BWD(gates, c, wci, wcf, wco, dh, dc_out)


class GateFunction(torch.autograd.Function):
    r"""The gate block under autograd: forward K1 (or its plain version on
    the CPU), backward K2 (or its plain version) plus the peephole sums over
    the batch. Saves the inputs and ``c_new``, the forward's rounded output,
    which the ``wco`` gradient uses, as the JAX package's VJP does."""

    @staticmethod
    def forward(ctx, gates, c, wci, wcf, wco):
        h_new, c_new = convlstm_gate_forward(gates, c, wci, wcf, wco)
        ctx.save_for_backward(gates, c, wci, wcf, wco, c_new)
        return h_new, c_new

    @staticmethod
    def backward(ctx, dh, dc_out):
        gates, c, wci, wcf, wco, c_new = ctx.saved_tensors
        dt = c.dtype
        dgates, dc_in = convlstm_gate_backward(gates, c, wci, wcf, wco,
                                               dh.to(dt).contiguous(), dc_out.to(dt).contiguous())
        need = ctx.needs_input_grad
        # batch sums in f32 from the gate slices: ``dz * s`` with ``s`` in f32
        # promotes as it multiplies, so no f32 copy of ``dgates`` is made
        dzi, dzf, _, dzo = dgates.chunk(4, dim=-1)
        cf = c.float() if need[2] or need[3] else None
        d_peep = [(dz * s).sum(0).to(p.dtype) if need[k] else None
                  for k, dz, s, p in ((2, dzi, cf, wci), (3, dzf, cf, wcf),
                                      (4, dzo, c_new.float() if need[4] else None, wco))]
        return (dgates if need[0] else None, dc_in if need[1] else None, *d_peep)


def convlstm_gate_fuse(gates, c, wci, wcf, wco):
    r"""Fused ConvLSTM gate/peephole block, differentiable; returns
    ``(h_new, c_new)`` in ``c.dtype``. Runs :class:`GateFunction`: K1 forward
    and K2 backward on CUDA tensors (contiguous, all bf16 or all f32; it
    raises on anything else), their plain versions on CPU tensors."""
    return GateFunction.apply(gates, c, wci, wcf, wco)


#: Launches of K1 since the count was last set to 0.
convlstm_gate_fuse.launches = 0
#: Launches of K2 since the count was last set to 0.
convlstm_gate_backward.launches = 0
