r"""ConvLSTM gate/peephole block: a Triton kernel (K1) and its plain version.

Math (Shi ConvLSTM), on pre-activations ``gates`` ``[b, h, w, 4c]`` in gate
order i, f, c, o, the cell ``c`` ``[b, h, w, c]`` and peepholes ``[h, w, c]``::

    i = s(gi + wci*c);  f = s(gf + wcf*c)
    c' = f*c + i*tanh(gc)
    o = s(go + wco*c');  h = o*tanh(c')

computed in f32 and rounded to the dtype of ``c`` (bf16 or f32).

The kernel replaces the JAX package's TPU kernel
``ops/pallas_cells.py:_fwd_kernel`` (through ``_fwd_call``, public
``convlstm_gate_fuse``). Bound: it is a pure elementwise pass, memory-bound:
five ``[b, h, w, c]`` streams read (the four gates and c), two written, plus
the peepholes, which stay in L2 across the batch. Design: one flat pass over
``b*h*w*c`` elements in blocks of 1024; each program reads the four gates
straight out of the ``[..., 4c]`` tensor by offset, so no split copies are
made first (the TPU version split them outside its kernel), and keeps every
intermediate in registers.
"""
import functools

import torch

#: ``triton.language``, bound at the first launch (Triton is imported only then).
tl = None

_BLOCK = 1024


def _check(gates, c, wci, wcf, wco):
    if c.dim() != 4:
        raise ValueError(f"c must be [b, h, w, c], got shape {tuple(c.shape)}")
    b, h, w, ch = c.shape
    if tuple(gates.shape) != (b, h, w, 4 * ch):
        raise ValueError(f"gates must be [b, h, w, 4c] = {(b, h, w, 4 * ch)}, "
                         f"got {tuple(gates.shape)}")
    for name, p in (("wci", wci), ("wcf", wcf), ("wco", wco)):
        if tuple(p.shape) != (h, w, ch):
            raise ValueError(f"{name} must be [h, w, c] = {(h, w, ch)}, got {tuple(p.shape)}")
    tensors = (gates, c, wci, wcf, wco)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("gates, c and the peepholes must lie on one device")


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


@functools.cache
def _gate_kernel():
    r"""Imports Triton and defines the K1 kernel (first launch only)."""
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

    return _convlstm_gate_fwd


def convlstm_gate_fuse(gates, c, wci, wcf, wco):
    r"""Fused ConvLSTM gate/peephole block; returns ``(h_new, c_new)`` in
    ``c.dtype``. On CPU tensors it computes :func:`convlstm_gate_reference`;
    on CUDA tensors it launches the Triton kernel, which takes contiguous
    bf16 or f32 tensors of one dtype, and raises on anything else."""
    _check(gates, c, wci, wcf, wco)
    if c.device.type == "cpu":
        return convlstm_gate_reference(gates, c, wci, wcf, wco)
    if c.device.type != "cuda":
        raise ValueError(f"convlstm_gate_fuse runs on CPU or CUDA tensors, not {c.device}")
    tensors = (gates, c, wci, wcf, wco)
    if c.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != c.dtype for t in tensors):
        raise TypeError("convlstm_gate_fuse needs gates, c and peepholes all float32 or all "
                        f"bfloat16, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("convlstm_gate_fuse needs contiguous tensors")
    n = c.numel()
    if 4 * n >= 2 ** 31:
        raise ValueError(f"convlstm_gate_fuse indexes with int32: {4 * n} gate elements is too many")
    h_out = torch.empty_like(c)
    c_out = torch.empty_like(c)
    if n:
        kernel = _gate_kernel()
        ch = c.shape[-1]
        with torch.cuda.device(c.device):
            kernel[(-(-n // _BLOCK),)](gates, c, wci, wcf, wco, h_out, c_out, n, ch,
                                       c.shape[1] * c.shape[2] * ch, BLOCK=_BLOCK, num_warps=4)
        convlstm_gate_fuse.launches += 1
    return h_out, c_out


#: Launches of the Triton kernel since the count was last set to 0.
convlstm_gate_fuse.launches = 0
