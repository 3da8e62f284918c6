r"""Whole-recurrence ConvLSTM scan: CUDA kernels for its forward (K3, and
K3s, which also saves the training residuals) and its reverse-time backward
(K4), their plain versions, and the autograd Function that joins them.

One forward call runs all ``seq_len`` steps of a peephole ConvLSTM whose input
half is precomputed (``i2h_t``) or absent (decode mode, where the bias rides
the hidden convolution): per step the 3x3 hidden convolution, the bias, the
input half and the gate chain of :mod:`vp_suite_tpu_torch.ops.cells`. The
carry is ``h`` in the activation dtype and ``c`` in f32. Under training the
forward also saves, per step, the gate pre-activations ``z`` ``[T, b, sh, sw,
4enc]`` (the conv layout, so ``d_i2h`` is ``dz`` as it stands) and the
pre-update cell ``c_prev`` ``[T, b, sh, sw, enc]``, both in the activation
dtype. The backward walks time in reverse with the ``(dh, dc)`` carry in f32:
the gate backward of each step, ``dz`` rounded to the activation dtype, and
``dh`` of the previous step as the transposed 3x3 conv of ``dz``; it emits
``dz`` per step and the f32 gradients of ``h0`` and ``c0``. The weight, bias
and peephole gradients are bulk contractions outside the kernel, as the JAX
package leaves them to XLA: the hidden kernel's by cuDNN's weight gradient
over ``[h0, h_seq[:-1]]`` and ``dz``.

The kernels (``csrc/convlstm_scan.cu`` and ``csrc/convlstm_scan_bwd.cu``,
whose header notes give their bounds and designs) replace the JAX package's
TPU kernels ``ops/pallas_convlstm.py:_make_scan_kernel`` (both forms of
``save_gates``) and ``_make_bwd_kernel``; they are built with ``nvcc`` at
first use (:mod:`vp_suite_tpu_torch.kernels.build`) and called through
``ctypes``.
"""
from typing import Optional

import torch
import torch.nn.functional as F
from torch import Tensor

from vp_suite_tpu_torch.kernels import build
from vp_suite_tpu_torch.ops.library import check_device, define_op


def _check(i2h_t, h0, c0, h_kernel, bias, wci, wcf, wco, seq_len):
    if h0.dim() != 4:
        raise ValueError(f"h0 must be [b, sh, sw, enc], got shape {tuple(h0.shape)}")
    b, sh, sw, enc = h0.shape
    if seq_len < 1:
        raise ValueError(f"seq_len must be at least 1, got {seq_len}")
    if tuple(c0.shape) != tuple(h0.shape):
        raise ValueError(f"c0 must match h0 {tuple(h0.shape)}, got {tuple(c0.shape)}")
    if tuple(h_kernel.shape) != (3, 3, enc, 4 * enc):
        raise ValueError(f"h_kernel must be [3, 3, enc, 4enc] = {(3, 3, enc, 4 * enc)}, "
                         f"got {tuple(h_kernel.shape)}")
    if tuple(bias.shape) != (4 * enc,):
        raise ValueError(f"bias must be [4enc] = {(4 * enc,)}, got {tuple(bias.shape)}")
    for name, p in (("wci", wci), ("wcf", wcf), ("wco", wco)):
        if tuple(p.shape) != (sh, sw, enc):
            raise ValueError(f"{name} must be [sh, sw, enc] = {(sh, sw, enc)}, "
                             f"got {tuple(p.shape)}")
    if i2h_t is not None and tuple(i2h_t.shape) != (seq_len, b, sh, sw, 4 * enc):
        raise ValueError(f"i2h_t must be [T, b, sh, sw, 4enc] = {(seq_len, b, sh, sw, 4 * enc)}, "
                         f"got {tuple(i2h_t.shape)}")
    tensors = [t for t in (i2h_t, h0, c0, h_kernel, bias, wci, wcf, wco) if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("the scan's tensors must lie on one device")


def _check_backward(z_seq, c_prev_seq, dh_seq, dc_last, h_kernel, wci, wcf, wco, dh_last):
    if z_seq.dim() != 5 or z_seq.shape[-1] % 4:
        raise ValueError(f"z_seq must be [T, b, sh, sw, 4enc], got shape {tuple(z_seq.shape)}")
    T, b, sh, sw, enc4 = z_seq.shape
    enc = enc4 // 4
    want = {"c_prev_seq": (c_prev_seq, (T, b, sh, sw, enc)), "dh_seq": (dh_seq, (T, b, sh, sw, enc)),
            "dc_last": (dc_last, (b, sh, sw, enc)), "h_kernel": (h_kernel, (3, 3, enc, 4 * enc)),
            "wci": (wci, (sh, sw, enc)), "wcf": (wcf, (sh, sw, enc)), "wco": (wco, (sh, sw, enc)),
            "dh_last": (dh_last, (b, sh, sw, enc))}
    for name, (t, shape) in want.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    tensors = [t for t in (z_seq, c_prev_seq, dh_seq, dc_last, h_kernel, wci, wcf, wco, dh_last)
               if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("the scan backward's tensors must lie on one device")


def convlstm_scan_forward_reference(i2h_t, h0, c0, h_kernel, bias, wci, wcf, wco, seq_len,
                                    save_gates=False):
    r"""Plain PyTorch version of the forward scan: a loop over time with
    ``F.conv2d`` and the gate chain, under the kernel's dtype rules (conv
    products of activation-dtype values summed in f32, f32 gate math and cell
    carry, ``h`` rounded to the activation dtype). Same signature and return
    as :func:`convlstm_scan_forward`."""
    _check(i2h_t, h0, c0, h_kernel, bias, wci, wcf, wco, seq_len)
    dt = h0.dtype
    w = h_kernel.to(dt).float().permute(3, 2, 0, 1)   # [4enc, enc, 3, 3]
    bias = bias.float()
    peep = [p.to(dt).float() for p in (wci, wcf, wco)]
    h, c = h0, c0.to(dt).float()
    outs, zs, c_prevs = [], [], []
    for t in range(seq_len):
        z = F.conv2d(h.float().permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1) + bias
        if i2h_t is not None:
            z = z + i2h_t[t].to(dt).float()
        if save_gates:
            zs.append(z.to(dt))
            c_prevs.append(c.to(dt))
        zi, zf, zc, zo = z.chunk(4, dim=-1)
        i = torch.sigmoid(zi + peep[0] * c)
        f = torch.sigmoid(zf + peep[1] * c)
        c = f * c + i * torch.tanh(zc)
        o = torch.sigmoid(zo + peep[2] * c)
        h = (o * torch.tanh(c)).to(dt)
        outs.append(h)
    result = (torch.stack(outs), c.to(dt))
    return result + (torch.stack(zs), torch.stack(c_prevs)) if save_gates else result


def _scan_forward_cpu(i2h_t: Optional[Tensor], h0: Tensor, c0: Tensor, h_kernel: Tensor,
                      bias: Tensor, wci: Tensor, wcf: Tensor, wco: Tensor, seq_len: int,
                      save_gates: bool) -> list[Tensor]:
    return list(convlstm_scan_forward_reference(i2h_t, h0, c0, h_kernel, bias, wci, wcf, wco,
                                                seq_len, save_gates))


def _scan_forward_cuda(i2h_t, h0, c0, h_kernel, bias, wci, wcf, wco, seq_len, save_gates):
    _check(i2h_t, h0, c0, h_kernel, bias, wci, wcf, wco, seq_len)
    dt = h0.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"convlstm_scan_fused takes bfloat16 or float32 activations, not {dt}")
    b, sh, sw, enc = h0.shape
    if enc % 16:
        raise ValueError(f"the scan kernel tiles 16 hidden channels at a time: enc={enc} "
                         f"is not a multiple of 16")
    # the kernel's operand layout: contiguous, activation dtype; bias and the cell in f32
    h0 = h0.contiguous()
    h_kernel = h_kernel.to(dt).contiguous()
    bias = bias.float().contiguous()
    wci, wcf, wco = (p.to(dt).contiguous() for p in (wci, wcf, wco))
    if i2h_t is not None:
        i2h_t = i2h_t.to(dt).contiguous()
    # a private f32 copy that the kernel updates in place: c0 in, c_last out
    c = c0.to(dt).to(torch.float32, memory_format=torch.contiguous_format, copy=True)
    h_seq = torch.empty((seq_len, b, sh, sw, enc), dtype=dt, device=h0.device)
    z_seq = c_prev_seq = None
    if save_gates:
        z_seq = torch.empty((seq_len, b, sh, sw, 4 * enc), dtype=dt, device=h0.device)
        c_prev_seq = torch.empty_like(h_seq)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = build.scan_library()
    with torch.cuda.device(h0.device):
        err = lib.vp_convlstm_scan_fwd(
            int(dt == torch.bfloat16), ptr(i2h_t), h0.data_ptr(), c.data_ptr(),
            h_kernel.data_ptr(), bias.data_ptr(), wci.data_ptr(), wcf.data_ptr(), wco.data_ptr(),
            h_seq.data_ptr(), ptr(z_seq), ptr(c_prev_seq), seq_len, b, sh, sw, enc,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"convlstm_scan_fused: kernel launch failed: "
                           f"{lib.vp_cuda_error_string(err).decode()} ({err})")
    if save_gates:
        convlstm_scan_fused.save_gates_launches += 1
        return [h_seq, c.to(dt), z_seq, c_prev_seq]
    convlstm_scan_fused.launches += 1
    return [h_seq, c.to(dt)]


def _scan_forward_fake(i2h_t, h0, c0, h_kernel, bias, wci, wcf, wco, seq_len, save_gates):
    _check(i2h_t, h0, c0, h_kernel, bias, wci, wcf, wco, seq_len)
    b, sh, sw, enc = h0.shape
    h_seq = h0.new_empty((seq_len, b, sh, sw, enc))
    if not save_gates:
        return [h_seq, h0.new_empty(h0.shape)]
    return [h_seq, h0.new_empty(h0.shape), h0.new_empty((seq_len, b, sh, sw, 4 * enc)),
            h0.new_empty((seq_len, b, sh, sw, enc))]


def _scan_flops(i2h_t, h0, c0, h_kernel, bias, wci, wcf, wco, seq_len, save_gates=False, *,
                out_shape=None, **kwargs):
    r"""The hidden 3x3 convolution's products at 2 per multiply-add:
    ``2 T b sh sw 9 enc 4enc``."""
    b, sh, sw, enc = h0
    return 2 * seq_len * b * sh * sw * 9 * enc * 4 * enc


_SCAN_FWD = define_op("convlstm_scan_forward", _scan_forward_cpu, _scan_forward_cuda,
                      _scan_forward_fake, _scan_flops)


def convlstm_scan_forward(i2h_t, h0, c0, h_kernel, bias, wci, wcf, wco, seq_len,
                          save_gates=False):
    r"""The forward scan with no autograd: ``(h_seq [T, b, sh, sw, enc],
    c_last)`` in the activation dtype (``h0``'s), and with ``save_gates``
    also the residuals ``(z_seq [T, b, sh, sw, 4enc], c_prev_seq [T, b, sh,
    sw, enc])`` in the activation dtype. The operator
    ``vp_suite_tpu_torch::convlstm_scan_forward``: on CPU tensors it computes
    :func:`convlstm_scan_forward_reference`; on CUDA tensors it launches K3
    (K3s with ``save_gates``), which needs ``enc`` a multiple of 16 (and in
    bf16 at most 288, since a block keeps its channels' weights resident in
    shared memory), and raises on anything it does not take."""
    check_device("convlstm_scan_fused", h0)
    return tuple(_SCAN_FWD(i2h_t, h0, c0, h_kernel, bias, wci, wcf, wco, seq_len, save_gates))


def convlstm_scan_backward_reference(z_seq, c_prev_seq, dh_seq, dc_last, h_kernel, wci, wcf, wco,
                                     dh_last=None):
    r"""Plain PyTorch version of the reverse-time scan backward, under the
    kernel's dtype rules: activations recomputed in f32 from the residuals,
    ``(dh, dc)`` carried in f32 (``dh`` starting from ``dh_last``),
    ``dz`` rounded to the activation dtype (``z_seq``'s) before it is stored
    and before the transposed conv (a ``F.conv_transpose2d`` with the
    forward's weight). Same signature and return as
    :func:`convlstm_scan_backward`."""
    _check_backward(z_seq, c_prev_seq, dh_seq, dc_last, h_kernel, wci, wcf, wco, dh_last)
    dt = z_seq.dtype
    w = h_kernel.to(dt).float().permute(3, 2, 0, 1)   # conv_transpose2d's [in=4enc, out=enc, 3, 3]
    wci, wcf, wco = (p.to(dt).float() for p in (wci, wcf, wco))
    dh = torch.zeros(dc_last.shape, dtype=torch.float32, device=dc_last.device) \
        if dh_last is None else dh_last.to(dt).float()
    dc = dc_last.to(dt).float()
    dzs = []
    for t in reversed(range(z_seq.shape[0])):
        zi, zf, zc, zo = z_seq[t].float().chunk(4, dim=-1)
        c = c_prev_seq[t].float()
        i = torch.sigmoid(zi + wci * c)
        f = torch.sigmoid(zf + wcf * c)
        g = torch.tanh(zc)
        c_new = f * c + i * g
        o = torch.sigmoid(zo + wco * c_new)
        t2 = torch.tanh(c_new)
        dh = dh + dh_seq[t].to(dt).float()
        dzo = dh * t2 * o * (1.0 - o)
        dc2 = dc + dh * o * (1.0 - t2 * t2) + dzo * wco
        dzi = dc2 * g * i * (1.0 - i)
        dzf = dc2 * c * f * (1.0 - f)
        dgc = dc2 * i * (1.0 - g * g)
        dz = torch.cat([dzi, dzf, dgc, dzo], dim=-1).to(dt)
        dzs.append(dz)
        dc = dc2 * f + dzi * wci + dzf * wcf
        dh = F.conv_transpose2d(dz.float().permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    return torch.stack(dzs[::-1]), dh.contiguous(), dc


def _scan_backward_cpu(z_seq: Tensor, c_prev_seq: Tensor, dh_seq: Tensor, dc_last: Tensor,
                       h_kernel: Tensor, wci: Tensor, wcf: Tensor, wco: Tensor,
                       dh_last: Optional[Tensor]) -> tuple[Tensor, Tensor, Tensor]:
    return convlstm_scan_backward_reference(z_seq, c_prev_seq, dh_seq, dc_last, h_kernel,
                                            wci, wcf, wco, dh_last)


def _scan_backward_cuda(z_seq, c_prev_seq, dh_seq, dc_last, h_kernel, wci, wcf, wco, dh_last):
    _check_backward(z_seq, c_prev_seq, dh_seq, dc_last, h_kernel, wci, wcf, wco, dh_last)
    dt = z_seq.dtype
    if dt not in (torch.float32, torch.bfloat16) or c_prev_seq.dtype != dt:
        raise TypeError(f"convlstm_scan_backward takes bfloat16 or float32 residuals of one "
                        f"dtype, not {dt} and {c_prev_seq.dtype}")
    T, b, sh, sw, enc = c_prev_seq.shape
    if enc % 16:
        raise ValueError(f"the scan kernel tiles 16 hidden channels at a time: enc={enc} "
                         f"is not a multiple of 16")
    z_seq, c_prev_seq = z_seq.contiguous(), c_prev_seq.contiguous()
    dh_seq = dh_seq.to(dt).contiguous()
    if dh_last is not None:
        dh_last = dh_last.to(dt).contiguous()
    h_kernel = h_kernel.to(dt).contiguous()
    wci, wcf, wco = (p.to(dt).contiguous() for p in (wci, wcf, wco))
    # a private f32 copy that the kernel updates in place: dc_last in, dc0 out
    dc = dc_last.to(dt).to(torch.float32, memory_format=torch.contiguous_format, copy=True)
    dz_seq = torch.empty_like(z_seq)
    dh0 = torch.empty((b, sh, sw, enc), dtype=torch.float32, device=z_seq.device)
    lib = build.scan_bwd_library()
    with torch.cuda.device(z_seq.device):
        err = lib.vp_convlstm_scan_bwd(
            int(dt == torch.bfloat16), z_seq.data_ptr(), c_prev_seq.data_ptr(), dh_seq.data_ptr(),
            None if dh_last is None else dh_last.data_ptr(), dc.data_ptr(), h_kernel.data_ptr(),
            wci.data_ptr(), wcf.data_ptr(), wco.data_ptr(), dz_seq.data_ptr(), dh0.data_ptr(),
            T, b, sh, sw, enc,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"convlstm_scan_backward: kernel launch failed: "
                           f"{lib.vp_cuda_error_string(err).decode()} ({err})")
    convlstm_scan_backward.launches += 1
    return dz_seq, dh0, dc


def _scan_backward_fake(z_seq, c_prev_seq, dh_seq, dc_last, h_kernel, wci, wcf, wco, dh_last):
    _check_backward(z_seq, c_prev_seq, dh_seq, dc_last, h_kernel, wci, wcf, wco, dh_last)
    f32 = dict(dtype=torch.float32)
    return torch.empty_like(z_seq), dc_last.new_empty(dc_last.shape, **f32), \
        dc_last.new_empty(dc_last.shape, **f32)


def _scan_backward_flops(z_seq, *args, out_shape=None, **kwargs):
    r"""The transposed 3x3 convolution's products: the forward's count."""
    T, b, sh, sw, enc4 = z_seq
    return 2 * T * b * sh * sw * 9 * enc4 * (enc4 // 4)


_SCAN_BWD = define_op("convlstm_scan_backward", _scan_backward_cpu, _scan_backward_cuda,
                      _scan_backward_fake, _scan_backward_flops)


def convlstm_scan_backward(z_seq, c_prev_seq, dh_seq, dc_last, h_kernel, wci, wcf, wco,
                           dh_last=None):
    r"""The scan's reverse-time backward from its residuals.

    Args:
        z_seq, c_prev_seq: the forward's residuals (``convlstm_scan_forward``
            with ``save_gates``); their dtype is the activation dtype.
        dh_seq: ``[T, b, sh, sw, enc]`` gradient of ``h_seq``.
        dc_last: ``[b, sh, sw, enc]`` gradient of ``c_last``.
        h_kernel, wci, wcf, wco: the forward's weights and peepholes.
        dh_last: ``[b, sh, sw, enc]`` gradient of ``h_last``, or None
            (zeros). It is taken in the activation dtype and starts the f32
            ``dh`` carry, to which ``dh_seq[-1]`` is then added in f32, as in
            the JAX kernel.

    Returns ``(dz_seq [T, b, sh, sw, 4enc]`` in the activation dtype, ``dh0``,
    ``dc0)``, the last two f32. The operator
    ``vp_suite_tpu_torch::convlstm_scan_backward``: on CPU tensors it computes
    :func:`convlstm_scan_backward_reference`; on CUDA tensors it launches K4,
    which needs ``enc`` a multiple of 16, and raises on anything it does not
    take.
    """
    check_device("convlstm_scan_backward", z_seq)
    return _SCAN_BWD(z_seq, c_prev_seq, dh_seq, dc_last, h_kernel, wci, wcf, wco, dh_last)


class ScanFunction(torch.autograd.Function):
    r"""The scan under autograd: forward K3s, which saves the training
    residuals; backward K4 plus the bulk weight, bias and peephole
    contractions (plain versions on the CPU). ``h_last`` is an output of its
    own, so its gradient reaches K4 apart from ``h_seq``'s and enters the f32
    ``dh`` carry there, as in the JAX kernel. Gradients come back in each
    input's dtype; inputs that need none get None, and the hidden kernel's
    cuDNN weight gradient is skipped when the kernel is frozen."""

    @staticmethod
    def forward(ctx, i2h_t, h0, c0, h_kernel, bias, wci, wcf, wco, seq_len):
        h_seq, c_last, z_seq, c_prev_seq = convlstm_scan_forward(
            i2h_t, h0, c0, h_kernel, bias, wci, wcf, wco, seq_len, save_gates=True)
        ctx.save_for_backward(z_seq, c_prev_seq, h_seq, h0, c_last, h_kernel, bias, wci, wcf, wco)
        ctx.dtypes = (None if i2h_t is None else i2h_t.dtype, c0.dtype)
        return h_seq, h_seq[-1].clone(), c_last

    @staticmethod
    def backward(ctx, dh_seq, dh_last, dc_last):
        z_seq, c_prev_seq, h_seq, h0, c_last, h_kernel, bias, wci, wcf, wco = ctx.saved_tensors
        i2h_dtype, c0_dtype = ctx.dtypes
        need = ctx.needs_input_grad
        dz_seq, dh0, dc0 = convlstm_scan_backward(z_seq, c_prev_seq, dh_seq, dc_last, h_kernel,
                                                  wci, wcf, wco, dh_last)
        T, b, sh, sw, enc = c_prev_seq.shape
        d_hk = d_bias = None
        if need[3]:
            h_prev = torch.cat([h0[None], h_seq[:-1]]).reshape(T * b, sh, sw, enc)
            d_hk = torch.nn.grad.conv2d_weight(
                h_prev.permute(0, 3, 1, 2), (4 * enc, enc, 3, 3),
                dz_seq.reshape(T * b, sh, sw, 4 * enc).permute(0, 3, 1, 2), padding=1)
            d_hk = d_hk.permute(2, 3, 1, 0).to(h_kernel.dtype)
        if need[4]:
            d_bias = dz_seq.float().sum((0, 1, 2, 3)).to(bias.dtype)
        dz_f, c_prev_f = dz_seq.float(), c_prev_seq.float()
        d_peep = [None, None, None]
        for k, (gate, p) in enumerate(((0, wci), (1, wcf), (3, wco))):
            if need[5 + k]:
                cell = c_prev_f if gate < 3 else torch.cat([c_prev_f[1:], c_last.float()[None]])
                dz_g = dz_f[..., gate * enc:(gate + 1) * enc]
                d_peep[k] = (dz_g * cell).sum((0, 1)).to(p.dtype)
        return (dz_seq.to(i2h_dtype) if need[0] else None,
                dh0.to(h0.dtype) if need[1] else None,
                dc0.to(c0_dtype) if need[2] else None,
                d_hk, d_bias, *d_peep, None)


def convlstm_scan_reference(i2h_t, h0, c0, h_kernel, bias, wci, wcf, wco, seq_len):
    r"""Plain PyTorch version of :func:`convlstm_scan_fused`, differentiable
    by autograd: same signature and return."""
    h_seq, c_last = convlstm_scan_forward_reference(i2h_t, h0, c0, h_kernel, bias, wci, wcf, wco,
                                                    seq_len)
    return h_seq, (h_seq[-1], c_last)


def convlstm_scan_fused(i2h_t, h0, c0, h_kernel, bias, wci, wcf, wco, seq_len: int):
    r"""Whole-scan fused ConvLSTM, differentiable.

    Args:
        i2h_t: ``[T, b, sh, sw, 4*enc]`` precomputed input half (time-major),
            or None (decode mode: bias-only input).
        h0, c0: ``[b, sh, sw, enc]`` initial states; ``h0``'s dtype (bf16 or
            f32) is the activation dtype.
        h_kernel: ``[3, 3, enc, 4*enc]`` hidden-half conv kernel (gate order
            i, f, c, o on the last axis).
        bias: ``[4*enc]``, added in f32.
        wci, wcf, wco: ``[sh, sw, enc]`` peepholes.
        seq_len: T.

    Returns ``(h_seq [T, b, sh, sw, enc], (h_last, c_last))``, all in the
    activation dtype; ``h_last`` equals ``h_seq[-1]``. On CUDA tensors it
    launches K3, or, when grad mode is on and some input requires grad, runs
    :class:`ScanFunction` (K3s, and K4 in the backward); ``enc`` must be a
    multiple of 16. On CPU tensors it runs their plain versions.
    """
    _check(i2h_t, h0, c0, h_kernel, bias, wci, wcf, wco, seq_len)
    tensors = (i2h_t, h0, c0, h_kernel, bias, wci, wcf, wco)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        h_seq, h_last, c_last = ScanFunction.apply(*tensors, seq_len)
        return h_seq, (h_last, c_last)
    h_seq, c_last = convlstm_scan_forward(*tensors, seq_len)
    return h_seq, (h_seq[-1], c_last)


#: Launches of K3 (the forward without residuals) since the count was last set to 0.
convlstm_scan_fused.launches = 0
#: Launches of K3s (the forward that saves the training residuals).
convlstm_scan_fused.save_gates_launches = 0
#: Launches of K4 since the count was last set to 0.
convlstm_scan_backward.launches = 0
