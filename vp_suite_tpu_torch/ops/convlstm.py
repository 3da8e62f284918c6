r"""Whole-recurrence ConvLSTM forward scan: a CUDA kernel (K3) and its plain version.

One call runs all ``seq_len`` steps of a peephole ConvLSTM whose input half is
precomputed (``i2h_t``) or absent (decode mode, where the bias rides the
hidden convolution): per step the 3x3 hidden convolution, the bias, the input
half and the gate chain of :mod:`vp_suite_tpu_torch.ops.cells`. The carry is
``h`` in the activation dtype and ``c`` in f32.

The kernel (``csrc/convlstm_scan.cu``, whose header note gives its bound and
design) replaces the JAX package's TPU kernel
``ops/pallas_convlstm.py:_make_scan_kernel`` in its forward form
(``save_gates=False``); it is built with ``nvcc`` at first use
(:mod:`vp_suite_tpu_torch.kernels.build`) and called through ``ctypes``.
"""
import torch
import torch.nn.functional as F

from vp_suite_tpu_torch.kernels import build


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


def convlstm_scan_reference(i2h_t, h0, c0, h_kernel, bias, wci, wcf, wco, seq_len):
    r"""Plain PyTorch version of the scan: a loop over time with ``F.conv2d``
    and the gate chain, under the kernel's dtype rules (conv products of
    activation-dtype values summed in f32, f32 gate math and cell carry, ``h``
    rounded to the activation dtype). Same signature and return as
    :func:`convlstm_scan_fused`."""
    _check(i2h_t, h0, c0, h_kernel, bias, wci, wcf, wco, seq_len)
    dt = h0.dtype
    w = h_kernel.to(dt).float().permute(3, 2, 0, 1)   # [4enc, enc, 3, 3]
    bias = bias.float()
    peep = [p.to(dt).float() for p in (wci, wcf, wco)]
    h, c = h0, c0.to(dt).float()
    outs = []
    for t in range(seq_len):
        z = F.conv2d(h.float().permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1) + bias
        if i2h_t is not None:
            z = z + i2h_t[t].to(dt).float()
        zi, zf, zc, zo = z.chunk(4, dim=-1)
        i = torch.sigmoid(zi + peep[0] * c)
        f = torch.sigmoid(zf + peep[1] * c)
        c = f * c + i * torch.tanh(zc)
        o = torch.sigmoid(zo + peep[2] * c)
        h = (o * torch.tanh(c)).to(dt)
        outs.append(h)
    return torch.stack(outs), (h, c.to(dt))


def convlstm_scan_fused(i2h_t, h0, c0, h_kernel, bias, wci, wcf, wco, seq_len: int):
    r"""Whole-scan fused ConvLSTM forward.

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
    activation dtype. On CPU tensors it computes
    :func:`convlstm_scan_reference`; on CUDA tensors it launches the CUDA
    kernel, which needs ``enc`` a multiple of 16, and raises on anything it
    does not take.
    """
    _check(i2h_t, h0, c0, h_kernel, bias, wci, wcf, wco, seq_len)
    if h0.device.type == "cpu":
        return convlstm_scan_reference(i2h_t, h0, c0, h_kernel, bias, wci, wcf, wco, seq_len)
    if h0.device.type != "cuda":
        raise ValueError(f"convlstm_scan_fused runs on CPU or CUDA tensors, not {h0.device}")
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
    lib = build.scan_library()
    with torch.cuda.device(h0.device):
        err = lib.vp_convlstm_scan_fwd(
            int(dt == torch.bfloat16), None if i2h_t is None else i2h_t.data_ptr(),
            h0.data_ptr(), c.data_ptr(), h_kernel.data_ptr(), bias.data_ptr(),
            wci.data_ptr(), wcf.data_ptr(), wco.data_ptr(), h_seq.data_ptr(),
            seq_len, b, sh, sw, enc, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"convlstm_scan_fused: kernel launch failed: "
                           f"{lib.vp_cuda_error_string(err).decode()} ({err})")
    convlstm_scan_fused.launches += 1
    return h_seq, (h_seq[-1], c.to(dt))


#: Launches of the CUDA kernel since the count was last set to 0.
convlstm_scan_fused.launches = 0
