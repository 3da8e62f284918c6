r"""Conv shape arithmetic (parity with the reference vp-suite's
``utils/models.py:131-193``)."""


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def conv_output_shape(hw, kernel_size=1, stride=1, pad=0, dilation=1):
    r"""Output (h, w) of a conv layer."""
    h, w = _pair(hw)
    k, s, p, d = _pair(kernel_size), _pair(stride), _pair(pad), _pair(dilation)
    oh = (h + 2 * p[0] - d[0] * (k[0] - 1) - 1) // s[0] + 1
    ow = (w + 2 * p[1] - d[1] * (k[1] - 1) - 1) // s[1] + 1
    return oh, ow


def convtransp_output_shape(hw, kernel_size=1, stride=1, pad=0, dilation=1, out_pad=0):
    r"""Output (h, w) of a transposed conv layer."""
    h, w = _pair(hw)
    k, s, p, d, op = (_pair(kernel_size), _pair(stride), _pair(pad), _pair(dilation),
                      _pair(out_pad))
    oh = (h - 1) * s[0] - 2 * p[0] + d[0] * (k[0] - 1) + op[0] + 1
    ow = (w - 1) * s[1] - 2 * p[1] + d[1] * (k[1] - 1) + op[1] + 1
    return oh, ow
