r"""Carries EF-ConvLSTM weights from the JAX package's parameter tree into the
port's model.

The JAX tree (``{"enc_rnn1": {"conv_kernel", "conv_bias", "wci", "wcf",
"wco"}, "enc_stage1": {layer: {"kernel", "bias"}}, ..., "dec_rnn1", ...}``,
nested dicts of arrays) maps onto the port's ``state_dict``, which uses the
reference vp-suite's names: ``encoder.rnn{k}._conv.weight``/``.bias``,
``encoder.rnn{k}.Wci`` (and ``Wcf``, ``Wco``), ``encoder.stage{k}.{layer}``,
and JAX forecaster block ``n+1`` as ``forecaster.rnn{blocks-n}`` /
``forecaster.stage{blocks-n}``. Layouts: conv ``[kh, kw, in, out] -> [out,
in, kh, kw]``, convT ``[kh, kw, in, out] -> [in, out, kh, kw]``, peephole
``[h, w, c] -> [1, c, h, w]``.
"""
import numpy as np
import torch


def _tensor(a, axes=None):
    a = np.array(a, dtype=np.float32)  # a writable copy
    return torch.from_numpy(np.ascontiguousarray(a if axes is None else a.transpose(axes)))


def ef_state_dict_from_jax(params) -> dict:
    r"""The port's EF ``state_dict`` (f32 CPU tensors) for a JAX EF-ConvLSTM
    parameter tree."""
    blocks = 0
    while f"enc_rnn{blocks + 1}" in params:
        blocks += 1
    if blocks == 0:
        raise ValueError("no enc_rnn{k} entries found: not an EF-ConvLSTM parameter tree")
    sd = {}
    for n in range(blocks):
        for jax_name, prefix in ((f"enc_rnn{n + 1}", f"encoder.rnn{n + 1}"),
                                 (f"dec_rnn{n + 1}", f"forecaster.rnn{blocks - n}")):
            rnn = params[jax_name]
            sd[f"{prefix}._conv.weight"] = _tensor(rnn["conv_kernel"], (3, 2, 0, 1))
            sd[f"{prefix}._conv.bias"] = _tensor(rnn["conv_bias"])
            for name in ("wci", "wcf", "wco"):
                sd[f"{prefix}.W{name[1:]}"] = _tensor(rnn[name], (2, 0, 1))[None]
        for jax_name, prefix in ((f"enc_stage{n + 1}", f"encoder.stage{n + 1}"),
                                 (f"dec_stage{n + 1}", f"forecaster.stage{blocks - n}")):
            for layer, p in params[jax_name].items():
                axes = (2, 3, 0, 1) if "deconv" in layer else (3, 2, 0, 1)
                sd[f"{prefix}.{layer}.weight"] = _tensor(p["kernel"], axes)
                sd[f"{prefix}.{layer}.bias"] = _tensor(p["bias"])
    return sd


def load_jax_params(model, params):
    r"""Copies a JAX EF-ConvLSTM parameter tree into ``model`` (strict: every
    key on both sides must match); the model keeps its device and dtype."""
    model.load_state_dict(ef_state_dict_from_jax(params), strict=True)
    return model
