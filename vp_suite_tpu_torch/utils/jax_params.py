r"""Carries Encoder-Forecaster weights (EF-ConvLSTM and EF-TrajGRU) from the
JAX package's parameter tree into the port's model.

The JAX tree (``{"enc_rnn1": {...}, "enc_stage1": {layer: {"kernel",
"bias"}}, ..., "dec_rnn1", ...}``, nested dicts of arrays) maps onto the
port's ``state_dict``, which uses the reference vp-suite's names:
``encoder.rnn{k}``, ``encoder.stage{k}.{layer}``, and JAX forecaster block
``n+1`` as ``forecaster.rnn{blocks-n}`` / ``forecaster.stage{blocks-n}``. A
ConvLSTM block's ``{"conv_kernel", "conv_bias", "wci", "wcf", "wco"}`` become
``_conv.weight``/``.bias`` and ``Wci`` (``Wcf``, ``Wco``); a TrajGRU block's
``{name}_kernel``/``{name}_bias`` for ``name`` in ``i2h``, ``i2f_conv1``,
``h2f_conv1``, ``flows_conv`` and ``ret`` become ``{name}.weight``/``.bias``.
Layouts: conv ``[kh, kw, in, out] -> [out, in, kh, kw]``, convT ``[kh, kw,
in, out] -> [in, out, kh, kw]``, peephole ``[h, w, c] -> [1, c, h, w]``.
"""
import numpy as np
import torch


def _tensor(a, axes=None):
    a = np.array(a, dtype=np.float32)  # a writable copy
    return torch.from_numpy(np.ascontiguousarray(a if axes is None else a.transpose(axes)))


TRAJGRU_CONVS = ("i2h", "i2f_conv1", "h2f_conv1", "flows_conv", "ret")


def _convlstm_rnn(sd, prefix, rnn):
    sd[f"{prefix}._conv.weight"] = _tensor(rnn["conv_kernel"], (3, 2, 0, 1))
    sd[f"{prefix}._conv.bias"] = _tensor(rnn["conv_bias"])
    for name in ("wci", "wcf", "wco"):
        sd[f"{prefix}.W{name[1:]}"] = _tensor(rnn[name], (2, 0, 1))[None]


def _trajgru_rnn(sd, prefix, rnn):
    for name in TRAJGRU_CONVS:
        sd[f"{prefix}.{name}.weight"] = _tensor(rnn[f"{name}_kernel"], (3, 2, 0, 1))
        sd[f"{prefix}.{name}.bias"] = _tensor(rnn[f"{name}_bias"])


def ef_state_dict_from_jax(params) -> dict:
    r"""The port's EF ``state_dict`` (f32 CPU tensors) for a JAX EF-ConvLSTM
    or EF-TrajGRU parameter tree; the block kind comes from the keys."""
    blocks = 0
    while f"enc_rnn{blocks + 1}" in params:
        blocks += 1
    if blocks == 0:
        raise ValueError("no enc_rnn{k} entries found: not an Encoder-Forecaster parameter tree")
    if "conv_kernel" in params["enc_rnn1"]:
        rnn_fn = _convlstm_rnn
    elif "i2h_kernel" in params["enc_rnn1"]:
        rnn_fn = _trajgru_rnn
    else:
        raise ValueError(f"enc_rnn1 holds neither a ConvLSTM nor a TrajGRU block: "
                         f"{sorted(params['enc_rnn1'])}")
    sd = {}
    for n in range(blocks):
        for jax_name, prefix in ((f"enc_rnn{n + 1}", f"encoder.rnn{n + 1}"),
                                 (f"dec_rnn{n + 1}", f"forecaster.rnn{blocks - n}")):
            rnn_fn(sd, prefix, params[jax_name])
        for jax_name, prefix in ((f"enc_stage{n + 1}", f"encoder.stage{n + 1}"),
                                 (f"dec_stage{n + 1}", f"forecaster.stage{blocks - n}")):
            for layer, p in params[jax_name].items():
                axes = (2, 3, 0, 1) if "deconv" in layer else (3, 2, 0, 1)
                sd[f"{prefix}.{layer}.weight"] = _tensor(p["kernel"], axes)
                sd[f"{prefix}.{layer}.bias"] = _tensor(p["bias"])
    return sd


def load_jax_params(model, params):
    r"""Copies a JAX EF parameter tree into ``model`` (strict: every
    key on both sides must match); the model keeps its device and dtype."""
    model.load_state_dict(ef_state_dict_from_jax(params), strict=True)
    return model
