r"""Carries parameters from the JAX package's layouts into the port's: the
weights of EF-ConvLSTM, EF-TrajGRU, UNet-3D, PredRNN++ and PhyDNet into the
port's model, and the measure nets' flat dicts (LPIPS, I3D) into the port's
parameter dicts.

The JAX tree (``{"enc_rnn1": {...}, "enc_stage1": {layer: {"kernel",
"bias"}}, ..., "dec_rnn1", ...}``, nested dicts of arrays) maps onto the
port's ``state_dict``, which uses the reference vp-suite's names:
``encoder.rnn{k}``, ``encoder.stage{k}.{layer}``, and JAX forecaster block
``n+1`` as ``forecaster.rnn{blocks-n}`` / ``forecaster.stage{blocks-n}``. A
ConvLSTM block's ``{"conv_kernel", "conv_bias", "wci", "wcf", "wco"}`` become
``_conv.weight``/``.bias`` and ``Wci`` (``Wcf``, ``Wco``); a TrajGRU block's
``{name}_kernel``/``{name}_bias`` for ``name`` in ``i2h``, ``i2f_conv1``,
``h2f_conv1``, ``flows_conv`` and ``ret`` become ``{name}.weight``/``.bias``.
UNet-3D's variables (``{"params", "batch_stats"}``) are the inverse of the
JAX package's ``utils/torch_import._import_unet3d``: ``down{i}`` ->
``downs.{i}``, ``bottleneck``, ``up_c{i}`` -> ``ups.{2i+1}`` (double convs:
``conv1``/``bn1``/``conv2``/``bn2`` -> ``conv.0``/``.1``/``.3``/``.4``, a
BatchNorm's ``scale``/``bias`` -> ``weight``/``bias`` and its ``batch_stats``
``mean``/``var`` -> ``running_mean``/``running_var``), ``time3d_{i}`` ->
``time3ds.{i}`` with ``time3d_bn`` last, ``up_t{i}`` -> ``ups.{2i}``,
``action_inflate{i}`` -> ``action_inflates.{i}``. PredRNN++'s flat params
are the inverse of ``_import_predrnn``: ``cell{i}_{conv}_kernel`` /
``_bias`` -> ``cell_list.{i}.{conv}.0.weight`` / ``.bias`` (``conv_last``
without the ``.0``), ``cell{i}_ln_{x,h,a,m,o}_scale`` / ``_bias`` ->
``cell_list.{i}.conv_{x,h,a,m,o}.1.weight`` / ``.bias``, and the model's
``conv_last``, ``adapter``, ``conv_input{1,2}``, ``action_conv_input{1,2}``
and ``deconv_output{1,2}``. PhyDNet's flat params are the inverse of
``_import_phydnet``: a DCGAN block's ``{module}_{block}_conv_kernel`` /
``_bias`` and ``_gn_scale`` / ``_gn_bias`` -> ``{module}.{block}.main.0``
and ``.main.1`` ``weight`` / ``bias`` (transposed convs in the
``decoder_*`` modules), ``decoder_D_upc3`` -> ``decoder_D.upc3``,
``phycell{j}_{conv}`` -> ``phycell.cell_list.{j}.{conv}`` (``F_conv1``,
``F_conv2`` -> ``F.conv1``, ``F.conv2``, ``F_bn1_scale`` / ``_bias`` ->
``F.bn1.weight`` / ``.bias``; ``convgate``, ``frame_action_conv``,
``hidden_action_conv``) and ``convcell{j}_conv`` ->
``convcell.cell_list.{j}.conv``.

Layouts: conv ``[kh, kw, in, out] -> [out, in, kh, kw]``, convT ``[kh, kw,
in, out] -> [in, out, kh, kw]``, peephole ``[h, w, c] -> [1, c, h, w]``, 3-D
conv ``[kt, kh, kw, in, out] -> [out, in, kt, kh, kw]``, dense ``[in, out]
-> [out, in]``, LayerNorm ``[h, w, c] -> [c, h, w]``.
"""
import re

import numpy as np
import torch

from vp_suite_tpu_torch.models.phydnet import PhyDNet
from vp_suite_tpu_torch.models.predrnn_v2 import PredRNN_V2
from vp_suite_tpu_torch.models.unet3d import UNet3D


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


CONV, CONVT, CONV3D, DENSE, LN_CHW = (3, 2, 0, 1), (2, 3, 0, 1), (4, 3, 0, 1, 2), (1, 0), (2, 0, 1)


def _double_conv(sd, prefix, params, stats, axes):
    for i, (conv, bn) in enumerate((("conv1", "bn1"), ("conv2", "bn2"))):
        sd[f"{prefix}.conv.{3 * i}.weight"] = _tensor(params[conv]["kernel"], axes)
        sd[f"{prefix}.conv.{3 * i + 1}.weight"] = _tensor(params[bn]["scale"])
        sd[f"{prefix}.conv.{3 * i + 1}.bias"] = _tensor(params[bn]["bias"])
        sd[f"{prefix}.conv.{3 * i + 1}.running_mean"] = _tensor(stats[bn]["mean"])
        sd[f"{prefix}.conv.{3 * i + 1}.running_var"] = _tensor(stats[bn]["var"])
        sd[f"{prefix}.conv.{3 * i + 1}.num_batches_tracked"] = torch.tensor(0)


def _weight_bias(sd, prefix, p, axes):
    sd[f"{prefix}.weight"] = _tensor(p["kernel"], axes)
    sd[f"{prefix}.bias"] = _tensor(p["bias"])


def unet3d_state_dict_from_jax(variables) -> dict:
    r"""The port's UNet-3D ``state_dict`` for the JAX model's variables
    ``{"params": ..., "batch_stats": ...}``."""
    params, stats = variables["params"], variables["batch_stats"]
    n = 0
    while f"down{n}" in params:
        n += 1
    sd = {}
    for i in range(n):
        _double_conv(sd, f"downs.{i}", params[f"down{i}"], stats[f"down{i}"], CONV3D)
        _weight_bias(sd, f"time3ds.{i}", params[f"time3d_{i}"], CONV3D)
        if f"action_inflate{i}" in params:
            _weight_bias(sd, f"action_inflates.{i}", params[f"action_inflate{i}"], DENSE)
        _weight_bias(sd, f"ups.{2 * i}", params[f"up_t{i}"], CONVT)
        _double_conv(sd, f"ups.{2 * i + 1}", params[f"up_c{i}"], stats[f"up_c{i}"], CONV)
    _weight_bias(sd, f"time3ds.{n}", params["time3d_bn"], CONV3D)
    if "bottleneck_action_inflate" in params:
        _weight_bias(sd, "bottleneck_action_inflate", params["bottleneck_action_inflate"], DENSE)
    _double_conv(sd, "bottleneck", params["bottleneck"], stats["bottleneck"], CONV)
    _weight_bias(sd, "final_conv", params["final_conv"], CONV)
    return sd


def predrnn_state_dict_from_jax(params) -> dict:
    r"""The port's PredRNN++ ``state_dict`` for the JAX model's params."""
    sd = {}
    for key, value in params.items():
        name, kind = key.rsplit("_", 1)
        if name.startswith("cell"):
            cell, name = name.split("_", 1)
            prefix = f"cell_list.{cell[4:]}."
            if name.startswith("ln_"):
                sd[f"{prefix}conv_{name[3:]}.1.{'weight' if kind == 'scale' else 'bias'}"] = \
                    _tensor(value, LN_CHW)
                continue
            if name != "conv_last":
                name += ".0"
            name = prefix + name
        sd[f"{name}.{'weight' if kind == 'kernel' else 'bias'}"] = _tensor(
            value, (CONVT if name.startswith("deconv") else CONV) if kind == "kernel" else None)
    return sd


_DCGAN_KEY = re.compile(r"(encoder_E|encoder_Ep|encoder_Er|decoder_Dp|decoder_Dr|decoder_D)"
                        r"_((?:up)?c\d)_(conv|gn)")
_CELL_KEY = re.compile(r"(phycell|convcell)(\d+)_(\w+)")


def phydnet_state_dict_from_jax(params) -> dict:
    r"""The port's PhyDNet ``state_dict`` for the JAX model's flat params."""
    sd = {}
    for key, value in params.items():
        name, kind = key.rsplit("_", 1)
        transposed = name.startswith("decoder")
        if m := _DCGAN_KEY.fullmatch(name):
            name = f"{m[1]}.{m[2]}.main.{0 if m[3] == 'conv' else 1}"
        elif name == "decoder_D_upc3":
            name = "decoder_D.upc3"
        elif m := _CELL_KEY.fullmatch(name):
            name = f"{m[1]}.cell_list.{m[2]}.{m[3].replace('F_', 'F.')}"
        else:
            raise ValueError(f"not a PhyDNet parameter: {key}")
        sd[f"{name}.{'bias' if kind == 'bias' else 'weight'}"] = _tensor(
            value, (CONVT if transposed else CONV) if kind == "kernel" else None)
    return sd


def load_jax_params(model, params):
    r"""Copies JAX parameters into ``model`` (strict: every key on both sides
    must match): a parameter tree of EF-ConvLSTM, EF-TrajGRU, PredRNN++ or
    PhyDNet, or UNet-3D's variables ``{"params", "batch_stats"}``; the model
    keeps its device and dtype."""
    if isinstance(model, UNet3D):
        sd = unet3d_state_dict_from_jax(params)
    elif isinstance(model, PredRNN_V2):
        sd = predrnn_state_dict_from_jax(params)
    elif isinstance(model, PhyDNet):
        sd = phydnet_state_dict_from_jax(params)
    else:
        sd = ef_state_dict_from_jax(params)
    model.load_state_dict(sd, strict=True)
    return model


def _kernels_from_jax(params, axes):
    return {k: _tensor(v, axes if k.endswith("_kernel") else None) for k, v in params.items()}


def lpips_params_from_jax(params) -> dict:
    r"""The port's LPIPS parameters (f32 CPU tensors, same keys) from the JAX
    package's dict: ``conv{i}_kernel`` HWIO -> OIHW; ``conv{i}_bias`` and
    the linear heads ``lin{i}`` as they are."""
    return _kernels_from_jax(params, (3, 2, 0, 1))


def i3d_params_from_jax(params) -> dict:
    r"""The port's I3D parameters (f32 CPU tensors, same keys) from the JAX
    package's dict: every ``*_kernel`` DHWIO -> OIDHW; biases and the
    BatchNorm vectors (``*_bn_mean``, ``_bn_var``, ``_bn_scale``,
    ``_bn_bias``) as they are."""
    return _kernels_from_jax(params, (4, 3, 0, 1, 2))
