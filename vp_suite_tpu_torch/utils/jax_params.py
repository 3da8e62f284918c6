r"""Carries parameters from the JAX package's layouts into the port's: the
weights of EF-ConvLSTM, EF-TrajGRU, UNet-3D, PredRNN++, PhyDNet, ST-Phy,
LSTM, MinConvRNN, SimVP and PredFormer into the port's model, and the
measure nets' flat dicts (LPIPS, I3D) into the port's parameter dicts; and
the last five models' weights and the model blocks' back into the JAX
package's trees (``*_params_to_jax``, ``block_params_to_jax``).

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
``convcell.cell_list.{j}.conv``. MinConvRNN's and SimVP's flat names
(``{name}_kernel`` / ``_bias``, GroupNorm ``{name}_scale`` / ``_bias``) keep
``name``, but for MinConvRNN's ``l{i}_{f,g,out}`` -> ``layers.{i}.{f,g,out}``
and SimVP's ``t{i}_{red,mid,exp,gn1,gn2}`` -> ``translator.{i}.{...}``; the
``dec*`` convs are transposed. PredFormer's nested tree keeps its names
(``block{i}`` -> ``blocks.{i}``; LayerNorm ``scale`` -> ``weight``); an
attention's ``query`` / ``key`` / ``value`` kernels ``[d, heads, head_dim]``
become ``[heads * head_dim, d]`` (biases flattened) and its ``out`` kernel
``[heads, head_dim, d]`` becomes ``[d, heads * head_dim]``. ST-Phy's and
LSTM's flat names map by the rules ``ST_PHY_KEYS`` and ``LSTM_KEYS``, both
ways: the inverses of ``_import_st_phy`` and ``_import_lstm``.

Layouts: conv ``[kh, kw, in, out] -> [out, in, kh, kw]``, convT ``[kh, kw,
in, out] -> [in, out, kh, kw]``, peephole ``[h, w, c] -> [1, c, h, w]``, 3-D
conv ``[kt, kh, kw, in, out] -> [out, in, kt, kh, kw]``, dense ``[in, out]
-> [out, in]``, LayerNorm ``[h, w, c] -> [c, h, w]``.
"""
import re

import numpy as np
import torch

from vp_suite_tpu_torch.models.lstm import LSTM
from vp_suite_tpu_torch.models.min_conv_rnn import MinConvRNN
from vp_suite_tpu_torch.models.phydnet import PhyDNet
from vp_suite_tpu_torch.models.pred_former import PredFormer
from vp_suite_tpu_torch.models.predrnn_v2 import PredRNN_V2
from vp_suite_tpu_torch.models.simvp import SimVP
from vp_suite_tpu_torch.models.st_phy import STPhy
from vp_suite_tpu_torch.models.unet3d import UNet3D
from vp_suite_tpu_torch.nn.layers import Conv2d, ConvTranspose2d, GroupNorm


def _tensor(a, axes=None):
    a = np.array(a, dtype=np.float32)  # a writable copy
    return torch.from_numpy(np.ascontiguousarray(a if axes is None else a.transpose(axes)))


def _array(t):
    r"""An f32 numpy copy of a tensor (a copy: JAX may read a numpy array
    without copying it, after the port has updated the tensor in place)."""
    return t.detach().to("cpu", torch.float32).numpy().copy()


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


def _flat_conv_state_dict(params, group):
    r"""The port's ``state_dict`` for flat conv and GroupNorm params
    (``{name}_kernel``, ``_bias``, ``_scale``; ``dec*`` kernels transposed),
    with the blocks ``{jax}{i}_{name}`` of ``group = (jax, port)`` as
    ``{port}.{i}.{name}``."""
    jax_group, port_group = group
    sd = {}
    for key, value in params.items():
        name, kind = key.rsplit("_", 1)
        m = re.fullmatch(rf"{jax_group}(\d+)_(\w+)", name)
        port = f"{port_group}.{m[1]}.{m[2]}" if m else name
        if kind == "kernel":
            sd[f"{port}.weight"] = _tensor(value, CONVT if name.startswith("dec") else CONV)
        else:
            sd[f"{port}.{'weight' if kind == 'scale' else 'bias'}"] = _tensor(value)
    return sd


def _flat_conv_params(state_dict, group):
    r"""The inverse of :func:`_flat_conv_state_dict`: flat JAX params (f32 numpy)."""
    jax_group, port_group = group
    params = {}
    for key, value in state_dict.items():
        port, kind = key.rsplit(".", 1)
        m = re.fullmatch(rf"{port_group}\.(\d+)\.(\w+)", port)
        name = f"{jax_group}{m[1]}_{m[2]}" if m else port
        v = _array(value)
        if v.ndim == 4:
            perm = CONVT if name.startswith("dec") else CONV
            params[f"{name}_kernel"] = v.transpose(np.argsort(perm))
        else:
            params[f"{name}_{'scale' if kind == 'weight' else 'bias'}"] = v
    return params


def min_conv_rnn_state_dict_from_jax(params) -> dict:
    r"""The port's MinConvRNN ``state_dict`` for the JAX model's flat params."""
    return _flat_conv_state_dict(params, ("l", "layers"))


def min_conv_rnn_params_to_jax(state_dict) -> dict:
    r"""The JAX MinConvRNN's flat params for the port's ``state_dict``."""
    return _flat_conv_params(state_dict, ("l", "layers"))


def simvp_state_dict_from_jax(params) -> dict:
    r"""The port's SimVP ``state_dict`` for the JAX model's flat params."""
    return _flat_conv_state_dict(params, ("t", "translator"))


def simvp_params_to_jax(state_dict) -> dict:
    r"""The JAX SimVP's flat params for the port's ``state_dict``."""
    return _flat_conv_params(state_dict, ("t", "translator"))


def _flax_layers(sd, prefix, tree):
    r"""Adds the port's entries for a flax subtree: an attention (``query``,
    ``key``, ``value``, ``out`` DenseGenerals), a LayerNorm (``scale``), a
    Dense (``kernel``), or a dict of those."""
    if "query" in tree:
        d, heads, hd = np.shape(tree["query"]["kernel"])
        for proj in ("query", "key", "value"):
            sd[f"{prefix}.{proj}.weight"] = _tensor(
                np.reshape(tree[proj]["kernel"], (d, heads * hd)), DENSE)
            sd[f"{prefix}.{proj}.bias"] = _tensor(np.reshape(tree[proj]["bias"], -1))
        sd[f"{prefix}.out.weight"] = _tensor(np.reshape(tree["out"]["kernel"], (heads * hd, d)),
                                             DENSE)
        sd[f"{prefix}.out.bias"] = _tensor(tree["out"]["bias"])
    elif "scale" in tree:
        sd[f"{prefix}.weight"] = _tensor(tree["scale"])
        sd[f"{prefix}.bias"] = _tensor(tree["bias"])
    elif "kernel" in tree:
        _weight_bias(sd, prefix, tree, DENSE)
    else:
        for name, sub in tree.items():
            _flax_layers(sd, f"{prefix}.{name}", sub)


def pred_former_state_dict_from_jax(params) -> dict:
    r"""The port's PredFormer ``state_dict`` for the JAX model's params."""
    sd = {}
    for name, value in params.items():
        if name.startswith("pos_"):
            sd[name] = _tensor(value)
        else:
            _flax_layers(sd, f"blocks.{name[5:]}" if name.startswith("block") else name, value)
    return sd


def pred_former_params_to_jax(state_dict, heads) -> dict:
    r"""The JAX PredFormer's params (nested dicts of f32 numpy) for the port's
    ``state_dict`` of a model with ``heads`` attention heads."""
    params = {}
    for key, value in state_dict.items():
        v = _array(value)
        path = key.split(".")
        if path[0] == "blocks":
            path = [f"block{path[1]}"] + path[2:]
        *parents, kind = path
        if not parents:                     # pos_spatial, pos_temporal
            params[kind] = v
            continue
        leaf = "kernel" if kind == "weight" else "bias"
        if len(parents) > 1 and parents[-2].startswith("attn"):
            if kind == "bias":
                v = v if parents[-1] == "out" else v.reshape(heads, -1)
            elif parents[-1] == "out":      # [d, heads * hd] -> [heads, hd, d]
                v = v.T.reshape(heads, -1, v.shape[0])
            else:                           # [heads * hd, d] -> [d, heads, hd]
                v = v.T.reshape(v.shape[1], heads, -1)
        elif parents[-1].startswith("ln"):
            leaf = "scale" if kind == "weight" else "bias"
        elif kind == "weight":
            v = v.T
        node = params
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = v
    return params


#: ``{name}`` placeholders of the key rules below and what each matches
_FIELDS = {"i": r"\d+", "n": r"\d+", "l": "[xhamo]", "d": "[hw]", "g": "ih|hh",
           "c": "convgate|frame_action_conv|hidden_action_conv",
           "lin": "to_linear|from_linear|action_inflate"}


def _layer(jax, port, axes):
    return [(f"{jax}_kernel", f"{port}.weight", axes), (f"{jax}_bias", f"{port}.bias", None)]


def _norm(jax, port, axes):
    return [(f"{jax}_scale", f"{port}.weight", axes), (f"{jax}_bias", f"{port}.bias", axes)]


#: (JAX key, port key, the JAX -> port transpose) of ST-Phy's flat params
ST_PHY_KEYS = [
    *_layer("ae_enc_conv{n}", "autoencoder.encoder.conv{n}", CONV),
    *_layer("ae_enc_mean", "autoencoder.encoder.mean_layer", CONV),
    *_layer("ae_dec_fc1", "autoencoder.decoder.fc1", CONV),
    *_layer("ae_dec_conv{n}", "autoencoder.decoder.conv{n}", CONVT),
    *_layer("st_cell{i}_conv_last", "st_cell_list.{i}.conv_last", CONV),
    *_layer("st_cell{i}_conv_{l}", "st_cell_list.{i}.conv_{l}.0", CONV),
    *_norm("st_cell{i}_ln_{l}", "st_cell_list.{i}.conv_{l}.1", LN_CHW),
    *_layer("phycell{i}_F_conv{n}", "phycell_list.{i}.F.conv{n}", CONV),
    *_norm("phycell{i}_F_bn1", "phycell_list.{i}.F.bn1", None),
    *_layer("phycell{i}_{c}", "phycell_list.{i}.{c}", CONV),
    *_layer("hidden_conv{i}", "hidden_conv_list.{i}", CONV),
    ("adapter_kernel", "adapter.weight", CONV),
    ("action_inflate_kernel", "action_inflate.weight", DENSE),
    ("action_conv_{d}_kernel", "action_conv_{d}.weight", CONV),
]
#: the same for LSTM's
LSTM_KEYS = [
    *_layer("enc{n}", "enc{n}", CONV),
    *_layer("dec{n}", "dec{n}", CONVT),
    *_layer("{lin}", "{lin}", DENSE),
    ("lstm{i}_w_{g}", "rnn_layers.{i}.weight_{g}", DENSE),
    ("lstm{i}_b_{g}", "rnn_layers.{i}.bias_{g}", None),
]


def _key_pattern(fmt):
    parts = re.split(r"\{(\w+)\}", fmt)
    return "".join(re.escape(p) if k % 2 == 0 else f"(?P<{p}>{_FIELDS[p]})"
                   for k, p in enumerate(parts))


def _rename(key, rules, src):
    r"""``(key on the other side, JAX -> port transpose)`` of ``key`` on side
    ``src`` (0 JAX, 1 port) by the first rule that matches it."""
    for rule in rules:
        if m := re.fullmatch(_key_pattern(rule[src]), key):
            return rule[1 - src].format(**m.groupdict()), rule[2]
    raise ValueError(f"no rule maps the parameter {key}")


def _state_dict_by_rules(params, rules):
    sd = {}
    for key, value in params.items():
        port, axes = _rename(key, rules, 0)
        sd[port] = _tensor(value, axes)
    return sd


def _params_by_rules(state_dict, rules):
    params = {}
    for key, value in state_dict.items():
        name, axes = _rename(key, rules, 1)
        v = _array(value)
        params[name] = v if axes is None else v.transpose(np.argsort(axes))
    return params


def st_phy_state_dict_from_jax(params) -> dict:
    r"""The port's ST-Phy ``state_dict`` for the JAX model's flat params (the
    inverse of the JAX package's ``torch_import._import_st_phy``)."""
    return _state_dict_by_rules(params, ST_PHY_KEYS)


def st_phy_params_to_jax(state_dict) -> dict:
    r"""The JAX ST-Phy's flat params (f32 numpy copies) for the port's ``state_dict``."""
    return _params_by_rules(state_dict, ST_PHY_KEYS)


def lstm_state_dict_from_jax(params) -> dict:
    r"""The port's LSTM ``state_dict`` for the JAX model's flat params (the
    inverse of ``torch_import._import_lstm``)."""
    return _state_dict_by_rules(params, LSTM_KEYS)


def lstm_params_to_jax(state_dict) -> dict:
    r"""The JAX LSTM's flat params (f32 numpy copies) for the port's ``state_dict``."""
    return _params_by_rules(state_dict, LSTM_KEYS)


def block_params_to_jax(block) -> dict:
    r"""The JAX counterpart's params (f32 numpy copies) of a port model block
    built of ``Conv2d``, ``ConvTranspose2d`` and ``GroupNorm`` layers (the
    blocks of ``model_blocks/enc.py`` and ``conv.py``'s DCGAN convs, nested
    flax trees, a DCGAN conv's ``main.0`` / ``main.1`` as ``conv`` / ``gn``;
    ``ConvLSTMNdrplz``, whose ``cell_list.{i}.conv`` is ``cell{i}_conv``)."""
    params = {}
    for name, module in block.named_modules():
        if isinstance(module, GroupNorm):
            leaf = {"scale": _array(module.weight), "bias": _array(module.bias)}
        elif isinstance(module, (Conv2d, ConvTranspose2d)):
            axes = CONVT if isinstance(module, ConvTranspose2d) else CONV
            leaf = {"kernel": _array(module.weight).transpose(np.argsort(axes))}
            if module.bias is not None:
                leaf["bias"] = _array(module.bias)
        else:
            continue
        if m := re.fullmatch(r"cell_list\.(\d+)\.conv", name):
            params.update({f"cell{m[1]}_conv_{k}": v for k, v in leaf.items()})
            continue
        *parents, last = name.replace("main.0", "conv").replace("main.1", "gn").split(".")
        node = params
        for parent in parents:
            node = node.setdefault(parent, {})
        node[last] = leaf
    return params


def load_jax_params(model, params):
    r"""Copies JAX parameters into ``model`` (strict: every key on both sides
    must match): a parameter tree of EF-ConvLSTM, EF-TrajGRU, PredRNN++,
    PhyDNet, ST-Phy, LSTM, MinConvRNN, SimVP or PredFormer, or UNet-3D's variables
    ``{"params", "batch_stats"}``; the model keeps its device and dtype."""
    if isinstance(model, UNet3D):
        sd = unet3d_state_dict_from_jax(params)
    elif isinstance(model, PredRNN_V2):
        sd = predrnn_state_dict_from_jax(params)
    elif isinstance(model, PhyDNet):
        sd = phydnet_state_dict_from_jax(params)
    elif isinstance(model, STPhy):
        sd = st_phy_state_dict_from_jax(params)
    elif isinstance(model, LSTM):
        sd = lstm_state_dict_from_jax(params)
    elif isinstance(model, MinConvRNN):
        sd = min_conv_rnn_state_dict_from_jax(params)
    elif isinstance(model, SimVP):
        sd = simvp_state_dict_from_jax(params)
    elif isinstance(model, PredFormer):
        sd = pred_former_state_dict_from_jax(params)
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
