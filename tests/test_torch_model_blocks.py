r"""The port's model block registry against the JAX package's, on the CPU, in
f32 under ``jax.default_matmul_precision("highest")``, each block on the
port's weights carried into JAX (``jax_params.block_params_to_jax``).

- ``enc.py``'s blocks: ``Encoder`` (its width-axis L2 normalization),
  ``Decoder`` at an image size its transposed convs give (no resize) and at
  one they overshoot (35x35: 36x36 decoded, shrunk by the antialiased
  resize), ``Autoencoder``'s ``encode``, ``decode``, round trip and
  ``encoded_shape``, ``DCGANEncoder``, ``DCGANDecoder`` to its own size and
  to another, ``EncoderSplit`` and ``DecoderSplit``: to 1e-4, with
  randomized GroupNorm affines.
- ``ConvLSTMNdrplz``, 2 layers of other widths and kernels, time- and
  batch-major input, the last layer or all of them: every output sequence
  and last state to 1e-4; its two refusals, on both sides.
- ``ConvStage`` with ``pool*`` specs (a 2x2 pool and a 3x3/s2 pool padded
  by 1) between convs, and ``max_pool_2d``'s strides and padding against
  flax's ``max_pool``.
- ``MODEL_BLOCK_CLASSES``: the JAX package's classes, by name and ``NAME``,
  in its order; and the model registry, ``MODEL_CLASSES``: the JAX package's
  11 ids in its order, each model's ``NAME``, training regime and whether it
  takes actions.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vp_suite_tpu.model_blocks as jax_blocks
from vp_suite_tpu.models import MODEL_CLASSES as JAX_MODELS
from vp_suite_tpu.models.precipitation_nowcasting.ef_blocks import ConvStage as JaxConvStage
import vp_suite_tpu_torch.model_blocks as blocks
from vp_suite_tpu_torch.models import MODEL_CLASSES
from vp_suite_tpu_torch.models.precipitation_nowcasting.ef_blocks import ConvStage
from vp_suite_tpu_torch.nn.layers import max_pool_2d
from vp_suite_tpu_torch.utils.jax_params import block_params_to_jax

torch.set_num_threads(1)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _randomized(block, seed=1):
    r"""``block`` with its parameters drawn from ``seed`` (GroupNorm affines
    away from 1 and 0)."""
    g = torch.Generator().manual_seed(seed)
    for module in block.modules():
        if module is not block and hasattr(module, "reset_parameters"):
            module.reset_parameters(g)
    with torch.no_grad():
        for p in block.parameters():
            if p.dim() == 1:
                p.add_(torch.randn(p.shape, generator=g) * 0.1)
    return block


def _apply(jax_block, block, *args, method=None):
    with jax.default_matmul_precision("highest"):
        out = jax_block.apply({"params": block_params_to_jax(block)},
                              *map(jnp.asarray, args), method=method)
    return jax.tree.map(np.asarray, out)


BLOCKS = {
    "encoder": (lambda: blocks.Encoder(3, 16), lambda: jax_blocks.Encoder(3, 16),
                (2, 32, 32, 3), (2, 4, 4, 16)),
    "decoder": (lambda: blocks.Decoder(16, (3, 32, 32)),
                lambda: jax_blocks.Decoder(16, (3, 32, 32)), (2, 4, 4, 16), (2, 32, 32, 3)),
    "decoder_shrinks": (lambda: blocks.Decoder(16, (3, 35, 35)),
                        lambda: jax_blocks.Decoder(16, (3, 35, 35)), (2, 5, 5, 16),
                        (2, 35, 35, 3)),
    "autoencoder": (lambda: blocks.Autoencoder((3, 35, 35), 16),
                    lambda: jax_blocks.Autoencoder((3, 35, 35), 16), (2, 35, 35, 3),
                    (2, 35, 35, 3)),
    "dcgan_encoder": (lambda: blocks.DCGANEncoder(3, 16), lambda: jax_blocks.DCGANEncoder(3, 16),
                      (2, 16, 16, 3), (2, 4, 4, 32)),
    "dcgan_decoder": (lambda: blocks.DCGANDecoder((16, 16), 3, 16),
                      lambda: jax_blocks.DCGANDecoder((16, 16), 3, 16), (2, 4, 4, 32),
                      (2, 16, 16, 3)),
    "dcgan_decoder_resized": (lambda: blocks.DCGANDecoder((13, 18), 3, 16),
                              lambda: jax_blocks.DCGANDecoder((13, 18), 3, 16), (2, 4, 4, 32),
                              (2, 13, 18, 3)),
    "encoder_split": (lambda: blocks.EncoderSplit(16, 32), lambda: jax_blocks.EncoderSplit(16, 32),
                      (2, 6, 6, 16), (2, 6, 6, 32)),
    "decoder_split": (lambda: blocks.DecoderSplit(16, 32), lambda: jax_blocks.DecoderSplit(16, 32),
                      (2, 6, 6, 32), (2, 6, 6, 16)),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_jax(name):
    make, make_jax, in_shape, out_shape = BLOCKS[name]
    block = _randomized(make())
    x = _rand(2, *in_shape) if name != "autoencoder" else np.abs(_rand(2, *in_shape))
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    want = _apply(make_jax(), block, x)
    assert got.shape == want.shape == out_shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_autoencoder_halves_and_encoded_shape_match_jax():
    block = _randomized(blocks.Autoencoder((3, 35, 35), 16))
    jblock = jax_blocks.Autoencoder((3, 35, 35), 16)
    assert block.encoded_shape == jblock.encoded_shape == (1, 16, 5, 5)
    x = np.abs(_rand(3, 2, 35, 35, 3))
    with torch.no_grad():
        code = block.encode(torch.from_numpy(x))
        frames = block.decode(code)
    want_code = _apply(jblock, block, x, method=jax_blocks.Autoencoder.encode)
    want_frames = _apply(jblock, block, code.numpy(), method=jax_blocks.Autoencoder.decode)
    np.testing.assert_allclose(code.numpy(), want_code, rtol=1e-4, atol=1e-4)
    # the L2 normalization over the width axis: unit norm along it wherever not all zero
    norms = np.sqrt((code.numpy() ** 2).sum(axis=-2))
    assert np.all((np.abs(norms - 1) < 1e-5) | (norms == 0)) and (norms > 0).any()
    np.testing.assert_allclose(frames.numpy(), want_frames, rtol=1e-4, atol=1e-4)


NDRPLZ = dict(input_dim=3, hidden_dim=[4, 6], kernel_size=[(3, 3), (5, 5)], num_layers=2)


@pytest.mark.parametrize("return_all_layers", [False, True], ids=["last_layer", "all_layers"])
@pytest.mark.parametrize("batch_first", [False, True], ids=["time_major", "batch_first"])
def test_conv_lstm_ndrplz_matches_jax(batch_first, return_all_layers):
    kw = dict(NDRPLZ, batch_first=batch_first, return_all_layers=return_all_layers)
    block = _randomized(blocks.ConvLSTMNdrplz(**kw))
    x = _rand(4, *((2, 3) if batch_first else (3, 2)), 6, 5, 3)
    with torch.no_grad():
        outs, states = block(torch.from_numpy(x))
    want_outs, want_states = _apply(jax_blocks.ConvLSTMNdrplz(**kw, remat=False), block, x)
    n = 2 if return_all_layers else 1
    assert len(outs) == len(states) == len(want_outs) == len(want_states) == n
    for got, want, hid in zip(outs, want_outs, [4, 6][-n:]):
        assert got.shape == want.shape == (2, 3, 6, 5, hid)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    for got, want in zip(states, want_states):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)


def test_conv_lstm_ndrplz_refusals_match_jax():
    bad = dict(NDRPLZ, hidden_dim=[4, 6, 8])
    x = jnp.zeros((3, 2, 6, 5, 3))
    with pytest.raises(ValueError, match="Inconsistent list length"):
        jax.eval_shape(lambda x: jax_blocks.ConvLSTMNdrplz(**bad).init(jax.random.PRNGKey(0), x),
                       x)
    with pytest.raises(ValueError, match="Inconsistent list length"):
        blocks.ConvLSTMNdrplz(**bad)
    state = [(jnp.zeros((2, 6, 5, 4)),) * 2]
    with pytest.raises(NotImplementedError, match="stateful"):
        jax.eval_shape(lambda x: jax_blocks.ConvLSTMNdrplz(**NDRPLZ).init(
            jax.random.PRNGKey(0), x, hidden_state=state), x)
    with pytest.raises(NotImplementedError, match="stateful"):
        blocks.ConvLSTMNdrplz(**NDRPLZ)(torch.zeros((3, 2, 6, 5, 3)),
                                        hidden_state=[(torch.zeros((2, 6, 5, 4)),) * 2])


STAGE = (("conv1_leaky_1", (3, 8, 3, 1, 1)), ("pool1", (2, 2, 0)),
         ("conv2_relu_1", (8, 16, 3, 1, 1)), ("pool2", (3, 2, 1)),
         ("identity", ()), ("deconv3_leaky_1", (16, 8, 4, 2, 1)))


def test_conv_stage_with_pools_matches_jax():
    stage = _randomized(ConvStage(STAGE))
    x = _rand(5, 2, 17, 14, 3)
    with torch.no_grad():
        got = stage(torch.from_numpy(x)).numpy()
    want = _apply(JaxConvStage(STAGE), stage, x)
    assert got.shape == want.shape == (2, 8, 8, 8)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("window,strides,padding",
                         [(2, None, 0), (3, 2, 1), ((3, 2), (1, 2), (1, 0))])
def test_max_pool_strides_and_padding_match_flax(window, strides, padding):
    x = _rand(6, 2, 3, 9, 8, 4)
    got = max_pool_2d(torch.from_numpy(x), window, strides, padding).numpy()
    w = (window, window) if isinstance(window, int) else window
    s = w if strides is None else ((strides, strides) if isinstance(strides, int) else strides)
    p = (padding, padding) if isinstance(padding, int) else padding
    want = fnn.max_pool(jnp.asarray(x.reshape(6, 9, 8, 4)), w, s, [(p[0], p[0]), (p[1], p[1])])
    np.testing.assert_array_equal(got, np.asarray(want).reshape(2, 3, *want.shape[1:]))


def test_registry_matches_jax():
    got = [(c.__name__, c.NAME) for c in blocks.MODEL_BLOCK_CLASSES]
    want = [(c.__name__, c.NAME) for c in jax_blocks.MODEL_BLOCK_CLASSES]
    assert got == want and len(got) == 12


def test_model_registry_matches_jax():
    def described(registry):
        return [(k, c.NAME, c.TRAIN_REGIME, c.CAN_HANDLE_ACTIONS) for k, c in registry.items()]
    assert described(MODEL_CLASSES) == described(JAX_MODELS) and len(MODEL_CLASSES) == 11
