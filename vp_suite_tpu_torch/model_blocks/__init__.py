r"""The model block registry (the JAX package's ``model_blocks/__init__.py``):
the same blocks, in the same order in ``MODEL_BLOCK_CLASSES``. Where the JAX
package exports a cell as a parameter factory (``make_st_lstm_cell``,
``make_phycell_cell``), the port exports the cell's module
(``SpatioTemporalLSTMCell``, ``PhyCellCell`` and its stack ``PhyCell``)."""
from vp_suite_tpu_torch.model_blocks.conv_lstm_shi import ConvLSTMShi
from vp_suite_tpu_torch.model_blocks.conv_lstm_ndrplz import (
    ConvLSTMNdrplz, ConvLSTMCellNdrplz, convlstm_ndrplz_gates)
from vp_suite_tpu_torch.model_blocks.traj_gru import TrajGRU, conv_rnn_state_size
from vp_suite_tpu_torch.model_blocks.predrnn import SpatioTemporalLSTMCell
from vp_suite_tpu_torch.model_blocks.phydnet import (
    PhyCellCell, PhyCell, k2m, k2m_matrices, moment_loss, moment_constraints,
    find_divisor_for_group_norm)
from vp_suite_tpu_torch.model_blocks.conv import (
    DoubleConv2d, DoubleConv3d, DCGANConv, DCGANConvTranspose)
from vp_suite_tpu_torch.model_blocks.enc import (
    Autoencoder, Encoder, Decoder, DCGANEncoder, DCGANDecoder,
    EncoderSplit, DecoderSplit)

MODEL_BLOCK_CLASSES = [
    ConvLSTMShi,
    ConvLSTMNdrplz,
    TrajGRU,
    DoubleConv2d,
    DoubleConv3d,
    DCGANConv,
    DCGANConvTranspose,
    Autoencoder,
    Encoder,
    Decoder,
    DCGANEncoder,
    DCGANDecoder,
]
