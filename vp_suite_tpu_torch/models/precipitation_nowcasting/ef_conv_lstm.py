r"""EF-ConvLSTM (Shi et al.): the Encoder-Forecaster stack with Shi ConvLSTM
blocks and the reference vp-suite's default hyperparameters (intended for
64x64 inputs; hidden states 64x64x64, 32x32x96 and 16x16x96).

The JAX package's ``use_pallas``, ``remat_policy`` and ``scan_unroll`` have no
counterpart (see :mod:`vp_suite_tpu_torch.model_blocks.conv_lstm_shi`).
"""
from vp_suite_tpu_torch.model_blocks.conv_lstm_shi import ConvLSTMShi
from vp_suite_tpu_torch.models.precipitation_nowcasting.ef_blocks import EncoderForecasterBase


class EF_ConvLSTM(EncoderForecasterBase):
    NAME = "EF-ConvLSTM (Shi et al.)"
    PAPER_REFERENCE = "https://arxiv.org/abs/1506.04214"
    CODE_REFERENCE = "https://github.com/Hzzone/Precipitation-Nowcasting"
    MATCHES_REFERENCE = "Yes"

    num_layers = 3
    enc_c = (16, 64, 64, 96, 96, 96)
    dec_c = (96, 96, 96, 96, 64, 16)

    enc_conv_names = ("conv1_leaky_1", "conv2_leaky_1", "conv3_leaky_1")
    enc_conv_k = (3, 3, 3)
    enc_conv_s = (1, 2, 2)
    enc_conv_p = (1, 1, 1)

    dec_conv_names = ("deconv1_leaky_1", "deconv2_leaky_1", "deconv3_leaky_1")
    dec_conv_k = (4, 4, 3)
    dec_conv_s = (2, 2, 1)
    dec_conv_p = (1, 1, 1)

    enc_rnn_k = (3, 3, 3)
    enc_rnn_s = (1, 1, 1)
    enc_rnn_p = (1, 1, 1)

    dec_rnn_k = (3, 3, 3)
    dec_rnn_s = (1, 1, 1)
    dec_rnn_p = (1, 1, 1)

    final_conv_1_name = "identity"
    final_conv_1_c = 16
    final_conv_1_k = 3
    final_conv_1_s = 1
    final_conv_1_p = 1

    final_conv_2_name = "conv3_3"
    final_conv_2_k = 1
    final_conv_2_s = 1
    final_conv_2_p = 0

    use_fused_scan = False  #: run each cell's whole recurrence as one CUDA kernel launch
    hoist_i2h = False       #: batch the cells' input-half convs over time

    def _build_encoder_decoder(self):
        r"""Conv specs and ConvLSTM blocks per stage (reference
        ``ef_conv_lstm.py:70-108``)."""
        cell_kw = dict(use_fused_scan=self.use_fused_scan, hoist_i2h=self.hoist_i2h)
        layer_in_c = self.img_c
        enc_convs, enc_rnns = [], []
        for n in range(self.num_layers):
            layer_mid_c = self.enc_c[2 * n]
            layer_out_c = self.enc_c[2 * n + 1]
            enc_convs.append({
                self.enc_conv_names[n]: (layer_in_c, layer_mid_c, self.enc_conv_k[n],
                                         self.enc_conv_s[n], self.enc_conv_p[n])
            })
            enc_rnns.append(ConvLSTMShi(
                in_channels=layer_mid_c, enc_channels=layer_out_c,
                state_h=self.enc_rnn_state_h[n], state_w=self.enc_rnn_state_w[n],
                kernel_size=self.enc_rnn_k[n], stride=self.enc_rnn_s[n],
                padding=self.enc_rnn_p[n], **cell_kw))
            layer_in_c = layer_out_c

        dec_convs, dec_rnns = [], []
        for n in range(self.num_layers):
            layer_mid_c = self.dec_c[2 * n]
            layer_out_c = self.dec_c[2 * n + 1]
            dec_rnns.append(ConvLSTMShi(
                in_channels=layer_in_c, enc_channels=layer_mid_c,
                state_h=self.dec_rnn_state_h[n], state_w=self.dec_rnn_state_w[n],
                kernel_size=self.dec_rnn_k[n], stride=self.dec_rnn_s[n],
                padding=self.dec_rnn_p[n], **cell_kw))
            dec_conv_dict = {
                self.dec_conv_names[n]: (layer_mid_c, layer_out_c, self.dec_conv_k[n],
                                         self.dec_conv_s[n], self.dec_conv_p[n])
            }
            if n == self.num_layers - 1:
                dec_conv_dict[self.final_conv_1_name] = (
                    layer_out_c, self.final_conv_1_c, self.final_conv_1_k,
                    self.final_conv_1_s, self.final_conv_1_p)
                dec_conv_dict[self.final_conv_2_name] = (
                    self.final_conv_1_c, self.img_c, self.final_conv_2_k,
                    self.final_conv_2_s, self.final_conv_2_p)
            dec_convs.append(dec_conv_dict)
            layer_in_c = layer_out_c
        return enc_convs, enc_rnns, dec_convs, dec_rnns
