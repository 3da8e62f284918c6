r"""EF-TrajGRU (Shi et al.): the Encoder-Forecaster stack with TrajGRU blocks
and the reference vp-suite's default hyperparameters (intended for 64x64
inputs; hidden states 64x64x64, 32x32x96 and 16x16x96, L=13 flows in every
block).

The blocks' state is one tensor ``h``, where EF-ConvLSTM's is ``(h, c)``; the
stack in :mod:`~vp_suite_tpu_torch.models.precipitation_nowcasting.ef_blocks`
passes states through as they come. The model's ``remat`` goes to every
block, as in the JAX package (see
:mod:`vp_suite_tpu_torch.model_blocks.traj_gru`); its ``scan_unroll`` has no
counterpart.
"""
from vp_suite_tpu_torch.model_blocks.traj_gru import TrajGRU
from vp_suite_tpu_torch.models.precipitation_nowcasting.ef_blocks import EncoderForecasterBase


class EF_TrajGRU(EncoderForecasterBase):
    NAME = "EF-TrajGRU (Shi et al.)"
    PAPER_REFERENCE = "https://arxiv.org/abs/1706.03458"
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

    enc_rnn_z = (0.0, 0.0, 0.0)
    enc_rnn_L = (13, 13, 13)
    enc_rnn_i2h_k = ((3, 3), (3, 3), (3, 3))
    enc_rnn_i2h_s = ((1, 1), (1, 1), (1, 1))
    enc_rnn_i2h_p = ((1, 1), (1, 1), (1, 1))
    enc_rnn_h2h_k = ((5, 5), (5, 5), (3, 3))
    enc_rnn_h2h_d = ((1, 1), (1, 1), (1, 1))

    dec_rnn_z = (0.0, 0.0, 0.0)
    dec_rnn_L = (13, 13, 13)
    dec_rnn_i2h_k = ((3, 3), (3, 3), (3, 3))
    dec_rnn_i2h_s = ((1, 1), (1, 1), (1, 1))
    dec_rnn_i2h_p = ((1, 1), (1, 1), (1, 1))
    dec_rnn_h2h_k = ((3, 3), (5, 5), (5, 5))
    dec_rnn_h2h_d = ((1, 1), (1, 1), (1, 1))

    final_conv_1_name = "identity"
    final_conv_1_c = 16
    final_conv_1_k = 3
    final_conv_1_s = 1
    final_conv_1_p = 1

    final_conv_2_name = "conv3_3"
    final_conv_2_k = 1
    final_conv_2_s = 1
    final_conv_2_p = 0

    act_slope = 0.2

    def _rnn(self, kind, n, in_c, enc_c, state_h, state_w):
        r"""The TrajGRU block of stage ``n`` with the ``kind`` ('enc' or 'dec')
        per-layer hyperparameters."""
        p = lambda name: getattr(self, f"{kind}_rnn_{name}")[n]
        return TrajGRU(in_channels=in_c, enc_channels=enc_c, state_h=state_h, state_w=state_w,
                       zoneout=p("z"), L=p("L"), i2h_kernel=p("i2h_k"), i2h_stride=p("i2h_s"),
                       i2h_pad=p("i2h_p"), h2h_kernel=p("h2h_k"), h2h_dilate=p("h2h_d"),
                       act_slope=self.act_slope, remat=self.remat)

    def _build_encoder_decoder(self):
        r"""Conv specs and TrajGRU blocks per stage (reference
        ``ef_traj_gru.py:77-119``)."""
        layer_in_c = self.img_c
        enc_convs, enc_rnns = [], []
        for n in range(self.num_layers):
            layer_mid_c = self.enc_c[2 * n]
            layer_out_c = self.enc_c[2 * n + 1]
            enc_convs.append({
                self.enc_conv_names[n]: (layer_in_c, layer_mid_c, self.enc_conv_k[n],
                                         self.enc_conv_s[n], self.enc_conv_p[n])
            })
            enc_rnns.append(self._rnn("enc", n, layer_mid_c, layer_out_c,
                                      self.enc_rnn_state_h[n], self.enc_rnn_state_w[n]))
            layer_in_c = layer_out_c

        dec_convs, dec_rnns = [], []
        for n in range(self.num_layers):
            layer_mid_c = self.dec_c[2 * n]
            layer_out_c = self.dec_c[2 * n + 1]
            dec_rnns.append(self._rnn("dec", n, layer_in_c, layer_mid_c,
                                      self.dec_rnn_state_h[n], self.dec_rnn_state_w[n]))
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
