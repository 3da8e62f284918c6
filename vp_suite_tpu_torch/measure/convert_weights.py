r"""One-time conversion of pretrained PyTorch weights of the perceptual nets
(LPIPS's AlexNet and heads, FVD's I3D) into the ``.npz`` files that the
port's measures read (``measure/lpips_net.py``, ``measure/fvd/i3d.py``); the
JAX package's ``measure/convert_weights.py``, whose files these are byte for
byte. Nothing is downloaded: the checkpoint must be on disk::

    python -m vp_suite_tpu_torch.measure.convert_weights --i3d /path/to/rgb_imagenet.pt
    python -m vp_suite_tpu_torch.measure.convert_weights --lpips /path/to/lpips_alex.pth

The files land in ``vp_suite_tpu_torch/resources/``.
"""
import argparse
from pathlib import Path

import numpy as np
import torch

RESOURCES = Path(__file__).parent.parent / "resources"


def convert_i3d(ckpt_path, out_fp=None):
    r"""The torch I3D ``state_dict`` (pytorch_i3d's names) as a flat dict of
    DHWIO kernels and BatchNorm statistics, written with ``np.savez``."""
    sd = torch.load(ckpt_path, map_location="cpu")
    out = {}

    def conv(prefix_t, prefix_j, bn=True, bias=False):
        w = sd[f"{prefix_t}.conv3d.weight"].numpy()  # [out, in, t, h, w]
        out[f"{prefix_j}_kernel"] = w.transpose(2, 3, 4, 1, 0)
        if bias and f"{prefix_t}.conv3d.bias" in sd:
            out[f"{prefix_j}_bias"] = sd[f"{prefix_t}.conv3d.bias"].numpy()
        if bn:
            out[f"{prefix_j}_bn_mean"] = sd[f"{prefix_t}.bn.running_mean"].numpy()
            out[f"{prefix_j}_bn_var"] = sd[f"{prefix_t}.bn.running_var"].numpy()
            out[f"{prefix_j}_bn_scale"] = sd[f"{prefix_t}.bn.weight"].numpy()
            out[f"{prefix_j}_bn_bias"] = sd[f"{prefix_t}.bn.bias"].numpy()

    for name in ["Conv3d_1a_7x7", "Conv3d_2b_1x1", "Conv3d_2c_3x3"]:
        conv(name, name)
    for name in ["Mixed_3b", "Mixed_3c", "Mixed_4b", "Mixed_4c", "Mixed_4d",
                 "Mixed_4e", "Mixed_4f", "Mixed_5b", "Mixed_5c"]:
        for branch in ["b0", "b1a", "b1b", "b2a", "b2b", "b3b"]:
            conv(f"{name}.{branch}", f"{name}_{branch}")
    conv("logits", "logits", bn=False, bias=True)

    out_fp = out_fp or RESOURCES / "i3d_rgb_imagenet.npz"
    RESOURCES.mkdir(parents=True, exist_ok=True)
    np.savez(out_fp, **out)
    print(f"saved {len(out)} arrays to {out_fp}")


def convert_lpips(ckpt_path, out_fp=None):
    r"""torchvision AlexNet's ``features.<i>.weight/bias`` and LPIPS's linear
    heads ``lin<i>.model.1.weight`` as a flat dict of HWIO kernels, biases
    and head vectors, written with ``np.savez``."""
    sd = torch.load(ckpt_path, map_location="cpu")
    out = {}
    conv_idx = [0, 3, 6, 8, 10]   # AlexNet's conv layers in .features
    for i, idx in enumerate(conv_idx):
        w = sd[f"features.{idx}.weight"].numpy()  # [out, in, kh, kw]
        out[f"conv{i}_kernel"] = w.transpose(2, 3, 1, 0)
        out[f"conv{i}_bias"] = sd[f"features.{idx}.bias"].numpy()
        lw = sd[f"lin{i}.model.1.weight"].numpy()  # [1, c, 1, 1]
        out[f"lin{i}"] = lw.reshape(-1)
    out_fp = out_fp or RESOURCES / "lpips_alexnet.npz"
    RESOURCES.mkdir(parents=True, exist_ok=True)
    np.savez(out_fp, **out)
    print(f"saved {len(out)} arrays to {out_fp}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--i3d", type=str, default=None)
    parser.add_argument("--lpips", type=str, default=None)
    args = parser.parse_args(argv)
    if args.i3d:
        convert_i3d(args.i3d)
    if args.lpips:
        convert_lpips(args.lpips)
    if not args.i3d and not args.lpips:
        print("nothing to do (pass --i3d and/or --lpips)")


if __name__ == "__main__":
    main()
