r"""Visualisations: sequence videos with coloured context and prediction
borders, multi-model comparison images with a ``vis_info.txt`` manifest, and
a debug histogram; the JAX package's ``utils/visualization.py``.

All frames are uint8 ``[t, h, w, c]`` (postprocessed, channels last). The
card's machine has no ``imageio``, PIL, cv2 or matplotlib, so the files are
written by the port's own encoders (:mod:`vp_suite_tpu_torch.utils.image_io`):
GIFs by :func:`~vp_suite_tpu_torch.utils.image_io.write_gif` (a frame of at
most 256 colours exactly, a frame of more quantised) and PNGs by
:func:`~vp_suite_tpu_torch.utils.image_io.write_png`. No mp4 writer exists on
either machine: ``vis_mode="mp4"`` writes a GIF and says so, as the JAX
package does when its mp4 write fails. The histogram is drawn as bars in
numpy, with its minimum, maximum and mean printed (the JAX version writes
them in the plot's title; the card's machine has no fonts).
"""
from pathlib import Path

import numpy as np
import torch

from vp_suite_tpu_torch.utils.image_io import write_gif, write_png

COLORS = {"green": (40, 180, 40), "red": (210, 40, 40), "yellow": (210, 210, 40),
          "none": None}


def add_borders(trajs, context_frames: int, border: int = 2):
    r"""Frames with a green border for the context and a red one for the
    predictions; greyscale sequences are made RGB first, so that the borders
    keep their colours."""
    trajs = np.asarray(trajs)
    t, h, w, c = trajs.shape
    if c < 3:
        trajs = np.repeat(trajs[..., :1], 3, axis=-1)
        c = 3
    out = np.zeros((t, h + 2 * border, w + 2 * border, c), dtype=np.uint8)
    for i in range(t):
        color = COLORS["green"] if i < context_frames else COLORS["red"]
        out[i, :, :] = np.asarray(color, dtype=np.uint8)[:c]
        out[i, border:-border, border:-border] = trajs[i]
    return out


def compose_vid_frames(context_frames, **trajs):
    r"""The frames :func:`save_vid_vis` writes: the named sequences with
    their borders side by side, 4 black columns apart, as long as the shortest."""
    seqs = [add_borders(v, context_frames) for v in trajs.values()]
    t = min(s.shape[0] for s in seqs)
    gap = 4
    h = max(s.shape[1] for s in seqs)
    frames = []
    for i in range(t):
        row = []
        for s in seqs:
            fr = s[i]
            if fr.shape[0] < h:
                fr = np.concatenate([fr, np.zeros((h - fr.shape[0], *fr.shape[1:]), np.uint8)])
            row.append(fr)
            row.append(np.zeros((h, gap, fr.shape[2]), np.uint8))
        frames.append(np.concatenate(row[:-1], axis=1))
    return np.stack(frames)


def save_vid_vis(out_fp, context_frames, mode="gif", fps=4, **trajs):
    r"""Saves the named uint8 ``[t, h, w, c]`` sequences (e.g. ``GT=...,
    Pred=...``) side by side as a looping GIF of ``fps`` frames a second;
    ``mode="mp4"`` writes a GIF too (there is no mp4 writer) and prints that
    it did. Returns the file's path (``.gif`` added where missing)."""
    frames = compose_vid_frames(context_frames, **trajs)
    out_fp = str(out_fp)
    if mode == "mp4":
        out_fp = out_fp[:-4] if out_fp.endswith(".mp4") else out_fp
        print(f"no mp4 writer: writing {out_fp}.gif instead")
    if not out_fp.endswith(".gif"):
        out_fp += ".gif"
    write_gif(out_fp, frames, fps=fps)
    return out_fp


def get_vis_from_model(dataset, data, predict_fn, context_frames, device="cpu"):
    r"""Runs ``predict_fn`` (``batch -> (preds, ...)``, a batch of one
    sequence on ``device``) on a dataset item; returns the postprocessed
    uint8 ``(input_vis, pred_vis)``, ``pred_vis`` the context frames followed
    by the predictions."""
    batch = {k: torch.as_tensor(np.asarray(data[k]))[None].to(device)
             for k in ("frames", "actions")}
    preds, _ = predict_fn(batch)
    input_vis = dataset.postprocess(np.asarray(data["frames"]))
    pred_vis = dataset.postprocess(preds[0].float().cpu().numpy())
    return input_vis, np.concatenate([input_vis[:context_frames], pred_vis], axis=0)


def visualize_vid(dataset, context_frames, pred_frames, predict_fn, out_path,
                  vis_idx=None, n_vis=5, vis_mode="gif", device="cpu"):
    r"""Saves ground-truth-beside-prediction videos ``vis_{i}.gif`` of
    ``n_vis`` items drawn by ``default_rng(0)`` (or of ``vis_idx``); returns
    their paths."""
    out_path = Path(out_path)
    out_path.mkdir(parents=True, exist_ok=True)
    n = len(dataset)
    if vis_idx is None:
        vis_idx = np.random.default_rng(0).choice(n, size=min(n_vis, n), replace=False)
    out_fps = []
    for i, idx in enumerate(vis_idx):
        data = dataset[int(idx)]
        gt_vis, pred_vis = get_vis_from_model(dataset, data, predict_fn, context_frames, device)
        out_fps.append(save_vid_vis(out_path / f"vis_{i}", context_frames, mode=vis_mode,
                                    GT=gt_vis[:context_frames + pred_frames], Pred=pred_vis))
    return out_fps


def compose_compare_img(ground_truth_vis, preds_vis):
    r"""The comparison image :func:`save_frame_compare_img` writes: the
    ground truth's frames in a row, each model's below (padded with black to
    the ground truth's width)."""
    t = ground_truth_vis.shape[0]
    gt_row = np.concatenate([ground_truth_vis[i] for i in range(t)], axis=1)
    rows = [gt_row]
    for pred_vis in preds_vis:
        row = np.concatenate([pred_vis[i] for i in range(min(t, pred_vis.shape[0]))], axis=1)
        if row.shape[1] < gt_row.shape[1]:
            pad = np.zeros((row.shape[0], gt_row.shape[1] - row.shape[1], row.shape[2]), np.uint8)
            row = np.concatenate([row, pad], axis=1)
        rows.append(row)
    return np.concatenate(rows, axis=0)


def save_frame_compare_img(out_fp, context_frames, ground_truth_vis, preds_vis,
                           vis_context_frame_idx=None):
    r"""Writes the multi-model comparison image as a PNG; returns its path.
    ``context_frames`` and ``vis_context_frame_idx`` are taken, and unused,
    as in the JAX package."""
    write_png(out_fp, compose_compare_img(ground_truth_vis, preds_vis))
    return out_fp


def visualize_sequences(dataset, context_frames, pred_frames, model_predict_fns, out_path,
                        n_vis=5, vis_mode="gif", vis_compare=False, vis_context_frame_idx=None,
                        device="cpu"):
    r"""For ``n_vis`` items drawn by ``default_rng(0)``: one video per model
    (``vis_{i}_{model name}.gif``), with ``vis_compare`` a comparison image
    ``compare_{i}.png``, and a manifest ``vis_info.txt`` of the items drawn."""
    out_path = Path(out_path)
    out_path.mkdir(parents=True, exist_ok=True)
    n = len(dataset)
    vis_idx = np.random.default_rng(0).choice(n, size=min(n_vis, n), replace=False)
    info_lines = []
    for i, idx in enumerate(vis_idx):
        data = dataset[int(idx)]
        gt_vis = dataset.postprocess(np.asarray(data["frames"]))
        preds_vis = []
        for model_name, predict_fn in model_predict_fns.items():
            _, pred_vis = get_vis_from_model(dataset, data, predict_fn, context_frames, device)
            preds_vis.append(pred_vis)
            save_vid_vis(out_path / f"vis_{i}_{model_name}", context_frames, mode=vis_mode,
                         GT=gt_vis, Pred=pred_vis)
        if vis_compare:
            save_frame_compare_img(out_path / f"compare_{i}.png", context_frames, gt_vis,
                                   preds_vis, vis_context_frame_idx)
        info_lines.append(f"vis_{i}: dataset idx {idx}, origin: {data.get('origin', '?')}")
    with open(out_path / "vis_info.txt", "w") as f:
        f.write("\n".join(info_lines) + "\n")


HIST_SIZE = (480, 640)            #: (height, width) of the histogram image
HIST_BAR = (31, 119, 180)         #: the bars' RGB colour


def draw_hist(arr):
    r"""The histogram image of ``arr``'s values: 100 bars (6 pixels wide, 1
    apart) in a white 480 x 640 RGB image with black axes, each bar as tall
    as its count over the largest count."""
    bins = 100
    counts, _ = np.histogram(np.asarray(arr, dtype=np.float64).ravel(), bins=bins)
    h, w = HIST_SIZE
    img = np.full((h, w, 3), 255, np.uint8)
    left, bottom, top = 20, h - 20, 20
    img[top:bottom + 1, left - 1] = 0
    img[bottom, left - 1:left + 7 * bins] = 0
    heights = np.rint(counts / max(counts.max(), 1) * (bottom - top)).astype(int)
    for i, bar in enumerate(heights):
        if bar:
            img[bottom - bar:bottom, left + 7 * i:left + 7 * i + 6] = HIST_BAR
    return img


def save_arr_hist(arr, out_fp="debug_hist.png"):
    r"""Writes the 100-bin histogram of ``arr``'s values (:func:`draw_hist`)
    as a PNG and prints its minimum, maximum and mean."""
    arr = np.asarray(arr)
    write_png(out_fp, draw_hist(arr))
    print(f"{out_fp}: min={arr.min():.4f} max={arr.max():.4f} mean={arr.mean():.4f}")
