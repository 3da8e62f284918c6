r"""The port's visualisations (``utils/visualization.py``) and its GIF and PNG
writers (``utils/image_io.py``) against the JAX package's and PIL.

- On the same uint8 inputs, the frames of a sequence video and the
  comparison image are bit for bit those that the JAX package hands to
  ``imageio`` (captured by patching ``imageio.v2``'s writers).
- ``write_png`` files read back bit for bit by PIL and by ``read_png``;
  ``write_gif`` files by PIL and ``read_gif``: exact for frames of at most
  256 colours, a looping NETSCAPE2.0 block and 1000/fps ms a frame; frames of
  more colours no worse in mean absolute error than the GIF that the JAX
  package's ``imageio`` path writes here.
- ``VPSuite.test`` with visualisation (two items, ``vis_compare``) on
  EF-ConvLSTM with the JAX parameters carried over: the same files as the
  JAX suite's, the same items (on-the-fly Moving MNIST, ``reset_rng`` first),
  every frame within one grey level; ``train`` writes ``vis_ep_{NNN}``;
  ``vis_mode="mp4"`` writes GIFs; ``save_arr_hist``'s bars.
"""
import functools

import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch
from PIL import Image

import vp_suite_tpu.defaults as jax_defaults
import vp_suite_tpu.utils.visualization as jax_vis
import vp_suite_tpu.vpsuite as jax_vpsuite
import vp_suite_tpu_torch.utils.visualization as vis
import vp_suite_tpu_torch.vpsuite as port_vpsuite
from vp_suite_tpu_torch import VPSuite
from vp_suite_tpu_torch.defaults import SETTINGS
from vp_suite_tpu_torch.utils.image_io import read_gif, read_png, write_gif, write_png
from vp_suite_tpu_torch.utils.jax_params import load_jax_params

torch.set_num_threads(1)

MMF = dict(split="test", img_size=16, digit_source="synthetic", n_seqs=4)
TEST = dict(brief_test=True, context_frames=2, pred_frames=2, metrics=["mse"], no_vis=False,
            vis_compare=True, n_vis=2, no_wandb=True)


def _uint8(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _pil_frames(fp):
    im = Image.open(fp)
    frames = []
    for k in range(im.n_frames):
        im.seek(k)
        frames.append(np.asarray(im.convert("RGB")))
    return np.stack(frames), im.info


class _Recorder:
    r"""Wraps a writer: records ``(file name, array)`` of each call, then
    writes as the writer does."""

    def __init__(self, write, array_of):
        self.write, self.array_of, self.calls = write, array_of, []

    def __call__(self, fp, arr, *args, **kwargs):
        self.calls.append((str(fp).rsplit("/", 1)[-1], np.asarray(self.array_of(arr))))
        return self.write(fp, arr, *args, **kwargs)


def _jax_recorders(mp):
    gifs = _Recorder(imageio.mimsave, np.stack)
    pngs = _Recorder(imageio.imwrite, np.asarray)
    mp.setattr(imageio, "mimsave", gifs)
    mp.setattr(imageio, "imwrite", pngs)
    return gifs, pngs


def _port_recorders(mp):
    gifs = _Recorder(write_gif, np.stack)
    pngs = _Recorder(write_png, np.asarray)
    mp.setattr(vis, "write_gif", gifs)
    mp.setattr(vis, "write_png", pngs)
    return gifs, pngs


@pytest.mark.parametrize("channels", [1, 3])
def test_vid_frames_match_jax(tmp_path, monkeypatch, channels):
    gt, pred = _uint8(0, 5, 12, 10, channels), _uint8(1, 5, 12, 10, channels)
    gifs, _ = _jax_recorders(monkeypatch)
    jax_vis.save_vid_vis(tmp_path / "jax", 2, GT=gt, Pred=pred)
    (_, want), = gifs.calls
    got = vis.compose_vid_frames(2, GT=gt, Pred=pred)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert np.array_equal(vis.add_borders(gt, 2), jax_vis.add_borders(gt, 2))


def test_compare_img_matches_jax(tmp_path, monkeypatch):
    gt = _uint8(2, 4, 8, 8, 3)
    preds = [_uint8(3, 4, 8, 8, 3), _uint8(4, 3, 8, 8, 3)]
    _, pngs = _jax_recorders(monkeypatch)
    jax_vis.save_frame_compare_img(tmp_path / "jax.png", 2, gt, preds)
    (_, want), = pngs.calls
    fp = vis.save_frame_compare_img(tmp_path / "port.png", 2, gt, preds)
    assert np.array_equal(vis.compose_compare_img(gt, preds), want)
    assert np.array_equal(read_png(fp), want) and np.array_equal(np.asarray(Image.open(fp)), want)


@pytest.mark.parametrize("shape", [(7, 9), (7, 9, 1), (7, 9, 2), (7, 9, 3), (7, 9, 4)])
def test_png_reads_back(tmp_path, shape):
    img = _uint8(5, *shape)
    write_png(tmp_path / "a.png", img)
    want = img[..., 0] if img.ndim == 3 and img.shape[-1] == 1 else img
    assert np.array_equal(np.asarray(Image.open(tmp_path / "a.png")), want)
    assert np.array_equal(read_png(tmp_path / "a.png"), want)


def test_gif_of_few_colours_is_exact(tmp_path):
    rng = np.random.default_rng(6)
    frames = (rng.integers(0, 6, (4, 17, 23, 3)) * 51).astype(np.uint8)   # 216 colours
    frames[2] = 7   # one flat frame
    write_gif(tmp_path / "a.gif", frames, fps=4)
    pil, info = _pil_frames(tmp_path / "a.gif")
    got, ours = read_gif(tmp_path / "a.gif")
    assert np.array_equal(pil, frames) and np.array_equal(got, frames)
    assert info["loop"] == 0 and info["duration"] == 250
    assert ours == {"loop": 0, "delays_ms": [250] * 4}


def test_gif_of_many_colours_beats_imageio(tmp_path):
    r"""A frame of thousands of colours: the port's palette and nearest
    colours against PIL's quantisation (imageio's GIF path, dithered)."""
    y, x = np.mgrid[0:40, 0:70]
    noise = np.random.default_rng(7).random((40, 70)) * 20
    frames = np.stack([np.stack([(x * 1.8 + i * 5) % 256, (y * 3.7) % 256,
                                 ((x + y) * 1.3 + noise) % 256], -1)
                       for i in range(3)]).astype(np.uint8)
    write_gif(tmp_path / "port.gif", frames)
    imageio.mimsave(tmp_path / "jax.gif", list(frames), duration=250, loop=0)
    port, _ = _pil_frames(tmp_path / "port.gif")
    jax_gif, _ = _pil_frames(tmp_path / "jax.gif")
    err = [np.abs(g.astype(int) - frames).mean() for g in (port, jax_gif)]
    assert err[0] <= err[1]
    assert np.array_equal(read_gif(tmp_path / "port.gif")[0], port)


def _one_worker(mp, module):
    mp.setattr(module, "BatchLoader", functools.partial(module.BatchLoader, num_workers=1))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r"""``test`` with visualisation in both packages, the port's model on the
    JAX model's initial parameters; the arrays each wrote."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _one_worker(mp, jax_vpsuite)
        mp.setattr(jax_defaults.SETTINGS, "OUT_PATH", tmp_path_factory.mktemp("jax"))
        gifs, pngs = _jax_recorders(mp)
        suite = jax_vpsuite.VPSuite(device="cpu", compilation_cache=False)
        suite.load_dataset("MMF", **MMF)
        entry = suite.create_model("convlstm-shi")
        params = jax.tree_util.tree_map(np.asarray, entry.state.params)
        with jax.default_matmul_precision("highest"):
            suite.test(**TEST)
        out["jax"] = dict(gifs=gifs.calls, pngs=pngs.calls)
    with pytest.MonkeyPatch.context() as mp:
        _one_worker(mp, port_vpsuite)
        run_path = tmp_path_factory.mktemp("port")
        mp.setattr(SETTINGS, "_run_path", run_path)
        gifs, pngs = _port_recorders(mp)
        suite = VPSuite(device="cpu")
        suite.load_dataset("MMF", **MMF)
        load_jax_params(suite.create_model("convlstm-shi").model, params)
        suite.test(**TEST)
        (run_dir,) = (run_path / "output").iterdir()
        out["port"] = dict(gifs=gifs.calls, pngs=pngs.calls, dir=run_dir)
    return out


def test_suite_test_writes_jax_files(runs):
    port, want = runs["port"], runs["jax"]
    assert [n for n, _ in port["gifs"]] == [n for n, _ in want["gifs"]] == [
        "vis_0_EF-ConvLSTM_(Shi_et_al.).gif", "vis_0_CopyLastFrame.gif",
        "vis_1_EF-ConvLSTM_(Shi_et_al.).gif", "vis_1_CopyLastFrame.gif"]
    assert [n for n, _ in port["pngs"]] == [n for n, _ in want["pngs"]] \
        == ["compare_0.png", "compare_1.png"]
    files = sorted(p.name for p in port["dir"].iterdir())
    assert {"vis_info.txt", "compare_0.png", "test_metrics.json"} <= set(files)
    assert (port["dir"] / "vis_info.txt").read_text().startswith("vis_0: dataset idx")


def test_suite_test_frames_within_one_grey_level(runs):
    r"""The ground truth (the same items, drawn after the same reset) equal;
    each prediction's frames within one grey level of JAX's."""
    port, want = runs["port"], runs["jax"]
    for (name, got), (_, ref) in zip(port["gifs"] + port["pngs"], want["gifs"] + want["pngs"]):
        assert got.shape == ref.shape, name
        assert np.abs(got.astype(int) - ref).max() <= 1, name
        if name.endswith(".png"):
            assert np.array_equal(got[:got.shape[0] // 3], ref[:ref.shape[0] // 3]), name
    for name, frames in port["gifs"]:
        pil, info = _pil_frames(port["dir"] / name)
        assert pil.shape == frames.shape and info["loop"] == 0 and info["duration"] == 250
    for name, img in port["pngs"]:
        assert np.array_equal(np.asarray(Image.open(port["dir"] / name)), img)
        assert np.array_equal(read_png(port["dir"] / name), img)


def test_train_writes_vis_every_epochs(tmp_path, monkeypatch):
    monkeypatch.setattr(SETTINGS, "_run_path", tmp_path)
    suite = VPSuite(device="cpu")
    suite.load_dataset("MMF", img_size=16, digit_source="synthetic",
                       n_seqs={"train": 4, "val": 3, "test": 2})
    suite.create_model("convlstm-shi")
    suite.train(epochs=2, batch_size=2, context_frames=2, pred_frames=2, steps_per_epoch=1,
                vis_every=2, n_vis=2, no_wandb=True, out_dir=str(tmp_path / "run"))
    assert sorted(p.name for p in (tmp_path / "run").glob("vis_ep_*")) == ["vis_ep_002"]
    for fp in ("vis_0.gif", "vis_1.gif"):
        frames, info = read_gif(tmp_path / "run" / "vis_ep_002" / fp)
        assert frames.shape == (4, 20, 44, 3) and info["loop"] == 0


def test_mp4_mode_writes_gif(tmp_path, capsys):
    fp = vis.save_vid_vis(tmp_path / "v.mp4", 1, mode="mp4", GT=_uint8(8, 3, 6, 6, 3))
    assert fp.endswith("v.gif") and read_gif(fp)[0].shape == (3, 10, 10, 3)
    assert "no mp4 writer" in capsys.readouterr().out


def test_arr_hist(tmp_path, capsys):
    arr = np.concatenate([np.zeros(30), np.linspace(0.0, 1.0, 70)])
    vis.save_arr_hist(arr, tmp_path / "h.png")
    img = read_png(tmp_path / "h.png")
    assert img.shape == (480, 640, 3)
    bars = (img == vis.HIST_BAR).all(-1)
    tallest = bars.sum(0)
    assert tallest.max() == 440 and tallest[20:26].min() == 440   # the first bin, 30 zeros
    out = capsys.readouterr().out
    assert "min=0.0000 max=1.0000" in out and f"mean={arr.mean():.4f}" in out
