"""The port's Visualizer against the JAX package's (which draws with OpenCV),
on the CPU.

Exact: OpenCV's 8-bit HSV -> RGB (every hue and value at the saturations
the colour maps use, and a random sample of the rest), the colour maps and
the optical-flow colours. The rendered frames are drawn in numpy, whose
anti-aliased edge is not OpenCV's LINE_AA, so they are held to JAX's by
what the edge does not touch: tracks kept apart by more than a disc's
reach, each visible track's centre pixel has JAX's colour, every pixel
further than a disc's reach from all tracks is the input frame's, and the
pixels changed by more than 32 codes agree with JAX's to an IoU of 0.9
(0.948-0.976 measured at these shapes; the edge ramps differ by up to
~0.2 of a pixel's coverage). Then the segmentation, camera-motion,
optical-flow and ground-truth paths against JAX's shapes and IoU, the mp4
and TensorBoard fallbacks, and the ImportError without OpenCV. Only the
comparisons with OpenCV or the JAX visualizer need cv2; the ImportError
checks run without it."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from cotracker_tpu_torch.utils import visualizer as P

T, H, W = 5, 48, 64


def _cv2():
    return pytest.importorskip("cv2")


def _jax_visualizer():
    """The JAX package's visualizer, which draws with OpenCV."""
    _cv2()
    return pytest.importorskip("cotracker_tpu.utils.visualizer")


def _scene(seed=1):
    """A video and 12 tracks on a jittered 4x3 lattice: more than 2 x (disc
    radius + 3) pixels apart at every frame."""
    rng = np.random.default_rng(seed)
    video = (rng.random((1, T, 3, H, W)) * 255).astype(np.float32)
    gx, gy = np.meshgrid(np.arange(4) * 15 + 8, np.arange(3) * 15 + 8)
    base = np.stack([gx, gy], -1).reshape(1, 1, 12, 2).astype(np.float32)
    tracks = base + rng.uniform(-1.4, 1.4, (1, T, 12, 2)).astype(np.float32)
    vis = rng.random((1, T, 12)) > 0.3
    return video, tracks, vis


def test_hsv_to_rgb_is_opencvs():
    h, v = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    rng = np.random.default_rng(0)
    cases = [np.stack([h, np.full_like(h, s), v], -1).reshape(-1, 3)
             for s in (0, 1, 128, 254, 255)] + [rng.integers(0, 256, (200_000, 3))]
    hsv = np.concatenate(cases).astype(np.uint8)
    cv2 = _cv2()
    ref = cv2.cvtColor(hsv[:, None], cv2.COLOR_HSV2RGB)[:, 0]
    np.testing.assert_array_equal(P.hsv_to_rgb(hsv), ref)


def test_colour_maps_are_jaxs():
    J = _jax_visualizer()
    x = np.linspace(-0.1, 1.1, 1201)
    for name in ("rainbow", "cool"):
        np.testing.assert_array_equal(P._colormap(name, x), J._colormap(name, x))
    flow = np.random.default_rng(2).normal(0, 5, (9, 40, 2)).astype(np.float32)
    flow[0, :3] = [[3, 0], [0, 0], [-2, 0]]  # hue 180 and 0, no motion
    np.testing.assert_array_equal(P._flow_to_color(flow), J._flow_to_color(flow))


def _changed(frames, orig):
    return np.abs(frames.astype(int) - orig.astype(int)).max(-1) > 32


@pytest.mark.parametrize("kw", [dict(), dict(mode="cool", linewidth=3, pad_value=4)],
                         ids=["rainbow", "cool_padded"])
def test_frames_agree_with_jax(kw):
    J = _jax_visualizer()
    video, tracks, vis = _scene()
    ref = J.Visualizer(**kw).visualize(video, tracks, vis, save_video=False)
    out = P.Visualizer(**kw).visualize(torch.from_numpy(video), torch.from_numpy(tracks),
                                       torch.from_numpy(vis), save_video=False)
    assert out.shape == ref.shape == (10 + T - 1, H + 2 * kw.get("pad_value", 0),
                                      W + 2 * kw.get("pad_value", 0), 3)
    assert out.dtype == np.uint8
    p, reach = kw.get("pad_value", 0), 2 * kw.get("linewidth", 2) + 2
    orig = np.pad(video[0].transpose(0, 2, 3, 1).astype(np.uint8),
                  ((0, 0), (p, p), (p, p), (0, 0)), constant_values=255)
    orig = np.concatenate([orig[:1]] * 10 + [orig[1:]])
    xy = np.concatenate([tracks[0, :1]] * 10 + [tracks[0, 1:]]) + p
    vv = np.concatenate([vis[0, :1]] * 10 + [vis[0, 1:]])
    yy, xx = np.mgrid[: orig.shape[1], : orig.shape[2]]
    for t in range(out.shape[0]):
        c = np.round(xy[t]).astype(int)
        for n in np.flatnonzero(vv[t]):
            assert np.array_equal(out[t, c[n, 1], c[n, 0]], ref[t, c[n, 1], c[n, 0]]), (t, n)
        d = np.hypot(xx[..., None] - c[:, 0], yy[..., None] - c[:, 1]).min(-1)
        np.testing.assert_array_equal(out[t][d > reach], orig[t][d > reach])
    a, b = _changed(out, orig), _changed(ref, orig)
    assert (a & b).sum() / (a | b).sum() >= 0.9


@pytest.mark.parametrize("kw, call", [
    (dict(tracks_leave_trace=-1, mode="cool"), dict(gt=True)),
    (dict(tracks_leave_trace=2), dict(segm=True, compensate_for_camera_motion=True)),
    (dict(mode="optical_flow"), dict(opacity=0.6)),
    (dict(mode="cool", grayscale=True), dict(segm=True)),
], ids=["trace_gt", "segm_camera", "flow_opacity", "segm_cool_gray"])
def test_other_paths_agree_with_jax(kw, call):
    J = _jax_visualizer()
    video, tracks, vis = _scene(3)
    call = dict(call)
    if call.pop("gt", False):
        call["gt_tracks"] = tracks + 1.0
    if call.pop("segm", False):
        mask = np.zeros((1, 1, H, W), np.float32)
        mask[..., :, : W // 2] = 1
        call["segm_mask"] = mask
    ref = J.Visualizer(**kw).visualize(video, tracks, vis, save_video=False, **call)
    out = P.Visualizer(**kw).visualize(video, tracks, vis, save_video=False, **call)
    assert out.shape == ref.shape and out.dtype == np.uint8
    orig = J.Visualizer(**kw).visualize(video, np.zeros_like(tracks), None, save_video=False)
    a, b = _changed(out, orig), _changed(ref, orig)
    assert (a & b).sum() / (a | b).sum() >= 0.9


def test_save_video_writes_an_mp4_or_names_cv2(tmp_path, monkeypatch):
    _cv2()
    video, tracks, vis = _scene()
    v = P.Visualizer(save_dir=str(tmp_path), show_first_frame=0)
    frames = v.visualize(video, tracks, vis, filename="clip")
    assert frames.shape == (T, H, W, 3) and os.path.getsize(tmp_path / "clip.mp4") > 0

    class Writer:  # a SummaryWriter without moviepy: the mp4 instead
        def add_video(self, *a, **k):
            raise AssertionError("add_video without moviepy writes nothing")

    if importlib.util.find_spec("moviepy") is None:
        assert v.save_video(frames, "tb", writer=Writer()) == str(tmp_path / "tb.mp4")
    monkeypatch.setitem(sys.modules, "cv2", None)  # OpenCV missing
    with pytest.raises(ImportError, match="cv2"):
        v.save_video(frames, "none")
    with pytest.raises(ImportError, match="cv2"):
        P.read_video_from_path(str(tmp_path / "clip.mp4"))
    assert not os.path.exists(tmp_path / "none.mp4")


def test_without_opencv_the_errors_name_cv2(tmp_path, monkeypatch):
    """Port only, and with or without OpenCV installed: where cv2 does not
    import, the mp4 (also TensorBoard's fallback to it without moviepy)
    and reading a video file raise an ImportError naming cv2, and nothing
    is written; with moviepy the frames go to the writer instead."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    video, tracks, vis = _scene()
    v = P.Visualizer(save_dir=str(tmp_path), show_first_frame=0)
    frames = v.visualize(video, tracks, vis, save_video=False)
    calls = []

    class Writer:
        def add_video(self, tag, clip, global_step=0, fps=0):
            calls.append((tag, tuple(clip.shape), global_step))

    with pytest.raises(ImportError, match="cv2"):
        v.save_video(frames, "none")
    if importlib.util.find_spec("moviepy") is None:
        with pytest.raises(ImportError, match="cv2"):
            v.save_video(frames, "tb", writer=Writer())
    else:
        assert v.save_video(frames, "tb", writer=Writer(), step=3) is None
        assert calls == [("tb", (1, T, 3, H, W), 3)]
    with pytest.raises(ImportError, match="cv2"):
        P.read_video_from_path(str(tmp_path / "clip.mp4"))
    assert os.listdir(tmp_path) == []
