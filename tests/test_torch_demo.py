"""The port's demos on the CPU, port only: `demo.track_video` and its CLI on
a tiny `.npy` video (and an `.npy` mask) with the plain float32 model at a
small model resolution; `online_demo.track_stream` with the online model
(8-frame windows), and its chunk loop against the chunks written out by
hand, on a predictor that records them."""

import functools

import numpy as np
import pytest
import torch

from cotracker_tpu_torch import demo, online_demo
from cotracker_tpu_torch import predictor as predictor_module
from cotracker_tpu_torch.predictor import CoTrackerOnlinePredictor, CoTrackerPredictor

torch.set_num_threads(2)

RES = (32, 48)
T, H, W = 6, 40, 56


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    d = tmp_path_factory.mktemp("demo")
    video = (np.random.default_rng(6).random((T, H, W, 3)) * 255).astype(np.uint8)
    mask = np.zeros((H, W), np.int64)
    mask[:, : W // 2] = 1
    np.save(d / "clip.npy", video)
    np.save(d / "mask.npy", mask)
    return d, video


def test_demo_on_an_npy_video(clip, monkeypatch):
    d, video = clip
    assert np.array_equal(demo.read_video(str(d / "clip.npy"), max_frames=6), video[:6])
    pred = CoTrackerPredictor(model_resolution=RES, device="cpu")
    mask = demo.read_mask(str(d / "mask.npy"))
    tracks, vis, frames = demo.track_video(video, predictor=pred, grid_size=4, segm_mask=mask)
    n = tracks.shape[2]
    assert 0 < n < 16 and tracks.shape == (1, T, n, 2) and vis.shape == (1, T, n)
    assert (tracks[0, 0, :, 0] < W / 2).all()  # the grid points inside the mask
    assert frames.shape == (10 + T - 1, H + 240, W + 240, 3) and frames.dtype == np.uint8
    # the CLI: the same predictor class at the small resolution, an mp4 written
    monkeypatch.setattr(predictor_module, "CoTrackerPredictor",
                        functools.partial(CoTrackerPredictor, model_resolution=RES))
    path = demo.main(["--video_path", str(d / "clip.npy"), "--grid_size", "3",
                      "--device", "cpu", "--save_dir", str(d / "out")])
    assert path.endswith("clip.mp4")


def test_online_demo_runs_the_online_model(clip):
    _, video = clip
    pred = CoTrackerOnlinePredictor(model_resolution=RES, device="cpu", capacity=16, window_len=8)
    tracks, vis, frames = online_demo.track_stream(iter(video), pred, grid_size=3)
    # a chunk at frame 4 (frames 0-4, window [0, 8)), then the tail (all 6
    # frames again, window [4, 12)): the stream covers 10 frames
    assert np.array_equal(frames, video) and tracks.shape == (1, 10, 9, 2)
    assert vis.shape == (1, 10, 9) and torch.isfinite(tracks).all()
    rendered = online_demo.render(video, tracks, vis)
    assert rendered.shape == (10 + T - 1, H + 240, W + 240, 3)


class Recorder:
    """An online predictor's interface that records the frames of each chunk."""
    step = 8

    def __init__(self):
        self.calls = []

    def __call__(self, chunk, is_first_step=False, grid_size=0, grid_query_frame=0):
        self.calls.append((is_first_step, chunk[0, :, 0, 0, 0].astype(int).tolist()))
        return (None, None) if is_first_step else (torch.zeros(1), torch.zeros(1))


@pytest.mark.parametrize("n", [10, 16, 27])
def test_online_demo_chunks_match_the_loop_by_hand(n):
    frames = [np.full((2, 2, 3), i, np.uint8) for i in range(n)]
    rec = Recorder()
    online_demo.track_stream(frames, rec, grid_size=3)
    # by hand: every 8 frames (i = 8, 16, ...) the last 16 frames read so
    # far, then the last n % 8 + 8 frames; the first chunk's first frame
    # registers the grid
    ends = list(range(9, n + 1, 8))
    want = [list(range(max(0, e - 16), e)) for e in ends] + [list(range(n - (n % 8 + 8), n))]
    assert rec.calls == [(True, [0])] + [(False, w) for w in want]
