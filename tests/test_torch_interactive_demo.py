"""The port's interactive demo (a standard-library web server) on the CPU,
as tests/test_interactive_demo.py runs the JAX package's: the page, the
first frame as a PNG (read back with read_png: frame 0), /track with
clicked points and with a grid on a `.npy` clip through a small plain
model, the mp4 where cv2 imports, and without cv2 the numbers with the
reason no mp4 was written (and /result.mp4 a 404 with the same words).
Every request has a timeout of its own, so a hung server fails its test."""

import importlib.util
import json
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from cotracker_tpu_torch.datasets.png import read_png
from cotracker_tpu_torch.interactive_demo import DemoState, main, make_handler
from cotracker_tpu_torch.predictor import CoTrackerPredictor

torch.set_num_threads(2)
TIMEOUT = 120


@pytest.fixture(scope="module")
def demo_server(tmp_path_factory):
    from http.server import ThreadingHTTPServer

    tmp = tmp_path_factory.mktemp("demo")
    video = (np.random.default_rng(0).random((8, 36, 48, 3)) * 255).astype(np.uint8)
    np.save(tmp / "clip.npy", video)
    state = DemoState(str(tmp / "clip.npy"), max_frames=8, device="cpu", save_dir=str(tmp))
    # a small model resolution for the CPU (the default is 384x512)
    state._pred = CoTrackerPredictor(window_len=8, model_resolution=(32, 48), device="cpu")
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", state, video
    srv.shutdown()
    srv.server_close()
    t.join(TIMEOUT)
    assert not t.is_alive()


def _get(url):
    return urllib.request.urlopen(url, timeout=TIMEOUT).read()


def _track(base, body):
    req = urllib.request.Request(base + "/track", data=json.dumps(body).encode(), method="POST")
    return json.loads(urllib.request.urlopen(req, timeout=TIMEOUT).read())


def test_page_and_frame(demo_server, tmp_path):
    base, _, video = demo_server
    page = _get(base + "/").decode()
    assert "canvas" in page and "/track" in page and "/frame.png" in page
    png = _get(base + "/frame.png")
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    (tmp_path / "frame.png").write_bytes(png)
    np.testing.assert_array_equal(read_png(str(tmp_path / "frame.png")), video[0])
    with pytest.raises(urllib.error.HTTPError, match="404"):
        _get(base + "/nothing")


def test_track_points_and_grid(demo_server):
    base, state, _ = demo_server
    out = _track(base, {"points": [[10, 12], [30, 20]], "grid_size": 0})
    assert out["n_tracks"] == 2 and out["n_frames"] == 8 and out["seconds"] > 0
    if importlib.util.find_spec("cv2") is not None:
        assert out["mp4"] == "/result.mp4" and out["no_mp4"] is None
        assert len(_get(base + "/result.mp4")) > 500
    out = _track(base, {"points": [], "grid_size": 3, "backward": True})
    assert out["n_tracks"] == 9 and out["n_frames"] == 8


def test_track_without_opencv(demo_server, monkeypatch):
    base, state, _ = demo_server
    monkeypatch.setitem(sys.modules, "cv2", None)
    out = _track(base, {"points": [[5, 5]], "grid_size": 0})
    assert out["n_tracks"] == 1 and out["mp4"] is None
    assert "no mp4 was written" in out["no_mp4"] and "cv2" in out["no_mp4"]
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(base + "/result.mp4")
    assert err.value.code == 404 and err.value.read().decode() == out["no_mp4"]


def test_command_line_reads_the_video_and_its_device(tmp_path):
    """main() builds its state from the flags before serving: a missing
    video raises, and so does the default device where CUDA is absent."""
    with pytest.raises(FileNotFoundError):
        main(["--video", str(tmp_path / "missing.npy"), "--device", "cpu"])
    if not torch.cuda.is_available():
        np.save(tmp_path / "clip.npy", np.zeros((2, 8, 8, 3), np.uint8))
        state = DemoState(str(tmp_path / "clip.npy"), max_frames=2)
        with pytest.raises(RuntimeError, match="cuda"):
            state.predictor()
