"""Interactive point-tracking demo (port of the JAX package's
interactive_demo.py): a standard-library web server. The page shows the
video's first frame; click query points on it (at frame 0) or leave it
empty for a regular grid, then "Track": the offline predictor runs and the
tracks drawn over the video play back.

    python -m cotracker_tpu_torch.interactive_demo --video clip.npy \\
        [--port 7860] [--max_frames 48] [--checkpoint scaled_offline.pth] \\
        [--save_dir ./saved_videos] [--device cuda]

then open http://localhost:7860/. A video ending in `.npy` is a
(T, H, W, 3) uint8 array; other files are decoded with OpenCV. The first
frame is served as a PNG (`datasets.png`, no OpenCV). Tracking runs on the
GPU (`--device cuda`, the default; it raises without one) or, asked, on the
CPU. The rendered result is an mp4 written through OpenCV: where cv2 is
missing (the GPU machine has none), /track still returns its numbers, its
JSON says why no mp4 was written, and /result.mp4 answers 404 with the same
words.
"""

import argparse
import json
import os
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

PAGE = """<!doctype html>
<html><head><title>cotracker_tpu_torch interactive demo</title><style>
 body { font-family: sans-serif; margin: 2em; background: #111; color: #eee; }
 canvas { border: 1px solid #555; cursor: crosshair; }
 button, input { margin: 0.3em; }
 #status { margin-left: 1em; color: #8bc34a; }
</style></head><body>
<h2>cotracker_tpu_torch: interactive tracking</h2>
<p>Click points on the first frame (queries at frame 0), or leave it empty
and set a grid size. Then Track.</p>
<div>
  <canvas id="cv"></canvas>
</div>
<div>
  <button onclick="clearPts()">Clear points</button>
  grid size (used when no points): <input id="grid" type="number" value="10" min="0" max="40" style="width:4em">
  <label><input id="bwd" type="checkbox"> backward tracking</label>
  <button onclick="track()">Track</button>
  <span id="status"></span>
</div>
<div id="out"></div>
<script>
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
const img = new Image(); let pts = [];
img.onload = () => { cv.width = img.width; cv.height = img.height; draw(); };
img.src = '/frame.png';
function draw() {
  ctx.drawImage(img, 0, 0);
  ctx.fillStyle = '#ff4081';
  for (const p of pts) { ctx.beginPath(); ctx.arc(p[0], p[1], 4, 0, 7); ctx.fill(); }
}
cv.addEventListener('click', e => {
  const r = cv.getBoundingClientRect();
  pts.push([e.clientX - r.left, e.clientY - r.top]); draw();
});
function clearPts() { pts = []; draw(); }
async function track() {
  document.getElementById('status').textContent = 'tracking...';
  const body = JSON.stringify({points: pts,
    grid_size: +document.getElementById('grid').value,
    backward: document.getElementById('bwd').checked});
  const r = await fetch('/track', {method: 'POST', body});
  if (!r.ok) { document.getElementById('status').textContent = 'error: ' + await r.text(); return; }
  const j = await r.json();
  document.getElementById('status').textContent =
    `tracked ${j.n_tracks} points over ${j.n_frames} frames in ${j.seconds.toFixed(1)} s`;
  document.getElementById('out').innerHTML = j.mp4 ?
    `<video controls autoplay loop src="${j.mp4}?ts=${Date.now()}" width="${cv.width}"></video>` :
    j.no_mp4;
}
</script></body></html>
"""

RESULT_NAME = "interactive_demo_result"


class DemoState:
    """The video, its first frame as PNG bytes, and the predictor, shared by
    the requests (tracking runs one request at a time)."""

    def __init__(self, video_path, max_frames, checkpoint=None, device="cuda",
                 save_dir="./saved_videos"):
        from cotracker_tpu_torch.datasets.png import encode_png
        from cotracker_tpu_torch.demo import read_video

        frames = read_video(video_path, max_frames)
        if len(frames) == 0:
            raise ValueError(f"no frame in {video_path}")
        self.video = frames[None].transpose(0, 1, 4, 2, 3).astype(np.float32)
        self.first_frame = frames[0]
        self.first_frame_png = encode_png(frames[0])
        self.checkpoint = checkpoint
        self.device = device
        self.save_dir = save_dir
        self.no_mp4 = None  # why the last /track wrote no mp4
        self._pred = None
        self.lock = threading.Lock()

    @property
    def result_path(self):
        return os.path.join(self.save_dir, RESULT_NAME + ".mp4")

    def predictor(self):
        if self._pred is None:
            from cotracker_tpu_torch.predictor import CoTrackerPredictor

            self._pred = CoTrackerPredictor(checkpoint=self.checkpoint, device=self.device)
        return self._pred

    def track(self, points, grid_size, backward):
        """Track clicked (x, y) points at frame 0, or a grid where there are
        none; render and write the mp4 where OpenCV is present. Returns the
        JSON the page reads."""
        from cotracker_tpu_torch.utils.visualizer import Visualizer

        t0 = time.time()
        pred = self.predictor()
        if points:
            queries = np.asarray([[0.0, float(x), float(y)] for x, y in points], np.float32)[None]
            tracks, vis = pred(self.video, queries=queries, backward_tracking=backward)
        else:
            tracks, vis = pred(self.video, grid_size=max(1, int(grid_size)),
                               backward_tracking=backward)
        viz = Visualizer(save_dir=self.save_dir, fps=12, show_first_frame=3,
                         tracks_leave_trace=-1)
        frames = viz.visualize(self.video, tracks, vis, save_video=False)
        out = {"n_tracks": int(tracks.shape[2]), "n_frames": int(tracks.shape[1]),
               "seconds": time.time() - t0}
        try:
            Visualizer.video_sink()
        except ImportError as e:
            self.no_mp4 = f"no mp4 was written: {e}"
            out.update(mp4=None, no_mp4=self.no_mp4)
            return out
        self.no_mp4 = None
        viz.save_video(frames, RESULT_NAME)
        out.update(mp4="/result.mp4", no_mp4=None)
        return out


def make_handler(state: DemoState):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, body, ctype="text/html"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/" or self.path.startswith("/index"):
                self._send(200, PAGE.encode())
            elif self.path.startswith("/frame.png"):
                self._send(200, state.first_frame_png, "image/png")
            elif self.path.startswith("/result.mp4"):
                if state.no_mp4:
                    self._send(404, state.no_mp4.encode(), "text/plain")
                    return
                try:
                    with open(state.result_path, "rb") as f:
                        self._send(200, f.read(), "video/mp4")
                except FileNotFoundError:
                    self._send(404, b"no result yet", "text/plain")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/track":
                self._send(404, b"not found", "text/plain")
                return
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            try:
                with state.lock:
                    out = state.track(req.get("points") or [], req.get("grid_size", 10),
                                      bool(req.get("backward")))
            except Exception as e:  # the server keeps serving; the page shows the error
                traceback.print_exc()
                self._send(500, f"{type(e).__name__}: {e}".encode(), "text/plain")
                return
            self._send(200, json.dumps(out).encode(), "application/json")

        def log_message(self, fmt, *args):
            pass

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--video", required=True)
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--max_frames", type=int, default=48)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--save_dir", default="./saved_videos")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    state = DemoState(args.video, args.max_frames, args.checkpoint, args.device, args.save_dir)
    srv = ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(state))
    print(f"serving on http://localhost:{args.port}/  (video: {args.video}, "
          f"{state.video.shape[1]} frames)")
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
