"""Track visualization (port of cotracker_tpu/utils/visualizer.py): draw
predicted tracks over video frames and return them as (T, H, W, 3) uint8
arrays; write them as an mp4 (OpenCV) or to a TensorBoard writer.

Nothing here needs OpenCV except reading and writing video files, which
import cv2 when called and raise an ImportError naming it where it is
missing (the GPU machine has none):
  * the colour maps and the optical-flow colours use OpenCV's 8-bit
    HSV -> RGB formula, written out in numpy (`hsv_to_rgb`, the same codes
    as cv2.cvtColor(..., COLOR_HSV2RGB));
  * discs, rings, lines and the 50% trace blend are drawn in numpy. Their
    anti-aliased edge is a linear ramp of the pixel's distance to the
    shape, its two constants fit to OpenCV's LINE_AA at this package's
    radii and widths; it is not LINE_AA, so frames agree with the JAX
    package's where a shape covers a pixel fully and differ along its edge.
"""

import os

import numpy as np
import torch


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def read_video_from_path(path):
    """Decode a video file to (T, H, W, 3) uint8 RGB with OpenCV; None if
    it holds no frame."""
    cv2 = import_cv2("reading a video file")
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
    cap.release()
    return np.stack(frames) if frames else None


def import_cv2(what):
    """OpenCV, or an ImportError saying that `what` needs it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} needs OpenCV (cv2), which is not installed") from e
    return cv2


# OpenCV's sector table: which of (v, p, q, t) each of b, g, r takes
_HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def _one_minus(a, b):
    """1 - a * b in float32 with one rounding, as a fused multiply-add gives
    it (float64 holds a * b of two float32 values exactly)."""
    return (1.0 - a.astype(np.float64) * b.astype(np.float64)).astype(np.float32)


def hsv_to_rgb(hsv):
    """(..., 3) uint8 HSV, hue in [0, 180) -> (..., 3) uint8 RGB, the codes
    of cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB): OpenCV's float32 formula with
    its two fused multiply-adds, rounded half to even."""
    hsv = np.asarray(hsv, np.uint8)
    f32 = np.float32
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)
    whole = np.trunc(h)
    frac = h - whole
    sector = (whole - np.trunc(whole * f32(1.0 / 6.0)) * f32(6.0)).astype(np.int64)
    tab = np.stack([v, v * (f32(1.0) - s), v * _one_minus(s, frac),
                    v * _one_minus(s, f32(1.0) - frac)], axis=-1)
    bgr = np.take_along_axis(tab, _HSV_SECTORS[sector], axis=-1) * f32(255.0)
    return np.clip(np.rint(bgr), 0, 255).astype(np.uint8)[..., ::-1]


def _colormap(name: str, x):
    """Colour maps without matplotlib. x in [0, 1] (scalar or array);
    returns float32 RGB in [0, 255]: 'cool' is (x, 1 - x, 1), anything else
    a hue sweep from red to magenta."""
    x = np.clip(np.asarray(x, np.float32), 0.0, 1.0)
    if name == "cool":
        return np.stack([x, 1.0 - x, np.ones_like(x)], axis=-1) * 255.0
    h = (x * 300.0 / 2.0).astype(np.uint8)  # OpenCV's hue is [0, 180)
    full = np.full_like(h, 255)
    return hsv_to_rgb(np.stack([h, full, full], axis=-1)).astype(np.float32)


def _flow_to_color(flow):
    """Optical-flow colours: hue the flow's direction, value its magnitude
    over the largest. flow (..., 2) -> uint8 RGB (..., 3)."""
    fx, fy = flow[..., 0], flow[..., 1]
    mag = np.sqrt(fx * fx + fy * fy)
    ang = np.arctan2(-fy, -fx) / np.pi  # [-1, 1]
    denom = max(mag.max(), 1e-6)
    hsv = np.stack([((ang + 1.0) * 90.0).astype(np.uint8), np.full(mag.shape, 255, np.uint8),
                    np.clip(mag / denom * 255.0, 0, 255).astype(np.uint8)], axis=-1)
    return hsv_to_rgb(hsv)


def _blend_weighted(a, alpha, b, beta):
    """cv2.addWeighted(a, alpha, b, beta, 0) on uint8 frames."""
    out = a.astype(np.float32) * np.float32(alpha) + b.astype(np.float32) * np.float32(beta)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _paint(img, box, coverage, color):
    """Blend `color` into img[y0:y1, x0:x1] by `coverage` in [0, 1]."""
    y0, y1, x0, x1 = box
    patch = img[y0:y1, x0:x1].astype(np.float32)
    c = np.asarray(color, np.float32)
    img[y0:y1, x0:x1] = np.clip(np.rint(patch + (c - patch) * coverage[..., None]), 0, 255)


def _grid(img, x0, x1, y0, y1):
    """The pixel grid of a box clipped to the image, or None if empty."""
    H, W = img.shape[:2]
    x0, y0, x1, y1 = max(x0, 0), max(y0, 0), min(x1, W), min(y1, H)
    if x0 >= x1 or y0 >= y1:
        return None
    yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
    return (y0, y1, x0, x1), xx, yy


def draw_disc(img, center, radius, color, filled=True):
    """A filled disc (or a one-pixel ring) at an integer centre, in place."""
    cx, cy = center
    g = _grid(img, cx - radius - 2, cx + radius + 3, cy - radius - 2, cy + radius + 3)
    if g is None:
        return
    box, xx, yy = g
    d = np.hypot(xx - cx, yy - cy)
    cov = radius + 1.0 - d if filled else (1.2 - np.abs(d - radius)) / 1.3
    _paint(img, box, np.clip(cov, 0.0, 1.0), color)


def draw_line(img, p0, p1, color, width):
    """A segment of `width` pixels with round ends between integer points,
    in place."""
    (ax, ay), (bx, by) = p0, p1
    r = width / 2.0 + 2.0
    g = _grid(img, int(np.floor(min(ax, bx) - r)), int(np.ceil(max(ax, bx) + r)) + 1,
              int(np.floor(min(ay, by) - r)), int(np.ceil(max(ay, by) + r)) + 1)
    if g is None:
        return
    box, xx, yy = g
    dx, dy = float(bx - ax), float(by - ay)
    t = np.clip(((xx - ax) * dx + (yy - ay) * dy) / max(dx * dx + dy * dy, 1e-12), 0.0, 1.0)
    d = np.hypot(xx - ax - t * dx, yy - ay - t * dy)
    _paint(img, box, np.clip((width / 2.0 + 1.0 - d) / 0.75, 0.0, 1.0), color)


class Visualizer:
    """Visualizer(save_dir, mode="rainbow").visualize(video, tracks, vis)
    returns the rendered (T, H, W, 3) uint8 frames and, with save_video,
    writes them (see save_video)."""

    def __init__(
        self,
        save_dir: str = "./results",
        grayscale: bool = False,
        pad_value: int = 0,
        fps: int = 10,
        mode: str = "rainbow",  # rainbow / cool / optical_flow
        linewidth: int = 2,
        show_first_frame: int = 10,
        tracks_leave_trace: int = 0,  # 0: none, -1: the whole history, k: the last k frames
    ):
        self.save_dir = save_dir
        self.grayscale = grayscale
        self.pad_value = pad_value
        self.fps = fps
        self.mode = mode
        self.linewidth = linewidth
        self.show_first_frame = show_first_frame
        self.tracks_leave_trace = tracks_leave_trace

    def visualize(
        self,
        video,
        tracks,
        visibility=None,
        gt_tracks=None,
        segm_mask=None,
        filename: str = "video",
        writer=None,  # a TensorBoard SummaryWriter
        step: int = 0,
        query_frame: int = 0,
        save_video: bool = True,
        compensate_for_camera_motion: bool = False,
        opacity: float = 1.0,
    ):
        """video (B, T, 3, H, W) in [0, 255]; tracks (B, T, N, 2);
        visibility (B, T, N) (invisible points are drawn as rings);
        segm_mask (B, 1, H, W), read at the tracks' query-frame points;
        gt_tracks (B, T, N, 2), drawn as red crosses with the traces.
        Numpy arrays or tensors on any device. Returns (T', H, W, 3) uint8,
        the first frame repeated show_first_frame times."""
        if compensate_for_camera_motion and segm_mask is None:
            raise ValueError("compensate_for_camera_motion needs a segm_mask")
        video = _host(video)[0].transpose(0, 2, 3, 1).astype(np.uint8).copy()
        tracks = _host(tracks)[0].astype(np.float32)
        vis = None if visibility is None else _host(visibility)[0]
        gt = None if gt_tracks is None else _host(gt_tracks)[0]

        segm = None
        if segm_mask is not None:  # each track's label: the mask at its query point
            m = _host(segm_mask).reshape(video.shape[1], video.shape[2])
            c = np.round(tracks[query_frame]).astype(int)
            segm = m[np.clip(c[:, 1], 0, m.shape[0] - 1), np.clip(c[:, 0], 0, m.shape[1] - 1)]

        if self.grayscale:
            video = np.repeat(video.mean(axis=-1, keepdims=True).astype(np.uint8), 3, axis=-1)
        if self.pad_value:
            p = self.pad_value
            video = np.pad(video, ((0, 0), (p, p), (p, p), (0, 0)), constant_values=255)
            tracks = tracks + p
            if gt is not None:
                gt = gt + p

        colors = self._colors(tracks, segm, query_frame)
        T, N = tracks.shape[:2]
        frames = [f.copy() for f in video]

        if self.tracks_leave_trace != 0:
            for t in range(query_frame + 1, T):
                first = max(0, t - self.tracks_leave_trace) if self.tracks_leave_trace >= 0 else 0
                cur, cc = tracks[first : t + 1], colors[first : t + 1]
                keep = slice(None)
                if compensate_for_camera_motion:
                    bg = segm <= 0
                    cur = cur - (cur[:, bg] - tracks[t : t + 1, bg]).mean(1)[:, None]
                    keep = segm > 0
                overlay = frames[t].copy()
                for s in range(cur.shape[0] - 1):
                    pts0, pts1, cols = cur[s, keep], cur[s + 1, keep], cc[s, keep]
                    for n in range(pts0.shape[0]):
                        draw_line(overlay, tuple(np.round(pts0[n]).astype(int)),
                                  tuple(np.round(pts1[n]).astype(int)),
                                  [int(v) for v in cols[n]], self.linewidth)
                frames[t] = _blend_weighted(overlay, 0.5, frames[t], 0.5)
                if gt is not None:
                    self._draw_gt(frames[t], gt[first : t + 1])

        alpha = float(np.clip(opacity, 0.0, 1.0))
        for t in range(T):
            base = frames[t].copy()
            for n in range(N):
                x, y = tracks[t, n]
                if x == 0 and y == 0:  # the (0, 0) sentinel is skipped
                    continue
                if compensate_for_camera_motion and segm[n] <= 0:
                    continue
                visible = True if vis is None else bool(vis[t, n])
                draw_disc(frames[t], (int(round(x)), int(round(y))), int(self.linewidth * 2),
                          [int(v) for v in colors[t, n]], filled=visible)
            if alpha < 1.0:
                frames[t] = _blend_weighted(frames[t], alpha, base, 1 - alpha)

        if self.show_first_frame > 1:
            frames = [frames[0]] * self.show_first_frame + frames[1:]
        out = np.stack(frames)
        if save_video:
            self.save_video(out, filename=filename, writer=writer, step=step)
        return out

    def _colors(self, tracks, segm, query_frame):
        """Per-(frame, track) float RGB colours, (T, N, 3)."""
        T, N = tracks.shape[:2]
        if self.mode == "optical_flow":
            return _flow_to_color(tracks - tracks[query_frame][None]).astype(np.float32)
        if segm is None:
            if self.mode == "rainbow":  # by the query-frame row
                y = tracks[query_frame, :, 1]
                lo, hi = float(y.min()), float(y.max())
                c = _colormap("rainbow", (y - lo) / max(hi - lo, 1e-6))
                return np.broadcast_to(c[None], (T, N, 3)).copy()
            tc = _colormap("cool", np.arange(T, dtype=np.float32) / max(T, 1))  # by time
            return np.broadcast_to(tc[:, None, :], (T, N, 3)).copy()
        if self.mode == "rainbow":  # foreground by row, background white
            colors = np.full((T, N, 3), 255.0, np.float32)
            fg = segm > 0
            if fg.any():
                y = tracks[0, fg, 1]
                lo, hi = float(y.min()), float(y.max())
                cfg = _colormap("rainbow", (tracks[0, :, 1] - lo) / max(hi - lo, 1e-6))
                colors[:, fg] = cfg[None][:, fg]
            return colors
        c = np.where((segm > 0)[:, None], _colormap("cool", np.ones(N)),  # by class
                     _colormap("cool", np.zeros(N)))
        return np.broadcast_to(c[None], (T, N, 3)).copy()

    def _draw_gt(self, frame, gt_tracks):
        """Ground-truth tracks as red crosses, in place."""
        L = self.linewidth * 3
        for t in range(gt_tracks.shape[0]):
            for n in range(gt_tracks.shape[1]):
                x, y = gt_tracks[t, n]
                if x <= 0 or y <= 0:
                    continue
                x, y = int(round(x)), int(round(y))
                draw_line(frame, (x - L, y - L), (x + L, y + L), (255, 0, 0), self.linewidth)
                draw_line(frame, (x + L, y - L), (x - L, y + L), (255, 0, 0), self.linewidth)

    def save_video(self, frames, filename: str, writer=None, step: int = 0):
        """frames (T, H, W, 3) uint8. With a TensorBoard writer and moviepy,
        add_video (which writes nothing without moviepy, so then the mp4);
        else an mp4 in save_dir through OpenCV, which raises an ImportError
        naming cv2 where it is missing. Returns the mp4's path or None."""
        if writer is not None:
            import importlib.util

            if importlib.util.find_spec("moviepy") is not None:
                writer.add_video(filename, torch.from_numpy(frames).permute(0, 3, 1, 2)[None],
                                 global_step=step, fps=self.fps)
                return None
            print("TensorBoard's add_video needs moviepy (absent); writing an mp4 instead")
        cv2 = import_cv2("writing an mp4")
        os.makedirs(self.save_dir, exist_ok=True)
        path = os.path.join(self.save_dir, f"{filename}.mp4")
        h, w = frames[0].shape[:2]
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), self.fps, (w, h))
        try:
            for f in frames:
                vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        finally:
            vw.release()
        print(f"Video saved to {path}")
        return path
