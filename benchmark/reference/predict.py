"""The predictors' semantics around the reference model: query grids, the
resize to the model's resolution, the offline snap-back and thresholds,
and the online stream's windows. Plain torch; nothing of the program."""

import numpy as np
import torch
import torch.nn.functional as F

from reference import cotracker3 as ref


def grid_points(size, height, width):
    """The published `get_points_on_a_grid`: size x size (x, y) points over
    (height, width) with a margin of width/64, row-major: (size^2, 2)."""
    if size == 1:
        return torch.tensor([[width / 2, height / 2]], dtype=torch.float32)
    margin = width / 64
    ys, xs = np.meshgrid(np.linspace(margin, height - margin, size),
                         np.linspace(margin, width - margin, size), indexing="ij")
    return torch.from_numpy(np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32))


def to_model(video, model_hw):
    """uint8 (T, 3, H, W) -> float32 (T, h, w, 3) at the model resolution
    (bilinear, align_corners=True; the identity at the same size)."""
    x = video.to(torch.float32)
    if tuple(x.shape[-2:]) != tuple(model_hw):
        x = F.interpolate(x, model_hw, mode="bilinear", align_corners=True)
    return x.permute(0, 2, 3, 1)


def input_scale(video, model_hw):
    H, W = video.shape[-2:]
    h, w = model_hw
    return torch.tensor([(W - 1) / (w - 1), (H - 1) / (h - 1)], device=video.device)


def grid_queries(grid_size, model_hw, device):
    xy = grid_points(grid_size, *model_hw).to(device)
    return torch.cat([torch.zeros_like(xy[:, :1]), xy], dim=1)


def offline_predict(p, cfg, video, grid_size, rq=ref.identity):
    """CoTrackerPredictor on a grid at frame 0: tracks (T, N, 2) at the
    input resolution, visibility (vis > 0.9, the queries' frame snapped to
    visible), vis and conf probabilities (T, N)."""
    hw = tuple(cfg["model_resolution"])
    q = grid_queries(grid_size, hw, video.device)
    tracks, vis, conf = ref.offline_forward(p, to_model(video, hw), q, rq, cfg["iters"],
                                            cfg["window_len"], cfg["stride"])
    visible = vis > 0.9
    tracks[0] = q[:, 1:]  # every query is at frame 0: snap back
    visible[0] = True
    return tracks * input_scale(video, hw), visible, vis, conf


def online_windows(p, cfg, video, grid_size, capacity, windows, rq=ref.identity):
    """CoTrackerOnlinePredictor on a grid at frame 0 over the first
    `windows` windows of the stream: per window (its start frame, tracks
    (S, N, 2) at the input resolution, visibility (vis * conf > 0.6), vis
    and conf probabilities (S, N))."""
    hw = tuple(cfg["model_resolution"])
    S = cfg["window_len"]
    stream = ref.OnlineStream(p, grid_queries(grid_size, hw, video.device), capacity, rq,
                              cfg["iters"], S, cfg["stride"])
    scale = input_scale(video, hw)
    out = []
    for _ in range(windows):
        ind = stream.ind
        coords, vis, conf = stream.step(to_model(video[ind:ind + S], hw))
        out.append((ind, coords * scale, vis * conf > 0.6, vis, conf))
    return out
