"""The benchmark protocol's predictor (port of
cotracker_tpu/evaluation/evaluation_predictor.py). Two modes over the raw
offline model:

  * joint: all queries in one forward, with optional global-grid, SIFT and
    uniform support points removed again before the metrics;
  * single_point: each query alone, with a local 8x8 grid (50 px around the
    query) and a global 5x5 grid, one forward each (the paper's protocol).

The video is resized on the model's device; the tracks are padded to a
multiple of 64 with a track mask, as in the JAX package: with few queries
that leaves fewer than 256 tracks, where the updateformer's kernel gates
put the W8A8 blocks off. Visibility is returned fused with the confidence
(vis * conf), as host arrays; the legacy CoTracker2 model has no confidence
head, and its conf is ones.
"""

from typing import Tuple

import numpy as np
import torch

from cotracker_tpu_torch.ops.bilinear import resize_bilinear
from cotracker_tpu_torch.ops.samplers import (
    get_points_on_a_grid, get_sift_sampled_pts, get_uniformly_sampled_pts,
)

N_BUCKET = 64


def _round_up(n, m):
    return ((n + m - 1) // m) * m


def _grid_queries(size, extent, center=None):
    """A grid's (x, y) points as frame-0 (t, x, y) queries, (1, n, 3) numpy."""
    xy = get_points_on_a_grid(size, extent, center=center).numpy()
    return np.concatenate([np.zeros_like(xy[:, :, :1]), xy], axis=2)


class EvaluationPredictor:
    def __init__(
        self,
        model,
        interp_shape: Tuple[int, int] = (384, 512),
        grid_size: int = 5,
        local_grid_size: int = 8,
        single_point: bool = True,
        sift_size: int = 0,
        num_uniformly_sampled_pts: int = 0,
        n_iters: int = 6,
        local_extent: int = 50,
    ):
        """model: the port's offline CoTrackerThree or CoTracker2, on the
        device it runs on."""
        self.model = model
        self.device = next(model.parameters()).device
        self.interp_shape = interp_shape
        self.grid_size = grid_size
        self.local_grid_size = local_grid_size
        self.single_point = single_point
        self.sift_size = sift_size
        self.num_uniformly_sampled_pts = num_uniformly_sampled_pts
        self.n_iters = n_iters
        self.local_extent = local_extent

    def _run_model(self, video_cl, queries):
        """video_cl (B, T, H, W, 3) at the model resolution on the device;
        queries (B, n, 3) numpy in model pixels. Returns host (coords, vis,
        conf) of the n queries."""
        B = video_cl.shape[0]
        n = queries.shape[1]
        n_pad = _round_up(max(n, 1), N_BUCKET)
        qp = np.zeros((B, n_pad, 3), np.float32)
        qp[:, :n] = queries
        mask = np.zeros((B, n_pad), bool)
        mask[:, :n] = True
        out = self.model(
            video_cl, torch.from_numpy(qp).to(self.device), iters=self.n_iters,
            track_mask=torch.from_numpy(mask).to(self.device))
        if len(out) == 3:  # CoTracker2: (coords, vis, train_data)
            coords, vis = out[:2]
            conf = torch.ones_like(vis)
        else:
            coords, vis, conf, _ = out
        return tuple(t[:, :, :n].float().cpu().numpy() for t in (coords, vis, conf))

    @torch.inference_mode()
    def __call__(self, video, queries):
        """video (1, T, 3, H, W) in [0, 255] (numpy or tensor); queries
        (1, N, 3) as (t, x, y) at the input resolution. Returns (tracks
        (1, T, N, 2) at the input resolution, vis * conf (1, T, N))."""
        queries = np.array(torch.as_tensor(queries).cpu(), np.float32, copy=True)
        B, T, _, H, W = video.shape
        ih, iw = self.interp_shape
        assert B == 1
        video = torch.as_tensor(video).to(self.device, torch.float32)
        video_cl = resize_bilinear(video.permute(0, 1, 3, 4, 2), (ih, iw), align_corners=True)
        queries[:, :, 1] *= (iw - 1) / (W - 1)
        queries[:, :, 2] *= (ih - 1) / (H - 1)

        if self.single_point:
            N = queries.shape[1]
            traj = np.zeros((B, T, N, 2), np.float32)
            vis = np.zeros((B, T, N), np.float32)
            conf = np.zeros((B, T, N), np.float32)
            for p in range(N):
                t, v, c = self._process_one_point(video_cl, queries[:, p : p + 1])
                traj[:, :, p], vis[:, :, p], conf[:, :, p] = t[:, :, 0], v[:, :, 0], c[:, :, 0]
        else:
            n_user = queries.shape[1]
            q = queries
            if self.grid_size > 0:
                q = np.concatenate([q, _grid_queries(self.grid_size, (ih, iw))], axis=1)
            if self.num_uniformly_sampled_pts > 0:
                xy = get_uniformly_sampled_pts(self.num_uniformly_sampled_pts, T, (ih, iw))
                q = np.concatenate([q, xy.numpy()], axis=1)
            if self.sift_size > 0:
                xy = get_sift_sampled_pts(video_cl.to(torch.uint8), self.sift_size, T, (ih, iw))
                if xy.shape[1] == self.sift_size:
                    q = np.concatenate([q, xy.numpy()], axis=1)
            traj, vis, conf = (a[:, :, :n_user] for a in self._run_model(video_cl, q))

        traj = traj * np.array([(W - 1) / float(iw - 1), (H - 1) / float(ih - 1)], np.float32)
        return traj, vis * conf

    def _process_one_point(self, video_cl, query):
        """The query, a local grid around it and the global grid."""
        ih, iw = self.interp_shape
        q = query
        if self.local_grid_size > 0:
            center = [query[0, 0, 2], query[0, 0, 1]]
            q = np.concatenate([q, _grid_queries(
                self.local_grid_size, (self.local_extent, self.local_extent), center)], axis=1)
        if self.grid_size > 0:
            q = np.concatenate([q, _grid_queries(self.grid_size, (ih, iw))], axis=1)
        if self.num_uniformly_sampled_pts > 0:
            xy = get_uniformly_sampled_pts(self.num_uniformly_sampled_pts, video_cl.shape[1],
                                           (ih, iw))
            q = np.concatenate([q, xy.numpy()], axis=1)
        return self._run_model(video_cl, q)
