"""User-facing predictors (port of cotracker_tpu/predictor.py):
CoTrackerPredictor (offline) and CoTrackerOnlinePredictor (streaming).

Videos are (B, T, 3, H, W) in [0, 255] (numpy or torch); results are torch
tensors on the model's device: tracks (B, T, N, 2) at the input resolution
and visibility (B, T, N) bool. Queries are built host-side; tracks are padded
to a bucket with a track mask as in the JAX package, so padding never
changes real-track results. `v2=True` runs the legacy CoTracker2 family
(models/cotracker2.py) behind the same surface: its window_len is the
caller's (8 for v2, 16 for v2.1, as hub.py passes them).
"""

from typing import Optional, Tuple

import numpy as np
import torch

from cotracker_tpu_torch.models.build import build_cotracker
from cotracker_tpu_torch.ops.kernels.variants import KernelVariants
from cotracker_tpu_torch.ops.bilinear import resize_bilinear
from cotracker_tpu_torch.ops.samplers import get_points_on_a_grid

N_BUCKET = 64


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class CoTrackerPredictor:
    """pred = CoTrackerPredictor(fast=True); tracks, vis = pred(video, grid_size=10)"""

    def __init__(
        self,
        checkpoint: Optional[str] = None,
        offline: bool = True,
        window_len: int = 60,
        dtype=torch.float32,
        model_resolution: Tuple[int, int] = (384, 512),
        fast: bool = False,
        device="cuda",
        dense_offsets_per_forward: int = 3,
        seed: int = 0,
        variants: Optional[KernelVariants] = None,
        v2: bool = False,
    ):
        """variants: the kernel-variant switches of the fast path; None reads
        the JAX package's environment variables once, here. v2: the legacy
        CoTracker2 model (see build_cotracker)."""
        self.model = build_cotracker(
            checkpoint, offline=offline, window_len=window_len, dtype=dtype,
            model_resolution=model_resolution, fast=fast, device=device, seed=seed,
            variants=variants, v2=v2,
        )
        self.device = next(self.model.parameters()).device
        self.interp_shape = self.model.model_resolution
        self.support_grid_size = 6
        self.dense_offsets_per_forward = dense_offsets_per_forward
        self._n_bucket = 512 if fast else N_BUCKET

    @torch.inference_mode()
    def __call__(self, video, queries=None, segm_mask=None, grid_size: int = 0,
                 grid_query_frame: int = 0, backward_tracking: bool = False):
        """video (B, T, 3, H, W) in [0, 255]; queries (B, N, 3) as (t, x, y).
        With neither queries nor grid_size, computes dense tracks."""
        if queries is None and grid_size == 0:
            return self._compute_dense_tracks(video, grid_query_frame, backward_tracking)
        return self._compute_sparse_tracks(
            video, queries, segm_mask, grid_size,
            add_support_grid=(grid_size == 0 or segm_mask is not None),
            grid_query_frame=grid_query_frame, backward_tracking=backward_tracking,
        )

    def _video(self, video):
        return torch.as_tensor(video, dtype=torch.float32).to(self.device)

    @torch.inference_mode()
    def _compute_dense_tracks(self, video, grid_query_frame, backward_tracking, grid_size=80):
        """A dense grid over pixel offsets, `dense_offsets_per_forward`
        offsets' grids tracked jointly per forward."""
        video = self._video(video)
        H, W = video.shape[-2:]
        grid_step = W // grid_size
        grid_width, grid_height = W // grid_step, H // grid_step
        n_off = grid_step * grid_step
        K = max(1, int(self.dense_offsets_per_forward))
        n_pts = grid_width * grid_height
        base_x = np.tile(np.arange(grid_width), grid_height) * grid_step
        base_y = np.repeat(np.arange(grid_height), grid_width) * grid_step
        tracks, vis = [], []
        for off0 in range(0, n_off, K):
            offs = range(off0, min(off0 + K, n_off))
            pts = np.zeros((video.shape[0], n_pts * len(offs), 3), np.float32)
            pts[:, :, 0] = grid_query_frame
            for j, offset in enumerate(offs):
                pts[:, j * n_pts : (j + 1) * n_pts, 1] = base_x + offset % grid_step
                pts[:, j * n_pts : (j + 1) * n_pts, 2] = base_y + offset // grid_step
            t, v = self._compute_sparse_tracks(video, pts, backward_tracking=backward_tracking)
            tracks.append(t)
            vis.append(v)
        return torch.cat(tracks, dim=2), torch.cat(vis, dim=2)

    @torch.inference_mode()
    def _compute_sparse_tracks(self, video, queries, segm_mask=None, grid_size: int = 0,
                               add_support_grid: bool = False, grid_query_frame: int = 0,
                               backward_tracking: bool = False):
        video = self._video(video)
        B, T, _, H, W = video.shape
        ih, iw = self.interp_shape
        if queries is not None:
            queries = np.array(torch.as_tensor(queries).cpu(), dtype=np.float32, copy=True)
            queries[:, :, 1] *= (iw - 1) / (W - 1)
            queries[:, :, 2] *= (ih - 1) / (H - 1)
        elif grid_size > 0:
            grid_pts = get_points_on_a_grid(grid_size, self.interp_shape).numpy()
            if segm_mask is not None:
                segm = np.asarray(torch.as_tensor(segm_mask).cpu())[0, 0]
                sh, sw = segm.shape
                yi = (np.arange(ih) * sh / ih).astype(np.int64)
                xi = (np.arange(iw) * sw / iw).astype(np.int64)
                segm_r = segm[yi][:, xi]
                py = np.clip(np.rint(grid_pts[0, :, 1]).astype(np.int64), 0, ih - 1)
                px = np.clip(np.rint(grid_pts[0, :, 0]).astype(np.int64), 0, iw - 1)
                grid_pts = grid_pts[:, segm_r[py, px].astype(bool)]
            queries = np.concatenate(
                [np.full_like(grid_pts[:, :, :1], grid_query_frame), grid_pts], axis=2
            )
            queries = np.tile(queries, (B, 1, 1)).astype(np.float32)
        n_user = queries.shape[1]
        if add_support_grid:
            grid_pts = get_points_on_a_grid(self.support_grid_size, self.interp_shape).numpy()
            support = np.concatenate([np.zeros_like(grid_pts[:, :, :1]), grid_pts], axis=2)
            queries = np.concatenate([queries, np.tile(support, (B, 1, 1))], axis=1)
        n_active = queries.shape[1]
        n_pad = _round_up(max(n_active, 1), self._n_bucket)
        queries_p = np.zeros((B, n_pad, 3), np.float32)
        queries_p[:, :n_active] = queries
        mask = np.zeros((B, n_pad), bool)
        mask[:, :n_active] = True
        tracks, vis = self._sparse_forward(
            video, torch.from_numpy(queries_p).to(self.device),
            torch.from_numpy(mask).to(self.device), n_user, backward_tracking,
        )
        return tracks[:, :, :n_user], vis[:, :, :n_user]

    def _sparse_forward(self, video, queries, track_mask, n_user, backward_tracking):
        """resize -> track -> backward merge -> threshold -> snap -> rescale."""
        B, T, _, H, W = video.shape
        ih, iw = self.interp_shape
        video = resize_bilinear(video.permute(0, 1, 3, 4, 2), (ih, iw), align_corners=True)
        tracks, vis, *_ = self.model(video, queries, iters=6, track_mask=track_mask)
        if backward_tracking:
            inv_queries = queries.clone()
            inv_queries[:, :, 0] = T - 1 - queries[:, :, 0]
            inv_tracks, inv_vis, *_ = self.model(
                video.flip(1), inv_queries, iters=6, track_mask=track_mask
            )
            before = torch.arange(T, device=video.device)[None, :, None] < queries[:, None, :, 0]
            tracks = torch.where(before[..., None], inv_tracks.flip(1), tracks)
            vis = torch.where(before, inv_vis.flip(1), vis)
        visibility = vis > 0.9
        # snap each user query back onto its own frame
        qt = queries[:, :n_user, 0].to(torch.int64)
        bidx = torch.arange(B, device=video.device)[:, None].expand_as(qt)
        nidx = torch.arange(n_user, device=video.device)[None, :].expand_as(qt)
        tracks = tracks.clone()
        tracks[bidx, qt, nidx] = queries[:, :n_user, 1:]
        visibility[bidx, qt, nidx] = True
        scale = torch.tensor([(W - 1) / (iw - 1), (H - 1) / (ih - 1)], dtype=torch.float32,
                             device=video.device)
        return tracks * scale, visibility


class CoTrackerOnlinePredictor:
    """Streaming predictor. Call once with `is_first_step=True` (registers the
    queries or the grid and resets the stream), then with consecutive
    `window_len`-frame chunks every `step = window_len // 2` frames:

        op = CoTrackerOnlinePredictor(fast=True, capacity=256)
        op(video[:, :1], is_first_step=True, grid_size=10)
        for ind in range(0, T - op.step, op.step):
            tracks, vis = op(video[:, ind : ind + 2 * op.step])

    Each call returns the tracks (B, frames_seen, N, 2) and visibility
    (B, frames_seen, N) of every frame so far, at the input resolution; with
    `return_full_buffers` the full (B, capacity, ...) buffers instead, valid
    on [0, frames_seen). Memory is constant in video length: `capacity`
    frames of predictions. A chunk shorter than the window is padded by
    repeating its last frame."""

    def __init__(
        self,
        checkpoint: Optional[str] = None,
        window_len: int = 16,
        capacity: int = 4096,
        dtype=torch.float32,
        model_resolution: Tuple[int, int] = (384, 512),
        fast: bool = False,
        return_full_buffers: bool = False,
        device="cuda",
        seed: int = 0,
        variants: Optional[KernelVariants] = None,
        v2: bool = False,
    ):
        """variants, v2: as CoTrackerPredictor's. The v2 stream thresholds
        its visibility alone (vis > 0.6): the legacy model has no
        confidence."""
        self.v2 = v2
        self.model = build_cotracker(
            checkpoint, offline=False, window_len=window_len, dtype=dtype,
            model_resolution=model_resolution, fast=fast, device=device, seed=seed,
            variants=variants, v2=v2,
        )
        self.device = next(self.model.parameters()).device
        self.interp_shape = self.model.model_resolution
        self.support_grid_size = 6
        self.step = self.model.window_len // 2
        self.capacity = capacity
        self.return_full_buffers = return_full_buffers
        self._n_bucket = 512 if fast else N_BUCKET
        self._state = None
        self._queries = self._track_mask = self._orig_hw = None
        self._n_user = 0
        self._frames_seen = 0

    @property
    def frames_seen(self) -> int:
        """Frames covered by predictions so far: the valid prefix of the
        full-capacity buffers when return_full_buffers is set."""
        return self._frames_seen

    @torch.inference_mode()
    def __call__(self, video_chunk, is_first_step: bool = False, queries=None,
                 grid_size: int = 5, grid_query_frame: int = 0, add_support_grid: bool = False):
        """video_chunk (B, T <= window_len, 3, H, W) in [0, 255]; queries
        (B, N, 3) as (t, x, y) at the input resolution, read at the first
        step only. The first step returns (None, None)."""
        B, T_true, _, H, W = video_chunk.shape
        ih, iw = self.interp_shape
        if is_first_step:
            self._register(B, H, W, queries, grid_size, grid_query_frame, add_support_grid)
            return None, None
        if self._queries is None:
            raise RuntimeError("call the predictor with is_first_step=True first")

        S = self.model.window_len
        if T_true > S:
            raise ValueError(f"online mode: a chunk holds at most window_len={S} frames, "
                             f"got {T_true}")
        chunk = torch.as_tensor(video_chunk, dtype=torch.float32).to(self.device)
        if T_true < S:  # pad with the last frame
            chunk = torch.cat([chunk, chunk[:, -1:].expand(-1, S - T_true, -1, -1, -1)], dim=1)
        if self._state is None:
            self._state = self.model.online_init(B, self._queries.shape[1], self.capacity)
        ind = self._state.ind
        if ind + S > self.capacity:
            raise ValueError(
                f"online prediction buffer overflow: window [{ind}, {ind + S}) exceeds "
                f"capacity={self.capacity}; construct CoTrackerOnlinePredictor(capacity=...) "
                f"to cover the stream length"
            )
        chunk = resize_bilinear(chunk.permute(0, 1, 3, 4, 2), (ih, iw), align_corners=True)
        if self.v2:  # no fmaps-tail cache to gate, no confidence
            self._state, coords, vis = self.model.online_step(
                self._state, chunk, self._queries, iters=6, track_mask=self._track_mask)
        else:
            self._state, coords, vis, conf = self.model.online_step(
                self._state, chunk, self._queries, iters=6, track_mask=self._track_mask,
                chunk_valid_len=T_true,
            )
        self._frames_seen = min(ind + T_true, self.capacity)

        n = self._n_user
        end = self.capacity if self.return_full_buffers else self._frames_seen
        H0, W0 = self._orig_hw
        scale = torch.tensor([(W0 - 1) / (iw - 1), (H0 - 1) / (ih - 1)], dtype=torch.float32,
                             device=self.device)
        tracks = coords[:, :end, :n] * scale
        visibility = vis[:, :end, :n] if self.v2 else vis[:, :end, :n] * conf[:, :end, :n]
        return tracks, visibility > 0.6

    def _register(self, B, H, W, queries, grid_size, grid_query_frame, add_support_grid):
        """First step: reset the stream and build the padded model-resolution
        queries with their track mask."""
        ih, iw = self.interp_shape
        if queries is not None:
            q = np.array(torch.as_tensor(queries).cpu(), dtype=np.float32, copy=True)
            q[:, :, 1] *= (iw - 1) / (W - 1)
            q[:, :, 2] *= (ih - 1) / (H - 1)
            n_user = q.shape[1]
            if add_support_grid:
                grid_pts = get_points_on_a_grid(self.support_grid_size, self.interp_shape).numpy()
                support = np.concatenate([np.zeros_like(grid_pts[:, :, :1]), grid_pts], axis=2)
                q = np.concatenate([q, np.tile(support, (q.shape[0], 1, 1))], axis=1)
        elif grid_size > 0:
            grid_pts = get_points_on_a_grid(grid_size, self.interp_shape).numpy()
            n_user = grid_size**2
            q = np.concatenate(
                [np.full_like(grid_pts[:, :, :1], grid_query_frame), grid_pts], axis=2)
        else:
            raise ValueError("the first step needs queries or a grid_size > 0")
        n_active = q.shape[1]
        n_pad = _round_up(n_active, self._n_bucket)
        qp = np.zeros((q.shape[0], n_pad, 3), np.float32)
        qp[:, :n_active] = q
        mask = np.zeros((q.shape[0], n_pad), bool)
        mask[:, :n_active] = True
        self._queries = torch.from_numpy(qp).to(self.device)
        self._track_mask = torch.from_numpy(mask).to(self.device)
        self._state = None
        self._n_user = n_user
        self._frames_seen = 0
        self._orig_hw = (H, W)
