"""The legacy CoTracker2 family, v2 (window_len=8) and v2.1 (window_len=16),
offline and streaming (port of cotracker_tpu/models/cotracker2.py).

Layouts as in the JAX package and models/cotracker3.py: videos
(B, T, H, W, 3) in [0, 255], channel-last feature maps, queries (B, N, 3)
as (t, x, y) model pixels, coords and vis logits carried in float32 whatever
the compute dtype. The JAX scans over windows and iterations are Python
loops: `window_core` is the JAX `V2WindowCore`, `iter_core` its
`V2IterCore`.

Architecture (reference cotracker.py:29-84): stride 4, latent 128, input
tokens of 456 (a 130-d flow embedding, 4 x 49 correlation taps, the
128-d track feature, the mask and the vis logit), an update transformer of
6 time blocks and 6 space rounds at hidden 384 whose flow head gives 2
coords and 128 track-feature deltas, a GroupNorm + Linear + exact GELU
track-feature updater and a linear visibility predictor. Unlike
CoTracker3, the feature maps are not L2-normalised, the track feature is one
centre tap per query, and the local correlation is the dot product of that
feature with 7x7 bilinear patches at four levels, scaled by 1/sqrt(128) and
accumulated in float32 (the dense correlation map sampled bilinearly, by
linearity).

Module and parameter names are the reference state_dict's (`fnet`,
`updateformer`, `norm`, `track_feat_updater.0`, `vis_predictor.0`), so a
reference `.pth` loads through models/checkpoint.py. The time and position
embeddings are buffers rebuilt by the constructor and kept out of the
state_dict. No kernel of ops/kernels runs here: the JAX package has none
for this model.
"""

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from cotracker_tpu_torch.models.blocks import AffineLayerNorm, BasicEncoder, dense
from cotracker_tpu_torch.models.cotracker3 import sample_patch_features
from cotracker_tpu_torch.models.updateformer import EfficientUpdateFormer
from cotracker_tpu_torch.ops.bilinear import sample_features_2d, sample_features_3d
from cotracker_tpu_torch.ops.embeddings import (
    get_1d_sincos_pos_embed, get_2d_embedding, get_2d_sincos_pos_embed,
)

F32 = torch.float32


class OnlineStateV2(NamedTuple):
    """Streaming carry of CoTracker2. `online_step` consumes the state it is
    given: its buffers are updated in place and handed on in the state it
    returns, so a state is used for one step only."""

    ind: int  # start frame of the next window (host integer)
    track_feat: torch.Tensor  # (B, 1, N, C) accumulated centre features, f32
    coords: torch.Tensor  # (B, CAP, N, 2) predicted tracks, model pixels, f32
    vis: torch.Tensor  # (B, CAP, N) visibility logits, f32


class CoTracker2(nn.Module):
    """The legacy tracker: window_len=8 is v2, window_len=16 is v2.1."""

    def __init__(
        self,
        window_len: int = 8,
        stride: int = 4,
        corr_radius: int = 3,
        corr_levels: int = 4,
        num_virtual_tracks: int = 64,
        model_resolution: Tuple[int, int] = (384, 512),
        add_space_attn: bool = True,
        latent_dim: int = 128,
        input_dim: int = 456,
        dtype=F32,
    ):
        super().__init__()
        self.window_len, self.stride = window_len, stride
        self.corr_radius, self.corr_levels = corr_radius, corr_levels
        self.model_resolution = tuple(model_resolution)
        self.latent_dim, self.dtype = latent_dim, dtype
        self.fnet = BasicEncoder(output_dim=latent_dim, stride=stride)
        self.updateformer = EfficientUpdateFormer(
            space_depth=6, time_depth=6, input_dim=input_dim, hidden_size=384, num_heads=8,
            output_dim=latent_dim + 2, mlp_ratio=4.0, num_virtual_tracks=num_virtual_tracks,
            add_space_attn=add_space_attn, dtype=dtype, linear_layer_for_vis_conf=False,
            v2_masking=True,
        )
        # the reference's GroupNorm(1, latent): an affine LayerNorm, eps 1e-5
        self.norm = AffineLayerNorm(latent_dim, eps=1e-5)
        self.track_feat_updater = nn.Sequential(nn.Linear(latent_dim, latent_dim), nn.GELU())
        self.vis_predictor = nn.Sequential(nn.Linear(latent_dim, 1))
        grid = np.linspace(0, window_len - 1, window_len)
        self.register_buffer(
            "time_emb", torch.from_numpy(get_1d_sincos_pos_embed(input_dim, grid)),
            persistent=False,
        )
        gh, gw = self.model_resolution[0] // stride, self.model_resolution[1] // stride
        self.register_buffer(
            "pos_emb", torch.from_numpy(get_2d_sincos_pos_embed(input_dim, (gh, gw))),
            persistent=False,
        )

    # ------------------------------------------------------------ features

    def compute_fmaps(self, video):
        """video (B, T, H, W, 3) in [0, 255] -> fmaps (B, T, H/stride,
        W/stride, latent) in the compute dtype, not normalised."""
        B, T, H, W, _ = video.shape
        frames = (2 * (video / 255.0) - 1.0).to(self.dtype).reshape(B * T, H, W, 3)
        fmaps = self.fnet(frames)
        return fmaps.reshape(B, T, H // self.stride, W // self.stride, self.latent_dim)

    def build_pyramid(self, fmaps):
        """2x2 average-pool pyramid, corr_levels deep."""
        pyramid = [fmaps]
        for _ in range(self.corr_levels - 1):
            B, T, H, W, C = fmaps.shape
            x = F.avg_pool2d(fmaps.reshape(B * T, H, W, C).permute(0, 3, 1, 2), 2, 2)
            fmaps = x.permute(0, 2, 3, 1).reshape(B, T, H // 2, W // 2, C)
            pyramid.append(fmaps)
        return pyramid

    def get_track_feat(self, fmaps, queried_frames, queried_coords):
        """One spatio-temporal bilinear sample a query, at (t, x, y):
        (B, 1, N, C)."""
        pts = torch.cat([queried_frames[..., None], queried_coords], dim=-1)[:, None]
        return sample_features_3d(fmaps, pts)

    # ------------------------------------------------------------ updates

    def iter_core(self, coords, track_feat, fmaps_pyramid, track_mask_vis, sampled_pos_emb,
                  attention_mask):
        """One update (JAX V2IterCore). coords (B, S, N, 2) f32 in fmap
        units, track_feat (B, S, N, C) f32. Returns the new coords, the new
        track features and the coords in model pixels."""
        coords = coords.detach()
        B, S, N, _ = coords.shape
        C, cd = self.latent_dim, self.dtype
        P = 2 * self.corr_radius + 1
        fcorrs = []
        for i, fmaps in enumerate(fmaps_pyramid):
            patches = sample_patch_features(fmaps, coords.to(cd) / 2**i, self.corr_radius)
            # the products of the compute dtype, summed in float32
            corr = torch.einsum("bsnijc,bsnc->bsnij", patches.to(F32),
                                track_feat.to(cd).to(F32)) / math.sqrt(C)
            fcorrs.append(corr.reshape(B, S, N, P * P))
        fcorrs = torch.cat(fcorrs, dim=-1)  # (B, S, N, 196), taps x-major level by level

        # the flow relative to the window's first frame, in fmap units
        flows = (coords - coords[:, 0:1]).transpose(1, 2)  # (B, N, S, 2)
        flow_emb = get_2d_embedding(flows.reshape(B * N, S, 2), 64, cat_coords=True)
        x = torch.cat([
            flow_emb.reshape(B, N, S, -1).to(cd),
            fcorrs.transpose(1, 2).to(cd),
            track_feat.transpose(1, 2).to(cd),
            track_mask_vis.to(cd),
        ], dim=-1)  # (B, N, S, 456)
        x = x + sampled_pos_emb.to(cd) + self.time_emb[:, None].to(cd)

        delta = self.updateformer(x, track_mask=attention_mask).to(F32)
        coords = coords + delta[..., :2].transpose(1, 2)
        # GroupNorm -> Linear -> exact GELU, residual
        dfeat = self.norm(delta[..., 2:])
        upd = F.gelu(dense(self.track_feat_updater[0], dfeat, cd), approximate="none")
        track_feat = track_feat + upd.transpose(1, 2).to(track_feat.dtype)
        return coords, track_feat, coords * float(self.stride)

    def window_core(self, coords_buf, vis_buf, ind: int, fmaps_pyramid, track_feat_center,
                    queried_frames, queried_coords, track_mask, iters: int,
                    fmap_origin: int = 0):
        """One sliding window starting at frame `ind` (JAX V2WindowCore).
        coords_buf (B, CAP, N, 2) model pixels and vis_buf (B, CAP, N)
        logits are written in place on [ind, ind + S); the pyramid's frames
        start at global frame `fmap_origin`. Returns the per-iteration
        coords (model pixels) and the window's vis logits."""
        S = self.window_len
        step = S // 2
        overlap = S - step
        B, _, N, _ = coords_buf.shape
        dev = coords_buf.device
        local = ind - fmap_origin
        fmaps_win = [f[:, local : local + S] for f in fmaps_pyramid]

        # warm start: the previous window's predictions on the overlap, then
        # its last frame repeated, for the tracks queried before ind + overlap
        coords_init = queried_coords[:, None].expand(B, S, N, 2)
        vis_init = torch.full((B, S, N), 10.0, dtype=F32, device=dev)
        if ind > 0:
            copy_over = (queried_frames < float(ind + overlap))[:, None, :]
            prev_c = coords_buf[:, ind : ind + overlap] / self.stride
            prev_c = torch.cat([prev_c, prev_c[:, -1:].expand(B, step, N, 2)], dim=1)
            prev_v = vis_buf[:, ind : ind + overlap]
            prev_v = torch.cat([prev_v, prev_v[:, -1:].expand(B, step, N)], dim=1)
            coords_init = torch.where(copy_over[..., None], prev_c, coords_init)
            vis_init = torch.where(copy_over, prev_v, vis_init)
        coords_init = coords_init.contiguous()

        # the attention mask: queried before the window's end; the track mask:
        # the (frame, track) points this window updates (not the overlap)
        attention_mask = (queried_frames < float(ind + S)) & track_mask
        frames = ind + torch.arange(S, dtype=F32, device=dev)
        tm = queried_frames[:, None, :] <= frames[None, :, None]  # (B, S, N)
        if ind > 0:
            tm = tm & (torch.arange(S, device=dev) >= overlap)[None, :, None]

        track_feat = (track_feat_center.expand(B, S, N, self.latent_dim)
                      * attention_mask[:, None, :, None].to(track_feat_center.dtype))
        track_mask_vis = torch.cat([tm[..., None].to(F32), vis_init[..., None]],
                                   dim=-1).transpose(1, 2)  # (B, N, S, 2)
        # the position embedding sampled at the window-initial coords
        pos_maps = self.pos_emb.expand(B, *self.pos_emb.shape[1:])
        sampled_pos = sample_features_2d(pos_maps, coords_init[:, 0])[:, :, None]  # (B, N, 1, D)

        coords = coords_init
        coord_preds = []
        for _ in range(iters):
            coords, track_feat, coords_px = self.iter_core(
                coords, track_feat, fmaps_win, track_mask_vis, sampled_pos, attention_mask)
            coord_preds.append(coords_px)
        vis_logits = dense(self.vis_predictor[0], track_feat, self.dtype)[..., 0].to(F32)
        coords_buf[:, ind : ind + S] = coord_preds[-1]
        vis_buf[:, ind : ind + S] = vis_logits
        return coord_preds, vis_logits

    # ------------------------------------------------------------ offline

    def forward(self, video, queries, iters: int = 4, track_mask=None, is_train: bool = False):
        """Offline forward over sliding windows. video (B, T, H, W, 3) in
        [0, 255]; queries (B, N, 3) (t, x, y) model pixels; track_mask
        (B, N) marks real tracks. Returns (coords (B, T, N, 2) pixels, vis
        (B, T, N) probabilities, train_data): train_data is None, or with
        is_train (per-window per-iteration coords (W, iters, B, S, N, 2)
        pixels, per-window vis probabilities (W, B, S, N), the query mask
        (B, T, N), the windows' start frames (W,))."""
        B, T = video.shape[:2]
        N = queries.shape[1]
        S = self.window_len
        step = S // 2
        pad = (S - T % S) % S
        if pad:  # repeat the last frame
            video = torch.cat([video, video[:, -1:].expand(B, pad, *video.shape[2:])], dim=1)
        queried_frames = queries[..., 0].to(F32)
        queried_coords = queries[..., 1:3].to(F32) / self.stride

        fmaps = self.compute_fmaps(video)
        pyramid = self.build_pyramid(fmaps)
        track_feat = self.get_track_feat(fmaps, queried_frames, queried_coords)
        if track_mask is None:
            track_mask = torch.ones((B, N), dtype=torch.bool, device=video.device)

        num_windows = max((T - S + step - 1) // step + 1, 1)
        coords_buf = torch.zeros((B, T + pad, N, 2), dtype=F32, device=video.device)
        vis_buf = torch.zeros((B, T + pad, N), dtype=F32, device=video.device)
        windows = [
            self.window_core(coords_buf, vis_buf, w * step, pyramid, track_feat,
                             queried_frames, queried_coords, track_mask, iters)
            for w in range(num_windows)
        ]
        coords, vis = coords_buf[:, :T], torch.sigmoid(vis_buf[:, :T])
        train_data = None
        if is_train:
            mask = (queried_frames[:, None, :]
                    <= torch.arange(T, dtype=F32, device=video.device)[None, :, None])
            train_data = (
                torch.stack([torch.stack(cp) for cp, _ in windows]),
                torch.sigmoid(torch.stack([v for _, v in windows])),
                mask,
                torch.arange(num_windows, dtype=torch.int32, device=video.device) * step,
            )
        return coords, vis, train_data

    # ------------------------------------------------------------ streaming

    def online_init(self, batch: int, num_tracks: int, capacity: int) -> OnlineStateV2:
        """Fresh streaming state with `capacity` frames of prediction buffer,
        on the model's device."""
        dev = self.time_emb.device
        return OnlineStateV2(
            ind=0,
            track_feat=torch.zeros((batch, 1, num_tracks, self.latent_dim), dtype=F32, device=dev),
            coords=torch.zeros((batch, capacity, num_tracks, 2), dtype=F32, device=dev),
            vis=torch.zeros((batch, capacity, num_tracks), dtype=F32, device=dev),
        )

    def online_step(self, state: OnlineStateV2, video_chunk, queries, iters: int = 4,
                    track_mask: Optional[torch.Tensor] = None):
        """Process one sliding window [ind, ind + S) of the stream.
        video_chunk (B, S, H, W, 3): the current window, already padded to
        S = window_len frames; queries (B, N, 3) global (t, x, y) in model
        pixels, the same at every step. Returns (new_state, coords
        (B, CAP, N, 2) pixels, vis (B, CAP, N) probabilities), valid on
        [0, ind + S). `state` is consumed (see OnlineStateV2); the returned
        tensors are copies that later steps do not touch."""
        B, S = video_chunk.shape[:2]
        if S != self.window_len:
            raise ValueError(f"online_step takes chunks of window_len={self.window_len} frames, "
                             f"got {S}")
        step = S // 2
        ind = state.ind
        if ind + S > state.coords.shape[1]:
            raise ValueError(f"online prediction buffer overflow: window [{ind}, {ind + S}) "
                             f"exceeds capacity={state.coords.shape[1]}")
        queried_frames = queries[..., 0].to(F32)
        queried_coords = queries[..., 1:3].to(F32) / self.stride
        fmaps = self.compute_fmaps(video_chunk)
        pyramid = self.build_pyramid(fmaps)

        # the features of the queries in the fresh part of this window, each
        # added once
        new_feat = self.get_track_feat(fmaps, queried_frames - float(ind), queried_coords)
        left = 0 if ind == 0 else ind + step
        fresh = (queried_frames >= left) & (queried_frames < ind + S)
        state.track_feat.add_(new_feat.to(F32) * fresh[:, None, :, None].to(F32))

        if track_mask is None:
            track_mask = torch.ones(queried_frames.shape, dtype=torch.bool,
                                    device=queried_frames.device)
        self.window_core(state.coords, state.vis, ind, pyramid, state.track_feat,
                         queried_frames, queried_coords, track_mask, iters, fmap_origin=ind)
        return (state._replace(ind=ind + step), state.coords.clone(),
                torch.sigmoid(state.vis))
