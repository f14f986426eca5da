"""CoTracker3 model, offline and streaming, inference and training (port of
cotracker_tpu/models/cotracker3.py).

Layouts as in the JAX package: videos (B, T, H, W, 3) in [0, 255], feature
maps (B, T, H/4, W/4, 128), queries (B, N, 3) as (t, x, y) model pixels,
coords/vis/conf carried in float32 across iterations whatever the compute
dtype. The scanned iteration core of the JAX package is a Python loop.

Three ways through the model, all over the same per-window `iterate`:
`forward` (the whole video as one window), `forward_windows` (sliding
windows with warm-started chaining over a full video) and the streaming pair
`online_init` / `online_step` (one window per call, constant memory in video
length, explicit OnlineState carry).

Two iteration forms: the reference one (per-level correlation embeddings
concatenated into the 1110-d input and projected), and `fold_input_proj`,
which folds the input projection into each level's correlation MLP second
layer. With `kernels` (the fast path, which requires fold_input_proj) the
correlation runs through the K4 int8 kernel and the update transformer's
point-side blocks through the W8A8 kernels K1-K3 (K8 -> K5 -> K9 for the
time blocks of videos over 128 frames; with fewer than 256 tracks the JAX
gates leave K5 between plain projections and plain space blocks, see
models/blocks.py); `attn_quant_int8=False` beside it keeps K4 and swaps
K1-K3 for the attention-core kernels K5-K7 between plain projections (the
JAX package's `use_pallas_attn` without `attn_quant_int8`).

The kernel-variant switches of the JAX package (`variants`, a
`KernelVariants`: `corr_fuse_mlp1`, `space_allt`, `bf16_ln`,
`gelu_quant_fold`; ops/kernels/variants.py) are fixed when the model is
built. With `kernels`, `corr_fuse_mlp1` runs every level's correlation and
MLP1 through K4m instead of K4 and the int8 MLP1 product; the other three
reach the update transformer's W8A8 blocks. Off by default, as in JAX.

Training (`is_train=True` of `forward` and `forward_windows`) runs the
unfolded form with plain updateformer blocks. `corr_kernels` (the JAX
package's `use_pallas_corr` with `corr_pallas_grad`) puts each level's
correlation through K4r (`corr_quant_int8`) or K4f and the epilogue,
wrapped in an autograd Function whose backward is the plain featurizer;
with `corr_fuse_mlp1` that forward is K4m (int8 only, as in JAX, whose
training wrapper reads the variable). `remat_iterations` recomputes each
iteration in the backward pass.
"""

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cotracker_tpu_torch.models.blocks import BasicEncoder, Mlp
from cotracker_tpu_torch.models.updateformer import EfficientUpdateFormer
from cotracker_tpu_torch.ops.bilinear import (
    bilinear_sample_frames, resize_linear_1d, sample_features_3d,
)
from cotracker_tpu_torch.ops.corr import fused_corr_embs, pad_fmaps, window_starts_and_weights
from cotracker_tpu_torch.ops.embeddings import get_1d_sincos_pos_embed, posenc
from cotracker_tpu_torch.ops.kernels import corr_cuda
from cotracker_tpu_torch.ops.kernels.variants import OFF, KernelVariants

F32 = torch.float32
# get_track_feat gathers at most this many points' windows at once
_TRACK_FEAT_CHUNK = 8192


def sample_patch_features(fmaps, coords, radius: int):
    """Bilinear (2r+1)x(2r+1) patches around points: fmaps (B, T, H, W, C),
    coords (B, T, N, 2) (x, y) in this level's pixels -> (B, T, N, P, P, C),
    patch[i, j] sampled at (x + i - r, y + j - r) (first axis offsets x)."""
    B, T, H, W, C = fmaps.shape
    N = coords.shape[2]
    P = 2 * radius + 1
    d = torch.arange(-radius, radius + 1, dtype=coords.dtype, device=coords.device)
    offs = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1)  # (P, P, 2)
    pts = (coords[:, :, :, None, None, :] + offs).reshape(B * T, N, P, P, 2)
    out = bilinear_sample_frames(fmaps.reshape(B * T, H, W, C), pts)
    return out.reshape(B, T, N, P, P, C)


def _get_track_feat_taps(fmaps, queried_frames, queried_coords, radius: int):
    """Per-tap trilinear form of get_track_feat (the T == 1 fallback)."""
    B = fmaps.shape[0]
    N = queried_frames.shape[1]
    P = 2 * radius + 1
    d = torch.arange(-radius, radius + 1, dtype=queried_coords.dtype, device=fmaps.device)
    offs = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1)  # (P, P, 2) x-first
    txy = torch.cat([queried_frames[..., None], queried_coords], dim=-1)  # (B, N, 3)
    pts = txy[:, :, None, None, :] + F.pad(offs, (1, 0))[None, None]
    pts = pts.reshape(B, N, P * P, 3).transpose(1, 2)  # (B, P*P, N, 3)
    return sample_features_3d(fmaps, pts)


def get_track_feat(fmaps, queried_frames, queried_coords, radius: int):
    """Support patches at the query frame, window form: one (2, 8, 8, C)
    window per point (two frames for the trilinear blend in t; wt is 0 for
    integer query frames) and the shared-fraction 4-term spatial combine.
    fmaps (B, T, H, W, C); queried_frames (B, N); queried_coords (B, N, 2)
    in this level's pixels. Returns center (B, 1, N, C), support (B, P*P, N, C)."""
    B, T, H, W, C = fmaps.shape
    N = queried_frames.shape[1]
    P = 2 * radius + 1
    WIN = P + 1
    if T < 2:
        support = _get_track_feat_taps(fmaps, queried_frames, queried_coords, radius)
        return support[:, None, (P * P) // 2], support
    if N > _TRACK_FEAT_CHUNK * 2:
        # bounds the (B, N, 2, WIN, WIN, C) window transient, which the
        # streaming accumulate holds for four levels at quasi-dense N
        parts = [
            get_track_feat(fmaps, queried_frames[:, s0 : s0 + _TRACK_FEAT_CHUNK],
                           queried_coords[:, s0 : s0 + _TRACK_FEAT_CHUNK], radius)
            for s0 in range(0, N, _TRACK_FEAT_CHUNK)
        ]
        return (torch.cat([f for f, _ in parts], dim=2),
                torch.cat([s for _, s in parts], dim=2))
    wsx, wsy, wx, wy = window_starts_and_weights(queried_coords, radius, H, W)
    t = queried_frames.to(F32).clamp(0.0, T - 1.0)
    t0 = torch.floor(t)
    wt = (t - t0)[..., None, None, None]
    t0c = t0.clamp(max=T - 2.0)
    sel = (t0 - t0c)[..., None, None, None]
    fmaps_p = pad_fmaps(fmaps, radius)
    dev = fmaps.device
    bi = torch.arange(B, device=dev)[:, None, None, None, None]
    tt = (t0c.long()[..., None] + torch.arange(2, device=dev))[..., :, None, None]
    dw = torch.arange(WIN, device=dev)
    yy = (wsy[..., None] + dw)[:, :, None, :, None]
    xx = (wsx[..., None] + dw)[:, :, None, None, :]
    win = fmaps_p[bi, tt, yy, xx]  # (B, N, 2, WIN(y), WIN(x), C)
    p0 = torch.where(sel > 0.5, win[:, :, 1], win[:, :, 0])
    blended = p0 + wt.to(win.dtype) * (win[:, :, 1] - p0)
    wxb = wx[..., None, None, None].to(blended.dtype)
    wyb = wy[..., None, None, None].to(blended.dtype)
    patch = (
        (1 - wyb) * (1 - wxb) * blended[:, :, :P, :P]
        + (1 - wyb) * wxb * blended[:, :, :P, 1:]
        + wyb * (1 - wxb) * blended[:, :, 1:, :P]
        + wyb * wxb * blended[:, :, 1:, 1:]
    )  # (B, N, P(y), P(x), C)
    support = patch.permute(0, 3, 2, 1, 4).reshape(B, P * P, N, C)  # x-major i*P + j
    return support[:, None, (P * P) // 2], support


class OnlineState(NamedTuple):
    """Streaming-tracker carry; all buffers have fixed capacity. `online_step`
    consumes the state it is given: the prediction and support buffers are
    updated in place and handed on in the state it returns, so a state is
    used for one step only."""

    ind: int  # start frame of the next window (host integer)
    track_feat: Tuple[torch.Tensor, ...]  # per level (B, 1, N, C)
    track_support: Tuple[torch.Tensor, ...]  # per level (B, P*P, N, C)
    coords: torch.Tensor  # (B, CAP, N, 2) predicted tracks, model pixels, f32
    vis: torch.Tensor  # (B, CAP, N) visibility logits, f32
    conf: torch.Tensor  # (B, CAP, N) confidence logits, f32
    # level-0 feature maps of the previous window's last `step` frames:
    # consecutive windows overlap by S/2 and fnet is per-frame, so the cache
    # is exact; (B, S/2, H/stride, W/stride, latent)
    fmaps_tail: torch.Tensor
    # number of real (non-padded) frames in fmaps_tail (host integer): a tail
    # cached from a padded chunk holds features of repeated frames and is not
    # reused; online_step re-encodes everything unless tail_valid == step
    tail_valid: int
    # host copy of the queries' frames, taken at the first window: decides
    # without a device synchronisation whether a window has queries to absorb
    query_frames: Optional[np.ndarray] = None


class CoTrackerThree(nn.Module):
    """The CoTracker3 tracker; one parameterization serves the offline
    (window_len=60) and online (window_len=16) checkpoints."""

    def __init__(
        self,
        window_len: int = 60,
        stride: int = 4,
        corr_radius: int = 3,
        corr_levels: int = 4,
        num_virtual_tracks: int = 64,
        model_resolution: Tuple[int, int] = (384, 512),
        add_space_attn: bool = True,
        latent_dim: int = 128,
        input_dim: int = 1110,
        dtype=F32,
        corr_chunk: Optional[int] = None,
        fold_input_proj: bool = False,
        kernels: bool = False,
        attn_kernels: Optional[bool] = None,
        attn_quant_int8: Optional[bool] = None,
        corr_kernels: bool = False,
        corr_quant_int8: bool = False,
        remat_iterations: bool = False,
        variants: KernelVariants = OFF,
    ):
        """kernels: the K4 correlation kernel, and the default of the two
        updateformer switches. attn_kernels: the attention-core kernels
        K5-K7; attn_quant_int8: the W8A8 block kernels K1-K3, which take
        precedence where both are set. `kernels=True` alone is everything on
        (K1-K4 run); `kernels=True, attn_quant_int8=False` runs K4-K7.

        The training switches, apart from `kernels` and turning on none of
        K1-K7: corr_kernels, the per-level correlation through K4r or K4f
        and the autograd wrapper (JAX `use_pallas_corr` + `corr_pallas_grad`:
        one switch here, because the wrapper costs nothing without a
        gradient); corr_quant_int8, K4r (int8 windows and support, JAX
        `corr_quant_int8`) instead of K4f; remat_iterations, each iteration
        checkpointed and recomputed in the backward pass (JAX `nn.remat` of
        the iteration core).

        variants: the JAX package's kernel-variant switches (see the module
        docstring); of these the training path's wrapper takes
        corr_fuse_mlp1 (K4m forward, int8 only, as the JAX wrapper reads it)."""
        super().__init__()
        if kernels and not fold_input_proj:
            raise ValueError("kernels=True runs the folded correlation path; set fold_input_proj")
        if kernels and corr_kernels:
            raise ValueError("kernels=True (K4) and corr_kernels (K4r/K4f) are two correlation "
                             "paths; set one")
        if corr_kernels and variants.corr_fuse_mlp1 and not corr_quant_int8:
            raise ValueError("corr_fuse_mlp1 rides the int8 window/support path (K4m): set "
                             "corr_quant_int8")
        attn_kernels = kernels if attn_kernels is None else attn_kernels
        attn_quant_int8 = kernels if attn_quant_int8 is None else attn_quant_int8
        self.window_len, self.stride = window_len, stride
        self.corr_radius, self.corr_levels = corr_radius, corr_levels
        self.model_resolution = tuple(model_resolution)
        self.latent_dim, self.dtype = latent_dim, dtype
        self.corr_chunk, self.fold_input_proj, self.kernels = corr_chunk, fold_input_proj, kernels
        self.corr_kernels, self.corr_quant_int8 = corr_kernels, corr_quant_int8
        self.remat_iterations = remat_iterations
        self.variants = variants
        P = 2 * corr_radius + 1
        self.fnet = BasicEncoder(output_dim=latent_dim, stride=stride)
        self.corr_mlp = Mlp(P**4, 384, 256)
        self.updateformer = EfficientUpdateFormer(
            space_depth=3, time_depth=3, input_dim=input_dim, hidden_size=384, num_heads=8,
            output_dim=4, mlp_ratio=4.0, num_virtual_tracks=num_virtual_tracks,
            add_space_attn=add_space_attn, dtype=dtype, attn_kernels=attn_kernels,
            quant_int8=attn_quant_int8, variants=variants,
        )
        grid = np.linspace(0, window_len - 1, window_len)
        self.register_buffer(
            "time_emb", torch.from_numpy(get_1d_sincos_pos_embed(input_dim, grid)), persistent=False
        )

    # ------------------------------------------------------------ features

    def compute_fmaps(self, video, chunk_size: Optional[int] = None):
        """video (B, T, H, W, 3) in [0, 255] -> L2-normalized fmaps
        (B, T, H/stride, W/stride, latent) in the compute dtype, encoding
        `chunk_size` frames at a time."""
        B, T, H, W, _ = video.shape
        frames = (2 * (video / 255.0) - 1.0).to(self.dtype).reshape(B * T, H, W, 3)
        if chunk_size is not None and B * T > chunk_size:
            fmaps = torch.cat([self.fnet(frames[i : i + chunk_size])
                               for i in range(0, B * T, chunk_size)])
        else:
            fmaps = self.fnet(frames)
        f32 = fmaps.to(F32)
        denom = torch.sqrt((f32 * f32).sum(dim=-1, keepdim=True).clamp_min(1e-12))
        fmaps = (f32 / denom).to(self.dtype)
        return fmaps.reshape(B, T, H // self.stride, W // self.stride, self.latent_dim)

    def build_pyramid(self, fmaps):
        """Average-pool pyramid, corr_levels deep."""
        pyramid = [fmaps]
        for _ in range(self.corr_levels - 1):
            B, T, H, W, C = fmaps.shape
            x = F.avg_pool2d(fmaps.reshape(B * T, H, W, C).permute(0, 3, 1, 2), 2, 2)
            fmaps = x.permute(0, 2, 3, 1).reshape(B, T, H // 2, W // 2, C)
            pyramid.append(fmaps)
        return pyramid

    def track_feat_pyramid(self, fmaps_pyramid, queried_frames, queried_coords):
        supports = []
        for i, fmaps in enumerate(fmaps_pyramid):
            _, s = get_track_feat(fmaps, queried_frames, queried_coords / 2**i, self.corr_radius)
            supports.append(s.to(self.dtype))
        return supports

    def interpolate_time_embed(self, t: int):
        """(1, t, input_dim) time embedding, linearly resized when t differs
        from the trained window length."""
        if t == self.time_emb.shape[1]:
            return self.time_emb
        return resize_linear_1d(self.time_emb, t, align_corners=False, axis=1)

    # ------------------------------------------------------------ updates

    def _corr_weights(self):
        m = self.corr_mlp
        return m.fc1.weight.t(), m.fc1.bias, m.fc2.weight.t(), m.fc2.bias

    def iterate(self, fmaps_pyramid, support_pyramid, coords, vis, conf, iters: int,
                track_mask=None, track_group=None):
        """`iters` transformer updates over one window. coords (B, T, N, 2)
        f32 in fmap units; vis/conf (B, T, N) logits; support_pyramid per
        level (B, P*P, N, C). Returns per-iteration lists of coords (model
        pixels), vis and conf logits.

        track_group: a process group over which the N tracks are sharded
        (JAX `track_axis`, parallel/mesh.py): every input holds this rank's
        tracks, and the updateformer's virtual <- points sums over the
        group. None: unsharded, exactly the model without it."""
        T = fmaps_pyramid[0].shape[1]
        time_emb = self.interpolate_time_embed(T)
        # everything iteration-invariant is prepared once per forward: the
        # W8A8 weight packs, the quantized corr W1, the int8 level maps and
        # the int8 support
        packs = self.updateformer.quantize()
        corr_in = None
        if self.corr_kernels:
            # each level's codes (K4r) or padded float map (K4f) once per
            # forward; the support is quantized per chunk inside the kernel
            # path, from the compute dtype, as the JAX training path does
            with torch.no_grad():
                corr_in = {"raw_levels": [
                    corr_cuda.build_int8_level(f, self.corr_radius) if self.corr_quant_int8
                    else corr_cuda.build_float_level(f, self.corr_radius, self.dtype)
                    for f in fmaps_pyramid
                ]}
        elif self.kernels:
            w1, _, _, _ = self._corr_weights()
            corr_in = {
                "w1": corr_cuda.quantize_w1(w1, self.dtype),
                "w1m": corr_cuda.quantize_w1_mlp1(w1) if self.variants.corr_fuse_mlp1 else None,
                "levels": [
                    (corr_cuda.build_int8_level(f, self.corr_radius),
                     *corr_cuda.quantize_support(s, self.dtype), f.shape[2:4])
                    for f, s in zip(fmaps_pyramid, support_pyramid)
                ],
            }
        remat = self.remat_iterations and torch.is_grad_enabled()
        cp, vp, fp = [], [], []
        for _ in range(iters):
            args = (coords, vis, conf, fmaps_pyramid, support_pyramid, track_mask, time_emb,
                    packs, corr_in, track_group)
            if remat:
                coords, vis, conf = checkpoint(self._iteration, *args, use_reentrant=False)
            else:
                coords, vis, conf = self._iteration(*args)
            cp.append(coords * float(self.stride))
            vp.append(vis)
            fp.append(conf)
        return cp, vp, fp

    def _iteration(self, coords, vis, conf, fmaps_pyramid, support_pyramid, track_mask,
                   time_emb, packs, corr_in, track_group):
        """One update: correlation features, token build, updateformer,
        additive update (mirrors one step of the reference forward_window)."""
        coords = coords.detach()
        cd = self.dtype
        scale = torch.tensor(
            [self.model_resolution[1], self.model_resolution[0]], dtype=F32, device=coords.device
        ) / self.stride
        coords_nt = coords.transpose(1, 2)  # (B, N, T, 2)
        rel_fwd = F.pad(coords_nt[:, :, :-1] - coords_nt[:, :, 1:], (0, 0, 0, 1))
        rel_bwd = F.pad(coords_nt[:, :, 1:] - coords_nt[:, :, :-1], (0, 0, 1, 0))
        rel = torch.cat([rel_fwd / scale, rel_bwd / scale], dim=-1)
        w1, b1, w2, b2 = self._corr_weights()
        uf = self.updateformer

        def level_embs(i, w2_, b2_):
            """Level i's correlation embedding (B, N, T, Do), plain or
            through K4r/K4f/K4m and the autograd wrapper."""
            args = (fmaps_pyramid[i], support_pyramid[i].transpose(1, 2), coords.to(cd) / 2**i,
                    w1, b1, w2_, b2_)
            kw = dict(radius=self.corr_radius, chunk=self.corr_chunk, compute_dtype=cd)
            if self.corr_kernels:
                return corr_cuda.fused_corr_embs_trainable(
                    corr_in["raw_levels"][i], *args, quant_int8=self.corr_quant_int8,
                    fuse_mlp1=self.variants.corr_fuse_mlp1, **kw)
            return fused_corr_embs(*args, track_major=True, **kw)

        if not self.fold_input_proj:
            corr_embs = torch.cat([level_embs(i, w2, b2) for i in range(self.corr_levels)],
                                  dim=-1)  # (B, N, T, 1024)
            x = torch.cat([
                vis.transpose(1, 2)[..., None].to(cd), conf.transpose(1, 2)[..., None].to(cd),
                corr_embs, posenc(rel, 0, 10).to(cd),
            ], dim=-1)
            x = x + time_emb[:, None].to(cd)
            delta = uf(x, track_mask=track_mask, packs=packs, track_group=track_group).to(F32)
        else:
            # input layout (1110 rows of Win): [vis, conf, corr x 1024, rel x 84]
            kin = uf.input_transform.weight.t().to(F32)
            bin_ = uf.input_transform.bias.to(F32)
            D = w2.shape[1]
            slices = [kin[2 + D * i : 2 + D * (i + 1)] for i in range(self.corr_levels)]
            krel = kin[2 + D * self.corr_levels :]
            time_proj = time_emb[:, None].to(F32) @ kin  # (1, 1, T, 384)

            def small_terms(vis_nt, conf_nt, rel_c):
                remb = posenc(rel_c, 0, 10)
                return (
                    vis_nt[..., None].to(F32) * kin[0]
                    + conf_nt[..., None].to(F32) * kin[1]
                    + remb.to(cd).to(F32) @ krel.to(cd).to(F32)
                    + time_proj
                    + bin_
                )

            if self.kernels:
                w1q, w1amax = corr_in["w1"]
                x = corr_cuda.fused_corr_tokens(
                    corr_in["levels"], coords.to(cd), w1q, w1amax, b1,
                    [w2.to(F32) @ m for m in slices], b2.to(F32) @ sum(slices),
                    radius=self.corr_radius, chunk=self.corr_chunk, compute_dtype=cd,
                    extra_ops=(vis.transpose(1, 2), conf.transpose(1, 2), rel),
                    extra_fn=small_terms, w1m=corr_in["w1m"],
                )
            else:
                x = None
                for i in range(self.corr_levels):
                    contrib = level_embs(i, w2.to(F32) @ slices[i], b2.to(F32) @ slices[i])
                    x = contrib if x is None else x + contrib
                small = small_terms(vis.transpose(1, 2), conf.transpose(1, 2), rel)
                x = x + small.to(cd)
            delta = uf(x, track_mask=track_mask, x_is_tokens=True, packs=packs,
                       track_group=track_group).to(F32)
        delta = delta.transpose(1, 2)  # (B, T, N, 4)
        return coords + delta[..., :2], vis + delta[..., 2], conf + delta[..., 3]

    # ------------------------------------------------------------ offline

    def forward_from_pyramid(self, fmaps_pyramid, queries, iters: int = 4, track_mask=None,
                             track_group=None):
        """Support sampling + masking, cold carry init, iterations (the
        single-window glue that the unsharded forward and the track-sharded
        one share; track_group as in `iterate`)."""
        B, N = queries.shape[:2]
        T = fmaps_pyramid[0].shape[1]
        queried_frames = queries[..., 0].to(F32)
        queried_coords = queries[..., 1:3].to(F32) / self.stride
        supports = self.track_feat_pyramid(fmaps_pyramid, queried_frames, queried_coords)
        if track_mask is not None:
            supports = [s * track_mask[:, None, :, None].to(s.dtype) for s in supports]
        coords = queried_coords[:, None].expand(B, T, N, 2).contiguous()
        vis = torch.zeros((B, T, N), dtype=F32, device=queries.device)
        conf = torch.zeros((B, T, N), dtype=F32, device=queries.device)
        return self.iterate(fmaps_pyramid, supports, coords, vis, conf, iters, track_mask,
                            track_group)

    def forward(self, video, queries, iters: int = 4, track_mask=None, is_train: bool = False,
                fmaps_chunk_size: Optional[int] = 200, track_group=None):
        """Offline forward, whole video as one window. video (B, T, H, W, 3)
        in [0, 255]; queries (B, N, 3) (t, x, y) model pixels; track_mask
        (B, N) marks real tracks. Returns (coords (B, T, N, 2) pixels,
        vis, conf (B, T, N) probabilities, train_data): train_data is None,
        or with is_train the per-iteration stacks (coords (iters, B, T, N, 2)
        pixels, vis and conf (iters, B, T, N) probabilities) and a valid mask
        of ones (B, T, N). track_group: queries and track_mask hold this
        rank's tracks of a track-sharded forward (see `iterate`)."""
        fmaps = self.compute_fmaps(video, chunk_size=None if is_train else fmaps_chunk_size)
        cp, vp, fp = self.forward_from_pyramid(
            self.build_pyramid(fmaps), queries, iters=iters, track_mask=track_mask,
            track_group=track_group,
        )
        train_data = None
        if is_train:
            train_data = (torch.stack(cp), torch.sigmoid(torch.stack(vp)),
                          torch.sigmoid(torch.stack(fp)), torch.ones_like(vp[-1]))
        return cp[-1], torch.sigmoid(vp[-1]), torch.sigmoid(fp[-1]), train_data

    # ------------------------------------------------------------ multi-window

    def forward_windows(self, video, queries, iters: int = 4, track_mask=None,
                        is_train: bool = False, fmaps_chunk_size: Optional[int] = 200,
                        track_group=None):
        """Sliding-window forward over a full video with warm-started window
        chaining: how the window-16 model is trained and runs non-streaming
        inference over videos longer than one window. video (B, T, H, W, 3)
        in [0, 255]; queries (B, N, 3) (t, x, y) model pixels. Returns
        (coords (B, T, N, 2) pixels, vis, conf (B, T, N) probabilities,
        train_data): train_data is None, or with is_train the per-window
        tuples of the iteration stacks (coords (iters, B, S, N, 2) pixels,
        vis and conf (iters, B, S, N) probabilities; windows past T keep all
        S frames) and the "query started" valid mask (B, T, N).

        Each window starts from the previous window's last outputs and no
        buffer is written in place, so gradients flow across windows
        through the warm-started vis and conf (coords are detached at every
        iteration, as in the reference). track_group as in `forward`."""
        B, T = video.shape[:2]
        S = self.window_len
        step = S // 2
        overlap = S - step
        queried_frames = queries[..., 0].to(F32)
        queried_coords = queries[..., 1:3].to(F32) / self.stride

        num_windows = max(1, -(-(T - S) // step) + 1)
        T_buf = step * (num_windows - 1) + S
        if T_buf > T:  # repeat the last frame
            video = torch.cat([video, video[:, -1:].expand(-1, T_buf - T, -1, -1, -1)], dim=1)
        fmaps = self.compute_fmaps(video, chunk_size=None if is_train else fmaps_chunk_size)
        fmaps_pyramid = self.build_pyramid(fmaps)
        support_pyramid = self.track_feat_pyramid(fmaps_pyramid, queried_frames, queried_coords)
        if track_mask is not None:
            support_pyramid = [s * track_mask[:, None, :, None].to(s.dtype)
                               for s in support_pyramid]

        prev = (None, None, None)  # the previous window's final coords, vis, conf logits
        kept = []  # per window, the frames no later window rewrites
        windows = []
        for w in range(num_windows):
            ind = w * step
            coords_init, vis_init, conf_init = self._window_init(
                *prev, ind, overlap, queried_frames, queried_coords, buf_start=ind - step)
            # tracks not queried yet: support zeroed, excluded as keys
            active = queried_frames < float(ind + S)
            wmask = active if track_mask is None else active & track_mask.bool()
            sup = [s * active[:, None, :, None].to(s.dtype) for s in support_pyramid]
            cp, vp, fp = self.iterate(
                [f[:, ind : ind + S] for f in fmaps_pyramid], sup, coords_init, vis_init,
                conf_init, iters, track_mask=wmask, track_group=track_group,
            )
            prev = (cp[-1], vp[-1], fp[-1])
            keep = S if w == num_windows - 1 else step
            kept.append([t[:, :keep] for t in prev])
            if is_train:
                windows.append((torch.stack(cp), torch.sigmoid(torch.stack(vp)),
                                torch.sigmoid(torch.stack(fp))))
        coords, vis, conf = (torch.cat(parts, dim=1)[:, :T] for parts in zip(*kept))
        train_data = None
        if is_train:
            valid_mask = (queried_frames[:, None, :]
                          <= torch.arange(T, dtype=F32, device=video.device)[None, :, None])
            train_data = (tuple(c for c, _, _ in windows), tuple(v for _, v, _ in windows),
                          tuple(f for _, _, f in windows), valid_mask.to(F32))
        return coords, torch.sigmoid(vis), torch.sigmoid(conf), train_data

    def _window_init(self, coords_buf, vis_buf, conf_buf, ind: int, overlap: int,
                     queried_frames, queried_coords, buf_start: int = 0):
        """Initial coords (fmap units), vis and conf logits of the window at
        `ind`: the query position and zeros, and, past the first window, for
        tracks queried before `ind + overlap`, the previous window's
        predictions on the overlap followed by its last frame repeated. The
        buffers hold frames from `buf_start` on (pixels for coords)."""
        B, N = queried_frames.shape
        S = self.window_len
        coords = queried_coords[:, None].expand(B, S, N, 2)
        vis = torch.zeros((B, S, N), dtype=F32, device=queried_frames.device)
        conf = torch.zeros_like(vis)
        if ind == 0:
            return coords.contiguous(), vis, conf
        copy_over = (queried_frames < float(ind + overlap))[:, None, :]

        def warm(buf, init, scale=1.0):
            sl = buf[:, ind - buf_start : ind - buf_start + overlap] / scale
            prev = torch.cat([sl, sl[:, -1:].expand(-1, S - overlap, *sl.shape[2:])], dim=1)
            cw = copy_over.reshape(copy_over.shape + (1,) * (buf.dim() - 3))
            return torch.where(cw, prev, init)

        return (warm(coords_buf, coords, float(self.stride)), warm(vis_buf, vis),
                warm(conf_buf, conf))

    # ------------------------------------------------------------ streaming

    def online_init(self, batch: int, num_tracks: int, capacity: int) -> OnlineState:
        """Fresh streaming state with `capacity` frames of prediction buffer,
        on the model's device."""
        dev = self.time_emb.device
        P = 2 * self.corr_radius + 1
        ih, iw = self.model_resolution

        def zeros(*shape, dtype=self.dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return OnlineState(
            ind=0,
            track_feat=tuple(zeros(batch, 1, num_tracks, self.latent_dim)
                             for _ in range(self.corr_levels)),
            track_support=tuple(zeros(batch, P * P, num_tracks, self.latent_dim)
                                for _ in range(self.corr_levels)),
            coords=zeros(batch, capacity, num_tracks, 2, dtype=F32),
            vis=zeros(batch, capacity, num_tracks, dtype=F32),
            conf=zeros(batch, capacity, num_tracks, dtype=F32),
            fmaps_tail=zeros(batch, self.window_len // 2, ih // self.stride, iw // self.stride,
                             self.latent_dim),
            tail_valid=0,
        )

    def online_step(self, state: OnlineState, video_chunk, queries, iters: int = 4,
                    track_mask=None, chunk_valid_len: Optional[int] = None, track_group=None):
        """Process one sliding window [ind, ind+S) of the stream.

        video_chunk (B, S, H, W, 3): the current window, already padded to
        S = window_len frames (callers pad a short tail by repeating the last
        frame); queries (B, N, 3) global (t, x, y) in model pixels, the same
        at every step; chunk_valid_len: the number of real frames in the
        chunk before padding (default S), which gates the fmaps_tail cache.

        Returns (new_state, coords (B, CAP, N, 2) pixels, vis, conf
        (B, CAP, N) probabilities), valid on [0, ind + S). `state` is
        consumed (see OnlineState); the three returned tensors are copies
        that later steps do not touch. The window index, the cache validity
        and the queries' frames are host values, so no step waits for the
        device (the first one copies the queries' frames to the host).
        track_group: the state, queries and track_mask hold this rank's
        tracks of a track-sharded stream (see `iterate`)."""
        B, S = video_chunk.shape[:2]
        if S != self.window_len:
            raise ValueError(f"online_step takes chunks of window_len={self.window_len} frames, "
                             f"got {S}")
        step = S // 2
        overlap = S - step
        ind = state.ind
        if ind + S > state.coords.shape[1]:
            raise ValueError(f"online prediction buffer overflow: window [{ind}, {ind + S}) "
                             f"exceeds capacity={state.coords.shape[1]}")
        queried_frames = queries[..., 0].to(F32)
        queried_coords = queries[..., 1:3].to(F32) / self.stride
        qf_host = state.query_frames
        if qf_host is None:
            qf_host = queried_frames.cpu().numpy()

        # the first `overlap` frames of this chunk are the previous chunk's
        # last frames, whose level-0 fmaps sit in state.fmaps_tail: encode
        # only the new ones, unless this is the first window or the tail was
        # cached from a padded chunk
        if ind == 0 or state.tail_valid < step:
            fmaps = self.compute_fmaps(video_chunk)
        else:
            fmaps = torch.cat(
                [state.fmaps_tail, self.compute_fmaps(video_chunk[:, S - step :])], dim=1)
        fmaps_pyramid = self.build_pyramid(fmaps)

        # absorb the queries that fall in the fresh part of this window; each
        # query adds its features exactly once. Skipped when no query does.
        left = 0 if ind == 0 else ind + step
        right = ind + S
        if ((qf_host >= left) & (qf_host < right)).any():
            sample_mask = ((queried_frames >= left) & (queried_frames < right))
            sample_mask = sample_mask[:, None, :, None].to(self.dtype)
            for i, fmaps_lvl in enumerate(fmaps_pyramid):
                f, s = get_track_feat(fmaps_lvl, queried_frames - float(ind),
                                      queried_coords / 2**i, self.corr_radius)
                # cast before the mask multiply: no full-size f32 temporary,
                # and the state stays in the compute dtype
                state.track_feat[i].add_(f.to(self.dtype) * sample_mask)
                state.track_support[i].add_(s.to(self.dtype) * sample_mask)

        coords_init, vis_init, conf_init = self._window_init(
            state.coords, state.vis, state.conf, ind, overlap, queried_frames, queried_coords)
        # no mask on the support of tracks not queried yet (forward_windows
        # has one): a query's support is accumulated only once its window has
        # arrived, so it is still zero wherever that mask would apply
        cp, vp, fp = self.iterate(fmaps_pyramid, list(state.track_support), coords_init,
                                  vis_init, conf_init, iters, track_mask=track_mask,
                                  track_group=track_group)
        state.coords[:, ind : ind + S] = cp[-1]
        state.vis[:, ind : ind + S] = vp[-1]
        state.conf[:, ind : ind + S] = fp[-1]

        valid = S if chunk_valid_len is None else int(chunk_valid_len)
        new_state = state._replace(
            ind=ind + step,
            fmaps_tail=fmaps[:, S - step :],  # the next window's first frames
            tail_valid=min(max(valid - step, 0), step),
            query_frames=qf_host,
        )
        return (new_state, state.coords.clone(), torch.sigmoid(state.vis),
                torch.sigmoid(state.conf))
