"""Bilinear / trilinear sampling and separable resizes (port of
cotracker_tpu/ops/bilinear.py).

Conventions follow the reference `bilinear_sampler` (torch grid_sample):
pixel-unit (x, y) or (t, x, y) coordinates, `align_corners=True` maps
coordinate 0 to the first pixel centre, `padding_mode="border"` clamps the
sample position before the weights are taken. Everything is channel-last.
"""

import torch


def _axis_scale(size: int) -> float:
    # align_corners=True: identity for size > 1, collapses a size-1 axis to 0
    return (size - 1) / max(size - 1, 1)


def _prep(c, size, align_corners, padding_mode):
    c = c * _axis_scale(size) if align_corners else c - 0.5
    if padding_mode == "border":
        c = c.clamp(0.0, size - 1)
    c0 = torch.floor(c)
    return c0.long(), c - c0


def bilinear_sample(img, coords, align_corners: bool = True, padding_mode: str = "border"):
    """Sample img (H, W, C) at coords (..., 2) as (x, y) pixels ->
    coords.shape[:-1] + (C,)."""
    return bilinear_sample_frames(img[None], coords[None], align_corners, padding_mode)[0]


def bilinear_sample_frames(imgs, coords, align_corners: bool = True,
                           padding_mode: str = "border"):
    """Sample each of F images imgs (F, H, W, C) at its own coords
    (F, ..., 2) as (x, y) pixels -> coords.shape[:-1] + (C,): bilinear_sample
    of every image, in one gather a corner."""
    F, H, W, C = imgs.shape
    x0, wx = _prep(coords[..., 0], W, align_corners, padding_mode)
    y0, wy = _prep(coords[..., 1], H, align_corners, padding_mode)
    wx, wy = wx[..., None], wy[..., None]
    base = torch.arange(F, device=imgs.device).reshape((F,) + (1,) * (x0.dim() - 1)) * (H * W)
    flat = imgs.reshape(F * H * W, C)

    def tap(yy, xx):
        v = flat[base + yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)]
        if padding_mode == "zeros":
            inb = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            v = torch.where(inb[..., None], v, torch.zeros((), dtype=v.dtype, device=v.device))
        return v

    top = tap(y0, x0) * (1.0 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1.0 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1.0 - wy) + bot * wy


def bilinear_sample_3d(vid, coords, align_corners: bool = True, padding_mode: str = "border"):
    """Trilinear-sample vid (T, H, W, C) at coords (..., 3) as (t, x, y)."""
    T, H, W, C = vid.shape
    t0, wt = _prep(coords[..., 0], T, align_corners, padding_mode)
    x0, wx = _prep(coords[..., 1], W, align_corners, padding_mode)
    y0, wy = _prep(coords[..., 2], H, align_corners, padding_mode)
    wt, wx, wy = wt[..., None], wx[..., None], wy[..., None]
    flat = vid.reshape(T * H * W, C)

    def tap(tt, yy, xx):
        idx = (tt.clamp(0, T - 1) * H + yy.clamp(0, H - 1)) * W + xx.clamp(0, W - 1)
        v = flat[idx]
        if padding_mode == "zeros":
            inb = (tt >= 0) & (tt < T) & (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            v = torch.where(inb[..., None], v, torch.zeros((), dtype=v.dtype, device=v.device))
        return v

    def plane(tt):
        top = tap(tt, y0, x0) * (1.0 - wx) + tap(tt, y0, x0 + 1) * wx
        bot = tap(tt, y0 + 1, x0) * (1.0 - wx) + tap(tt, y0 + 1, x0 + 1) * wx
        return top * (1.0 - wy) + bot * wy

    return plane(t0) * (1.0 - wt) + plane(t0 + 1) * wt


def sample_features_2d(fmaps, coords, align_corners: bool = True, padding_mode: str = "border"):
    """fmaps (B, H, W, C), coords (B, N, 2) as (x, y) -> (B, N, C)
    (reference `sample_features4d`)."""
    return bilinear_sample_frames(fmaps, coords, align_corners, padding_mode)


def sample_features_3d(fmaps, coords, align_corners: bool = True, padding_mode: str = "border"):
    """fmaps (B, T, H, W, C), coords (B, R1, R2, 3) as (t, x, y) ->
    (B, R1, R2, C) (reference `sample_features5d`)."""
    return torch.stack(
        [
            bilinear_sample_3d(fmaps[b], coords[b], align_corners, padding_mode)
            for b in range(fmaps.shape[0])
        ]
    )


def interp_matrix_1d(src: int, dst: int, align_corners: bool, device=None) -> torch.Tensor:
    """(dst, src) float32 linear-interpolation matrix matching F.interpolate."""
    if src == dst:
        return torch.eye(src, dtype=torch.float32, device=device)
    i = torch.arange(dst, dtype=torch.float32, device=device)
    if align_corners:
        pos = i * (src - 1) / max(dst - 1, 1)
    else:
        pos = (i + 0.5) * (src / dst) - 0.5
    pos = pos.clamp(0.0, src - 1)
    lo = torch.floor(pos).long()
    hi = (lo + 1).clamp(max=src - 1)
    w = pos - lo.float()
    m = torch.zeros((dst, src), dtype=torch.float32, device=device)
    rows = torch.arange(dst, device=device)
    m.index_put_((rows, lo), 1.0 - w, accumulate=True)
    m.index_put_((rows, hi), w, accumulate=True)
    return m


def resize_bilinear(x, out_hw, align_corners: bool = True):
    """Resize (..., H, W, C) to (..., H', W', C) with two separable matmuls."""
    H, W = x.shape[-3], x.shape[-2]
    mh = interp_matrix_1d(H, out_hw[0], align_corners, x.device).to(x.dtype)
    mw = interp_matrix_1d(W, out_hw[1], align_corners, x.device).to(x.dtype)
    x = torch.einsum("oh,...hwc->...owc", mh, x)
    return torch.einsum("pw,...owc->...opc", mw, x)


def resize_linear_1d(x, out_len: int, align_corners: bool = False, axis: int = -2):
    """Linear resize along one axis (time-embedding interpolation)."""
    m = interp_matrix_1d(x.shape[axis], out_len, align_corners, x.device).to(x.dtype)
    x = torch.movedim(x, axis, -1)
    x = torch.einsum("os,...s->...o", m, x)
    return torch.movedim(x, -1, axis)
