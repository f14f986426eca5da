"""Seeded synthetic videos, made on the device.

A smooth textured background drifting at a seeded velocity, with textured
discs moving across it at their own seeded velocities, bouncing off the
frame's edges. uint8 (T, 3, H, W), as a camera delivers frames. The same
seed and index give the same video.
"""

import math

import torch
import torch.nn.functional as F


def _texture(g, h, w, cells, device):
    """A smooth random colour texture (3, h, w) in [0, 1]."""
    coarse = torch.rand(1, 3, cells, cells, generator=g, device=device)
    fine = torch.rand(1, 3, 4 * cells, 4 * cells, generator=g, device=device)
    tex = (0.7 * F.interpolate(coarse, (h, w), mode="bicubic", align_corners=False)
           + 0.3 * F.interpolate(fine, (h, w), mode="bilinear", align_corners=False))
    return tex[0].clamp(0, 1)


def make_video(seed, index, frames, height, width, scene, device, chunk=32):
    """Video `index` of run `seed`: uint8 (frames, 3, height, width)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + 7919 * (index + 1)) % (1 << 63))
    margin = int(scene["max_speed_px"] * frames) + 8
    bg = _texture(g, height + 2 * margin, width + 2 * margin, 12, device)
    n_obj = int(scene["objects"])
    r = torch.rand(4, n_obj, generator=g, device=device)
    radius = 20.0 + r[0] * (min(height, width) / 5.0)
    cx, cy = r[1] * width, r[2] * height
    ang = r[3] * 2 * math.pi
    speed = scene["max_speed_px"] * (0.25 + 0.75 * torch.rand(n_obj, generator=g, device=device))
    vx, vy = speed * torch.cos(ang), speed * torch.sin(ang)
    bgv = (torch.rand(2, generator=g, device=device) * 2 - 1) * scene["max_speed_px"] / 2
    tex = torch.stack([_texture(g, 64, 64, 6, device) for _ in range(n_obj)])  # (K, 3, 64, 64)
    ys = torch.arange(height, device=device, dtype=torch.float32)
    xs = torch.arange(width, device=device, dtype=torch.float32)
    out = torch.empty(frames, 3, height, width, dtype=torch.uint8, device=device)
    span_x, span_y = float(width), float(height)
    for f0 in range(0, frames, chunk):
        t = torch.arange(f0, min(f0 + chunk, frames), device=device, dtype=torch.float32)
        n = t.shape[0]
        # background: a translation of the big texture, sampled bilinearly
        ox = margin + bgv[0] * t
        oy = margin + bgv[1] * t
        gx = (xs[None, None, :] + ox[:, None, None]) / (bg.shape[2] - 1) * 2 - 1
        gy = (ys[None, :, None] + oy[:, None, None]) / (bg.shape[1] - 1) * 2 - 1
        grid = torch.stack([gx.expand(n, height, width), gy.expand(n, height, width)], -1)
        img = F.grid_sample(bg[None].expand(n, -1, -1, -1), grid, align_corners=True)
        for k in range(n_obj):  # objects bounce inside the frame (a triangle wave)
            px = span_x - (span_x - (cx[k] + vx[k] * t) % (2 * span_x)).abs()
            py = span_y - (span_y - (cy[k] + vy[k] * t) % (2 * span_y)).abs()
            dx = (xs[None, None, :] - px[:, None, None]) / radius[k]
            dy = (ys[None, :, None] - py[:, None, None]) / radius[k]
            alpha = torch.sigmoid((1.0 - torch.sqrt(dx * dx + dy * dy)) * radius[k] / 1.5)
            ogrid = torch.stack([dx.expand(n, height, width), dy.expand(n, height, width)], -1)
            col = F.grid_sample(tex[k][None].expand(n, -1, -1, -1), ogrid.clamp(-1, 1),
                                align_corners=True)
            img = img + alpha[:, None] * (col - img)
        out[f0:f0 + n] = (img * 255.0).round().clamp(0, 255).to(torch.uint8)
    return out
