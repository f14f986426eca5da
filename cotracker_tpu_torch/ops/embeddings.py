"""Sinusoidal positional embeddings (port of cotracker_tpu/ops/embeddings.py)."""

import math

import numpy as np
import torch


def get_1d_sincos_pos_embed(embed_dim: int, pos) -> np.ndarray:
    """1D sincos embedding of positions, flattened to (M,): returns
    (1, M, embed_dim) float32, the omega grid computed in float64 like the
    reference `get_1d_sincos_pos_embed_from_grid`."""
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    pos = np.asarray(pos, dtype=np.float64).reshape(-1)
    out = np.einsum("m,d->md", pos, omega)
    emb = np.concatenate([np.sin(out), np.cos(out)], axis=1)
    return emb[None].astype(np.float32)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size) -> np.ndarray:
    """2D sincos embedding over a (gh, gw) grid, channel-last: returns
    (1, gh, gw, embed_dim) float32. As in the reference, the first half
    (`emb_h`) embeds the w coordinate of each cell and the second half
    (`emb_w`) the h coordinate."""
    gh, gw = grid_size if isinstance(grid_size, tuple) else (grid_size, grid_size)
    ww, hh = np.meshgrid(np.arange(gw, dtype=np.float32), np.arange(gh, dtype=np.float32))
    emb_h = get_1d_sincos_pos_embed(embed_dim // 2, ww)  # (1, gh*gw, D/2)
    emb_w = get_1d_sincos_pos_embed(embed_dim // 2, hh)
    emb = np.concatenate([emb_h, emb_w], axis=2)
    return emb.reshape(1, gh, gw, embed_dim).astype(np.float32)


def get_2d_embedding(xy: torch.Tensor, C: int, cat_coords: bool = True) -> torch.Tensor:
    """Sin/cos embedding of (B, N, 2) coordinates -> (B, N, 2C [+ 2]): the
    coordinates themselves first (cat_coords), then x's and y's C channels,
    each with sin on the even and cos on the odd channels, at frequencies
    arange(0, C, 2) * (1000 / C)."""
    B, N, _ = xy.shape
    div_term = torch.arange(0, C, 2, dtype=torch.float32, device=xy.device) * (1000.0 / C)

    def interleaved(v):  # (B, N, 1) -> (B, N, C): sin, cos, sin, cos, ...
        arg = v * div_term
        return torch.stack([torch.sin(arg), torch.cos(arg)], dim=-1).reshape(B, N, C)

    pe = torch.cat([interleaved(xy[..., 0:1]), interleaved(xy[..., 1:2])], dim=2)
    return torch.cat([xy, pe], dim=2) if cat_coords else pe


def posenc(x: torch.Tensor, min_deg: int, max_deg: int) -> torch.Tensor:
    """NeRF-style encoding: x concatenated with sin(x * 2^deg) and its
    pi/2-shifted copy; output dim d + 2*d*(max_deg - min_deg)."""
    if min_deg == max_deg:
        return x
    scales = torch.tensor(
        [2.0**i for i in range(min_deg, max_deg)], dtype=x.dtype, device=x.device
    )
    xb = (x[..., None, :] * scales[:, None]).reshape(*x.shape[:-1], -1)
    four_feat = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))
    return torch.cat([x, four_feat], dim=-1)
