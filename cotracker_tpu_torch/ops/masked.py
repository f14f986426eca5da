"""Masked reductions (port of cotracker_tpu/ops/masked.py, the part the
training losses use; the mesh `axis_name` psum is the parallelism slice's)."""

import torch

EPS = 1e-6


def reduce_masked_mean(x, mask, dim=None, keepdim: bool = False):
    """Mean of `x` over the elements where `mask` is nonzero:
    sum(x * m) / (eps + sum(m)), the mask broadcast to x's shape."""
    mask = torch.broadcast_to(mask, x.shape).to(x.dtype)
    if dim is None:
        return (x * mask).sum() / (EPS + mask.sum())
    return (x * mask).sum(dim=dim, keepdim=keepdim) / (EPS + mask.sum(dim=dim, keepdim=keepdim))
