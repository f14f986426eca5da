"""Masked reductions (port of cotracker_tpu/ops/masked.py; the mesh
`axis_name` psum of `reduce_masked_mean` is its `group`).

`reduce_masked_mean` serves the losses. `masked_mean` and `masked_mean_var`
complete the module's surface; no path of the port calls them yet (nor of
the JAX package, which only re-exports them)."""

import torch

from cotracker_tpu_torch.ops.collectives import psum_value

EPS = 1e-6


def reduce_masked_mean(x, mask, dim=None, keepdim: bool = False, group=None):
    """Mean of `x` over the elements where `mask` is nonzero:
    sum(x * m) / (eps + sum(m)), the mask broadcast to x's shape.

    group: a process group over which x and mask are sharded (JAX
    `axis_name`): the numerator and the denominator are summed over it, so
    the mean covers the global elements; the gradient reaches the local
    terms only (ops/collectives.psum_value)."""
    mask = torch.broadcast_to(mask, x.shape).to(x.dtype)
    kw = {} if dim is None else dict(dim=dim, keepdim=keepdim)
    numer, denom = (x * mask).sum(**kw), mask.sum(**kw)
    if group is not None:
        numer, denom = psum_value(numer, group), psum_value(denom, group)
    return numer / (EPS + denom)


def masked_mean(data, mask, dim):
    """Masked mean over `dim`, the denominator clamped to at least 1, keeping
    `dim`; with no mask the plain mean (JAX ops/masked.py::masked_mean)."""
    if mask is None:
        return data.mean(dim=dim, keepdim=True)
    mask = mask.to(data.dtype)
    mask_sum = mask.sum(dim=dim, keepdim=True)
    return (data * mask).sum(dim=dim, keepdim=True) / mask_sum.clamp_min(1.0)


def masked_mean_var(data, mask, dim):
    """Masked mean and (biased) variance over `dim`. With a mask both drop
    `dim`; with none both keep it, as the JAX function does."""
    if mask is None:
        return data.mean(dim=dim, keepdim=True), data.var(dim=dim, unbiased=False, keepdim=True)
    mask = mask.to(data.dtype)
    mask_sum = mask.sum(dim=dim, keepdim=True).clamp_min(1.0)
    m = (data * mask).sum(dim=dim, keepdim=True) / mask_sum
    v = (mask * (data - m) ** 2).sum(dim=dim, keepdim=True) / mask_sum
    return m.squeeze(dim), v.squeeze(dim)
