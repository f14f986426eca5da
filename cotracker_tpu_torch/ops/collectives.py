"""Collectives over a torch.distributed process group for the track-sharded
model and losses: the port's `lax.psum` / `lax.pmax` of the JAX package's
shard_map regions (models/blocks.py:250-289, ops/masked.py:12,
training/losses.py). Every reduction runs in float32 whatever the tensor's
dtype (gloo has no bfloat16 sum), on a contiguous copy: the input is never
written.

How the sharded gradient equals the unsharded one. Every rank of a sharded
step holds the same global loss. Each rank's backward computes its own part
of the full gradient, and the step then sums those parts over every rank
(JAX `psum(grads, axes)`, parallel/mesh.py). Two kinds of sum keep the parts
right:

  * `psum`, inside the model: sharded inputs (each rank's own points), a
    replicated output (the virtual tokens). A rank's cotangent of that output
    holds only what flows back from its own points, so the backward sums the
    cotangents of every rank, and each rank's input gets the full one;
  * `psum_value`, for the loss's masked means: the value is the group's sum,
    but the gradient reaches the local term alone, unsummed. Summing it too
    would scale the gradient by the group's size, once the step sums the
    parameters' gradients.

`pmax_nograd` serves the softmax's stabilising row max, which needs no
gradient (a softmax does not move with a shift of its row).
"""

import torch
import torch.distributed as dist

F32 = torch.float32


def _reduced(x, group, op=dist.ReduceOp.SUM):
    """A float32 contiguous copy of x reduced over `group`."""
    y = torch.empty_like(x, dtype=F32, memory_format=torch.contiguous_format).copy_(x)
    dist.all_reduce(y, op=op, group=group)
    return y


def _reduced_many(xs, group):
    """Each of xs summed over `group`, in one float32 all_reduce."""
    flat = _reduced(torch.cat([x.reshape(-1).to(F32) for x in xs]), group)
    return tuple(y.view_as(x).to(x.dtype) for x, y in zip(xs, flat.split([x.numel() for x in xs])))


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return _reduced_many(xs, group)

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + _reduced_many(gs, ctx.group)


class _PsumValue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduced(x, group).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(xs, group):
    """The sum over `group` of a tensor, or of each of a tuple of tensors
    (one all_reduce for them all); its backward sums the cotangents over the
    group too (the model's sums of sharded terms)."""
    if isinstance(xs, torch.Tensor):
        return _Psum.apply(group, xs)[0]
    return _Psum.apply(group, *xs)


def psum_value(x, group):
    """The sum of x over `group`, with the gradient of the local term alone
    (the loss's sums; see the module docstring)."""
    return _PsumValue.apply(x, group)


def pmax_nograd(x, group):
    """The elementwise max of x over `group`, detached."""
    with torch.no_grad():
        return _reduced(x.detach(), group, dist.ReduceOp.MAX).to(x.dtype)
