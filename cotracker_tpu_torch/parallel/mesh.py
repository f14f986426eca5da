"""The rank mesh, placement helpers, the track-sharded forward and training
step (port of cotracker_tpu/parallel/mesh.py).

The framework uses one logical mesh with axes ("data", "track"):

  * "data": batch parallelism (each data index holds its own batch rows);
  * "track": the CoTracker-specific model parallelism: the N (tracks) axis
    is split over ranks. Time attention and correlation are independent per
    track; information crosses tracks only through the 64 virtual-track
    tokens, so the one collective of a forward is the virtual <- points
    softmax's O(T * V * C) sums (models/blocks.py).

In the port a mesh is a grid of processes, one a device (parallel/
distributed.py), and each axis has its process groups: the ranks that
differ only along it. JAX has two versions of each sharded function, GSPMD
for the XLA path and shard_map for the kernels, because GSPMD cannot split
a pallas_call. Here one implementation serves both names: every rank runs
the unsharded model code on its own tracks, its kernels routed by the local
N exactly as the unsharded route at that N would be, and passes its process
group to the model's virtual <- points sums.
"""

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from cotracker_tpu_torch.parallel.distributed import rank_device

F32 = torch.float32


class Mesh:
    """A grid of ranks of the default process group, `shape` over
    `axis_names`; rank r sits at np.unravel_index(r, shape), as JAX lays
    devices out by reshape. Every rank must build the same meshes in the
    same order (each builds every axis's process groups).

    shape, index: {axis: size}, {axis: this rank's coordinate}; device:
    this rank's device (distributed.rank_device); group(axis) the process
    group along `axis` through this rank, group() every rank of the mesh;
    ranks(axis) that group's global ranks in axis order."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        world, rank = dist.get_world_size(), dist.get_rank()
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} for axes {tuple(axis_names)}")
        if int(np.prod(shape)) != world:
            raise ValueError(f"mesh shape {shape} != {world} ranks")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.index = {a: int(i) for a, i in zip(self.axis_names, np.unravel_index(rank, shape))}
        self.device = rank_device()
        grid = np.arange(world).reshape(shape)
        self._groups, self._ranks = {}, {}
        for i, axis in enumerate(self.axis_names):
            for line in np.moveaxis(grid, i, -1).reshape(-1, shape[i]).tolist():
                group = dist.new_group(line)  # a collective call: every rank, every line
                if rank in line:
                    self._groups[axis], self._ranks[axis] = group, line

    def group(self, *axes: str):
        if not axes or set(axes) == set(self.axis_names):
            return dist.group.WORLD
        if len(axes) != 1:
            raise ValueError(f"no process group for axes {axes} of {self.axis_names}")
        return self._groups[axes[0]]

    def ranks(self, axis: str):
        return list(self._ranks[axis])


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axis_names: Sequence[str] = ("data", "track")) -> Mesh:
    """A ("data", "track") mesh over every rank. shape=None puts every rank
    on "track" (the default for one video's quasi-dense inference); pass
    e.g. (2, 4) to split."""
    if shape is None:
        shape = (1, dist.get_world_size())
    return Mesh(shape, axis_names)


def _tensors(tree):
    if isinstance(tree, nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [t for v in tree for t in _tensors(v)]


def replicate(mesh: Mesh, tree):
    """Give every rank rank 0's values of a module's parameters and buffers
    (or of a tensor, a dict or a sequence of tensors), in place, bit for
    bit. Returns `tree`."""
    with torch.no_grad():
        for t in _tensors(tree):
            dist.broadcast(t.data, src=0, group=mesh.group())
    return tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, tree, spec: Sequence[Optional[str]]):
    """This rank's part of a global tensor (or a dict or sequence of them,
    all with the same spec), on its device. spec: an axis name or None for
    each leading dimension (JAX's PartitionSpec): a named dimension is cut
    into equal parts, one for each index along that axis; it must divide."""
    def cut(x):
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            n, i = mesh.shape[axis], mesh.index[axis]
            if x.shape[dim] % n:
                raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not split over "
                                 f"{n} ranks of axis {axis!r}")
            per = x.shape[dim] // n
            x = x.narrow(dim, i * per, per)
        return x.to(mesh.device)

    return _map(cut, tree)


def gather(mesh: Mesh, tree, spec: Sequence[Optional[str]]):
    """The inverse of shard_batch: every rank's parts joined along the
    dimensions `spec` names, the whole tensor on every rank. Each part is
    written at its place in a zero tensor and the zeros summed over the
    axis's group (exact; all_reduce takes CUDA tensors over both NCCL and
    gloo, where gloo's all_gather takes CPU ones only). Floating tensors."""
    def join(x):
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            n, i = mesh.shape[axis], mesh.index[axis]
            per = x.shape[dim]
            shape = list(x.shape)
            shape[dim] = per * n
            full = torch.zeros(shape, dtype=F32, device=x.device)
            full.narrow(dim, i * per, per).copy_(x)
            dist.all_reduce(full, group=mesh.group(axis))
            x = full.to(x.dtype)
        return x

    return _map(join, tree)


# the training batch's layout: rows over "data", tracks over "track" (shared
# by the sharded step and the trainer's distributed data path)
BATCH_PSPECS = {
    "video": ("data", None, None, None, None),
    "trajs_g": ("data", None, "track", None),
    "vis_g": ("data", None, "track"),
    "valids": ("data", None, "track"),
}
# the offline forward's inputs and outputs
QUERY_PSPEC = ("data", "track", None)  # queries (B, N, 3)
MASK_PSPEC = ("data", "track")  # track_mask (B, N)
COORDS_PSPEC = ("data", None, "track", None)  # (B, T, N, 2)
TN_PSPEC = ("data", None, "track")  # (B, T, N)


def track_sharded_forward(model, mesh: Mesh, iters: int = 6):
    """The offline forward with tracks split over "track" and videos over
    "data" (JAX's GSPMD `track_sharded_forward` and its shard_map twin for
    kernel models, in one). Returns fn(video, queries, track_mask) ->
    (coords, vis, conf) of this rank's part: video (B_local, T, H, W, 3) its
    data rows, queries (B_local, N_local, 3) and track_mask (B_local,
    N_local) its tracks (shard_batch with QUERY_PSPEC / MASK_PSPEC), the
    outputs (B_local, T, N_local, ...); `gather` with COORDS_PSPEC /
    TN_PSPEC joins them. N must divide over the track axis (pad and mask).

    Each rank encodes its rows (the track ranks of one data index repeat
    that work, as in JAX), then runs forward_from_pyramid on its tracks: the
    kernels see the local N, and virtual <- points sums over the track
    group (K3 and K7, which normalise locally, never run). The model's
    parameters must be equal on every rank (`replicate`). Runs without
    gradients."""
    track_group = mesh.group("track")

    @torch.no_grad()
    def fn(video, queries, track_mask):
        fmaps = model.compute_fmaps(video, chunk_size=200)
        cp, vp, fp = model.forward_from_pyramid(
            model.build_pyramid(fmaps), queries, iters=iters, track_mask=track_mask,
            track_group=track_group)
        return cp[-1], torch.sigmoid(vp[-1]), torch.sigmoid(fp[-1])

    return fn


def all_reduce_grads(params, group):
    """Sum the parameters' gradients over `group` in one float32 all_reduce
    (a missing gradient counts as zeros, as apply_gradients takes it)."""
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1).to(F32) for p in params])
    dist.all_reduce(flat, group=group)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad.copy_(g.view_as(p.grad))


def make_fast_sharded_train_step(model, optimizer, scheduler, cfg, mesh: Mesh):
    """The training step on a ("data", "track") mesh (JAX's shard_map step,
    and its GSPMD `sharded_train_step`, in one). Returns step(batch,
    generator) -> the loss terms, like training.train_step.train_step:
    batch holds this rank's rows and tracks (BATCH_PSPECS, as
    distributed.global_batch gives them), and every rank passes a
    generator in the same state.

    The queries are drawn at the global batch's shape from that generator
    and sliced (bit for bit the unsharded step's); every masked mean of the
    loss is the global one; the gradients are summed over every rank before
    the update, so the loss and the gradients equal the unsharded step's up
    to float32 reassociation, and every rank makes the same update on the
    same values. K4r, where the model runs it, runs per rank on the local
    tracks."""
    from cotracker_tpu_torch.training.train_step import (
        apply_gradients, sample_queries_from_gt, tracker_loss_fn,
    )

    group, track_group = mesh.group(), mesh.group("track")
    nd, nt = mesh.shape["data"], mesh.shape["track"]

    def step(batch, generator):
        B, _, N = batch["vis_g"].shape
        shard = ((mesh.index["data"] * B, B * nd), (mesh.index["track"] * N, N * nt))
        queries = sample_queries_from_gt(batch["trajs_g"], batch["vis_g"], generator,
                                         cfg.query_sampling_method, shard=shard)
        optimizer.zero_grad(set_to_none=True)
        total, aux = tracker_loss_fn(model, batch["video"], batch["trajs_g"], batch["vis_g"],
                                     batch["valids"], queries, cfg,
                                     track_mask=batch.get("track_mask"), group=group,
                                     track_group=track_group)
        total.backward()
        all_reduce_grads(model.parameters(), group)
        apply_gradients(optimizer, scheduler)
        return {k: v.detach() for k, v in aux.items()}

    return step


# one implementation serves both of JAX's step factories
sharded_train_step = make_fast_sharded_train_step
