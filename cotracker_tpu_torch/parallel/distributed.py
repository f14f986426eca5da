"""Multi-process bring-up over torch.distributed: process initialization and
per-rank data rows (port of cotracker_tpu/parallel/distributed.py).

One process drives one device, and a rank's device is
`cuda:{local_rank % device_count}` (so two ranks can share one card), or the
CPU. Every rank runs the same program: `initialize()` joins the ranks into
one process group, the ("data", "track") mesh is a grid of ranks
(parallel/mesh.py), and each rank loads only the batch rows of its data
index. The reference launches 4 nodes x 8 GPUs under SLURM over NCCL
(train_on_kubric.py:698-706); the port runs under SLURM or torchrun:

    torchrun --nproc_per_node 8 -m cotracker_tpu_torch.training.trainer --distributed ...
    srun --ntasks 32 --ntasks-per-node 8 env MASTER_ADDR=$head MASTER_PORT=29500 \\
        python -m cotracker_tpu_torch.training.trainer --distributed ...

The backend is an argument: NCCL by default on CUDA, gloo on the CPU (and
for ranks that share one card). Every collective waits at most `timeout_s`,
so a rank that dies or hangs fails the others instead of stalling them.
"""

import datetime
import os
from typing import Mapping, NamedTuple, Optional

import torch
import torch.distributed as dist

from cotracker_tpu_torch import resolve_device

DEFAULT_TIMEOUT_S = 1800.0

# the rank's device, set by initialize (the JAX runtime's process-wide state
# has the same lifetime: one process group a process)
_DEVICE = {}


class Settings(NamedTuple):
    """Where and as what this process joins: the coordinator "host:port",
    the number of processes, this one's rank and its local rank (its index
    among the processes of its node)."""

    coordinator_address: str
    num_processes: int
    process_id: int
    local_rank: int


def resolve_settings(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     environ: Optional[Mapping[str, str]] = None) -> Settings:
    """initialize's settings, each from the first source that has it: the
    arguments; SLURM's SLURM_NTASKS, SLURM_PROCID and SLURM_LOCALID; then
    torchrun's WORLD_SIZE, RANK, LOCAL_RANK. The coordinator is the argument
    or MASTER_ADDR:MASTER_PORT (where JAX reads JAX_COORDINATOR_ADDRESS).
    Without a local rank the rank stands for it (one node). Raises a
    ValueError for a setting that no source gives."""
    env = os.environ if environ is None else environ

    def pick(arg, *names):
        if arg is not None:
            return int(arg)
        for n in names:
            if n in env:
                return int(env[n])
        return None

    world = pick(num_processes, "SLURM_NTASKS", "WORLD_SIZE")
    rank = pick(process_id, "SLURM_PROCID", "RANK")
    local = pick(local_rank, "SLURM_LOCALID", "LOCAL_RANK")
    if not coordinator_address and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    missing = [name for name, v in (
        ("coordinator_address (or MASTER_ADDR and MASTER_PORT)", coordinator_address or None),
        ("num_processes (or SLURM_NTASKS, WORLD_SIZE)", world),
        ("process_id (or SLURM_PROCID, RANK)", rank)) if v is None]
    if missing:
        raise ValueError("initialize: no source gives " + "; ".join(missing))
    if not 0 <= rank < world:
        raise ValueError(f"initialize: process_id {rank} outside [0, {world})")
    return Settings(coordinator_address, world, rank, rank if local is None else local)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_rank: Optional[int] = None,
               backend: Optional[str] = None,
               device: str = "cuda",
               timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join this process to the job (JAX `jax.distributed.initialize` with
    its SLURM fallbacks): settings from `resolve_settings`, the device
    `cuda:{local_rank % device_count}` made current (or the CPU with
    device="cpu"), the default process group over `backend` (None: "nccl"
    on CUDA, "gloo" on the CPU). Asking for CUDA, or for NCCL, without a GPU
    raises. A second call in a joined process checks that it asks for the
    same job and returns. Returns (rank, world_size)."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise RuntimeError("the NCCL backend needs CUDA devices; pass device='cuda' on a GPU "
                           "machine, or backend='gloo'")
    s = resolve_settings(coordinator_address, num_processes, process_id, local_rank)
    if dev.type == "cuda":
        dev = torch.device("cuda", s.local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size(), dist.get_backend()) != (
                s.process_id, s.num_processes, backend):
            raise RuntimeError(f"initialize: this process already joined rank "
                               f"{dist.get_rank()} of {dist.get_world_size()} over "
                               f"{dist.get_backend()}, not rank {s.process_id} of "
                               f"{s.num_processes} over {backend}")
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://{s.coordinator_address}", world_size=s.num_processes,
            rank=s.process_id, timeout=datetime.timedelta(seconds=timeout_s))
    _DEVICE["device"] = dev
    return dist.get_rank(), dist.get_world_size()


def rank_device() -> torch.device:
    """This rank's device, as initialize chose it."""
    if "device" not in _DEVICE:
        raise RuntimeError("call parallel.distributed.initialize() first")
    return _DEVICE["device"]


def is_main_process() -> bool:
    """Rank 0, or a process outside any job."""
    return not dist.is_initialized() or dist.get_rank() == 0


def host_shard_bounds(total: int):
    """[start, stop) rows of a global batch of `total` that this rank owns:
    an even split over the ranks, which must divide it (the reference's
    DistributedSampler with drop_last)."""
    n, i = dist.get_world_size(), dist.get_rank()
    if total % n:
        raise AssertionError(f"global batch {total} does not divide over {n} hosts")
    per = total // n
    return i * per, (i + 1) * per


def global_batch(mesh, tree_specs, host_tree):
    """This rank's part of a batch from its host rows (JAX assembles the
    global sharded arrays instead): `host_tree` holds the rows of the
    rank's data index, whole along every other axis; each leaf is cut along
    the dimensions its spec (a tuple of axis names or None, as in
    mesh.BATCH_PSPECS) splits over the mesh's other axes, and put on the
    rank's device. tree_specs and host_tree are dicts with the same keys."""
    from cotracker_tpu_torch.parallel.mesh import shard_batch

    return {k: shard_batch(mesh, torch.as_tensor(v), tuple(
        None if ax == "data" else ax for ax in tree_specs[k])) for k, v in host_tree.items()}


def sync_global_devices():
    """A barrier over every rank (reference self.barrier(),
    train_on_kubric.py:445)."""
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[rank_device().index])
    else:
        dist.barrier()
