"""Data, track and window parallelism over torch.distributed (port of
cotracker_tpu/parallel/): `distributed` (process bring-up, per-rank rows),
`mesh` (the ("data", "track") rank mesh, placement, the track-sharded
forward and training step), `window_pipeline` (GPipe over sliding
windows)."""

from cotracker_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch  # noqa: F401
