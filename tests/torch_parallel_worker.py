"""One rank of tests/test_torch_parallel.py's gloo job (four ranks, a (2, 2)
mesh). It imports no JAX: the pytest process runs the JAX references and
checks what the ranks wrote.

    RANK=r WORLD_SIZE=4 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_parallel_worker.py OUT_DIR

Reads OUT_DIR/inputs.pt (the pytest process's seeded weights and inputs),
runs every scenario below in order, and writes OUT_DIR/rank{r}.pt: a dict of
each scenario's results. Each rank also runs one scenario's unsharded port
counterpart (ref_*). A failure writes OUT_DIR/rank{r}.err and exits 1 (the other
ranks then fail on the collective's timeout).
"""

import builtins
import hashlib
import os
import sys
import time
import traceback
import types

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from cotracker_tpu_torch.models.blocks import CrossAttnBlock  # noqa: E402
from cotracker_tpu_torch.models.cotracker3 import CoTrackerThree  # noqa: E402
from cotracker_tpu_torch.parallel import distributed as pdist  # noqa: E402
from cotracker_tpu_torch.parallel.mesh import (  # noqa: E402
    COORDS_PSPEC, MASK_PSPEC, QUERY_PSPEC, TN_PSPEC, gather, make_fast_sharded_train_step,
    make_mesh, replicate, shard_batch, track_sharded_forward,
)
from cotracker_tpu_torch.parallel.window_pipeline import (  # noqa: E402
    make_window_mesh, window_pipeline_forward,
)
from cotracker_tpu_torch.predictor import CoTrackerOnlinePredictor  # noqa: E402
from cotracker_tpu_torch.training import trainer  # noqa: E402
from cotracker_tpu_torch.training.data_loader import Sample  # noqa: E402
from cotracker_tpu_torch.training.train_step import (  # noqa: E402
    TrainConfig, make_optimizer, train_step,
)

RES = (32, 32)
# the port-against-port scenarios' models: 8 virtual tracks instead of 64,
# whose tokens' work otherwise dominates at these few tracks
V_SMALL = 8


def small_model(training=False, **kw):
    """A seeded CoTrackerThree with V_SMALL virtual tracks; with `training`
    the trainer's configuration (build_training_model: K4r through the
    autograd wrapper, every iteration rematerialised)."""
    if training:
        kw.update(corr_kernels=True, corr_quant_int8=True, remat_iterations=True)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = CoTrackerThree(model_resolution=kw.pop("model_resolution", RES),
                               num_virtual_tracks=V_SMALL, **kw)
    return model.train() if training else model.eval()


def damp_heads(model, k=0.05):
    """Scale the update heads so the window chain contracts (the JAX tests'
    regime: at full random scale it amplifies float32 reassociation noise)."""
    uf = model.updateformer
    with torch.no_grad():
        for head in (uf.flow_head, uf.vis_conf_head):
            head.weight.mul_(k)
            head.bias.mul_(k)
    return model


def v2p_block(inp, mesh):
    """CrossAttnBlock.virtual_from_points sharded over "track": the output
    and the gradients of sum(out * w) for the virtual tokens, this rank's
    points and the parameters, summed over the track group as the sharded
    step sums them. The output is replicated, so each rank seeds its part
    of the loss, 1 / track size of it (in the model a replicated tensor's
    cotangent holds only what flows back from the rank's own points)."""
    b = inp["block"]
    block = CrossAttnBlock(b["hidden"], b["hidden"], num_heads=b["heads"])
    block.load_state_dict(b["state"])
    virtual = b["virtual"].clone().requires_grad_(True)
    points = shard_batch(mesh, b["points"], (None, "track")).clone().requires_grad_(True)
    mask = shard_batch(mesh, b["key_mask"], (None, "track"))
    out = block.virtual_from_points(virtual, points, key_mask=mask, group=mesh.group("track"))
    (out * b["w"]).sum().div(mesh.shape["track"]).backward()
    grads = {n: p.grad.clone() for n, p in block.named_parameters()}
    for g in grads.values():
        torch.distributed.all_reduce(g, group=mesh.group("track"))
    virtual_grad = virtual.grad.clone()
    torch.distributed.all_reduce(virtual_grad, group=mesh.group("track"))
    return {"out": out.detach(), "virtual_grad": virtual_grad,
            "points_grad": gather(mesh, points.grad, (None, "track")), "param_grads": grads}


def sharded_forward(inp, mesh):
    f = inp["forward"]
    model = CoTrackerThree(window_len=8, model_resolution=RES)
    model.load_state_dict(f["state"])
    replicate(mesh, model)
    fwd = track_sharded_forward(model, mesh, iters=2)
    c, v, cf = fwd(shard_batch(mesh, f["video"], ("data",)),
                   shard_batch(mesh, f["queries"], QUERY_PSPEC),
                   shard_batch(mesh, f["mask"], MASK_PSPEC))
    res = {"coords": gather(mesh, c, COORDS_PSPEC), "vis": gather(mesh, v, TN_PSPEC),
           "conf": gather(mesh, cf, TN_PSPEC)}
    return res


def unsharded_forward(inp):
    f = inp["forward"]
    model = CoTrackerThree(window_len=8, model_resolution=RES)
    model.load_state_dict(f["state"])
    with torch.no_grad():
        return model(f["video"], f["queries"], iters=2, track_mask=f["mask"])[:3]


def train_batch(B, T, N, seed):
    """A training batch whose valid counts differ between the ranks' parts."""
    rng = np.random.default_rng(seed)
    vis = (rng.random((B, T, N)) > 0.3).astype(np.float32)
    vis[:, 0] = 1.0
    valids = (rng.random((B, T, N)) > 0.25).astype(np.float32)
    valids[:, :, -N // 4:] *= rng.random((B, 1, N // 4)) > 0.5  # uneven across track parts
    return {"video": torch.from_numpy(rng.random((B, T, *RES, 3), np.float32) * 255),
            "trajs_g": torch.from_numpy(rng.random((B, T, N, 2)).astype(np.float32) * 31),
            "vis_g": torch.from_numpy(vis), "valids": torch.from_numpy(valids)}


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _digest(tensors):
    """A hash of the tensors' bits (the ranks compare parameters by it)."""
    h = hashlib.sha256()
    for t in tensors.values():
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _train_setup():
    """The offline model's step, 8 frames, one iteration."""
    cfg = TrainConfig(iters=1, offline_model=True)
    return train_batch(2, 8, 16, seed=7), cfg, small_model(training=True, window_len=8)


def unsharded_steps():
    """Two unsharded steps: the first's loss and gradients, the parameters
    after the second."""
    batch, cfg, model = _train_setup()
    opt, sched = make_optimizer(model, 1e-4, 1e-5, 100)
    gen = torch.Generator().manual_seed(0)
    aux = train_step(model, opt, sched, batch, gen, cfg)
    res = {"loss": aux["total_loss"], "grads": _grads(model)}
    train_step(model, opt, sched, batch, gen, cfg)
    res["params"] = _params(model)
    return res


def sharded_steps(mesh, ref=None):
    """The same two steps through make_fast_sharded_train_step; with `ref`
    (unsharded_steps' results, on rank 0) the largest differences from it
    of the first step's gradients and of the parameters after the second."""
    batch, cfg, model = _train_setup()
    res = {}
    opt, sched = make_optimizer(model, 1e-4, 1e-5, 100)
    step = make_fast_sharded_train_step(model, opt, sched, cfg, mesh)
    gen = torch.Generator().manual_seed(0)
    local = {k: shard_batch(mesh, v, spec) for k, v, spec in (
        ("video", batch["video"], ("data",)), ("trajs_g", batch["trajs_g"], ("data", None, "track")),
        ("vis_g", batch["vis_g"], ("data", None, "track")),
        ("valids", batch["valids"], ("data", None, "track")))}
    aux = step(local, gen)
    grads = _grads(model)
    res["loss"], res["grads_digest"] = aux["total_loss"], _digest(grads)
    res["local_valid_count"] = float(local["valids"].sum())
    step(local, gen)
    params = _params(model)
    res["params_digest"] = _digest(params)
    if ref is not None:  # the others' are equal bit for bit (the digests)
        res["ref_loss"] = ref["loss"]
        for what, mine in (("grads", grads), ("params", params)):
            diffs = {n: (mine[n] - ref[what][n]).abs().max().item() for n in mine}
            res[f"{what}_max_diff"] = max(diffs.items(), key=lambda kv: kv[1])
    return res


def stream(mesh, video):
    """The streaming predictor over `video`, track-sharded by `mesh` (None:
    unsharded), damped heads."""
    p = CoTrackerOnlinePredictor(window_len=8, capacity=64, model_resolution=RES,
                                 return_full_buffers=True, device="cpu", mesh=mesh)
    # the same seeded model on every rank
    p.model = damp_heads(small_model(window_len=8))
    p(video[:, :1], is_first_step=True, grid_size=3)
    for ind in range(0, video.shape[1] - p.step, p.step):
        tracks, vis = p(video[:, ind : ind + 8])
    return tracks[:, : p.frames_seen], vis[:, : p.frames_seen]


def pipeline(inp):
    pl = inp["pipeline"]
    model = damp_heads(small_model(window_len=8))
    res = {}
    for name, mesh in (("window", make_window_mesh(4)), ("window_track", make_window_mesh(2, 2))):
        replicate(mesh, model)
        res[name] = window_pipeline_forward(model, mesh, iters=2)(pl["video"], pl["queries"],
                                                                   pl["mask"])
    return res


def unsharded_pipeline(inp):
    pl = inp["pipeline"]
    with torch.no_grad():
        return damp_heads(small_model(window_len=8)).forward_windows(
            pl["video"], pl["queries"], iters=2, track_mask=pl["mask"])[:3]


class TinyClips:
    """Four 10-frame clips of random frames and tracks; records the entropy
    of the generator each read draws from, and every clip index read."""

    def __init__(self, T=10, N=16):
        rng = np.random.default_rng(5)
        self.clips = [Sample((rng.random((T, 3, *RES)) * 255).astype(np.float32),
                             (rng.random((T, N, 2)) * 31).astype(np.float32),
                             (rng.random((T, N)) > 0.2).astype(np.float32),
                             np.ones((T, N), np.float32)) for _ in range(4)]
        self.reads = []

    def __len__(self):
        return len(self.clips)

    def get(self, ix, rng):
        self.reads.append((int(ix), list(rng.bit_generator.seed_seq.entropy)))
        return self.clips[ix], True


def train_distributed(out_dir):
    """trainer.train(--distributed) on the four ranks, the online model (10
    frames in windows of 8 at step 4: the second window's last two frames
    are padding that the frame mask leaves out), batch 2 (the default mesh
    (2, 2)), 1 step, then a call to the same step count that resumes and
    trains no further; and a mesh_shape whose data axis does not divide the
    batch."""
    written, batches, resumed = [], [], []
    real_open, real_save = builtins.open, torch.save
    real_shared, real_load = trainer._shared_batch, trainer.load_checkpoint

    def open_w(path, mode="r", *a, **k):
        if any(c in mode for c in "wax+"):
            written.append(str(path))
        return real_open(path, mode, *a, **k)

    def save_w(obj, f, *a, **k):
        written.append(str(f))
        return real_save(obj, f, *a, **k)

    def shared(*a, **k):
        batch = real_shared(*a, **k)
        batches.append(float(batch["video"].double().sum()))
        return batch

    def load(path, *a, **k):
        resumed.append(os.path.basename(path))
        return real_load(path, *a, **k)

    args = trainer.TrainerArgs(
        exp_dir=os.path.join(out_dir, "train"), batch_size=2, seq_len=10, traj_per_sample=16,
        num_steps=1, train_iters=1, save_every_n_steps=1, crop_size=RES, model_window_len=8,
        offline_model=False,
        num_loader_workers=1, dataset_repeats=1, device="cpu", distributed=True,
        dist_backend="gloo", seed=3)
    data = TinyClips()
    model = small_model(training=True, window_len=8)
    builtins.open, torch.save = open_w, save_w
    trainer._shared_batch, trainer.load_checkpoint = shared, load
    try:
        trainer.train(args, dataset=data, model=model)
        model = trainer.train(args, dataset=data, model=small_model(training=True, window_len=8))
    finally:
        builtins.open, torch.save = real_open, real_save
        trainer._shared_batch, trainer.load_checkpoint = real_shared, real_load
    try:
        trainer.train(trainer.TrainerArgs(**{**vars(args), "mesh_shape": (4, 1)}), dataset=data,
                      model=model)
        error = None
    except ValueError as e:
        error = str(e)
    return {"written": written, "batch_sums": batches, "resumed": resumed,
            "entropies": sorted({tuple(e) for _, e in data.reads}),
            "params_digest": _digest(_params(model)),
            "mesh_error": error}


def timed(res, name, fn, *a):
    t0 = time.perf_counter()
    res[name] = fn(*a)
    print(f"{name} {time.perf_counter() - t0:.2f} s", flush=True)


def main(out_dir):
    torch.set_num_threads(1)
    # the trainer's TensorBoard writer on tensorboard's no-TensorFlow stub
    sys.modules["tensorboard.compat.notf"] = types.ModuleType("tensorboard.compat.notf")
    rank, world = pdist.initialize(device="cpu", timeout_s=90)
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    res = {"rank": rank, "world": world, "bounds": pdist.host_shard_bounds(8)}
    # the unsharded counterparts first, one a rank, side by side
    video = inp["stream_video"]
    refs = [("ref_train", unsharded_steps), ("ref_stream", stream, None, video),
            ("ref_pipeline", unsharded_pipeline, inp), ("ref_forward", unsharded_forward, inp)]
    timed(res, *refs[rank])
    mesh = make_mesh((2, 2))
    res["index"] = dict(mesh.index)
    probe = torch.full((3,), float(rank))
    res["replicated"] = replicate(mesh, probe).clone()
    timed(res, "v2p", v2p_block, inp, mesh)
    timed(res, "forward", sharded_forward, inp, mesh)
    timed(res, "train", sharded_steps, mesh, res.pop("ref_train", None))
    timed(res, "stream", stream, mesh, video)
    timed(res, "pipeline", pipeline, inp)
    timed(res, "trainer", train_distributed, out_dir)
    pdist.sync_global_devices()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    try:
        main(sys.argv[1])
    except BaseException:
        with open(os.path.join(sys.argv[1], f"rank{os.environ.get('RANK')}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
