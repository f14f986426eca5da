"""The port's data, track and window parallelism (cotracker_tpu_torch/
parallel/) on the CPU over gloo.

One module fixture starts four ranks (tests/torch_parallel_worker.py, one
thread each, no JAX) once: a (2, 2) ("data", "track") mesh, and 4-stage and
2 x 2 window meshes for the pipeline.
The ranks run every scenario and write their results; the tests read them.
Two JAX references run in this process while the ranks work: the two-pass
virtual <- points under jax.shard_map on 2 virtual devices, and the JAX
track_sharded_forward on a (2, 2) mesh (the whole slice). Every other
scenario is held to its unsharded port counterpart, which the other port
tests hold to JAX, on a model of 8 virtual tracks (the 64 tracks' tokens
otherwise take most of the time at these few tracks).

Tolerances: the forward against JAX, ROADMAP's end-to-end band (coords
rtol 1e-3 / atol 2e-2 px, vis and conf atol 1e-3; random weights at
iters=2); the two-pass block against JAX 1e-5 (output) and 1e-4 (gradients,
relative to each tensor's largest); sharded against unsharded port: loss
rtol 1e-5, gradients and parameters after two steps 5e-4 (JAX
test_parallel.py's bound), the damped stream and pipeline rtol 1e-4 / atol
5e-3 px and 1e-5 on vis / conf (JAX test_parallel.py, test_window_pipeline
.py). Across ranks the parameters are equal bit for bit.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from cotracker_tpu.models.blocks import CrossAttnBlock as JaxCrossAttnBlock
from cotracker_tpu.models.checkpoint import import_torch_state_dict
from cotracker_tpu.models.cotracker3 import CoTrackerThree as JaxCoTrackerThree
from cotracker_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cotracker_tpu.parallel.mesh import replicate as jax_replicate
from cotracker_tpu.parallel.mesh import shard_batch as jax_shard_batch
from cotracker_tpu.parallel.mesh import track_sharded_forward as jax_track_sharded_forward
from cotracker_tpu_torch.models.blocks import CrossAttnBlock
from cotracker_tpu_torch.models.checkpoint import export_reference_state_dict
from cotracker_tpu_torch.models.cotracker3 import CoTrackerThree
from cotracker_tpu_torch.parallel import distributed as pdist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
RES = (32, 32)
HID, HEADS = 32, 4


def _seeded(cls, *a, **k):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return cls(*a, **k)


def _inputs():
    """The ranks' seeded weights and inputs (numpy draws, torch init)."""
    rng = np.random.default_rng(11)
    model = _seeded(CoTrackerThree, window_len=8, model_resolution=RES)
    B, N, T = 2, 16, 8
    queries = np.stack([rng.integers(0, T, (B, N)), rng.random((B, N)) * (RES[1] - 1),
                        rng.random((B, N)) * (RES[0] - 1)], -1).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[:, -3:] = False  # a masked tail: the padding the caller adds
    block = _seeded(CrossAttnBlock, HID, HID, num_heads=HEADS)
    key_mask = rng.random((2, 12)) > 0.3
    key_mask[1, 6:] = False  # every key of rank 1's part of row 1 masked
    qt = rng.integers(0, 13, (3, 16)).astype(np.float32)
    qt[:, :4] = 0.0
    qt[0, 4] = 10.0  # a query in the last window
    pl_queries = np.stack([qt, rng.random((3, 16)) * 31, rng.random((3, 16)) * 31], -1)
    pl_mask = np.ones((3, 16), bool)
    pl_mask[:, -2:] = False
    t = torch.from_numpy
    return {
        "forward": {"state": model.state_dict(),
                    "video": t(rng.random((B, T, *RES, 3), np.float32) * 255),
                    "queries": t(queries), "mask": t(mask)},
        "block": {"hidden": HID, "heads": HEADS, "state": block.state_dict(),
                  "virtual": t(rng.standard_normal((2, 3, 4, HID)).astype(np.float32)),
                  "points": t(rng.standard_normal((2, 12, 3, HID)).astype(np.float32)),
                  "key_mask": t(key_mask),
                  "w": t(rng.standard_normal((2, 3, 4, HID)).astype(np.float32))},
        "pipeline": {"video": t(rng.random((3, 14, *RES, 3), np.float32) * 255),
                     "queries": t(pl_queries.astype(np.float32)), "mask": t(pl_mask)},
        "stream_video": t((rng.random((1, 12, 3, 36, 52)) * 255).astype(np.float32)),
        "_model": model, "_block": block,
    }


class Ranks:
    def __init__(self, out_dir, procs):
        self.out_dir, self.procs, self._res = out_dir, procs, None

    def results(self):
        if self._res is None:
            logs = []
            for p in self.procs:
                try:
                    p.wait(timeout=420)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
                logs.append(p.stdout.read())
                p.stdout.close()
            errs = [open(os.path.join(self.out_dir, f)).read()
                    for f in sorted(os.listdir(self.out_dir)) if f.endswith(".err")]
            assert not errs and all(p.returncode == 0 for p in self.procs), (errs, logs)
            self._res = [torch.load(os.path.join(self.out_dir, f"rank{r}.pt"), weights_only=False)
                         for r in range(WORLD)]
        return self._res


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ranks"))
    inp = _inputs()
    torch.save({k: v for k, v in inp.items() if not k.startswith("_")},
               os.path.join(out, "inputs.pt"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
           "WORLD_SIZE": str(WORLD), "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "PYTHONPATH": REPO}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_parallel_worker.py"), out],
        cwd=REPO, env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    ranks = Ranks(out, procs)
    ranks.inputs = inp
    yield ranks
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _close(a, b, rtol, atol, what):
    """|a - b| <= atol + rtol * |b| everywhere (numpy's assert_allclose,
    in torch: the parameter trees are large)."""
    a, b = (torch.as_tensor(np.array(x, np.float64)) for x in (a, b))
    bad = (a - b).abs() > atol + rtol * b.abs()
    assert a.shape == b.shape and not bad.any(), (
        f"{what}: {int(bad.sum())} of {b.numel()} outside rtol {rtol} / atol {atol}, largest "
        f"difference {(a - b).abs().max().item():.3e}")


def _jax_block_params(block):
    sd = {k: v.numpy() for k, v in block.state_dict().items()}
    dense = lambda n: {"kernel": sd[f"{n}.weight"].T, "bias": sd[f"{n}.bias"]}  # noqa: E731
    return {"norm_context": {"scale": sd["norm_context.weight"], "bias": sd["norm_context.bias"]},
            "cross_attn": {k: dense(f"cross_attn.{k}") for k in ("to_q", "to_kv", "to_out")},
            "mlp": {k: dense(f"mlp.{k}") for k in ("fc1", "fc2")}}


@pytest.fixture(scope="module")
def jax_refs(job):
    """Both JAX references, computed while the ranks run: the two-pass
    block under shard_map on 2 virtual devices (output and gradients of
    sum(out * w)), and track_sharded_forward on a (2, 2) mesh."""
    b = job.inputs["block"]
    jb = JaxCrossAttnBlock(hidden_size=HID, num_heads=HEADS, dim_head=HID // HEADS)
    virtual, points, w = (jnp.asarray(b[k].numpy()) for k in ("virtual", "points", "w"))
    key_mask = jnp.asarray(b["key_mask"].numpy())
    mesh2 = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("track",))

    def loss(p, v, x):
        out = jax.shard_map(
            lambda p_, v_, x_, m_: jb.apply({"params": p_}, v_, x_, key_mask=m_,
                                            axis_name="track",
                                            method=JaxCrossAttnBlock.virtual_from_points),
            mesh=mesh2, in_specs=(P(), P(), P(None, "track"), P(None, "track")),
            out_specs=P())(p, v, x, key_mask)
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        _jax_block_params(job.inputs["_block"]), virtual, points)

    f = job.inputs["forward"]
    model = JaxCoTrackerThree(window_len=8, model_resolution=RES)
    params = import_torch_state_dict(export_reference_state_dict(job.inputs["_model"]))
    mesh = jax_make_mesh((2, 2), devices=jax.devices()[:4])
    video, queries, mask = (jnp.asarray(f[k].numpy()) for k in ("video", "queries", "mask"))
    fwd = jax_track_sharded_forward(model, mesh, iters=2)(
        jax_replicate(mesh, params), jax_shard_batch(mesh, video, P("data", None, None, None, None)),
        jax_shard_batch(mesh, queries, P("data", "track", None)),
        jax_shard_batch(mesh, mask, P("data", "track")))
    return {"block": (np.asarray(out), jax.tree.map(np.asarray, grads)),
            "forward": tuple(np.asarray(x) for x in fwd)}


def test_two_pass_virtual_from_points_matches_jax(job, jax_refs):
    """JAX's CrossAttnBlock.virtual_from_points(axis_name="track") under
    shard_map on 2 virtual devices against the port's two-pass block on two
    gloo ranks: the output and the gradients of sum(out * w) (virtual
    tokens, points, parameters); rank 1's keys of row 1 are all masked."""
    out, grads = jax_refs["block"]

    def rel(a, ref, what):
        _close(a, ref, 0, 1e-4 * np.abs(ref).max(), what)

    for r, res in enumerate(job.results()):
        port = res["v2p"]
        _close(port["out"], out, 1e-5, 1e-5, f"rank {r} output")
        rel(port["virtual_grad"], grads[1], "virtual grad")
        rel(port["points_grad"], grads[2], "points grad")
        g = port["param_grads"]
        rel(g["norm_context.weight"], grads[0]["norm_context"]["scale"], "norm scale grad")
        for k in ("to_q", "to_kv", "to_out"):
            rel(g[f"cross_attn.{k}.weight"], grads[0]["cross_attn"][k]["kernel"].T, k)
        rel(g["mlp.fc1.weight"], grads[0]["mlp"]["fc1"]["kernel"].T, "fc1 grad")


def test_track_sharded_forward_matches_jax(job, jax_refs):
    """The whole slice: JAX's track_sharded_forward on a (2, 2) mesh of
    virtual devices against the port's on four gloo ranks, a masked tail,
    iters=2, the weights carried by the reference-format bridge."""
    c, v, cf = jax_refs["forward"]
    m = np.broadcast_to(job.inputs["forward"]["mask"].numpy()[:, None, :], v.shape)
    for r, res in enumerate(job.results()):
        port = res["forward"]
        _close(port["coords"].numpy()[m], c[m], 1e-3, 2e-2, f"rank {r} coords")
        _close(port["vis"].numpy()[m], v[m], 0, 1e-3, f"rank {r} vis")
        _close(port["conf"].numpy()[m], cf[m], 0, 1e-3, f"rank {r} conf")
    _close(job.results()[0]["forward"]["coords"].numpy()[m],
           job.results()[3]["ref_forward"][0].numpy()[m], 1e-4, 5e-4, "sharded vs unsharded port")


def test_initialize_settings_and_backend_checks():
    """initialize's sources in order (arguments, SLURM, torchrun), and the
    checks that need no job: NCCL or CUDA asked for without a GPU raise."""
    env = {"SLURM_NTASKS": "8", "SLURM_PROCID": "5", "SLURM_LOCALID": "1",
           "WORLD_SIZE": "4", "RANK": "2", "LOCAL_RANK": "2", "MASTER_ADDR": "head",
           "MASTER_PORT": "29500"}
    s = pdist.resolve_settings("node:1234", 2, 1, 0, environ=env)
    assert s == pdist.Settings("node:1234", 2, 1, 0)
    assert pdist.resolve_settings(environ=env) == pdist.Settings("head:29500", 8, 5, 1)
    torchrun = {k: v for k, v in env.items() if not k.startswith("SLURM")}
    assert pdist.resolve_settings(environ=torchrun) == pdist.Settings("head:29500", 4, 2, 2)
    assert pdist.resolve_settings(environ={"WORLD_SIZE": "2", "RANK": "1", "MASTER_ADDR": "h",
                                           "MASTER_PORT": "1"}).local_rank == 1
    with pytest.raises(ValueError, match="coordinator_address"):
        pdist.resolve_settings(environ={"WORLD_SIZE": "2", "RANK": "0"})
    with pytest.raises(ValueError, match="outside"):
        pdist.resolve_settings("h:1", 2, 2, environ={})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="NCCL"):
            pdist.initialize("h:1", 1, 0, backend="nccl", device="cpu")
        with pytest.raises(RuntimeError, match="cuda"):
            pdist.initialize("h:1", 1, 0)


def test_ranks_bounds_and_replicate(job):
    res = job.results()
    assert [r["rank"] for r in res] == list(range(WORLD)) and {r["world"] for r in res} == {4}
    assert [r["bounds"] for r in res] == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert [r["index"] for r in res] == [{"data": d, "track": t} for d in (0, 1) for t in (0, 1)]
    for r in res:
        assert torch.equal(r["replicated"], torch.zeros(3))


def test_sharded_train_step_matches_unsharded(job):
    """make_fast_sharded_train_step on the (2, 2) mesh, the offline model
    (8 frames, one iteration), K4r's plain version and the rematerialised
    iteration per rank on 8 local tracks, each rank with another count of
    valid points: the loss and the gradients of the first step equal the
    unsharded step's, the parameters after two steps too, and they are
    equal bit for bit on every rank. (The online model's loss runs sharded
    in the trainer's test.)"""
    res = [r["train"] for r in job.results()]
    assert len({r["local_valid_count"] for r in res}) == WORLD
    for r in res:
        _close(r["loss"], res[0]["ref_loss"], 1e-5, 0, "loss")
    assert len({r["grads_digest"] for r in res}) == len({r["params_digest"] for r in res}) == 1
    for what in ("grads", "params"):
        name, diff = res[0][f"{what}_max_diff"]  # rank 0 compared them with its unsharded run
        assert diff <= 5e-4, (what, name, diff)


def test_streaming_predictor_with_mesh(job):
    """CoTrackerOnlinePredictor(mesh=) on the (2, 2) mesh, its tracks split
    over "track" (9 grid points padded to 128, 64 a rank; each data index
    streams the same video), damped heads, 12 frames in 2 windows, against
    the unsharded stream; every rank returns the whole tracks."""
    res = job.results()
    t0, v0 = res[1]["ref_stream"]
    for r in res:
        t1, v1 = r["stream"]
        assert t1.shape == t0.shape == (1, 12, 9, 2)
        _close(t1, t0, 1e-4, 5e-3, "tracks")
        assert (v1 == v0).float().mean() > 0.99


def test_window_pipeline_matches_forward_windows(job):
    """window_pipeline_forward on a 4-stage ("window",) mesh and a 2 x 2
    ("window", "track") mesh against forward_windows, damped heads: B = 3
    videos of 14 frames (3 windows: the 4-stage chain pads one, so its last
    stage runs none and the stitch's tail comes from stage 2; the 2-stage
    chain pads one), a query in the last window, a masked tail."""
    res = job.results()
    ref = res[2]["ref_pipeline"]
    for r in res:
        for name in ("window", "window_track"):
            c, v, f = r["pipeline"][name]
            _close(c, ref[0], 1e-4, 5e-3, f"{name} coords")
            _close(v, ref[1], 1e-5, 1e-5, f"{name} vis")
            _close(f, ref[2], 1e-5, 1e-5, f"{name} conf")


def test_trainer_distributed(job):
    """trainer.train(--distributed) on four ranks, the online model (two
    windows, the second's padded frames masked), batch 2: the default mesh
    (2, 2); ranks 0 and 2 read, with their data index's
    seed offset (seed 3, 3 + 7919), and share their rows with ranks 1 and 3;
    only rank 0 writes; a second call resumes every rank from step 1's
    checkpoint; the parameters are equal bit for bit; a mesh whose data axis
    does not divide the batch raises a ValueError on every rank."""
    res = [r["trainer"] for r in job.results()]
    assert [r["entropies"] for r in res] == [[(3, 1)], [], [(3 + 7919, 1)], []]
    assert res[0]["batch_sums"] == res[1]["batch_sums"] != res[2]["batch_sums"]
    assert res[2]["batch_sums"] == res[3]["batch_sums"] and len(res[0]["batch_sums"]) == 1
    assert res[0]["written"] and not any(r["written"] for r in res[1:])
    assert {os.path.basename(p) for p in res[0]["written"]} >= {
        "meta.json", "train_log.jsonl", "model_000000001.pth.tmp", "model_final.pth.tmp"}
    assert all(r["resumed"] == ["model_000000001.pth"] for r in res)
    assert len({r["params_digest"] for r in res}) == 1
    assert all("don't shard over mesh (4, 1)" in r["mesh_error"] for r in res)
