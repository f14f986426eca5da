"""The port's pseudo-label distillation against the JAX package's, float32
on the CPU: the whole loop (distill_train) on the same video files, seed
and weights, the online student's loss and gradients, and the frozen-head
optimizer against optax. The tests with no model are in
test_torch_distill_data.py. Two JAX compiles: the loop's step, and the
online student's loss and gradient.

Tolerances, stated per test: the per-step losses rtol 1e-4 (the same
formulas; float32 summation order through the encoder, four steps); each
trained tensor's move within 5% of the JAX move (AdamW normalises every
gradient element, so elements whose gradient is near float32 noise move by
a step of either sign in either framework); the frozen vis_conf_head bit
for bit; the online loss rtol 1e-5 and each gradient within 1e-3 of its
largest magnitude (the bounds of test_torch_train.py); the optimizer's
move rtol 1e-4 (update order).
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from cotracker_tpu.datasets.real_videos import LocalVideoDataset as JaxLocalVideoDataset
from cotracker_tpu.models.cotracker3 import CoTrackerThree as JaxCoTrackerThree
from cotracker_tpu.training import distill as JD
from cotracker_tpu.training import distill_trainer as JT
from cotracker_tpu_torch.datasets.real_videos import LocalVideoDataset
from cotracker_tpu_torch.models.checkpoint import from_jax_params, jax_params_to_state_dict
from cotracker_tpu_torch.models.cotracker3 import CoTrackerThree
from cotracker_tpu_torch.training import distill as D
from cotracker_tpu_torch.training import distill_trainer as DT
from cotracker_tpu_torch.training.train_step import onecycle_lr

from test_torch_model import random_params

torch.set_num_threads(2)

LOOP = dict(crop_size=(32, 32), seq_len=8, sift_size=8, num_steps=4, train_iters=2,
            save_every_n_steps=2, model_window_len=8, query_method="sift")


def write_clips(root, n_videos=2, T=8, H=32, W=32, seed=0):
    """Noise clips written as MJPG .avi files with OpenCV (as
    tests/test_distill.py writes them)."""
    import cv2

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n_videos):
        wr = cv2.VideoWriter(os.path.join(root, f"vid{i}.avi"), cv2.VideoWriter_fourcc(*"MJPG"),
                             10, (W, H))
        assert wr.isOpened()
        for _ in range(T):
            wr.write((rng.random((H, W, 3)) * 255).astype(np.uint8))
        wr.release()
    return root


def drift_teacher(video, queries):
    """Tracks drifting 0.5 px a frame diagonally from each query point,
    visible everywhere (tests/test_distill.py's synthetic teacher)."""
    T, N = video.shape[1], queries.shape[1]
    base = np.asarray(queries)[:, None, :, 1:3]
    drift = np.arange(T, dtype=np.float32)[None, :, None, None] * 0.5
    return np.broadcast_to(base, (1, T, N, 2)) + drift, np.ones((1, T, N), np.float32)


@pytest.fixture
def no_tensorflow(monkeypatch):
    """Both Loggers' TensorBoard writers on tensorboard's no-TensorFlow stub
    (where TensorFlow is installed it would be imported, ~20 s)."""
    monkeypatch.setitem(sys.modules, "tensorboard.compat.notf",
                        types.ModuleType("tensorboard.compat.notf"))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's distill_train, once: two clips, the drift teacher, the loop's
    settings above, from random weights; its log and final parameters."""
    root = tmp_path_factory.mktemp("distill")
    videos = write_clips(str(root / "videos"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorboard.compat.notf",
                   types.ModuleType("tensorboard.compat.notf"))
        model = JaxCoTrackerThree(window_len=8, model_resolution=(32, 32))
        params = random_params(model, seed=5)
        init = jax.tree_util.tree_map(np.array, params)
        exp = str(root / "jax")
        final = JT.distill_train(
            JT.DistillTrainerArgs(exp_dir=exp, **LOOP),
            dataset=JaxLocalVideoDataset(videos, crop_size=(32, 32), seq_len=8),
            model=model, params=params,
            teacher=JD.TeacherEnsemble([drift_teacher], support_grid_size=0))
    log = [json.loads(line) for line in open(os.path.join(exp, "train_log.jsonl"))]
    return dict(root=root, videos=videos, init=init, log=log,
                final=jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, final)))


def test_distill_loop_matches_jax(jax_run, tmp_path, no_tensorflow):
    """The port's distill_train on the same files, seed and weights (the
    plain correlation, as JAX's loop runs): each step's flow, invis and
    total loss rtol 1e-4; every trained tensor's move from its start within
    5% of JAX's move; the encoder's biases that an instance norm follows
    (it removes them, so their gradients are float32 noise and their moves
    noise-driven steps in both frameworks) within the steps' summed
    learning rate; fnet.conv3's bias, which only the L2 normalisation over
    channels follows, by the 5% rule; the vis_conf_head bit for bit its
    start in both."""
    model = from_jax_params(CoTrackerThree(window_len=8, model_resolution=(32, 32)),
                            jax_run["init"])
    exp = str(tmp_path / "port")
    DT.distill_train(
        DT.DistillTrainerArgs(exp_dir=exp, device="cpu", use_corr_kernels=False, **LOOP),
        dataset=LocalVideoDataset(jax_run["videos"], crop_size=(32, 32), seq_len=8),
        model=model, teacher=D.TeacherEnsemble([drift_teacher], support_grid_size=0))
    log = [json.loads(line) for line in open(os.path.join(exp, "train_log.jsonl"))]
    assert [r["step"] for r in log] == [r["step"] for r in jax_run["log"]] == [0, 1, 2, 3]
    for mine, ref in zip(log, jax_run["log"]):
        for k in ("flow_loss", "invis_loss", "total_loss"):
            np.testing.assert_allclose(mine[k], ref[k], rtol=1e-4, atol=1e-7, err_msg=k)
    assert sorted(os.listdir(os.path.join(exp, "checkpoints"))) == [
        "model_000000002.pth", "model_000000004.pth", "model_final.pth"]

    init = jax_params_to_state_dict(jax_run["init"])
    lr_sum = sum(onecycle_lr(c, DT.DistillTrainerArgs.lr, DT.DistillTrainerArgs.num_steps + 100)
                 for c in range(4))
    for name, p in model.named_parameters():
        got, ref, start = p.detach().numpy(), jax_run["final"][name], init[name]
        if "vis_conf_head" in name:
            np.testing.assert_array_equal(ref, start, err_msg=name)
            np.testing.assert_array_equal(got, start, err_msg=name)
        elif name.startswith("fnet") and name.endswith("bias") and name != "fnet.conv3.bias":
            assert np.abs(got - ref).max() <= lr_sum, name
        else:
            move = np.linalg.norm(ref - start)
            assert move > 0, name
            assert np.linalg.norm((got - start) - (ref - start)) <= 0.05 * move, name


def test_online_student_loss_and_grads_match_jax():
    """The online student's distillation loss (CoTrackerThree window 6,
    T=9: two windows; 4 tracks, one queried at frame 4; the teacher's
    visibility mixed, so both terms count; iters=1) and the gradient of
    every parameter against jax.grad of JAX's make_distill_loss on the same
    weights: the loss and its terms rtol 1e-5; each gradient within 1e-3 of
    its largest magnitude, floor 1e-7 (test_torch_train.py's bounds)."""
    rng = np.random.default_rng(2)
    B, T, N = 1, 9, 4
    video = (rng.random((B, T, 32, 32, 3)) * 255).astype(np.float32)
    queries = np.stack([np.zeros((B, N)), rng.random((B, N)) * 31, rng.random((B, N)) * 31],
                       axis=-1).astype(np.float32)
    queries[0, -1, 0] = 4.0
    tracks = (rng.random((B, T, N, 2)) * 31).astype(np.float32)
    vis = rng.random((B, T, N)) > 0.3
    jm = JaxCoTrackerThree(window_len=6, model_resolution=(32, 32))
    params = random_params(jm, seed=6)
    jcfg = JD.DistillConfig(iters=1, offline_model=False, sliding_window_len=6)
    loss_fn = JD.make_distill_loss(jm, jcfg)
    (ref, ref_aux), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, video, queries, tracks, vis), has_aux=True))(params)

    model = from_jax_params(CoTrackerThree(window_len=6, model_resolution=(32, 32)), params)
    total, aux = D.distill_loss(
        model, *(torch.from_numpy(x) for x in (video, queries, tracks, vis)),
        D.DistillConfig(iters=1, offline_model=False, sliding_window_len=6))
    total.backward()
    assert float(ref_aux["invis_loss"]) > 0
    np.testing.assert_allclose(total.item(), float(ref), rtol=1e-5)
    for k in ("flow_loss", "invis_loss", "total_loss"):
        np.testing.assert_allclose(aux[k].item(), float(ref_aux[k]), rtol=1e-5, err_msg=k)
    ref_g = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, ref_grads))
    for name, p in model.named_parameters():
        g = ref_g[name]
        out = np.zeros_like(g) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(out, g, rtol=0, atol=max(1e-3 * np.abs(g).max(), 1e-7),
                                   err_msg=name)


class _Tiny(torch.nn.Module):
    def __init__(self, a, kernel, bias):
        super().__init__()
        self.a = torch.nn.Parameter(torch.from_numpy(a.copy()))
        self.vis_conf_head = torch.nn.Linear(*kernel.shape)
        with torch.no_grad():
            self.vis_conf_head.weight.copy_(torch.from_numpy(kernel.T.copy()))
            self.vis_conf_head.bias.copy_(torch.from_numpy(bias))


def test_frozen_head_optimizer_matches_optax():
    """make_distill_optimizer + distill_step's clip against JAX's
    make_distill_optimizer (optax: clip by the global norm of the whole
    tree, then AdamW on the trainable leaves and set_to_zero on the
    vis_conf_head): three updates from the same gradients, the head's
    large enough to decide the clip (the whole tree's norm above, below
    and above 1; the trainable tensor's below 1 at every step). The
    trainable tensor's move rtol 1e-4 (float32 moves of 1e-2 on values near
    1), the head bit for bit its start (no update, no weight decay); a norm
    over the trainable tensor alone moves it otherwise."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    kernel, bias = rng.standard_normal((4, 2)).astype(np.float32), np.zeros(2, np.float32)
    grads = [(rng.standard_normal((3, 4)) * s, rng.standard_normal((4, 2)) * h,
              rng.standard_normal(2) * h) for s, h in ((0.2, 3.0), (0.02, 0.02), (0.1, 0.9))]
    grads = [tuple(g.astype(np.float32) for g in gs) for gs in grads]
    cfg = dict(lr=1e-2, wdecay=1e-2, num_steps=3, grad_clip=1.0)

    jp = {"a": jnp.asarray(a), "vis_conf_head": {"kernel": jnp.asarray(kernel),
                                                  "bias": jnp.asarray(bias)}}
    tx = JD.make_distill_optimizer(jp, JD.DistillConfig(**cfg))
    state = tx.init(jp)
    for ga, gk, gb in grads:
        g = {"a": jnp.asarray(ga), "vis_conf_head": {"kernel": jnp.asarray(gk),
                                                      "bias": jnp.asarray(gb)}}
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)

    def run(whole_tree):
        m = _Tiny(a, kernel, bias)
        opt, sched = D.make_distill_optimizer(m, D.DistillConfig(**cfg))
        for ga, gk, gb in grads:
            m.a.grad = torch.tensor(ga)  # copies: the clip scales .grad in place
            m.vis_conf_head.weight.grad = torch.tensor(gk.T)
            m.vis_conf_head.bias.grad = torch.tensor(gb)
            D.apply_gradients(opt, sched, 1.0, clip_over=m.parameters() if whole_tree else None)
        return m

    m = run(True)
    ref_move = np.asarray(jp["a"]) - a
    np.testing.assert_allclose(m.a.detach().numpy() - a, ref_move, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(m.vis_conf_head.weight.detach().numpy(), kernel.T)
    np.testing.assert_array_equal(m.vis_conf_head.bias.detach().numpy(), bias)
    np.testing.assert_array_equal(np.asarray(jp["vis_conf_head"]["kernel"]), kernel)
    assert not np.allclose(run(False).a.detach().numpy() - a, ref_move, rtol=1e-2)
