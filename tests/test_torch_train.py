"""The port's training stack against the JAX package's, float32 on the CPU,
inputs from numpy seeds: the masked mean and the losses, the optimizer and
its schedule, the per-level correlation path through K4r / K4f (plain
versions) against the Pallas wrapper in interpret mode, the online model's
loss and every parameter gradient, and the offline model's training
outputs. The tests that compile JAX are all in this file; the port-only
training tests are in test_torch_train_ops.py.

Tolerances, stated per test: rtol 1e-6 for the losses (the same float32
formulas), 1e-6 for the schedule (optax evaluates its cosine in float32),
1e-5 after three AdamW + clip steps (update order), the int8 band of
test_torch_kernels for K4r (a tie moves one code by one step), and for the
model the float32 noise of two frameworks' summation orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from cotracker_tpu.models.cotracker3 import CoTrackerThree as JaxCoTrackerThree
from cotracker_tpu.ops.kernels import corr_pallas
from cotracker_tpu.ops.masked import reduce_masked_mean as jax_masked_mean
from cotracker_tpu.training import losses as JL
from cotracker_tpu.training import train_step as JS
from cotracker_tpu_torch.models.checkpoint import from_jax_params, jax_params_to_state_dict
from cotracker_tpu_torch.models.cotracker3 import CoTrackerThree
from cotracker_tpu_torch.ops.kernels import corr_cuda
from cotracker_tpu_torch.ops.masked import reduce_masked_mean
from cotracker_tpu_torch.training import losses as L
from cotracker_tpu_torch.training import train_step as TS

from test_torch_kernels import assert_codes_close
from test_torch_model import random_params

torch.set_num_threads(2)


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


@pytest.fixture(scope="module")
def loss_inputs():
    rng = np.random.default_rng(0)
    iters, B, T, N = 3, 2, 6, 5
    return dict(
        flow=(rng.standard_normal((iters, B, T, N, 2)) * 8).astype(np.float32),
        gt=(rng.standard_normal((B, T, N, 2)) * 8).astype(np.float32),
        valids=(rng.random((B, T, N)) > 0.2).astype(np.float32),
        vis=(rng.random((B, T, N)) > 0.3).astype(np.float32),
        prob=(rng.random((iters, B, T, N)) * 0.98 + 0.01).astype(np.float32),
        frame_mask=(np.arange(T) < 4).astype(np.float32),
    )


@pytest.mark.parametrize("loss", ["masked_mean", "huber", "flow", "flow_huber_visible", "bce",
                                  "prob"])
@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(loss_inputs, loss, masked):
    """Each loss, with and without the frame mask where it takes one
    (masked_mean: the mask on a reduction axis instead), rtol 1e-6."""
    d = loss_inputs
    fm = d["frame_mask"] if masked else None
    flow, gt, valids, vis, prob = _t(d["flow"], d["gt"], d["valids"], d["vis"], d["prob"])
    tfm = None if fm is None else torch.from_numpy(fm)
    if loss == "masked_mean":
        kw = dict(axis=(0, 2)) if masked else {}
        ref = jax_masked_mean(jnp.asarray(d["flow"][0, ..., 0]), d["valids"], **kw)
        out = reduce_masked_mean(flow[0, ..., 0], valids, **({"dim": (0, 2)} if masked else {}))
    elif loss == "huber":
        ref = JL.huber(jnp.asarray(d["flow"][0]), jnp.asarray(d["gt"]), delta=6.0)
        out = L.huber(flow[0], gt, delta=6.0)
    elif loss.startswith("flow"):
        kw = dict(add_huber_loss=loss != "flow", loss_only_for_visible=loss != "flow")
        val = d["valids"] * (1.0 if fm is None else fm[None, :, None])
        ref = JL.sequence_loss(jnp.asarray(d["flow"]), d["gt"], val, d["vis"], **kw)
        out = L.sequence_loss(flow, gt, torch.from_numpy(val), vis, **kw)
    elif loss == "bce":
        ref = JL.sequence_bce_loss(jnp.asarray(d["prob"]), d["vis"], frame_mask=fm)
        out = L.sequence_bce_loss(prob, vis, frame_mask=tfm)
    else:
        ref = JL.sequence_prob_loss(jnp.asarray(d["flow"]), d["prob"], d["gt"], d["vis"],
                                    frame_mask=fm)
        out = L.sequence_prob_loss(flow, prob, gt, vis, frame_mask=tfm)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


def test_schedule_matches_optax():
    """The learning rate of every step 0 ... num_steps + 100 (and past it)
    against optax.cosine_onecycle_schedule: rtol 1e-6, and atol 1e-7 of the
    peak, because optax evaluates the cosine in float32, where the start of
    the ramp is a difference of values near the peak (one ulp of it)."""
    num_steps, lr = 60, 5e-4
    _, schedule = JS.make_optimizer(lr=lr, num_steps=num_steps)
    opt, sched = TS.make_optimizer(torch.nn.Linear(2, 2), lr=lr, num_steps=num_steps)
    for c in range(num_steps + 104):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(schedule(c)), rtol=1e-6,
                                   atol=1e-7 * lr, err_msg=f"step {c}")
        opt.step()
        sched.step()


def test_adamw_and_clip_match_optax():
    """Three updates of a small parameter set from the same gradients (the
    first and third above the clip norm of 1, the second below it) against
    the JAX optax chain, rtol 1e-5."""
    rng = np.random.default_rng(1)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32) for k, v in params.items()}
             for s in (2.0, 0.05, 0.7)]
    tx, _ = JS.make_optimizer(lr=1e-2, wdecay=1e-2, num_steps=3)
    jp, state = jax.tree_util.tree_map(jnp.asarray, params), None
    state = tx.init(jp)
    module = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                                     for k, v in params.items()})
    opt, sched = TS.make_optimizer(module, lr=1e-2, wdecay=1e-2, num_steps=3)
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in module.items():
            p.grad = torch.from_numpy(g[k].copy())
        TS.apply_gradients(opt, sched)
        for k, p in module.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)


@pytest.mark.parametrize("quant_int8", [False, True])
def test_kernel_level_path_matches_pallas(quant_int8):
    """One level through K4f / K4r (plain versions) and the epilogue against
    fused_corr_embs_pallas(fuse_combine=False, interpret=True): T=4, 8
    points in chunks of 3, a 12x16 map, C=128. K4f within float32
    summation noise (rtol 1e-5 of the output scale); K4r within the int8
    band of test_torch_kernels.assert_codes_close."""
    rng = np.random.default_rng(20 + quant_int8)
    B, T, N, H, W = 1, 4, 8, 12, 16
    fm = rng.standard_normal((B, T, H, W, 128)).astype(np.float32)
    fm /= np.linalg.norm(fm, axis=-1, keepdims=True)
    sup = rng.standard_normal((B, N, 49, 128)).astype(np.float32)
    sup /= np.linalg.norm(sup, axis=-1, keepdims=True)
    coords = (rng.random((B, T, N, 2)) * np.array([W + 6, H + 6]) - 3).astype(np.float32)
    w1 = (rng.standard_normal((2401, 64)) * 0.02).astype(np.float32)
    b1 = (rng.standard_normal(64) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((64, 32)) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(32) * 0.1).astype(np.float32)
    ref = corr_pallas.fused_corr_embs_pallas(
        jnp.asarray(fm), jnp.asarray(sup), jnp.asarray(coords), w1, b1, w2, b2, radius=3,
        chunk=3, compute_dtype=jnp.float32, interpret=True, track_major=True,
        quant_int8=quant_int8, fuse_combine=False)
    tfm = torch.from_numpy(fm)
    level = (corr_cuda.build_int8_level(tfm, 3) if quant_int8
             else corr_cuda.build_float_level(tfm, 3, torch.float32))
    out = corr_cuda.fused_corr_embs_kernel(level, (H, W), *_t(sup, coords, w1, b1, w2, b2),
                                           chunk=3, compute_dtype=torch.float32,
                                           quant_int8=quant_int8)
    assert out.shape == (B, N, T, 32)
    if quant_int8:
        assert_codes_close(out.numpy(), ref)
    else:
        ref = np.asarray(ref)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_trainable_fuse_mlp1_matches_pallas(monkeypatch):
    """The autograd wrapper with fuse_mlp1 (K4m forward, plain version)
    against fused_corr_embs_pallas_trainable with COTRACKER_CORR_FUSE_MLP1=1
    (the JAX wrapper reads it at trace time), Pallas interpreted, at the
    shapes of test_kernel_level_path_matches_pallas with MLP1's 384 rows:
    the forward within the int8 band of test_torch_kernels.assert_codes_close,
    and the gradients of fmaps, support, coords, W1, b1, W2 and b2 (both
    backwards are the plain featurizer's autograd: a straight-through
    estimator) within float32 noise, 1e-4 of each tensor's largest."""
    monkeypatch.setenv("COTRACKER_CORR_FUSE_MLP1", "1")
    rng = np.random.default_rng(22)
    B, T, N, H, W = 1, 4, 8, 12, 16
    fm = rng.standard_normal((B, T, H, W, 128)).astype(np.float32)
    fm /= np.linalg.norm(fm, axis=-1, keepdims=True)
    sup = rng.standard_normal((B, N, 49, 128)).astype(np.float32)
    sup /= np.linalg.norm(sup, axis=-1, keepdims=True)
    coords = (rng.random((B, T, N, 2)) * np.array([W + 6, H + 6]) - 3).astype(np.float32)
    w1 = (rng.standard_normal((2401, 384)) * 0.02).astype(np.float32)
    b1 = (rng.standard_normal(384) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((384, 32)) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(32) * 0.1).astype(np.float32)
    ct = rng.standard_normal((B, N, T, 32)).astype(np.float32)
    inputs = (fm, sup, coords, w1, b1, w2, b2)
    packed = corr_pallas.build_shifted_fmaps(jnp.asarray(fm), 3, jnp.float32, quant_int8=True)

    @jax.jit
    def value_and_vjp(ct, *a):
        out, vjp = jax.vjp(lambda *a: corr_pallas.fused_corr_embs_pallas_trainable(
            packed, *a, radius=3, chunk=3, compute_dtype=jnp.float32, interpret=True,
            track_major=True, quant_int8=True), *a)
        return out, vjp(ct)

    ref, ref_grads = value_and_vjp(jnp.asarray(ct), *map(jnp.asarray, inputs))

    a = [t.requires_grad_() for t in _t(*inputs)]
    level = corr_cuda.build_int8_level(a[0].detach(), 3)
    out = corr_cuda.fused_corr_embs_trainable(level, *a, chunk=3, compute_dtype=torch.float32,
                                              quant_int8=True, fuse_mlp1=True)
    assert out.shape == (B, N, T, 32)
    assert_codes_close(out.detach().numpy(), np.asarray(ref))
    out.backward(torch.from_numpy(ct))
    for name, x, g in zip(("fmaps", "support", "coords", "w1", "b1", "w2", "b2"), a, ref_grads):
        g = np.asarray(g)
        np.testing.assert_allclose(x.grad.numpy(), g, rtol=0, atol=1e-4 * np.abs(g).max(),
                                   err_msg=name)


@pytest.fixture(scope="module")
def params():
    return random_params(JaxCoTrackerThree(), seed=3)


def _train_batch(seed, T, H, W, N):
    """A video, consistent ground truth (tracks moving 1-2 px per frame,
    some leaving the frame) and queries at each track's first visible frame
    (the last one at a later frame)."""
    rng = np.random.default_rng(seed)
    video = (rng.random((1, T, H, W, 3)) * 255).astype(np.float32)
    start = rng.random((N, 2)) * np.array([W - 1, H - 1])
    vel = rng.uniform(-2, 2, (N, 2))
    trajs = (start[None] + np.arange(T)[:, None, None] * vel[None])[None].astype(np.float32)
    vis = ((trajs >= 0) & (trajs <= np.array([W - 1, H - 1]))).all(-1).astype(np.float32)
    vis[0, : T // 2, -1] = 0.0
    vis[0, T // 2, -1] = 1.0
    valids = np.ones_like(vis)
    t0 = np.argmax(vis[0] > 0, axis=0)
    queries = np.concatenate([t0[:, None], trajs[0, t0, np.arange(N)]], -1)[None]
    return video, trajs, vis, valids, queries.astype(np.float32)


def test_online_model_loss_and_grads_match_jax(params):
    """tracker_loss_fn of the online model (32x32, T=8, window 6 at step 3:
    two windows, the second past the video's end; 4 tracks, one queried in
    the second window; iters=1) and the gradient of every parameter, the
    port against jax.grad of the JAX function on the same weights. The JAX
    gradient tree maps onto the port's parameters through the weight
    bridge (a rename and transpose). Loss rtol 1e-5; each gradient within
    1e-3 of its own largest magnitude (float32 summation order through the
    encoder's backward), with a floor of 1e-7 for the gradients that are
    zero up to float32 noise (the encoder's conv biases ahead of instance
    norm, which removes them; the floor of tests/test_training.py)."""
    video, trajs, vis, valids, queries = _train_batch(7, 8, 32, 32, 4)
    cfg = JS.TrainConfig(iters=1, offline_model=False, sliding_window_len=6)
    jm = JaxCoTrackerThree(window_len=6, model_resolution=(32, 32))
    (ref_loss, ref_aux), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: JS.tracker_loss_fn(jm, p, video, trajs, vis, valids, queries, cfg),
        has_aux=True))(params)

    model = from_jax_params(CoTrackerThree(window_len=6, model_resolution=(32, 32)), params)
    loss, aux = TS.tracker_loss_fn(model, *_t(video, trajs, vis, valids, queries),
                                   TS.TrainConfig(iters=1, offline_model=False,
                                                  sliding_window_len=6))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    for k in ref_aux:
        np.testing.assert_allclose(aux[k].item(), float(ref_aux[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    ref = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, ref_grads))
    got = dict(model.named_parameters())
    assert set(ref) == set(got)
    for k, g in ref.items():
        p = got[k]
        out = np.zeros_like(g) if p.grad is None else p.grad.numpy()
        atol = max(1e-3 * np.abs(g).max(), 1e-7)
        np.testing.assert_allclose(out, g, rtol=0, atol=atol, err_msg=k)


def test_offline_train_data_matches_jax(params):
    """The offline forward's is_train outputs (per-iteration coords, vis
    and conf probabilities, the valid mask of ones) at iters=2, 32x32, T=6,
    against JAX: coords rtol 1e-3 / atol 2e-2 px, vis and conf atol 1e-3
    (the tolerances of tests/test_models.py)."""
    video, _, _, _, queries = _train_batch(8, 6, 32, 32, 5)
    jm = JaxCoTrackerThree(window_len=8, model_resolution=(32, 32))
    ref = jax.jit(lambda p: jm.apply({"params": p}, video, queries, iters=2, is_train=True)[3])(
        params)
    model = from_jax_params(CoTrackerThree(window_len=8, model_resolution=(32, 32)), params)
    with torch.no_grad():
        out = model(*_t(video, queries), iters=2, is_train=True)[3]
    assert out[0].shape == (2, 1, 6, 5, 2) and out[1].shape == (2, 1, 6, 5)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=1e-3, atol=2e-2)
    for a, b in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-3)
