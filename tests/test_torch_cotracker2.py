"""The port's legacy CoTracker2 family (v2: window 8, v2.1: window 16)
against the JAX package's, float32, on the CPU, with the same random JAX
parameters carried across by the weight bridge: the three ops only v2 uses,
the bridge in both directions bit for bit, the offline forward of both
window lengths with masked padding tracks and the `is_train` outputs, three
streaming chunks, both predictors' v2 branches, the evaluation predictor
and the evaluation CLI's `--v2`.

Shapes are small apart from the widths, which the model fixes:
model_resolution 48x64, 4 real + 5 masked padding queries, iters=2; v2 at
T=12 and v2.1 at T=24 (two windows each). Tolerances are the JAX package's
own for v2 (tests/test_models.py:235-237, 266-271): coords rtol 1e-3 / atol
2e-2 pixels, vis 1e-3 offline and atol 2e-3 after three streaming chunks;
the predictors' visibility is a threshold, of which at most 1% of the
entries may flip.

The flow embedding's frequencies reach 1000/64 * 62 ~ 970 radians per
feature-map pixel, so with random weights a coordinate difference of 1e-5
pixels becomes a phase difference of 1e-2 in the next iteration's tokens
and grows with every window: the port against itself, with its video moved
by 1e-3 of a grey level, differs by 5 pixels in the second offline window
and by 0.02 in visibility after three streaming chunks, as much as it
differs from JAX there. So the random parameters are damped where that
loop closes: the input projection's rows of the sin/cos flow embedding (x
0.02) and the flow head (x 0.1, as tests/test_torch_predictor.py damps
CoTracker3's; the track-feature updater's LayerNorm restores the feature
deltas' scale). The tracks still move by 4-7 pixels, and the port then
agrees with JAX to ~1e-5.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cotracker_tpu.models.checkpoint import export_torch_state_dict_v2, import_torch_state_dict_v2
from cotracker_tpu.models.cotracker2 import CoTracker2 as JaxCoTracker2
from cotracker_tpu.ops import bilinear as jax_bilinear
from cotracker_tpu.ops import embeddings as jax_embeddings
from cotracker_tpu.predictor import CoTrackerOnlinePredictor as JaxOnlinePredictor
from cotracker_tpu.predictor import CoTrackerPredictor as JaxPredictor
from cotracker_tpu_torch.evaluation.evaluate import DefaultConfig, parse_config, run_eval
from cotracker_tpu_torch.evaluation.evaluation_predictor import EvaluationPredictor
from cotracker_tpu_torch.models.build import build_cotracker
from cotracker_tpu_torch.models.checkpoint import (
    export_reference_state_dict, from_jax_params, load_reference_state_dict,
    save_reference_checkpoint,
)
from cotracker_tpu_torch.models.cotracker2 import CoTracker2
from cotracker_tpu_torch.ops.bilinear import sample_features_2d
from cotracker_tpu_torch.ops.embeddings import get_2d_embedding, get_2d_sincos_pos_embed
from cotracker_tpu_torch.predictor import CoTrackerOnlinePredictor, CoTrackerPredictor
from test_torch_eval import _davis_pickle
from test_torch_model import random_params

torch.set_num_threads(2)

RES = (48, 64)
N_REAL, N_PAD = 4, 5
FRAMES = {8: 12, 16: 24}  # two windows of each
COORDS_TOL = dict(rtol=1e-3, atol=2e-2)


@pytest.fixture(scope="module")
def params():
    """One parameter tree serves both window lengths: none of its shapes
    depends on the window."""
    p = random_params(JaxCoTracker2(model_resolution=RES), seed=16)
    uf = p["window_core"]["iter_core"]["updateformer"]
    uf["flow_head"]["kernel"] *= 0.1
    uf["flow_head"]["bias"] *= 0.1
    uf["input_transform"]["kernel"][2:130] *= 0.02  # rows of the sin/cos flow embedding
    return p


def _inputs(T, seed):
    """A video (1, T, 48, 64, 3), 4 real queries at random frames and 5
    padding queries, the track mask of the real ones."""
    rng = np.random.default_rng(seed)
    video = (rng.random((1, T, *RES, 3)) * 255).astype(np.float32)
    n = N_REAL + N_PAD
    queries = np.stack([rng.integers(0, T, (1, n)), rng.random((1, n)) * (RES[1] - 1),
                        rng.random((1, n)) * (RES[0] - 1)], axis=-1).astype(np.float32)
    queries[:, N_REAL:, 0] = 0.0
    mask = np.arange(n)[None] < N_REAL
    return video, queries, mask


@pytest.fixture(scope="module")
def jax_offline(params):
    """The JAX offline forward (is_train) per window length, computed once."""

    @functools.lru_cache(maxsize=None)
    def run(window_len):
        jm = JaxCoTracker2(window_len=window_len, model_resolution=RES)
        video, queries, mask = _inputs(FRAMES[window_len], seed=window_len)
        out = jax.jit(lambda p, v, q, m: jm.apply({"params": p}, v, q, iters=2, track_mask=m,
                                                  is_train=True))(params, video, queries, mask)
        return jax.tree_util.tree_map(np.asarray, out)

    return run


def test_ops_match_jax():
    emb = get_2d_sincos_pos_embed(456, (12, 16))
    ref = np.asarray(jax_embeddings.get_2d_sincos_pos_embed(456, (12, 16)))
    assert emb.shape == (1, 12, 16, 456) and np.array_equal(emb, ref)
    # the first half embeds the w coordinate: constant down a column
    assert np.array_equal(emb[0, 0, :, :228], emb[0, 5, :, :228])

    rng = np.random.default_rng(1)
    xy = (rng.standard_normal((3, 8, 2)) * 4).astype(np.float32)
    pe = get_2d_embedding(torch.from_numpy(xy), 64, cat_coords=True)
    ref = np.asarray(jax_embeddings.get_2d_embedding(jnp.asarray(xy), 64, cat_coords=True))
    assert pe.shape == (3, 8, 130)
    np.testing.assert_allclose(pe.numpy(), ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(pe[..., :2].numpy(), xy)  # coordinates first
    # sin on even channels, cos on odd
    np.testing.assert_allclose(pe[..., 2:66:2] ** 2 + pe[..., 3:66:2] ** 2, 1.0, atol=1e-6)

    fmaps = rng.standard_normal((2, 12, 16, 5)).astype(np.float32)
    coords = np.stack([rng.uniform(-3, 19, (2, 7)), rng.uniform(-3, 15, (2, 7))], -1)
    coords = coords.astype(np.float32)  # some past the border: clamped
    out = sample_features_2d(torch.from_numpy(fmaps), torch.from_numpy(coords))
    ref = np.asarray(jax_bilinear.sample_features_2d(jnp.asarray(fmaps), jnp.asarray(coords)))
    assert out.shape == (2, 7, 5)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_weight_bridge_both_ways(params, tmp_path):
    model = from_jax_params(CoTracker2(model_resolution=RES), params)
    # flax tree -> port == JAX's reference-format export -> the port's loader
    jax_sd = export_torch_state_dict_v2(params)
    sd = {f"module.{k}": v for k, v in jax_sd.items()}
    sd["time_emb"] = np.zeros((1, 8, 456), np.float32)
    sd["pos_emb"] = np.zeros((1, 456, 12, 16), np.float32)
    loaded = load_reference_state_dict(CoTracker2(model_resolution=RES), {"model": sd})
    a, b = model.state_dict(), loaded.state_dict()
    assert a.keys() == b.keys() and "track_feat_updater.0.weight" in a
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    # the port's export == JAX's export
    ours = export_reference_state_dict(model)
    assert ours.keys() == jax_sd.keys() and "updateformer.virual_tracks" in ours
    for k, v in jax_sd.items():
        assert ours[k].dtype == torch.float32 and np.array_equal(ours[k].numpy(), v), k
    # JAX's import of the port's export gives the tree back
    back = import_torch_state_dict_v2(ours)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        got = np.asarray(functools.reduce(lambda n, k: n[k.key], path, back))
        assert np.array_equal(got, leaf), jax.tree_util.keystr(path)
    # a file the factory loads; an unmapped key still raises
    path = str(tmp_path / "cotracker2.pth")
    save_reference_checkpoint(path, model)
    built = build_cotracker(path, window_len=16, model_resolution=RES, device="cpu", v2=True)
    assert isinstance(built, CoTracker2) and built.window_len == 16
    for k, v in a.items():
        assert torch.equal(built.state_dict()[k], v), k
    model.register_buffer("calibration", torch.zeros(3))
    with pytest.raises(KeyError, match="calibration"):
        export_reference_state_dict(model)
    # the legacy entry points default to CUDA and raise without it
    if not torch.cuda.is_available():
        for entry in (lambda: build_cotracker(v2=True),
                      lambda: CoTrackerPredictor(window_len=8, v2=True),
                      lambda: CoTrackerOnlinePredictor(window_len=8, v2=True)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                entry()


@pytest.mark.parametrize("window_len", [8, 16], ids=["v2", "v2.1"])
def test_offline_matches_jax(params, jax_offline, window_len):
    ref = jax_offline(window_len)
    video, queries, mask = _inputs(FRAMES[window_len], seed=window_len)
    model = from_jax_params(CoTracker2(window_len=window_len, model_resolution=RES), params)
    with torch.no_grad():
        coords, vis, train = model(torch.from_numpy(video), torch.from_numpy(queries), iters=2,
                                   track_mask=torch.from_numpy(mask), is_train=True)
    T = FRAMES[window_len]
    assert coords.shape == (1, T, 9, 2) and vis.shape == (1, T, 9)
    assert torch.isfinite(coords).all() and torch.isfinite(vis).all()
    real = slice(0, N_REAL)
    np.testing.assert_allclose(coords[:, :, real].numpy(), ref[0][:, :, real], **COORDS_TOL)
    np.testing.assert_allclose(vis[:, :, real].numpy(), ref[1][:, :, real], rtol=1e-3, atol=1e-3)
    # per window and iteration (2, 2, 1, S, 9, 2), vis per window, query mask, starts
    assert train[0].shape == (2, 2, 1, window_len, 9, 2) == ref[2][0].shape
    np.testing.assert_allclose(train[0][..., real, :].numpy(), ref[2][0][..., real, :],
                               **COORDS_TOL)
    np.testing.assert_allclose(train[1][..., real].numpy(), ref[2][1][..., real],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(train[2].numpy(), ref[2][2])
    np.testing.assert_array_equal(train[3].numpy(), ref[2][3])
    assert train[3].tolist() == [0, window_len // 2]
    # the masked padding changes no real track
    with torch.no_grad():
        alone = model(torch.from_numpy(video), torch.from_numpy(queries[:, real]), iters=2)
    np.testing.assert_allclose(coords[:, :, real].numpy(), alone[0].numpy(), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(vis[:, :, real].numpy(), alone[1].numpy(), rtol=1e-4, atol=1e-4)


def _jax_predictor(params, window_len):
    """The JAX offline predictor with these parameters (its constructor
    would compile a random init first)."""
    jp = JaxPredictor.__new__(JaxPredictor)
    jp.v2, jp.dense_offsets_per_forward, jp._n_bucket = True, 3, 64
    jp.support_grid_size, jp._jit_cache = 6, {}
    jp.model = JaxCoTracker2(window_len=window_len, model_resolution=RES)
    jp.params, jp.interp_shape = params, RES
    return jp


def _same_visibility(ours, ref):
    assert ours.dtype == torch.bool and ours.shape == ref.shape
    assert np.mean(ours.numpy() != np.asarray(ref)) <= 0.01


STREAM_S, STREAM_CAP = 8, 32
STREAM_INDS = (0, 4, 8)  # chunks [0:8], [4:12], [8:16]


@pytest.fixture(scope="module")
def jax_stream(params):
    """The JAX online predictor (v2, window 8) over three chunks of a
    16-frame video at the model resolution (the resize is the identity), 4
    queries at frames 0, 5, 9 and 13 padded to 64 with a track mask: its
    outputs and its state's buffers after each chunk. One compile serves
    the model's and the predictor's streaming tests."""
    rng = np.random.default_rng(6)
    video = (rng.random((1, 16, 3, *RES)) * 255).astype(np.float32)
    queries = np.stack([np.array([[0, 5, 9, 13]]), rng.random((1, 4)) * (RES[1] - 1),
                        rng.random((1, 4)) * (RES[0] - 1)], axis=-1).astype(np.float32)
    jp = JaxOnlinePredictor.__new__(JaxOnlinePredictor)
    jp.v2, jp._n_bucket, jp.support_grid_size, jp.mesh = True, 64, 6, None
    jp.model = JaxCoTracker2(window_len=STREAM_S, model_resolution=RES)
    jp.params, jp.interp_shape = params, RES
    jp.step, jp.capacity, jp.return_full_buffers = STREAM_S // 2, STREAM_CAP, False
    jp._jit_step, jp._step_cache, jp._state, jp._queries = None, {}, None, None
    jp._n_user, jp._frames_seen, jp._ind_host, jp._orig_hw = 0, 0, 0, None
    assert jp(video[:, :1], is_first_step=True, queries=queries) == (None, None)
    chunks = []
    for ind in STREAM_INDS:
        tracks, vis = jp(video[:, ind : ind + STREAM_S])
        chunks.append(tuple(np.asarray(a) for a in (
            tracks, vis, jp._state.coords, jax.nn.sigmoid(jp._state.vis))))
    return video, queries, np.array(jp._queries), np.array(jp._track_mask), chunks


def test_online_chunks_match_jax(params, jax_stream):
    """Three online_step chunks of v2 against the JAX model's (inside the
    JAX streaming predictor, iters=6), and no state aliasing: a returned
    buffer is a copy no later step touches."""
    video, _, queries, mask, ref = jax_stream
    model = from_jax_params(CoTracker2(window_len=STREAM_S, model_resolution=RES), params)
    state = model.online_init(1, queries.shape[1], STREAM_CAP)
    clip = torch.from_numpy(video).permute(0, 1, 3, 4, 2)
    outs = []
    with torch.no_grad():
        for k, ind in enumerate(STREAM_INDS):
            state, coords, vis = model.online_step(
                state, clip[:, ind : ind + STREAM_S], torch.from_numpy(queries), iters=6,
                track_mask=torch.from_numpy(mask))
            assert state.ind == ind + STREAM_S // 2
            end = ind + STREAM_S
            np.testing.assert_allclose(coords[:, :end, :4].numpy(), ref[k][2][:, :end, :4],
                                       **COORDS_TOL)
            np.testing.assert_allclose(vis[:, :end, :4].numpy(), ref[k][3][:, :end, :4],
                                       rtol=1e-3, atol=2e-3)
            outs.append((coords, coords.clone(), vis))
    assert not torch.equal(outs[0][0][:, 4:8], outs[1][0][:, 4:8])  # later windows rewrote
    for returned, copy, _ in outs:
        assert torch.equal(returned, copy)
        assert returned.data_ptr() != state.coords.data_ptr()


def test_offline_predictor_matches_jax(params):
    """User queries with the 6x6 support grid (3 + 36 tracks, padded to 64
    with a track mask), iters=6, one window of 8 frames at 40x56: resize,
    v2 forward, 0.9 threshold, snap-back, rescale."""
    video = (np.random.default_rng(5).random((1, 8, 3, 40, 56)) * 255).astype(np.float32)
    queries = np.array([[[0, 5.0, 7.0], [3, 50.0, 30.0], [7, 20.5, 11.25]]], np.float32)
    tp = CoTrackerPredictor(window_len=8, model_resolution=RES, device="cpu", v2=True)
    assert isinstance(tp.model, CoTracker2) and tp.model.window_len == 8
    from_jax_params(tp.model, params)
    tracks, vis = tp(video, queries=queries)
    ref = _jax_predictor(params, 8)(video, queries=queries)
    assert tracks.shape == (1, 8, 3, 2)
    np.testing.assert_allclose(tracks.numpy(), np.asarray(ref[0]), rtol=1e-3,
                               atol=2e-2 * 56 / RES[1])
    _same_visibility(vis, ref[1])
    for n, (t, x, y) in enumerate(queries[0]):  # snap-back at the query frame
        np.testing.assert_allclose(tracks[0, int(t), n].numpy(), [x, y], rtol=1e-5)


def test_online_predictor_matches_jax(params, jax_stream):
    """The streaming predictor's v2 branch: registration, padding, no
    chunk_valid_len, visibility vis > 0.6 with no confidence, rescale."""
    video, queries, _, _, ref = jax_stream
    tp = CoTrackerOnlinePredictor(window_len=STREAM_S, capacity=STREAM_CAP,
                                  model_resolution=RES, device="cpu", v2=True)
    from_jax_params(tp.model, params)
    assert tp(video[:, :1], is_first_step=True, queries=queries) == (None, None)
    for k, ind in enumerate(STREAM_INDS):
        tracks, vis = tp(video[:, ind : ind + STREAM_S])
        assert tracks.shape == (1, ind + STREAM_S, 4, 2) and tp.frames_seen == ind + STREAM_S
        np.testing.assert_allclose(tracks.numpy(), ref[k][0], **COORDS_TOL)
        _same_visibility(vis, ref[k][1])
        probs = torch.sigmoid(tp._state.vis)[:, : ind + STREAM_S, :4]
        assert torch.equal(vis, probs > 0.6)


@pytest.mark.parametrize("mode", ["joint", "online"])
def test_evaluation_with_v2(params, tmp_path, mode):
    """The evaluation predictor's conf of ones (vis * conf is the model's
    vis), and run_eval(v2=True) on a synthetic TAP-Vid pickle on the CPU,
    offline (joint) and streaming, with the window given by --window_len."""
    if mode == "joint":
        model = from_jax_params(CoTracker2(window_len=8, model_resolution=(32, 48)), params)
        pred = EvaluationPredictor(model.eval(), interp_shape=(32, 48), grid_size=0,
                                   single_point=False, n_iters=2)
        rng = np.random.default_rng(7)
        video = (rng.random((1, 8, 3, 32, 48)) * 255).astype(np.float32)
        queries = np.array([[[0, 3.0, 4.0], [2, 40.0, 20.0]]], np.float32)
        traj, vis_conf = pred(video, queries)
        with torch.no_grad():
            q = torch.from_numpy(queries)
            coords, vis, _ = model(torch.from_numpy(video).permute(0, 1, 3, 4, 2), q, iters=2)
        # padded to 64 tracks there: the padding-invariance bounds
        np.testing.assert_allclose(vis_conf, vis.numpy(), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(traj, coords.numpy(), rtol=1e-4, atol=1e-3)
    cfg = parse_config(["--v2", "--window_len", "8", "--device", "cpu", "--model_res", "32x48",
                        "--n_iters", "2", "--grid_size", "2", "--online_capacity", "16",
                        "--exp_dir", str(tmp_path / "exp"),
                        "--dataset_root", _davis_pickle(tmp_path / "davis.pkl", T=8, H=40,
                                                        W=40, N=4)]
                       + (["--online"] if mode == "online" else []))
    assert cfg.v2 and cfg.window_len == 8 and cfg.offline_model == (mode == "joint")
    metrics = run_eval(cfg)
    assert set(metrics) == {"seq_a", "seq_b", "avg"}
    assert all(np.isfinite(v) for v in metrics["avg"].values())
    assert DefaultConfig().v2 is False
