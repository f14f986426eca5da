"""The port's CoTrackerPredictor against the JAX package's, float32, on the
same random JAX parameters, at a small model resolution: grid queries with
backward tracking (query frame 2 of 6), user queries with the 6x6 support
grid, a segmentation-mask grid, and dense mode with one and three pixel
offsets a forward. Covers the resize, bucket padding with a track mask, the
backward merge, the 0.9 visibility threshold, query snap-back, rescale,
the mask's nearest resize and the dense offsets' tiling.

The JAX predictor compiles its forward per (frames, padded tracks,
backward, H, W) and per user-track count (a static argument): the
segmentation test keeps the user-query test's 3 tracks and compiles
nothing new; the dense tests compile at 20 and 60 tracks.

Tolerances: tracks as the model test (rtol 1e-3, atol 2e-2 model pixels,
times the input/model size ratio); visibility is a threshold of float32
probabilities, so at most 1% of the entries may flip.
"""

import numpy as np
import pytest
import torch

from cotracker_tpu.models.cotracker3 import CoTrackerThree as JaxCoTrackerThree
from cotracker_tpu.predictor import CoTrackerPredictor as JaxPredictor
from cotracker_tpu_torch.models.checkpoint import from_jax_params
from cotracker_tpu_torch.predictor import CoTrackerPredictor
from test_torch_model import random_params

torch.set_num_threads(2)

RES = (32, 48)


@pytest.fixture(scope="module")
def predictors():
    params = random_params(JaxCoTrackerThree(), seed=2)
    # with random weights six iterations are chaotic (float32 rounding
    # differences grow ~10x per iteration as tracks fly off the frame); a
    # damped flow head keeps the updates at the scale of a trained model
    params["iter_core"]["updateformer"]["flow_head"]["kernel"] *= 0.05
    # the JAX predictor's constructor would compile a random init first; the
    # parameters come from random_params instead
    jp = JaxPredictor.__new__(JaxPredictor)
    jp.v2, jp.dense_offsets_per_forward, jp._n_bucket = False, 3, 64
    jp.support_grid_size, jp._jit_cache = 6, {}
    jp.model = JaxCoTrackerThree(model_resolution=RES)
    jp.params, jp.interp_shape = params, jp.model.model_resolution
    tp = CoTrackerPredictor(model_resolution=RES, device="cpu")
    from_jax_params(tp.model, params)
    video = (np.random.default_rng(3).random((1, 6, 3, 40, 56)) * 255).astype(np.float32)
    return jp, tp, video


def _compare(ref, out):
    scale = 56 / RES[1]
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=1e-3, atol=2e-2 * scale)
    assert np.mean(out[1].numpy() != np.asarray(ref[1])) <= 0.01


def test_grid_backward_matches_jax(predictors):
    jp, tp, video = predictors
    kw = dict(grid_size=4, grid_query_frame=2, backward_tracking=True)
    out = tp(video, **kw)
    _compare(jp(video, **kw), out)
    assert out[0].shape == (1, 6, 16, 2) and out[1].dtype == torch.bool
    assert bool(out[1][:, 2].all())  # visible at the query frame (snap-back)


def test_user_queries_match_jax(predictors):
    jp, tp, video = predictors
    queries = np.array([[[0, 5.0, 7.0], [3, 50.0, 30.0], [5, 20.5, 11.25]]], np.float32)
    out = tp(video, queries=queries)
    _compare(jp(video, queries=queries), out)
    for n, (t, x, y) in enumerate(queries[0]):
        np.testing.assert_allclose(out[0][0, int(t), n].numpy(), [x, y], rtol=1e-5)


def test_segm_mask_grid_matches_jax(predictors):
    jp, tp, video = predictors
    # a band across the frame keeps the middle row of the 3x3 grid (3 of 9
    # points, then the 36 support points): at the model's 32x48 the grid's
    # rows are y = 0.75, 16, 31.25, which the nearest resize reads at input
    # rows 1, 20 and 38
    mask = np.zeros((1, 1, 40, 56), np.float32)
    mask[..., 15:26, :] = 1
    kw = dict(grid_size=3, segm_mask=mask)
    out = tp(video, **kw)
    _compare(jp(video, **kw), out)
    assert out[0].shape == (1, 6, 3, 2)
    kept = [[0.75, 16.0], [24.0, 16.0], [47.25, 16.0]]  # model pixels, rescaled to 56x40
    np.testing.assert_allclose(out[0][0, 0].numpy(), np.array(kept) * [55 / 47, 39 / 31],
                               rtol=1e-6)


@pytest.mark.parametrize("per_forward", [1, 3])
def test_dense_matches_jax(predictors, per_forward):
    """grid_size=5 on an 8x10 video: a grid step of 2, 20 points an offset
    and 4 offsets; one a forward, or three and then the last one alone. Two
    frames keep the two JAX compiles and the six forwards of each side short."""
    jp, tp, _ = predictors
    video = (np.random.default_rng(4).random((1, 2, 3, 8, 10)) * 255).astype(np.float32)
    jp.dense_offsets_per_forward = tp.dense_offsets_per_forward = per_forward
    try:
        kw = dict(grid_query_frame=0, grid_size=5, backward_tracking=False)
        ref = jp._compute_dense_tracks(video, **kw)
        out = tp._compute_dense_tracks(video, **kw)
    finally:
        jp.dense_offsets_per_forward = tp.dense_offsets_per_forward = 3
    scale = 10 / RES[1]
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=1e-3, atol=2e-2 * scale)
    assert np.mean(out[1].numpy() != np.asarray(ref[1])) <= 0.01
    assert out[0].shape == (1, 2, 80, 2)
    # the offsets tile the 10x8 frame: every pixel is queried once, at frame 0
    xy = np.rint(out[0][0, 0].numpy()).astype(int)
    assert sorted(map(tuple, xy)) == [(x, y) for x in range(10) for y in range(8)]
