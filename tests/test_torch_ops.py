"""The port's sampling, resize and embedding ops, its support sampling and
its masked means against the JAX package's, float32 on CPU (tolerance 1e-5:
the same float32 formulas, summed in another order; the masked means, eager
jnp against torch, 1e-6 absolute and relative: a few float32 ulps of sums
of order 10)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cotracker_tpu.models import cotracker3 as jax_model
from cotracker_tpu.ops import bilinear as jax_bilinear
from cotracker_tpu.ops import embeddings as jax_embeddings
from cotracker_tpu.ops import masked as jax_masked
from cotracker_tpu_torch.models import cotracker3
from cotracker_tpu_torch.ops import bilinear, embeddings, masked

RNG = np.random.default_rng(0)
FMAPS = RNG.standard_normal((2, 3, 9, 11, 8)).astype(np.float32)


def _close(out, ref):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_bilinear_sampling(align_corners, padding_mode):
    img = FMAPS[0, 0]
    xy = (RNG.random((5, 4, 2)) * [14, 12] - [2, 2]).astype(np.float32)
    _close(bilinear.bilinear_sample(torch.from_numpy(img), torch.from_numpy(xy),
                                    align_corners, padding_mode),
           jax_bilinear.bilinear_sample(img, xy, align_corners, padding_mode))
    txy = np.concatenate([RNG.random((2, 5, 4, 1)) * 4 - 1, np.stack([xy] * 2)], -1)
    txy = txy.astype(np.float32)
    _close(bilinear.sample_features_3d(torch.from_numpy(FMAPS), torch.from_numpy(txy),
                                       align_corners, padding_mode),
           jax_bilinear.sample_features_3d(FMAPS, txy, align_corners, padding_mode))


def test_resizes_and_embeddings():
    x = torch.from_numpy(FMAPS[0])
    for ac in (True, False):
        _close(bilinear.resize_bilinear(x, (5, 17), ac),
               jax_bilinear.resize_bilinear(jnp.asarray(FMAPS[0]), (5, 17), ac))
        _close(bilinear.resize_linear_1d(x, 7, ac, axis=1),
               jax_bilinear.resize_linear_1d(jnp.asarray(FMAPS[0]), 7, ac, axis=1))
    rel = RNG.standard_normal((2, 3, 5, 4)).astype(np.float32)
    _close(embeddings.posenc(torch.from_numpy(rel), 0, 10),
           jax_embeddings.posenc(jnp.asarray(rel), 0, 10))
    np.testing.assert_array_equal(embeddings.get_1d_sincos_pos_embed(16, np.arange(5.0)),
                                  np.asarray(jax_embeddings.get_1d_sincos_pos_embed(16, np.arange(5.0))))


@pytest.mark.parametrize("T", [1, 3])
def test_track_features(T):
    """get_track_feat: the window form (T >= 2) and the tap fallback (T == 1),
    queries near and beyond the border; and sample_patch_features."""
    fm = FMAPS[:, :T]
    frames = RNG.integers(0, T, (2, 6)).astype(np.float32)
    xy = (RNG.random((2, 6, 2)) * [14, 12] - [2, 2]).astype(np.float32)
    c_t, s_t = cotracker3.get_track_feat(torch.from_numpy(fm), torch.from_numpy(frames),
                                         torch.from_numpy(xy), 3)
    c_j, s_j = jax_model.get_track_feat(jnp.asarray(fm), jnp.asarray(frames), jnp.asarray(xy), 3)
    _close(c_t, c_j)
    _close(s_t, s_j)
    coords = (RNG.random((2, T, 4, 2)) * [10, 8]).astype(np.float32)
    _close(cotracker3.sample_patch_features(torch.from_numpy(fm), torch.from_numpy(coords), 2),
           jax_model.sample_patch_features(jnp.asarray(fm), jnp.asarray(coords), 2))


@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "no_mask"])
def test_masked_mean_and_var(with_mask):
    rng = np.random.default_rng(5)
    data = rng.standard_normal((3, 7, 5)).astype(np.float32)
    mask = (rng.random((3, 7, 1)) > 0.4).astype(np.float32)
    mask[1] = 0  # a row with nothing under the mask: the denominator clamps to 1
    m = mask if with_mask else None
    tm = None if m is None else torch.from_numpy(m)
    for dim in (1, (1, 2)):
        ours = masked.masked_mean(torch.from_numpy(data), tm, dim)
        _close_exact(ours, jax_masked.masked_mean(jnp.asarray(data), m, dim))
        mean_var = masked.masked_mean_var(torch.from_numpy(data), tm, dim)
        ref = jax_masked.masked_mean_var(jnp.asarray(data), m, dim)
        for a, b in zip(mean_var, ref):
            _close_exact(a, b)


def _close_exact(out, ref):
    assert tuple(out.shape) == np.shape(ref)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
