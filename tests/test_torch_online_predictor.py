"""Protocol of the port's CoTrackerOnlinePredictor on CPU, float32, mirroring
the JAX package's tests (tests/test_predictor.py: streaming protocol, full
buffers, capacity guard, fmaps-tail cache): first-step registration, growing
outputs and frames_seen, return_full_buffers, a second stream through the
same object, the overflow ValueError, and the fmaps overlap cache being
exact on full chunks and bypassed after a padded mid-stream chunk.

The protocol does not depend on the number of update iterations, so these
tests run the model's online_step at iters=1 (the predictor asks for 6).
Exactness bounds: two runs of the same arithmetic agree to float32
convolution noise (the cache encodes 4 frames where the oracle encodes 8):
rtol 1e-5, atol 1e-4 pixels, visibility identical.
"""

import numpy as np
import pytest
import torch

from cotracker_tpu_torch import CoTrackerOnlinePredictor

torch.set_num_threads(2)

S, RES = 8, (32, 48)
VIDEO = (np.random.default_rng(77).random((1, 24, 3, 36, 52)) * 255).astype(np.float32)


def make(**kw):
    p = CoTrackerOnlinePredictor(window_len=S, model_resolution=RES, device="cpu",
                                 **{"capacity": 64, **kw})
    step = p.model.online_step
    p.model.online_step = lambda *a, **k: step(*a, **{**k, "iters": 1})
    return p


def drive(p, chunks, video=VIDEO, disable_cache=False, **first):
    assert p(video[:, :1], is_first_step=True, **first) == (None, None)
    outs = []
    for lo, hi in chunks:
        outs.append(p(video[:, lo:hi]))
        if disable_cache:  # oracle: every window re-encodes all its frames
            p._state = p._state._replace(tail_valid=0)
    return outs


FULL = [(0, 8), (4, 12), (8, 16), (12, 20)]


def test_grid_protocol_full_buffers_and_second_stream():
    p = make()
    outs = drive(p, FULL, grid_size=3)
    for (tracks, vis), (_, hi) in zip(outs, FULL):
        assert tracks.shape == (1, hi, 9, 2) and vis.shape == (1, hi, 9)
        assert vis.dtype == torch.bool and torch.isfinite(tracks).all()
    assert p.frames_seen == 20 and p.step == 4
    # what an earlier call returned is not rewritten by later windows
    assert not torch.equal(outs[0][0][:, 4:8], outs[1][0][:, 4:8])

    # a second stream through the same object starts from a fresh state
    again = drive(p, FULL, grid_size=3)
    assert torch.equal(again[-1][0], outs[-1][0]) and torch.equal(again[-1][1], outs[-1][1])

    # fixed-shape buffers, valid on [0, frames_seen), from a torch tensor video
    pf = make(return_full_buffers=True)
    tracks, vis = drive(pf, FULL, video=torch.from_numpy(VIDEO), grid_size=3)[-1]
    assert tracks.shape == (1, 64, 9, 2) and pf.frames_seen == 20
    np.testing.assert_allclose(tracks[:, :20].numpy(), outs[-1][0].numpy(), rtol=1e-5, atol=1e-4)
    assert torch.equal(vis[:, :20], outs[-1][1])


def test_queries_are_rescaled_padded_and_masked():
    """Explicit queries at the input resolution with the 6x6 support grid:
    4 + 36 tracks padded to the 64 bucket with a track mask; only the user's
    tracks come back; a later query frame is registered as given."""
    p = make()
    queries = np.array([[[0, 5.0, 7.0], [0, 50.0, 30.0], [6, 20.5, 11.25], [13, 3.0, 33.0]]],
                       np.float32)
    tracks, vis = drive(p, FULL[:3], queries=queries, add_support_grid=True)[-1]
    assert tracks.shape == (1, 16, 4, 2) and vis.shape == (1, 16, 4)
    assert p._queries.shape == (1, 64, 3) and p._track_mask.sum().item() == 40
    sx, sy = (RES[1] - 1) / 51, (RES[0] - 1) / 35
    np.testing.assert_allclose(p._queries[0, :4].numpy(), queries[0] * [1, sx, sy], rtol=1e-6)
    assert p._queries[0, 4:40, 0].abs().max().item() == 0  # support grid at frame 0
    assert p._state.query_frames.tolist()[0][:4] == [0, 0, 6, 13]


def test_overflow_and_misuse_raise():
    p = make(capacity=12)
    with pytest.raises(RuntimeError, match="is_first_step"):
        p(VIDEO[:, :8])
    drive(p, [(0, 8), (4, 12)], grid_size=2)  # window [4, 12) == capacity: fits
    with pytest.raises(ValueError, match="overflow"):
        p(VIDEO[:, 8:16])
    with pytest.raises(ValueError, match="at most"):
        p(VIDEO[:, 0:9])
    with pytest.raises(ValueError, match="queries or a grid_size"):
        p(VIDEO[:, :1], is_first_step=True, grid_size=0)


@pytest.mark.parametrize("chunks", [FULL, [(0, 8), (4, 12), (8, 14), (12, 20)]],
                         ids=["full_chunks", "padded_midstream_chunk"])
def test_fmaps_tail_cache_is_exact(chunks):
    """Reusing the previous window's encoded tail never changes the results;
    after a short chunk (6 of 8 frames, padded inside) the cached tail holds
    repeated-frame features and the next window must re-encode everything."""
    p = make()
    encoded = []
    fmaps = p.model.compute_fmaps
    p.model.compute_fmaps = lambda v, **k: (encoded.append(v.shape[1]), fmaps(v, **k))[1]
    t1, v1 = drive(p, chunks, grid_size=3)[-1]
    assert encoded == ([8, 4, 4, 4] if chunks is FULL else [8, 4, 4, 8])
    t0, v0 = drive(make(), chunks, grid_size=3, disable_cache=True)[-1]
    assert p.frames_seen == 20 and t1.shape[1] == 20
    np.testing.assert_allclose(t1.numpy(), t0.numpy(), rtol=1e-5, atol=1e-4)
    assert torch.equal(v1, v0)
