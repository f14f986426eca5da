"""The port's streaming path against its own non-streaming forms, float32 on
CPU: online_step chained over a video equals forward_windows on the whole
video (the fmaps overlap cache, the host-side branches and the skipped
support mask change nothing), returned tensors are not rewritten by later
steps, and the chunked get_track_feat equals the unchunked one.

Tolerance for streaming vs forward_windows: the two encode frames in
batches of different sizes, so float32 convolution noise only: rtol 1e-4,
atol 1e-3 pixels on coords, 1e-4 on vis and conf.
"""

import numpy as np
import pytest
import torch

from cotracker_tpu_torch.models import cotracker3
from cotracker_tpu_torch.models.cotracker3 import CoTrackerThree, get_track_feat
from test_torch_model import random_inputs

torch.set_num_threads(2)

S, RES = 8, (32, 32)


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return CoTrackerThree(window_len=S, model_resolution=RES).eval()


def _stream(model, video, queries, capacity, iters=2, track_mask=None):
    """Drive online_step as the predictor does: S-frame chunks every S/2
    frames, a short last chunk padded by repeating its last frame. Returns
    the per-step outputs."""
    T = video.shape[1]
    state = model.online_init(video.shape[0], queries.shape[1], capacity)
    outs = []
    with torch.no_grad():
        for ind in range(0, T - S // 2, S // 2):
            chunk = video[:, ind : ind + S]
            valid = chunk.shape[1]
            if valid < S:
                chunk = torch.cat([chunk, chunk[:, -1:].expand(-1, S - valid, -1, -1, -1)], 1)
            state, *out = model.online_step(state, chunk, queries, iters=iters,
                                            track_mask=track_mask, chunk_valid_len=valid)
            outs.append(out)
    return state, outs


@pytest.mark.parametrize("T", [16, 18])
def test_streaming_equals_forward_windows(model, T):
    """T=18 ends in a 6-frame chunk padded to the window; padded tracks are
    masked in both. Every query lies in the first window: forward_windows
    also excludes tracks not queried yet as attention keys, which the
    streaming path (like the JAX package's) does not, so the two agree only
    once every track is active. Later queries are held against JAX in
    test_torch_online."""
    video, queries = random_inputs(np.random.default_rng(T), 1, T, *RES, 7)
    queries[0, :, 0] = [0, 0, 1, 3, 5, 7, 0]
    video, queries = torch.from_numpy(video), torch.from_numpy(queries)
    mask = torch.tensor([[True] * 6 + [False]])
    with torch.no_grad():
        ref = model.forward_windows(video, queries, iters=2, track_mask=mask)
    state, outs = _stream(model, video, queries, capacity=24, track_mask=mask)
    assert ref[3] is None and ref[0].shape == (1, T, 7, 2)
    assert state.ind == 4 * len(outs) and state.tail_valid == (4 if T == 16 else 2)
    coords, vis, conf = (o[:, :T, :6] for o in outs[-1])
    np.testing.assert_allclose(coords.numpy(), ref[0][:, :, :6].numpy(), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(vis.numpy(), ref[1][:, :, :6].numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(conf.numpy(), ref[2][:, :, :6].numpy(), rtol=1e-4, atol=1e-4)


def test_forward_windows_training_outputs_not_ported(model):
    """is_train returns the training outputs (this test pinned their absence
    before they were ported, and keeps its name): per window the iteration
    stacks of coords (pixels), vis and conf (probabilities), all S frames
    of a window past the end kept; the last window's last iteration is what
    the forward returns on its frames; the "query started" valid mask.
    T=10 with windows of 8 at step 4: two windows, the second past T."""
    video, queries = random_inputs(np.random.default_rng(0), 1, 10, *RES, 3)
    queries[0, :, 0] = [0, 3, 6]
    with torch.no_grad():
        coords, vis, conf, (cw, vw, fw, valid) = model.forward_windows(
            torch.from_numpy(video), torch.from_numpy(queries), iters=2, is_train=True)
    assert len(cw) == len(vw) == len(fw) == 2
    assert cw[1].shape == (2, 1, S, 3, 2) and vw[1].shape == fw[1].shape == (2, 1, S, 3)
    torch.testing.assert_close(coords[:, 4:], cw[1][-1][:, :6], rtol=0, atol=0)
    # the sigmoid of a stack and of one slice may round apart by an ulp
    torch.testing.assert_close(vis[:, 4:], vw[1][-1][:, :6], rtol=1e-6, atol=0)
    torch.testing.assert_close(conf[:, :4], fw[0][-1][:, :4], rtol=1e-6, atol=0)
    expected = (queries[0, :, 0][None, None, :] <= np.arange(10)[None, :, None])
    np.testing.assert_array_equal(valid.numpy(), expected.astype(np.float32))


def test_returned_tensors_are_not_rewritten(model):
    """The state buffers are updated in place; what a step returned must keep
    its values when later steps overwrite the overlap, and must not share
    memory with the state."""
    video, queries = random_inputs(np.random.default_rng(1), 1, 16, *RES, 4)
    queries[0, :, 0] = [0, 1, 5, 9]
    state = model.online_init(1, 4, 16)
    kept, copies = [], []
    with torch.no_grad():
        for ind in (0, 4, 8):
            state, *out = model.online_step(
                state, torch.from_numpy(video[:, ind : ind + S]), torch.from_numpy(queries),
                iters=1)
            kept.append(out)
            copies.append([o.clone() for o in out])
    for out, copy in zip(kept, copies):
        for o, c, buf in zip(out, copy, (state.coords, state.vis, state.conf)):
            assert torch.equal(o, c)
            assert o.untyped_storage().data_ptr() != buf.untyped_storage().data_ptr()
    # the overlap really was rewritten by the next window
    assert not torch.equal(kept[0][0][:, 4:8], kept[1][0][:, 4:8])


def test_online_step_checks_its_inputs(model):
    video, queries = random_inputs(np.random.default_rng(2), 1, 12, *RES, 2)
    video, queries = torch.from_numpy(video), torch.from_numpy(queries)
    with pytest.raises(ValueError, match="window_len"):
        model.online_step(model.online_init(1, 2, 16), video[:, :6], queries)
    state = model.online_init(1, 2, 8)
    with torch.no_grad():
        state, *_ = model.online_step(state, video[:, :8], queries, iters=1)
        with pytest.raises(ValueError, match="overflow"):
            model.online_step(state, video[:, 4:12], queries, iters=1)


def test_get_track_feat_chunked_equals_unchunked(monkeypatch):
    """Above 2x the chunk size the window gather runs in chunks of N; with
    the chunk size lowered to 5, N=13 runs as 5+5+3 and must give the same
    values, out-of-window query frames (clamped) included."""
    rng = np.random.default_rng(3)
    fmaps = torch.from_numpy(rng.standard_normal((2, 4, 12, 16, 8)).astype(np.float32))
    frames = torch.from_numpy(rng.integers(-3, 8, (2, 13)).astype(np.float32))
    coords = torch.from_numpy((rng.random((2, 13, 2)) * [20, 16] - 2).astype(np.float32))
    whole = get_track_feat(fmaps, frames, coords, 3)
    monkeypatch.setattr(cotracker3, "_TRACK_FEAT_CHUNK", 5)
    chunked = get_track_feat(fmaps, frames, coords, 3)
    assert chunked[0].shape == (2, 1, 13, 8) and chunked[1].shape == (2, 49, 13, 8)
    assert torch.equal(chunked[0], whole[0]) and torch.equal(chunked[1], whole[1])
