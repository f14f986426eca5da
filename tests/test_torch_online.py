"""The port's streaming model (online_init / online_step) against the JAX
package's, float32, on the same random JAX parameters carried across by the
weight bridge: four overlapping 8-frame windows at step 4 with iters=2,
queries that start in the first, second and third window, a masked padding
track, and a short third chunk (6 real frames, padded by repeating the last)
after which the fmaps overlap cache must not be used. Both sides take the
same branches: the JAX package decides them on the device (`lax.cond`), the
port on host integers.

Tolerances are those of tests/test_models.py:146-157 (the JAX model against
the reference implementation): coords rtol 1e-3 / atol 2e-2 pixels, vis and
conf 1e-3.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from cotracker_tpu.models.cotracker3 import CoTrackerThree as JaxCoTrackerThree
from cotracker_tpu_torch.models.checkpoint import from_jax_params
from cotracker_tpu_torch.models.cotracker3 import CoTrackerThree
from test_torch_model import random_params

torch.set_num_threads(2)

S, RES, CAP = 8, (32, 48), 24
CHUNKS = [(0, 8), (4, 12), (8, 14), (12, 20)]  # (first frame, end): the third is short


def test_online_step_matches_jax():
    rng = np.random.default_rng(8)
    B, T, N = 1, 20, 7
    video = (rng.random((B, T, *RES, 3)) * 255).astype(np.float32)
    queries = np.stack(
        [np.array([[0, 0, 2, 5, 9, 13, 0]], np.float32), rng.random((B, N)) * (RES[1] - 1),
         rng.random((B, N)) * (RES[0] - 1)], axis=-1).astype(np.float32)
    mask = np.array([[True] * 6 + [False]])
    params = random_params(JaxCoTrackerThree(), seed=5)

    jm = JaxCoTrackerThree(window_len=S, model_resolution=RES)
    jstate = jm.apply({"params": params}, B, N, CAP, method=JaxCoTrackerThree.online_init)
    jstep = jax.jit(lambda p, st, ch, q, m, valid: jm.apply(
        {"params": p}, st, ch, q, iters=2, track_mask=m, chunk_valid_len=valid,
        method=JaxCoTrackerThree.online_step))
    model = from_jax_params(CoTrackerThree(window_len=S, model_resolution=RES), params)
    state = model.online_init(B, N, CAP)
    encoded = []
    fmaps = model.compute_fmaps
    model.compute_fmaps = lambda v, **k: (encoded.append(v.shape[1]), fmaps(v, **k))[1]

    for w, (lo, hi) in enumerate(CHUNKS):
        chunk = video[:, lo:hi]
        valid = chunk.shape[1]
        chunk = np.concatenate([chunk, np.repeat(chunk[:, -1:], S - valid, axis=1)], axis=1)
        jstate, *ref = jstep(params, jstate, jnp.asarray(chunk), jnp.asarray(queries),
                             jnp.asarray(mask), jnp.asarray(valid, jnp.int32))
        with torch.no_grad():
            state, *out = model.online_step(
                state, torch.from_numpy(chunk), torch.from_numpy(queries), iters=2,
                track_mask=torch.from_numpy(mask), chunk_valid_len=valid)
        end = lo + S  # the buffers are valid on [0, ind + S)
        assert state.ind == int(jstate.ind) and state.tail_valid == int(jstate.tail_valid)
        np.testing.assert_allclose(out[0][:, :end, :6].numpy(), np.asarray(ref[0])[:, :end, :6],
                                   rtol=1e-3, atol=2e-2, err_msg=f"coords, window {w}")
        for o, r, name in zip(out[1:], ref[1:], ("vis", "conf")):
            np.testing.assert_allclose(o[:, :end, :6].numpy(), np.asarray(r)[:, :end, :6],
                                       rtol=1e-3, atol=1e-3, err_msg=f"{name}, window {w}")
    # frames encoded per window: all 8 at first, the 4 new ones while the
    # cached tail is valid, all 8 again after the padded chunk
    assert encoded == [8, 4, 4, 8]
    # each query's support was added exactly once, and nowhere else
    for lvl, (s, js) in enumerate(zip(state.track_support, jstate.track_support)):
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4, atol=1e-5,
                                   err_msg=f"support level {lvl}")
