"""The port's CoTrackerThree against the JAX package's, float32, on the same
randomly initialised JAX parameters carried across by the weight bridge
(`from_jax_params`), and the bridge itself against the reference `.pth`
layout produced by the JAX package's `export_torch_state_dict`.

Tolerances are those of tests/test_models.py:155-157 (the JAX model against
the reference implementation): coords rtol 1e-3 / atol 2e-2 pixels, vis and
conf 1e-3.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cotracker_tpu.models.checkpoint import export_torch_state_dict
from cotracker_tpu.models.cotracker3 import CoTrackerThree as JaxCoTrackerThree
from cotracker_tpu_torch import resolve_device
from cotracker_tpu_torch.models.checkpoint import from_jax_params, load_reference_state_dict
from cotracker_tpu_torch.models.cotracker3 import CoTrackerThree

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _param_shapes(jax_model):
    """The JAX model's parameter tree as shapes, from eval_shape (no
    compile); cached per model configuration, as tracing the init is the
    costly part of random_params."""
    return jax.eval_shape(
        lambda r: jax_model.init(r, jnp.zeros((1, 2, 32, 32, 3)), jnp.zeros((1, 1, 3)), iters=1),
        jax.random.PRNGKey(0),
    )["params"]


def random_params(jax_model, seed=0):
    """Random float32 parameters in the JAX model's tree, drawn with numpy:
    kernels N(0, 1/fan_in), LayerNorm scales 1 + N(0, 0.01), virtual tracks
    N(0, 1), biases N(0, 0.0025). Shapes come from eval_shape (no compile)."""
    shapes = _param_shapes(jax_model)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        if name.endswith("kernel"):
            w = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            w = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif name == "virtual_tracks":
            w = rng.standard_normal(s.shape)
        else:
            w = 0.05 * rng.standard_normal(s.shape)
        return w.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def random_inputs(rng, B, T, H, W, N):
    video = (rng.random((B, T, H, W, 3)) * 255).astype(np.float32)
    queries = np.stack(
        [rng.integers(0, T, (B, N)).astype(np.float32),
         rng.random((B, N)) * (W - 1), rng.random((B, N)) * (H - 1)],
        axis=-1,
    ).astype(np.float32)
    return video, queries


@pytest.fixture(scope="module")
def params():
    return random_params(JaxCoTrackerThree())


@pytest.mark.parametrize("fold", [False, True])
def test_offline_forward_matches_jax(params, fold):
    """iters=2 at T=8 (time embedding interpolated from the 60-frame window),
    the reference input build (fold=False) and the folded projection."""
    video, queries = random_inputs(np.random.default_rng(6), 1, 8, 64, 96, 5)
    jm = JaxCoTrackerThree(fold_input_proj=fold)
    ref = jax.jit(lambda p, v, q: jm.apply({"params": p}, v, q, iters=2)[:3])(
        params, jnp.asarray(video), jnp.asarray(queries)
    )
    model = from_jax_params(CoTrackerThree(fold_input_proj=fold), params)
    with torch.no_grad():
        out = model(torch.from_numpy(video), torch.from_numpy(queries), iters=2)[:3]
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=1e-3, atol=2e-2)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(out[2].numpy(), np.asarray(ref[2]), rtol=1e-3, atol=1e-3)


def test_padding_invariance():
    """Masked padding tracks never change real-track results (the
    predictor's bucket padding relies on it)."""
    torch.manual_seed(0)
    model = CoTrackerThree(window_len=8, model_resolution=(32, 32)).eval()
    video, queries = random_inputs(np.random.default_rng(7), 1, 4, 32, 32, 3)
    qpad = np.concatenate([queries, np.full((1, 5, 3), 7.0, np.float32)], axis=1)
    mask = torch.tensor([[True] * 3 + [False] * 5])
    with torch.no_grad():
        base = model(torch.from_numpy(video), torch.from_numpy(queries), iters=2)
        padded = model(torch.from_numpy(video), torch.from_numpy(qpad), iters=2, track_mask=mask)
    np.testing.assert_allclose(padded[0][:, :, :3].numpy(), base[0].numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(padded[1][:, :, :3].numpy(), base[1].numpy(), rtol=1e-4, atol=1e-5)


def test_weight_bridge_matches_reference_layout(params):
    """load_reference_state_dict(export_torch_state_dict(params)) fills the
    same module as from_jax_params(params); the reference's buffers and
    `virual_tracks` spelling are handled."""
    a = from_jax_params(CoTrackerThree(), params)
    sd = {f"module.{k}": v for k, v in export_torch_state_dict(params).items()}
    assert "updateformer.virual_tracks" in export_torch_state_dict(params)
    sd["time_emb"] = np.zeros((1, 60, 1110), np.float32)
    b = load_reference_state_dict(CoTrackerThree(), {"model": sd})
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    np.testing.assert_array_equal(
        a.fnet.conv1.weight.detach().numpy(),
        np.transpose(np.asarray(params["fnet"]["conv1"]["kernel"]), (3, 2, 0, 1)),
    )


def test_cuda_device_is_explicit():
    """Entry points default to CUDA and raise without it; the CPU is only
    used when asked for."""
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
