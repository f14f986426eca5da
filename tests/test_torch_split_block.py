"""The time block's three-kernel split (K8 -> K5 -> K9) and the two JAX
shape gates that choose each block's function, against the JAX package on
the CPU (Pallas in interpret mode):

  * the port's gate functions against `pick_block_n` / `_pick_time_tile`;
  * K8's and K9's plain versions (what the wrappers run on CPU tensors)
    against `fused_ln_qkv_int8` / `fused_attnout_res_mlp_int8`, in float32
    and bfloat16;
  * the fast configuration's EfficientUpdateFormer (bf16, W8A8 blocks and
    attention cores on; one time block and one space round) against the JAX
    one: N=256 tracks at T=130 frames (the point tokens split, the virtual
    tokens K1) and T=200 (both split), and N=128 (the track gate off: K5
    between plain projections in the time blocks, plain space blocks). A
    route probe counts the calls of every kernel wrapper, so each case pins
    which kernels the port runs, where the JAX gates put them.

Tolerances. Float32: as tests/test_torch_kernels.py, the int8 codes agree
except at float32 rounding ties of a code boundary, so 98% of the elements
agree to 1e-4 of the mean output and every one to 5% of it. bfloat16: the
two sides round to bf16 at the same places, so 99% of the elements agree to
one bf16 ulp of the mean output (2^-8 of it) and every one to 5%. The
updateformer in bf16: each block's output is rounded to bf16 on both sides,
and W8A8 ties spread through the virtual tokens to every track, so the
output deltas agree elementwise relative to |ref| + mean|ref|: 99% of them
to 3% (about four bf16 ulps) and every one to 8%. Measured: 99th
percentile 1.3-1.6%, worst 2.3-4.0% across the three cases.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import cotracker_tpu.ops.kernels.attention_pallas as attention_pallas
import cotracker_tpu.ops.kernels.mlp_int8_pallas as mlp_int8_pallas
from cotracker_tpu.models.cotracker3 import CoTrackerThree as JaxCoTrackerThree
from cotracker_tpu.models.updateformer import EfficientUpdateFormer as JaxUpdateFormer
from cotracker_tpu_torch.models.checkpoint import jax_params_to_state_dict
from cotracker_tpu_torch.models.updateformer import EfficientUpdateFormer
from cotracker_tpu_torch.ops.kernels import attention_cuda, gates, mlp_int8_cuda
from test_torch_kernels import assert_codes_close
from test_torch_model import random_params

torch.set_num_threads(2)

C, HID, HEADS, DH = 384, 1536, 8, 48


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call
    forced = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    monkeypatch.setattr(mlp_int8_pallas.pl, "pallas_call", forced)
    monkeypatch.setattr(attention_pallas.pl, "pallas_call", forced)


def test_gates_match_jax():
    for M in (8, 24, 64, 128, 192, 256, 264, 512, 2560, 10240):
        for T in (1, 8, 16, 24, 60, 80, 96, 120, 128, 129, 130, 160, 192, 193, 200, 250, 300):
            for cap in (gates.POINT_TOKENS, gates.FLAT_TOKENS):
                assert gates.pick_time_tile(M, T, cap) == mlp_int8_pallas._pick_time_tile(
                    M, T, cap), (M, T, cap)
    for N in range(0, 4200, 4):
        assert gates.pick_block_n(N) == attention_pallas.pick_block_n(N), N
        assert gates.space_tile_ok(N) == (attention_pallas.pick_block_n(N) is not None)
    # the routes the long-video path takes (see models/blocks.py)
    assert gates.pick_time_tile(256, 128, gates.POINT_TOKENS) == 8
    assert gates.pick_time_tile(256, 130, gates.POINT_TOKENS) is None
    assert gates.pick_time_tile(64, 192, gates.FLAT_TOKENS) == 8
    assert gates.pick_time_tile(64, 193, gates.FLAT_TOKENS) is None


@pytest.fixture(scope="module")
def block_weights():
    """JAX (in, out) kernels and biases, and the port's quantized pack."""
    rng = np.random.default_rng(0)
    lin = lambda i, o: (rng.standard_normal((i, o)).astype(np.float32) / np.sqrt(i),
                        0.05 * rng.standard_normal(o).astype(np.float32))
    w = dict(q=lin(C, C), kv=lin(C, 2 * C), o=lin(C, C), f1=lin(C, HID), f2=lin(HID, C))
    q = lambda k, b: mlp_int8_cuda.quantize_linear(torch.from_numpy(k.T.copy()),
                                                   torch.from_numpy(b))
    pack = mlp_int8_cuda.TimeBlockWeights(
        qkv=q(np.concatenate([w["q"][0], w["kv"][0]], 1), np.concatenate([w["q"][1], w["kv"][1]])),
        out=q(*w["o"]), fc1=q(*w["f1"]), fc2=q(*w["f2"]))
    return w, pack


DTYPES = [(torch.float32, jnp.float32, dict()),
          (torch.bfloat16, jnp.bfloat16, dict(tight=2.0**-8, frac=0.01))]


@pytest.mark.parametrize("dtype,jdtype,tol", DTYPES, ids=["f32", "bf16"])
def test_ln_qkv_matches_pallas(block_weights, dtype, jdtype, tol):
    w, pack = block_weights
    x = np.random.default_rng(1).standard_normal((6, 40, C)).astype(np.float32)
    ref = mlp_int8_pallas.fused_ln_qkv_int8(
        jnp.asarray(x).astype(jdtype), *w["q"], *w["kv"], interpret=True)
    q, kv = mlp_int8_cuda.fused_ln_qkv_int8(torch.from_numpy(x).to(dtype), pack.qkv)
    for o, r in zip((q, kv), ref):
        assert o.dtype == dtype and tuple(o.shape) == r.shape
        assert_codes_close(o.float().numpy(), np.asarray(r.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("dtype,jdtype,tol", DTYPES, ids=["f32", "bf16"])
def test_attnout_mlp_matches_pallas(block_weights, dtype, jdtype, tol):
    w, pack = block_weights
    rng = np.random.default_rng(2)
    a, x = (rng.standard_normal((6, 40, C)).astype(np.float32) for _ in range(2))
    ref = mlp_int8_pallas.fused_attnout_res_mlp_int8(
        jnp.asarray(a).astype(jdtype), jnp.asarray(x).astype(jdtype),
        *w["o"], *w["f1"], *w["f2"], interpret=True)
    out = mlp_int8_cuda.fused_attnout_res_mlp_int8(
        torch.from_numpy(a).to(dtype), torch.from_numpy(x).to(dtype), pack)
    assert out.dtype == dtype and tuple(out.shape) == ref.shape
    assert_codes_close(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), **tol)


WRAPPERS = {
    "K1": (mlp_int8_cuda, "fused_time_block_int8"),
    "K8": (mlp_int8_cuda, "fused_ln_qkv_int8"),
    "K9": (mlp_int8_cuda, "fused_attnout_res_mlp_int8"),
    "K5": (attention_cuda, "fused_time_attention"),
    "K2": (mlp_int8_cuda, "fused_space_block_int8"),
    "K3": (attention_cuda, "fused_virtual_from_points_proj"),
    "K6": (attention_cuda, "fused_points_from_virtual"),
    "K7": (attention_cuda, "fused_virtual_from_points"),
}


@pytest.fixture(scope="module")
def uf_params():
    """Random parameters of one time block and one space round."""
    uf = random_params(JaxCoTrackerThree(), seed=5)["iter_core"]["updateformer"]
    return {k: v for k, v in uf.items() if not k[-1].isdigit() or k.endswith("_0")}


# (N, T, the port's calls per wrapper): one time block on the points and
# the virtual tokens, one space round
ROUTES = [
    (256, 130, dict(K1=1, K8=1, K5=1, K9=1, K2=1, K3=1)),
    (256, 200, dict(K8=2, K5=2, K9=2, K2=1, K3=1)),
    (128, 24, dict(K5=2)),
]


@pytest.mark.parametrize("N,T,calls", ROUTES, ids=["N256-T130", "N256-T200", "N128-T24"])
def test_updateformer_routes_match_jax(interpret, monkeypatch, uf_params, N, T, calls):
    seen = {}
    for name, (mod, fn) in WRAPPERS.items():
        orig = getattr(mod, fn)

        def spy(*a, _orig=orig, _name=name, **k):
            seen[_name] = seen.get(_name, 0) + 1
            return _orig(*a, **k)

        monkeypatch.setattr(mod, fn, spy)

    rng = np.random.default_rng(N + T)
    tokens = rng.standard_normal((1, N, T, C)).astype(np.float32)
    mask = np.ones((1, N), bool)
    mask[:, N - 7:] = False
    jm = JaxUpdateFormer(time_depth=1, space_depth=1, dtype=jnp.bfloat16,
                         use_pallas_attn=True, quant_int8=True)
    ref = jax.jit(lambda p, a, m: jm.apply({"params": p}, a, track_mask=m, x_is_tokens=True))(
        uf_params, jnp.asarray(tokens).astype(jnp.bfloat16), jnp.asarray(mask))
    model = EfficientUpdateFormer(time_depth=1, space_depth=1, dtype=torch.bfloat16,
                                  attn_kernels=True, quant_int8=True)
    sd = jax_params_to_state_dict({"iter_core": {"updateformer": uf_params}})
    model.load_state_dict({k.removeprefix("updateformer."): torch.from_numpy(v)
                           for k, v in sd.items()})
    with torch.no_grad():
        out = model(torch.from_numpy(tokens).to(torch.bfloat16),
                    track_mask=torch.from_numpy(mask), x_is_tokens=True)
    assert seen == calls
    ref = np.asarray(ref.astype(jnp.float32))
    rel = np.abs(out.float().numpy() - ref) / (np.abs(ref) + np.abs(ref).mean())
    assert np.quantile(rel, 0.99) <= 0.03 and rel.max() <= 0.08, (np.quantile(rel, 0.99),
                                                                  rel.max())
