"""Port kernels K5-K7 (the attention cores): each plain PyTorch version (what
the wrappers run on CPU tensors) against the JAX package's Pallas wrapper in
interpret mode on the same seeded numpy inputs.

Tolerances: float32 outputs are O(1) and differ only by summation order and
the two frameworks' exp, so 1e-5 absolute. In bfloat16 both sides round the
probabilities and the output to bf16 (8 bits of mantissa) at the same places,
but a last-ulp difference before a rounding flips it, so two bf16 ulps of an
O(1) output: 2^-6 absolute.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cotracker_tpu.ops.kernels import attention_pallas
from cotracker_tpu_torch.ops.kernels import attention_cuda

torch.set_num_threads(2)
# torch.exp on float32 CPU tensors calls MKL's VML exp. When a process's
# first such call comes from two threads at once, one thread's chunk can
# come out of a coarse exp (1.5e-4 relative: 8 of 330 fresh processes on
# one 8-core CPU, 30 at a time), which puts a few elements of the float32
# flash cases past their 1e-5 bound. One call on one thread first, here at
# import, before any test of the process, leaves every later call the
# accurate one (0 of 360 processes).
torch.set_num_threads(1)
torch.exp(torch.zeros(64))
torch.set_num_threads(2)

C, HEADS, DH, V = 384, 8, 48, 64
NEG_BIG = -0.7 * np.finfo(np.float32).max
TOL = {"float32": 1e-5, "bfloat16": 2.0**-6}


def _pair(a, dtype):
    """The same numpy array as a JAX and a torch array of `dtype`."""
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _check(out, ref, dtype):
    assert out.dtype == getattr(torch, dtype) and ref.dtype == getattr(jnp, dtype)
    ref = np.asarray(ref.astype(jnp.float32))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_attention_matches_pallas(dtype):
    rng = np.random.default_rng(0)
    M, T = 16, 8
    jq, tq = _pair(rng.standard_normal((M, T, C)).astype(np.float32), dtype)
    jkv, tkv = _pair(rng.standard_normal((M, T, 2 * C)).astype(np.float32), dtype)
    ref = attention_pallas.fused_time_attention(jq, jkv, HEADS, DH, interpret=True)
    _check(attention_cuda.fused_time_attention(tq, tkv, HEADS, DH), ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_attention_long_matches_pallas(dtype):
    """Past the 512 frames that K5's short route stages on chip (the
    wrapper takes its long route there): T=520, M=8, one Pallas block."""
    rng = np.random.default_rng(3)
    M, T = 8, 520
    jq, tq = _pair(rng.standard_normal((M, T, C)).astype(np.float32), dtype)
    jkv, tkv = _pair(rng.standard_normal((M, T, 2 * C)).astype(np.float32), dtype)
    ref = attention_pallas.fused_time_attention(jq, jkv, HEADS, DH, interpret=True)
    _check(attention_cuda.fused_time_attention(tq, tkv, HEADS, DH), ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_points_from_virtual_matches_pallas(dtype):
    rng = np.random.default_rng(1)
    N, T = 256, 3
    jq, tq = _pair(rng.standard_normal((N, T, C)).astype(np.float32), dtype)
    jkv, tkv = _pair(rng.standard_normal((T, V, 2 * C)).astype(np.float32), dtype)
    ref = attention_pallas.fused_points_from_virtual(jq, jkv, HEADS, DH, interpret=True)
    _check(attention_cuda.fused_points_from_virtual(tq, tkv, HEADS, DH), ref, dtype)


@pytest.mark.parametrize("dtype,mask,block_n", [
    ("float32", "tail", 256), ("float32", "tail", 512), ("float32", "all", 256),
    ("bfloat16", "none", 256),
])
def test_virtual_from_points_matches_pallas(dtype, mask, block_n):
    """N=512 keys in one or two Pallas tiles (the online softmax spans tiles),
    with a masked tail, every key masked (finite: the plain average of the
    values) and, in bfloat16, no mask."""
    rng = np.random.default_rng(2)
    N, T = 512, 2
    jq, tq = _pair(rng.standard_normal((T, V, C)).astype(np.float32) * 0.3, dtype)
    jkv, tkv = _pair(rng.standard_normal((N, T, 2 * C)).astype(np.float32), dtype)
    bias = None
    if mask != "none":
        bias = np.zeros(N, np.float32)
        bias[(300 if mask == "tail" else 0):] = NEG_BIG
    ref = attention_pallas.fused_virtual_from_points(
        jq, jkv, HEADS, DH, key_bias=None if bias is None else jnp.asarray(bias),
        block_n=block_n, interpret=True,
    )
    out = attention_cuda.fused_virtual_from_points(
        tq, tkv, HEADS, DH, key_bias=None if bias is None else torch.from_numpy(bias))
    assert torch.isfinite(out.float()).all()
    _check(out, ref, dtype)
    if mask == "all":
        mean_v = tkv[..., C:].float().mean(dim=0)[:, None].expand(T, V, C)
        np.testing.assert_allclose(out.float().numpy(), mean_v.numpy(), atol=1e-5)
