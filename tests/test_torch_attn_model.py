"""The update transformer in the attention-core configuration: the JAX
EfficientUpdateFormer with use_pallas_attn (K5, K6, K7 as Pallas kernels in
interpret mode, no W8A8) against the port's with attn_kernels on CPU (the
plain versions of K5-K7), float32, same random parameters, at N=256 so the
JAX tile gates take the kernel path, with masked padding tracks.

Tolerance: rtol 1e-3 / atol 1e-4 on O(1) outputs after 3 time and 3 space
blocks in float32 (summation order; no quantization on this path).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import cotracker_tpu.ops.kernels.attention_pallas as attention_pallas
from cotracker_tpu.models.cotracker3 import CoTrackerThree as JaxCoTrackerThree
from cotracker_tpu.models.updateformer import EfficientUpdateFormer as JaxUpdateFormer
from cotracker_tpu_torch.models.checkpoint import from_jax_params
from cotracker_tpu_torch.models.cotracker3 import CoTrackerThree
from cotracker_tpu_torch.ops.kernels import attention_cuda
from test_torch_model import random_params

torch.set_num_threads(2)


def test_updateformer_attention_cores_match_jax(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(attention_pallas.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    # every core of the port must be reached: count the plain versions' calls
    calls = {}
    for name in ("time_attention_plain", "p2v_plain", "v2p_plain"):
        fn = getattr(attention_cuda, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(attention_cuda, name, counted)

    params = random_params(JaxCoTrackerThree(), seed=3)
    rng = np.random.default_rng(4)
    B, N, T = 1, 256, 4
    x = rng.standard_normal((B, N, T, 1110)).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[:, 250:] = False
    jm = JaxUpdateFormer(use_pallas_attn=True)
    ref = jax.jit(lambda p, a, m: jm.apply({"params": p}, a, track_mask=m))(
        params["iter_core"]["updateformer"], jnp.asarray(x), jnp.asarray(mask))
    model = from_jax_params(
        CoTrackerThree(kernels=True, fold_input_proj=True, attn_quant_int8=False), params)
    with torch.no_grad():
        out = model.updateformer(torch.from_numpy(x), track_mask=torch.from_numpy(mask))
    assert calls == {"time_attention_plain": 6, "p2v_plain": 3, "v2p_plain": 3}
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-4)


def test_kernel_switches_are_independent():
    """`kernels=True` alone turns both updateformer switches on (W8A8 wins);
    attn_quant_int8=False leaves the attention cores; the virtual
    self-attention blocks get neither."""
    both = CoTrackerThree(kernels=True, fold_input_proj=True).updateformer
    cores = CoTrackerThree(kernels=True, fold_input_proj=True, attn_quant_int8=False).updateformer
    plain = CoTrackerThree().updateformer
    for uf, want in ((both, (True, True)), (cores, (True, False)), (plain, (False, False))):
        for blk in uf.time_blocks:
            assert (blk.attn.attn_kernels, blk.quant_int8) == want
        for blk in list(uf.space_virtual2point_blocks) + list(uf.space_point2virtual_blocks):
            assert (blk.cross_attn.attn_kernels, blk.quant_int8) == want
        for blk in uf.space_virtual_blocks:
            assert (blk.attn.attn_kernels, blk.quant_int8) == (False, False)
    assert cores.quantize() == {"time": [None] * 3, "v2p": [None] * 3, "p2v": [None] * 3}
