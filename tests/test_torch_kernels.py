"""Port kernels K1-K4: each plain PyTorch version (what the wrappers run on
CPU tensors) against the JAX package's Pallas wrapper in interpret mode, at
the calls tests/test_pallas.py makes, in float32 so that only the contract
is compared.

Tolerance: both sides quantize the same float32 values with the same
formulas, so the int8 codes agree except where a value lies within float32
rounding of a half-integer code boundary (the frameworks' softmax, mean and
rsqrt differ in the last ulp). Such a tie moves one code by one step and
perturbs the rows it feeds by about scale/127. `assert_codes_close`
therefore requires agreement to 1e-4 of the output's mean magnitude (float32
summation-order noise over up to 1,024 keys) for at least 98% of the
elements, and bounds every element by 5% of it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cotracker_tpu.ops.kernels import attention_pallas, corr_pallas, mlp_int8_pallas
from cotracker_tpu_torch.ops.kernels import attention_cuda, corr_cuda, mlp_int8_cuda

torch.set_num_threads(2)

C, HID, HEADS, DH = 384, 1536, 8, 48


def assert_codes_close(out, ref, tight=1e-4, loose=0.05, frac=0.02):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    scale = np.abs(ref).mean()
    err = np.abs(out - ref)
    assert np.mean(err > tight * scale) <= frac, (np.mean(err > tight * scale), frac)
    assert err.max() <= loose * scale, (err.max(), loose * scale)


def _lin(rng, i, o):
    return (rng.standard_normal((i, o)).astype(np.float32) * 0.05,
            rng.standard_normal(o).astype(np.float32) * 0.1)


def _q(w, b):
    """JAX (in, out) kernel -> the port's quantized nn.Linear layout."""
    return mlp_int8_cuda.quantize_linear(torch.from_numpy(w.T.copy()), torch.from_numpy(b))


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(0)
    return dict(q=_lin(rng, C, C), kv=_lin(rng, C, 2 * C), o=_lin(rng, C, C),
                f1=_lin(rng, C, HID), f2=_lin(rng, HID, C))


@pytest.mark.parametrize("T", [6, 8])
def test_time_block_matches_pallas(weights, T):
    w = weights
    x = np.random.default_rng(T).standard_normal((32, T, C)).astype(np.float32)
    ref = mlp_int8_pallas.fused_time_block_int8(
        jnp.asarray(x), *w["q"], *w["kv"], *w["o"], *w["f1"], *w["f2"], HEADS, DH,
        track_block=16, interpret=True,
    )
    pack = mlp_int8_cuda.TimeBlockWeights(
        qkv=_q(np.concatenate([w["q"][0], w["kv"][0]], 1), np.concatenate([w["q"][1], w["kv"][1]])),
        out=_q(*w["o"]), fc1=_q(*w["f1"]), fc2=_q(*w["f2"]),
    )
    out = mlp_int8_cuda.fused_time_block_int8(torch.from_numpy(x), pack, HEADS, DH)
    assert_codes_close(out.numpy(), ref)


def test_space_block_matches_pallas(weights):
    w = weights
    rng = np.random.default_rng(1)
    N, T, V = 256, 3, 64
    x = rng.standard_normal((N, T, C)).astype(np.float32)
    kv = rng.standard_normal((T, V, 2 * C)).astype(np.float32)
    ref = mlp_int8_pallas.fused_space_block_int8(
        jnp.asarray(x), jnp.asarray(kv), *w["q"], *w["o"], *w["f1"], *w["f2"], HEADS, DH,
        block_n=256, interpret=True,
    )
    pack = mlp_int8_cuda.SpaceBlockWeights(q=_q(*w["q"]), out=_q(*w["o"]), fc1=_q(*w["f1"]),
                                           fc2=_q(*w["f2"]))
    out = mlp_int8_cuda.fused_space_block_int8(torch.from_numpy(x), torch.from_numpy(kv), pack,
                                               HEADS, DH)
    assert_codes_close(out.numpy(), ref)


def test_virtual_from_points_proj_matches_pallas(weights):
    """N=1024 in 256-key tiles, so the online softmax spans tiles, with a
    masked tail of keys."""
    rng = np.random.default_rng(2)
    N, T, V = 1024, 2, 64
    q = rng.standard_normal((T, V, C)).astype(np.float32) * 0.3
    x = rng.standard_normal((N, T, C)).astype(np.float32)
    g = (rng.standard_normal(C) * 0.2 + 1.0).astype(np.float32)
    be = (rng.standard_normal(C) * 0.1).astype(np.float32)
    bias = np.zeros(N, np.float32)
    bias[700:] = -0.7 * np.finfo(np.float32).max
    ref = attention_pallas.fused_virtual_from_points_proj(
        jnp.asarray(q), jnp.asarray(x), *weights["kv"], g, be, HEADS, DH,
        key_bias=jnp.asarray(bias), block_n=256, interpret=True,
    )
    out = attention_cuda.fused_virtual_from_points_proj(
        torch.from_numpy(q), torch.from_numpy(x), _q(*weights["kv"]), torch.from_numpy(g),
        torch.from_numpy(be), HEADS, DH, key_bias=torch.from_numpy(bias),
    )
    assert_codes_close(out.numpy(), ref)


@pytest.mark.parametrize("T", [3, 4])
def test_corr_tokens_match_pallas(T):
    """K4 + its epilogue through the all-levels token loop, pre-quantized
    support, chunk (4) smaller than N (6); odd T exercises the padded frame."""
    rng = np.random.default_rng(10 + T)
    B, N, Dh, Dtok, H0, W0 = 1, 6, 384, 96, 24, 32
    packed, jsup, levels = [], [], []
    for i in range(2):
        fm = rng.standard_normal((B, T, H0 >> i, W0 >> i, 128)).astype(np.float32)
        fm /= np.linalg.norm(fm, axis=-1, keepdims=True)
        sup = rng.standard_normal((B, 49, N, 128)).astype(np.float32)
        sup /= np.linalg.norm(sup, axis=-1, keepdims=True)
        packed.append(corr_pallas.build_shifted_fmaps(jnp.asarray(fm), 3, jnp.float32,
                                                      quant_int8=True))
        sq, ss = corr_cuda.quantize_support(torch.from_numpy(sup), torch.float32)
        jsup.append((jnp.asarray(sq.numpy()), jnp.asarray(ss.numpy())))
        levels.append((corr_cuda.build_int8_level(torch.from_numpy(fm), 3), sq, ss,
                       (H0 >> i, W0 >> i)))
    coords = (rng.random((B, T, N, 2)) * np.array([W0 + 6, H0 + 6]) - 3).astype(np.float32)
    w1 = rng.standard_normal((2401, Dh)).astype(np.float32) * 0.02
    b1 = rng.standard_normal(Dh).astype(np.float32) * 0.1
    w2f = [rng.standard_normal((Dh, Dtok)).astype(np.float32) * 0.05 for _ in range(2)]
    b2f = rng.standard_normal(Dtok).astype(np.float32)
    ref = corr_pallas.fused_corr_tokens_pallas(
        packed, jsup, jnp.asarray(coords), w1, b1, w2f, b2f, radius=3, chunk=4,
        compute_dtype=jnp.float32, interpret=True, quant_int8=True, fuse_combine=True,
    )
    w1q, w1amax = corr_cuda.quantize_w1(torch.from_numpy(w1), torch.float32)
    out = corr_cuda.fused_corr_tokens(
        levels, torch.from_numpy(coords), w1q, w1amax, torch.from_numpy(b1),
        [torch.from_numpy(w) for w in w2f], torch.from_numpy(b2f), radius=3, chunk=4,
        compute_dtype=torch.float32,
    )
    assert_codes_close(out.numpy(), ref)


def test_corr_volume_layout_and_scale():
    """The plain K4 on a hand-built case: with (wx, wy) = (1, 0) frame 0's
    volume is the x+1 tap and frame 1's (0, 1) the y+1 tap of the raw
    correlation over the flattened (t, y, x) lane axis, wrapping at its end
    like the Pallas lane roll; the absmax over both frames maps to code 127."""
    rng = np.random.default_rng(3)
    fmq = torch.from_numpy(rng.integers(-127, 128, (2, 16, 16, 128)).astype(np.int8))
    supq = torch.from_numpy(rng.integers(-127, 128, (1, 49, 128)).astype(np.int8))
    starts = torch.tensor([[[0, 2, 3], [1, 4, 5]]], dtype=torch.int32)
    wxy = torch.tensor([[[1.0, 0.0], [0.0, 1.0]]])
    vol, scale = corr_cuda.corr_volume_plain(fmq, supq, starts, wxy)
    assert vol.shape == (1, 2, 64, 49) and vol.dtype == torch.int8
    sup = supq[0].double().t()
    g = torch.cat([fmq[0, 2:10, 3:11].reshape(64, 128).double() @ sup,
                   fmq[1, 4:12, 5:13].reshape(64, 128).double() @ sup])  # (128 lanes, 49)
    lanes = torch.arange(64)
    c = torch.cat([g[(lanes + 1) % 128], g[(64 + lanes + 8) % 128]])
    s = c.abs().max().item() / 127.0
    assert abs(scale.item() - s) <= 1e-6 * s
    codes = torch.round(c / s).to(torch.int8).reshape(2, 64, 49)
    np.testing.assert_array_equal(vol[0].numpy(), codes.numpy())
    assert vol.abs().max().item() == 127


def test_corr_volume_raw_layout_and_scale():
    """The plain K4r on a hand-built case: each frame's volume is its own
    window's raw correlation in (y, x, s) order, with nothing wrapped across
    frames (frame 0's last taps are its own (7, x) row, not frame 1's first),
    and the per-point scale is the raw absmax over both frames: frame 1
    holds the maximum (code 127), frame 0's smaller values keep smaller
    codes on the same scale."""
    rng = np.random.default_rng(4)
    fm = np.stack([rng.integers(-20, 21, (16, 16, 128)), rng.integers(-127, 128, (16, 16, 128))])
    fmq = torch.from_numpy(fm.astype(np.int8))
    supq = torch.from_numpy(rng.integers(-127, 128, (1, 49, 128)).astype(np.int8))
    starts = torch.tensor([[[0, 2, 3], [1, 4, 5]]], dtype=torch.int32)
    vol, scale = corr_cuda.corr_volume_raw_plain(fmq, supq, starts)
    assert vol.shape == (1, 2, 64, 49) and vol.dtype == torch.int8 and scale.shape == (1,)
    sup = supq[0].double().t()
    g = torch.stack([fmq[0, 2:10, 3:11].reshape(64, 128).double() @ sup,
                     fmq[1, 4:12, 5:13].reshape(64, 128).double() @ sup])  # (frame, y*8+x, s)
    s = g.abs().max().item() / 127.0
    assert abs(scale.item() - s) <= 1e-6 * s
    codes = torch.round(g.float() * (1.0 / scale)).to(torch.int8)
    np.testing.assert_array_equal(vol[0].numpy(), codes.numpy())
    assert vol[0, 1].abs().max().item() == 127 and vol[0, 0].abs().max().item() < 64
