"""The kernel-variant switches and the last four kernels (K4m, K10, K11,
K12) against the JAX package on the CPU, Pallas in interpret mode, the JAX
variables set with monkeypatch (the JAX package reads them at trace time):

  * K4m's plain version against `fused_corr_embs_pallas(fuse_mlp1=True)`
    (per level) and `fused_corr_tokens_pallas` under
    COTRACKER_CORR_FUSE_MLP1=1 (all levels, folded), f32 and bf16, odd and
    even T;
  * K10's plain version in every flag combination and K12's with the LN
    on and off, and the shapes for which both return None;
  * every W8A8 body's plain version under COTRACKER_BF16_LN and under
    COTRACKER_GELU_QUANT_FOLD (K11's is K2's, against the all-frames
    Pallas body);
  * the K11 gate against the JAX conditions, and the environment parsing;
  * one cross block's points<-virtual with `space_allt` at 256 tracks x 16
    frames in bf16 against JAX with COTRACKER_SPACE_ALLT=1, with a call
    probe on the port's K11 and K2 wrappers;
  * the whole model with all four switches against the JAX model with the
    four variables, 256 tracks, 16 frames, iters=1.

Tolerances. Float32 kernel outputs: as tests/test_torch_kernels.py (the
int8 codes agree except at float32 rounding ties of a code boundary: 98% of
the elements within 1e-4 of the mean output, every one within 5% of it).
bfloat16: 99% within one bf16 ulp of the mean output (2^-8 of it), every
one within 5%. The bf16 LayerNorm adds ties of its own (a sum in another
order moves a bf16 statistic by one ulp now and then), so the two variant
cases allow 4% of the elements beyond the tight bound; measured well under
that. K4m's rows allow 10% (XLA:CPU evaluates the combine's lerps as FMAs,
the port as K4 does, rounding the product: a tie moves a whole row; see
the test), and the folded tokens in bf16 3% (the GELU after K4m rounds at
other places in the two frameworks). The cross block in bf16: as the
updateformer in
tests/test_torch_split_block.py (99% of the elements within 3% of
|ref| + mean|ref|, every one within 8%). The whole model: the band of
tests/test_torch_kernel_model.py (median |coords error| below 0.25 px, max
below 2 px, vis and conf within 0.05).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import cotracker_tpu.ops.kernels.attention_pallas as attention_pallas
import cotracker_tpu.ops.kernels.corr_pallas as corr_pallas
import cotracker_tpu.ops.kernels.mlp_int8_pallas as mlp_int8_pallas
from cotracker_tpu.models.blocks import CrossAttnBlock as JaxCrossAttnBlock
from cotracker_tpu.models.cotracker3 import CoTrackerThree as JaxCoTrackerThree
from cotracker_tpu_torch.models.checkpoint import from_jax_params, jax_params_to_state_dict
from cotracker_tpu_torch.models.cotracker3 import CoTrackerThree
from cotracker_tpu_torch.models.updateformer import EfficientUpdateFormer
from cotracker_tpu_torch.ops.kernels import corr_cuda, gates, mlp_int8_cuda
from cotracker_tpu_torch.ops.kernels.variants import ENV, KernelVariants, mlp1_env
from test_torch_kernels import assert_codes_close
from test_torch_model import random_inputs, random_params

torch.set_num_threads(2)

C, HID, HEADS, DH = 384, 1536, 8, 48
BF16_TOL = dict(tight=2.0**-8, frac=0.01)


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call
    forced = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    monkeypatch.setattr(mlp_int8_pallas.pl, "pallas_call", forced)
    monkeypatch.setattr(attention_pallas.pl, "pallas_call", forced)


@pytest.fixture
def no_env(monkeypatch):
    for name in ENV.values():
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


# ------------------------------------------------------------ K4m


def _corr_inputs(rng, T, N=5, H=16, W=24):
    fm = rng.standard_normal((1, T, H, W, 128)).astype(np.float32)
    fm /= np.linalg.norm(fm, axis=-1, keepdims=True)
    sup = rng.standard_normal((1, N, 49, 128)).astype(np.float32)
    sup /= np.linalg.norm(sup, axis=-1, keepdims=True)
    coords = (rng.random((1, T, N, 2)) * np.array([W + 6, H + 6]) - 3).astype(np.float32)
    return fm, sup, coords


# each dtype with an odd T (a padded frame) in one test and an even T in the other
CD_T = [(torch.float32, jnp.float32, dict(), 3), (torch.bfloat16, jnp.bfloat16, BF16_TOL, 4)]


@pytest.mark.parametrize("dtype,jdtype,tol,T", CD_T, ids=["f32-T3", "bf16-T4"])
def test_corr_mlp1_per_level_matches_pallas(no_env, dtype, jdtype, tol, T):
    """In float32 at the shapes of tests/test_pallas.py:730-733 (5 points,
    16x24, chunk 3) the whole per-level path, fused_corr_embs_kernel(
    fuse_mlp1=True) against fused_corr_embs_pallas(fuse_mlp1=True); in both
    dtypes K4m's pre-GELU rows at 40 points against the JAX plan's
    (`hidden` with the GELU taken out)."""
    rng = np.random.default_rng(11 + T)
    fm, sup, coords = _corr_inputs(rng, T)
    w1 = rng.standard_normal((2401, 384)).astype(np.float32) * 0.02
    b1 = rng.standard_normal(384).astype(np.float32) * 0.1
    w2 = rng.standard_normal((384, 256)).astype(np.float32) * 0.05
    b2 = rng.standard_normal(256).astype(np.float32) * 0.1
    t = torch.from_numpy
    level = corr_cuda.build_int8_level(t(fm), 3)
    if dtype == torch.float32:
        ref = corr_pallas.fused_corr_embs_pallas(
            jnp.asarray(fm), jnp.asarray(sup), jnp.asarray(coords), w1, b1, w2, b2, radius=3,
            compute_dtype=jdtype, interpret=True, quant_int8=True, fuse_mlp1=True, chunk=3,
            track_major=True)
        out = corr_cuda.fused_corr_embs_kernel(
            level, fm.shape[2:4], t(sup), t(coords), t(w1), t(b1), t(w2), t(b2), radius=3,
            chunk=3, compute_dtype=dtype, quant_int8=True, fuse_mlp1=True)
        assert out.dtype == dtype and tuple(out.shape) == ref.shape
        assert_codes_close(out.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="int8"):
        corr_cuda.fused_corr_embs_kernel(
            corr_cuda.build_float_level(t(fm), 3, dtype), fm.shape[2:4], t(sup), t(coords),
            t(w1), t(b1), t(w2), t(b2), compute_dtype=dtype, quant_int8=False, fuse_mlp1=True)

    # XLA:CPU contracts the lerps a + w * (b - a) into FMAs, the port rounds
    # the product first (as K4): where a combined value lies within a float32
    # ulp of a code boundary the codes differ by one, and that moves the
    # whole 384-wide row. Measured 1.6-6.2% of the rows at 40 points; the
    # bound allows 10% of the elements beyond the tight bound, every element
    # within 5% of the mean output.
    fm, sup, coords = _corr_inputs(rng, T, N=40)
    level = corr_cuda.build_int8_level(t(fm), 3)
    no_env.setattr(corr_pallas.jax.nn, "gelu", lambda h, approximate: h)
    ops, hidden = corr_pallas._corr_level_plan(
        jnp.asarray(fm), jnp.asarray(sup), jnp.asarray(coords), w1, b1, compute_dtype=jdtype,
        interpret=True, quant_int8=True, fuse_mlp1=True, track_major=True)
    ref_rows = hidden(*ops)  # (1, 40, T, 384)
    N = sup.shape[1]
    starts, wxy = corr_cuda.level_operands(t(coords), 1, T, *fm.shape[2:4], 3)
    sc = t(sup).to(dtype)
    amax = sc.abs().amax(dim=(2, 3)).float().clamp_min(1e-20)
    supq = torch.round(sc.float() * (127.0 / amax[..., None, None])).to(torch.int8)
    rows = corr_cuda.corr_mlp1_int8(level, supq.reshape(N, 49, -1), starts, wxy,
                                    *corr_cuda.quantize_w1_mlp1(t(w1)), t(b1),
                                    (amax * (1.0 / 127.0 / 128.0)).reshape(N), dtype)
    rows = rows.reshape(1, N, -1, 384)[:, :, :T]
    assert rows.dtype == dtype and tuple(rows.shape) == ref_rows.shape
    assert_codes_close(rows.float().numpy(), np.asarray(ref_rows.astype(jnp.float32)),
                       **dict(tol, frac=0.10))


@pytest.mark.parametrize("dtype,jdtype,tol,T", [(*CD_T[1][:3], 3), (*CD_T[0][:3], 4)],
                         ids=["bf16-T3", "f32-T4"])
def test_corr_mlp1_tokens_match_pallas(no_env, dtype, jdtype, tol, T):
    """The folded all-levels loop under COTRACKER_CORR_FUSE_MLP1=1: two
    levels, pre-quantized support, chunk 4 of 6 points. In bfloat16 the
    exact-erf GELU after K4m rounds at other places on the two sides
    (XLA:CPU evaluates jax.nn.gelu of a bf16 array op by op, torch in one
    float32 pass: one-ulp differences in about a third of its outputs),
    which the folded fc2's float32 sums average: 97% of the tokens within
    one bf16 ulp of the mean output."""
    no_env.setenv(ENV["corr_fuse_mlp1"], "1")
    rng = np.random.default_rng(20 + T)
    B, N, Dh, Dtok, H0, W0 = 1, 6, 384, 96, 24, 32
    packed, jsup, levels = [], [], []
    for i in range(2):
        fm, sup, _ = _corr_inputs(rng, T, N, H0 >> i, W0 >> i)
        sup_t = torch.from_numpy(sup).transpose(1, 2)  # (B, 49, N, C)
        packed.append(corr_pallas.build_shifted_fmaps(jnp.asarray(fm), 3, jdtype, quant_int8=True))
        sq, ss = corr_cuda.quantize_support(sup_t, dtype)
        jsup.append((jnp.asarray(sq.numpy()), jnp.asarray(ss.numpy())))
        levels.append((corr_cuda.build_int8_level(torch.from_numpy(fm), 3), sq, ss,
                       (H0 >> i, W0 >> i)))
    coords = (rng.random((B, T, N, 2)) * np.array([W0 + 6, H0 + 6]) - 3).astype(np.float32)
    w1 = rng.standard_normal((2401, Dh)).astype(np.float32) * 0.02
    b1 = rng.standard_normal(Dh).astype(np.float32) * 0.1
    w2f = [rng.standard_normal((Dh, Dtok)).astype(np.float32) * 0.05 for _ in range(2)]
    b2f = rng.standard_normal(Dtok).astype(np.float32)
    ref = corr_pallas.fused_corr_tokens_pallas(
        packed, jsup, jnp.asarray(coords).astype(jdtype), w1, b1, w2f, b2f, radius=3, chunk=4,
        compute_dtype=jdtype, interpret=True, quant_int8=True, fuse_combine=True)
    tw1 = torch.from_numpy(w1)
    w1q, w1amax = corr_cuda.quantize_w1(tw1, dtype)
    out = corr_cuda.fused_corr_tokens(
        levels, torch.from_numpy(coords).to(dtype), w1q, w1amax, torch.from_numpy(b1),
        [torch.from_numpy(w) for w in w2f], torch.from_numpy(b2f), radius=3, chunk=4,
        compute_dtype=dtype, w1m=corr_cuda.quantize_w1_mlp1(tw1))
    assert out.dtype == dtype and tuple(out.shape) == ref.shape
    tol = dict(tol, frac=0.03) if dtype == torch.bfloat16 else tol
    assert_codes_close(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), **tol)


def test_corr_mlp1_plain_layout():
    """corr_mlp1_plain on a hand-built case: the per-point scale is the raw
    volume's absmax over every tap and frame (junk taps included), the codes
    are the combined real taps, and the output is (h32 * w1s) * scale + b1."""
    rng = np.random.default_rng(3)
    fmq = torch.from_numpy(rng.integers(-127, 128, (2, 16, 16, 128)).astype(np.int8))
    supq = torch.from_numpy(rng.integers(-127, 128, (1, 49, 128)).astype(np.int8))
    starts = torch.tensor([[[0, 2, 3], [1, 4, 5]]], dtype=torch.int32)
    wxy = torch.tensor([[[1.0, 0.0], [0.0, 1.0]]])
    w1c = torch.zeros((384, corr_cuda.KM), dtype=torch.int8)
    w1c[0, 0] = 1  # tap (y, x, s) = (0, 0, 0)
    w1c[1, 7 * 49 + 5] = 2  # (1, 0, 5)
    w1s = torch.full((384,), 0.5)
    b1 = torch.arange(384, dtype=torch.float32)
    out = corr_cuda.corr_mlp1_plain(fmq, supq, starts, wxy, w1c, w1s, b1, torch.tensor([3.0]),
                                    torch.float32)
    sup = supq[0].double().t()
    g = torch.stack([fmq[0, 2:10, 3:11].reshape(64, 128).double() @ sup,
                     fmq[1, 4:12, 5:13].reshape(64, 128).double() @ sup])  # (t, 64, 49)
    s = g.abs().max().item() / 127.0
    # frame 0 takes the x+1 tap, frame 1 the y+1 tap
    c0 = torch.round(torch.stack([g[0, 1, 0], g[1, 8, 0]]) / s)
    c1 = torch.round(torch.stack([g[0, 9, 5], g[1, 16, 5]]) / s)
    np.testing.assert_allclose(out[0, :, 0].numpy(), (c0 * 0.5 * s * 3.0).numpy(), rtol=1e-5)
    np.testing.assert_allclose(out[0, :, 1].numpy(), (2 * c1 * 0.5 * s * 3.0 + 1).numpy(),
                               rtol=1e-5)
    np.testing.assert_array_equal(out[0, :, 2:].numpy(), b1[2:].expand(2, -1).numpy())


# ------------------------------------------------------------ K10, K12


def _lin(rng, i, o):
    return (rng.standard_normal((i, o)).astype(np.float32) / np.sqrt(i),
            rng.standard_normal(o).astype(np.float32) * 0.1)


def _q(w, b):
    return mlp_int8_cuda.quantize_linear(torch.from_numpy(w.T.copy()), torch.from_numpy(b))


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(0)
    return dict(q=_lin(rng, C, C), kv=_lin(rng, C, 2 * C), o=_lin(rng, C, C),
                f1=_lin(rng, C, HID), f2=_lin(rng, HID, C), qkv=_lin(rng, C, 3 * C),
                g=(1 + 0.1 * rng.standard_normal(C)).astype(np.float32),
                be=(0.05 * rng.standard_normal(C)).astype(np.float32))


def _fold_weights(w):
    """fc1 with every pre-GELU value negative (about N(-3, 0.3)): the
    GELU-quant fold differs from the absmax scale only on rows whose max
    gelu stays under 0.17, and these weights make every row such a row."""
    k, b = w["f1"]
    return {**w, "f1": (0.3 * k, b - 3.0)}


@pytest.mark.parametrize("ln,affine,residual", [
    (ln, af, res) for ln in (False, True) for af in (False, True) for res in (False, True)])
def test_ln_dense_matches_pallas(no_env, weights, ln, affine, residual):
    """K10, every flag combination; residual needs N == C (to_out), the
    others use to_qkv (384 -> 1,152)."""
    w = weights
    kern, bias = w["o"] if residual else w["qkv"]
    x = np.random.default_rng(4).standard_normal((6, 40, C)).astype(np.float32)
    g, be = (w["g"], w["be"]) if affine else (None, None)
    ref = mlp_int8_pallas.fused_ln_dense_int8(
        jnp.asarray(x), kern, bias, ln=ln, gamma=g, beta=be, residual=residual, interpret=True)
    t = lambda a: None if a is None else torch.from_numpy(a)
    out = mlp_int8_cuda.fused_ln_dense_int8(torch.from_numpy(x), _q(kern, bias), ln=ln,
                                            gamma=t(g), beta=t(be), residual=residual)
    assert tuple(out.shape) == ref.shape
    assert_codes_close(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("ln", [True, False])
def test_ln_mlp_matches_pallas(no_env, weights, ln):
    w = weights
    x = np.random.default_rng(5).standard_normal((6, 40, C)).astype(np.float32)
    ref = mlp_int8_pallas.fused_ln_mlp_int8(jnp.asarray(x), *w["f1"], *w["f2"], ln=ln,
                                            interpret=True)
    out = mlp_int8_cuda.fused_ln_mlp_int8(torch.from_numpy(x), _q(*w["f1"]), _q(*w["f2"]), ln=ln)
    assert tuple(out.shape) == ref.shape
    assert_codes_close(out.numpy(), np.asarray(ref))


def test_ln_dense_and_mlp_none_cases(weights):
    """The shapes for which the JAX wrappers return None: rows that are not a
    multiple of 8, widths that are not multiples of 128, residual with
    N != C. Both sides return None for the same calls."""
    rng = np.random.default_rng(6)
    w = weights
    cases = [
        (rng.standard_normal((3, 5, C)), w["qkv"], False),  # 15 rows
        (rng.standard_normal((16, C)), w["qkv"], True),  # residual, N != C
        (rng.standard_normal((16, 200)), _lin(rng, 200, 256), False),  # C = 200
        (rng.standard_normal((16, C)), _lin(rng, C, 200), False),  # N = 200
    ]
    for x, (kern, bias), residual in cases:
        x = x.astype(np.float32)
        ref = mlp_int8_pallas.fused_ln_dense_int8(jnp.asarray(x), kern, bias, ln=True,
                                                  residual=residual, interpret=True)
        out = mlp_int8_cuda.fused_ln_dense_int8(torch.from_numpy(x), _q(kern, bias), ln=True,
                                                residual=residual)
        assert ref is None and out is None, x.shape
    f1, f2 = _lin(rng, C, 200), _lin(rng, 200, C)
    for x, a, b in [(rng.standard_normal((15, C)), w["f1"], w["f2"]),
                    (rng.standard_normal((16, C)), f1, f2)]:
        x = x.astype(np.float32)
        assert mlp_int8_pallas.fused_ln_mlp_int8(jnp.asarray(x), *a, *b, interpret=True) is None
        assert mlp_int8_cuda.fused_ln_mlp_int8(torch.from_numpy(x), _q(*a), _q(*b)) is None


# ------------------------------------------------------------ the two modes


def _packs(w):
    return (
        mlp_int8_cuda.TimeBlockWeights(
            qkv=_q(np.concatenate([w["q"][0], w["kv"][0]], 1),
                   np.concatenate([w["q"][1], w["kv"][1]])),
            out=_q(*w["o"]), fc1=_q(*w["f1"]), fc2=_q(*w["f2"])),
        mlp_int8_cuda.SpaceBlockWeights(q=_q(*w["q"]), out=_q(*w["o"]), fc1=_q(*w["f1"]),
                                        fc2=_q(*w["f2"])),
    )


def _body(name, w, mode):
    """(JAX call, port plain call) of one W8A8 body in float32; mode is
    "bf16_ln" or "gelu_fold" (the port's argument names)."""
    tw, sw = _packs(w)
    kw = {mode: True}
    rng = np.random.default_rng(len(name))
    t = torch.from_numpy
    if name in ("K1", "K8", "K9", "K10", "K12"):
        x = rng.standard_normal((8, 8, C)).astype(np.float32)
        a = rng.standard_normal((8, 8, C)).astype(np.float32)
    if name == "K1":
        return (lambda: mlp_int8_pallas.fused_time_block_int8(
                    jnp.asarray(x), *w["q"], *w["kv"], *w["o"], *w["f1"], *w["f2"], HEADS, DH,
                    track_block=8, interpret=True),
                lambda: mlp_int8_cuda.time_block_plain(t(x), tw, HEADS, DH, **kw))
    if name == "K8":
        kw.pop("gelu_fold", None)
        return (lambda: jnp.concatenate(mlp_int8_pallas.fused_ln_qkv_int8(
                    jnp.asarray(x), *w["q"], *w["kv"], interpret=True), -1),
                lambda: torch.cat(mlp_int8_cuda.ln_qkv_plain(t(x), tw.qkv, **kw), -1))
    if name == "K9":
        return (lambda: mlp_int8_pallas.fused_attnout_res_mlp_int8(
                    jnp.asarray(a), jnp.asarray(x), *w["o"], *w["f1"], *w["f2"], interpret=True),
                lambda: mlp_int8_cuda.attnout_mlp_plain(t(a), t(x), tw, **kw))
    if name == "K10":
        kw.pop("gelu_fold", None)
        return (lambda: mlp_int8_pallas.fused_ln_dense_int8(
                    jnp.asarray(x), *w["qkv"], ln=True, interpret=True),
                lambda: mlp_int8_cuda.ln_dense_plain(t(x), _q(*w["qkv"]), ln=True, **kw))
    if name == "K12":
        return (lambda: mlp_int8_pallas.fused_ln_mlp_int8(
                    jnp.asarray(x), *w["f1"], *w["f2"], interpret=True),
                lambda: mlp_int8_cuda.ln_mlp_plain(t(x), tw.fc1, tw.fc2, **kw))
    # K2 per frame, K11 on all frames (float32 tokens: 8 frames are one
    # sublane tile), both against the port's one plain version
    N, T = 256, 8
    x = rng.standard_normal((N, T, C)).astype(np.float32)
    kv = rng.standard_normal((T, 64, 2 * C)).astype(np.float32)
    return (lambda: mlp_int8_pallas.fused_space_block_int8(
                jnp.asarray(x), jnp.asarray(kv), *w["q"], *w["o"], *w["f1"], *w["f2"], HEADS, DH,
                block_n=256, interpret=True),
            lambda: mlp_int8_cuda.space_block_plain(t(x), t(kv), sw, HEADS, DH, **kw))


MODES = {"bf16_ln": ENV["bf16_ln"], "gelu_fold": ENV["gelu_quant_fold"]}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", ["K1", "K2", "K8", "K9", "K10", "K11", "K12"])
def test_w8a8_modes_match_pallas(no_env, interpret, weights, name, mode):
    no_env.setenv(MODES[mode], "1")
    if name == "K11":
        no_env.setenv(ENV["space_allt"], "1")
    jax_fn, port_fn = _body(name, _fold_weights(weights) if mode == "gelu_fold" else weights,
                            mode)
    ref = jax_fn()
    if name in ("K2", "K11"):
        assert mlp_int8_pallas._LAST_SPACE_ALLT is (name == "K11")
    out = port_fn()
    assert tuple(out.shape) == ref.shape
    assert_codes_close(out.numpy(), np.asarray(ref), frac=0.04)


def test_modes_change_the_function(weights):
    """Each mode changes the plain version's output (so the cases above
    hold the mode, not the default)."""
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((8, 8, C)).astype(np.float32))
    for kw, w in ((dict(bf16_ln=True), weights), (dict(gelu_fold=True), _fold_weights(weights))):
        tw, _ = _packs(w)
        base = mlp_int8_cuda.time_block_plain(x, tw, HEADS, DH)
        changed = mlp_int8_cuda.time_block_plain(x, tw, HEADS, DH, **kw) != base
        assert changed.float().mean() > 0.1, kw


# ------------------------------------------------------------ gates and parsing


def test_space_allt_gate_matches_jax():
    for N in (128, 256, 264, 512, 1000, 2560, 10240, 70656, 70664):
        for T in (4, 8, 12, 16, 24, 32, 48, 60, 64, 80, 96, 128, 160):
            for bf16, jdt in ((True, jnp.bfloat16), (False, jnp.float32)):
                ref = None
                if attention_pallas.pick_block_n(N) is not None and \
                        mlp_int8_pallas._reshape_repack_ok(T, jdt):
                    tile = mlp_int8_pallas._pick_time_tile(N, T, max_tokens=1024)
                    if tile is not None and any(
                            tile * T % c == 0 and tile * T // c <= 640 for c in range(1, 9)):
                        ref = tile
                assert gates.space_allt_tile(N, T, bf16) == ref, (N, T, bf16)
    assert gates.space_allt_tile(70656, 16, True) == 64  # the quasi-dense window
    assert gates.space_allt_tile(10240, 60, True) is None  # the offline window keeps K2


@pytest.mark.parametrize("value", [None, "", "0", "false", "False", "1", "true", "yes"])
def test_env_parsing_matches_jax(no_env, value):
    if value is not None:
        for name in ENV.values():
            no_env.setenv(name, value)
    for flag in (False, True):
        assert mlp1_env(flag) == corr_pallas._mlp1_env(flag)
    v = KernelVariants.from_env()
    assert v.corr_fuse_mlp1 == corr_pallas._mlp1_env(False)
    assert v.space_allt == v.bf16_ln == v.gelu_quant_fold == (value == "1")
    # an explicit argument overrides its variable, the others still read it
    w = KernelVariants.from_env(space_allt=False, corr_fuse_mlp1=True)
    assert not w.space_allt and w.corr_fuse_mlp1 and w.bf16_ln == v.bf16_ln


# ------------------------------------------------------------ the K11 route


def test_points_from_virtual_takes_k11(no_env, interpret, weights):
    no_env.setenv(ENV["space_allt"], "1")
    seen = {}
    for name in ("fused_space_block_int8", "fused_space_block_allt_int8"):
        orig = getattr(mlp_int8_cuda, name)

        def spy(*a, _orig=orig, _name=name, **k):
            seen[_name] = seen.get(_name, 0) + 1
            return _orig(*a, **k)

        no_env.setattr(mlp_int8_cuda, name, spy)
    uf = random_params(JaxCoTrackerThree(), seed=5)["iter_core"]["updateformer"]
    p = uf["space_point2virtual_blocks_0"]
    N, T, V = 256, 16, 64
    rng = np.random.default_rng(8)
    points = rng.standard_normal((1, N, T, C)).astype(np.float32)
    virtual = rng.standard_normal((1, T, V, C)).astype(np.float32)
    bf = jnp.bfloat16
    jb = JaxCrossAttnBlock(384, 8, 48, 4.0, dtype=bf, use_pallas_attn=True, quant_int8=True)
    ref = jax.jit(lambda prm, a, v: jb.apply({"params": prm}, a, v,
                                             method=JaxCrossAttnBlock.points_from_virtual))(
        p, jnp.asarray(points).astype(bf), jnp.asarray(virtual).astype(bf))
    assert mlp_int8_pallas._LAST_SPACE_ALLT is True
    model = EfficientUpdateFormer(time_depth=1, space_depth=1, dtype=torch.bfloat16,
                                  attn_kernels=True, quant_int8=True,
                                  variants=KernelVariants.from_env())
    sd = jax_params_to_state_dict({"iter_core": {"updateformer": {
        k: v for k, v in uf.items() if not k[-1].isdigit() or k.endswith("_0")}}})
    model.load_state_dict({k.removeprefix("updateformer."): torch.from_numpy(v)
                           for k, v in sd.items()})
    with torch.no_grad():
        out = model.space_point2virtual_blocks[0].points_from_virtual(
            torch.from_numpy(points).to(torch.bfloat16), torch.from_numpy(virtual).to(torch.bfloat16))
    assert seen == {"fused_space_block_allt_int8": 1}
    ref = np.asarray(ref.astype(jnp.float32))
    rel = np.abs(out.float().numpy() - ref) / (np.abs(ref) + np.abs(ref).mean())
    assert np.quantile(rel, 0.99) <= 0.03 and rel.max() <= 0.08, (np.quantile(rel, 0.99),
                                                                  rel.max())


# ------------------------------------------------------------ the whole slice


def test_model_with_all_variants_matches_jax(no_env, interpret):
    for name in ENV.values():
        no_env.setenv(name, "1")
    # one point per correlation grid step: the same per-point math, fewer
    # unrolled window copies for the interpreter
    no_env.setattr(corr_pallas, "_FORCE_PP", 1)
    B, T, H, W, N = 1, 16, 32, 32, 256
    video, queries = random_inputs(np.random.default_rng(0), B, T, H, W, N)
    params = random_params(JaxCoTrackerThree(), seed=1)
    jm = JaxCoTrackerThree(
        window_len=T, model_resolution=(H, W), corr_chunk=128, use_pallas_corr=True,
        corr_quant_int8=True, corr_fuse_combine=True, fold_input_proj=True,
        use_pallas_attn=True, attn_quant_int8=True, corr_pallas_interpret=True,
    )
    ref = jax.jit(lambda p, v, q: jm.apply({"params": p}, v, q, iters=1)[:3])(
        params, jnp.asarray(video), jnp.asarray(queries))
    assert mlp_int8_pallas._LAST_SPACE_ALLT is True
    variants = KernelVariants.from_env()
    assert all(variants)
    model = from_jax_params(
        CoTrackerThree(window_len=T, model_resolution=(H, W), corr_chunk=128,
                       fold_input_proj=True, kernels=True, variants=variants),
        params,
    )
    seen = {}
    for mod, name in ((corr_cuda, "corr_mlp1_int8"), (corr_cuda, "corr_volume_int8"),
                      (mlp_int8_cuda, "fused_space_block_allt_int8"),
                      (mlp_int8_cuda, "fused_space_block_int8")):
        orig = getattr(mod, name)

        def spy(*a, _orig=orig, _name=name, **k):
            seen[_name] = seen.get(_name, 0) + 1
            return _orig(*a, **k)

        no_env.setattr(mod, name, spy)
    with torch.no_grad():
        out = model(torch.from_numpy(video), torch.from_numpy(queries), iters=1)[:3]
    # 4 levels x 2 chunks through K4m, 3 space rounds through K11
    assert seen == {"corr_mlp1_int8": 8, "fused_space_block_allt_int8": 3}
    err = np.abs(out[0].numpy() - np.asarray(ref[0]))
    assert np.median(err) < 0.25 and err.max() < 2.0, (np.median(err), err.max())
    for o, r in zip(out[1:], ref[1:]):
        assert np.abs(o.numpy() - np.asarray(r)).max() < 0.05
