"""W8A8 block kernels: K1 (whole time block), K2 (whole points<-virtual
block), K8 / K9, the two W8A8 halves of the time block's three-kernel
split around the K5 attention core, K11 (the points<-virtual block of the
`space_allt` variant: K2's function, so K2's launches), and K10 (LN +
dense) and K12 (LN + MLP), the two bodies only the micro-benchmark
reaches.

K1 replaces cotracker_tpu/ops/kernels/mlp_int8_pallas.py::_time_block_kernel
(wrapper fused_time_block_int8), K2 its ::_space_block_kernel (wrapper
fused_space_block_int8). On the H100, K1 in bfloat16 is two launches of
csrc/int8_time_block.cu (a front per block of whole tracks: LN + quant, the
q|k|v products, the bf16 time core, a's row codes; a tail per 64-row tile:
to_out + residual, LN + quant, fc1 + GELU + quant, fc2 + residual), whose
tiling `k1_plan` computes; K2 in bfloat16 is two launches of the same file
(its own front per run of 64-track tiles of one frame: LN + quant, the q
product, the points<-virtual core, a's row codes; then K1's tail), routed
by `k2_plan`; K1 and K2 in float32 (K2 also past 64 virtual tokens) are
chains of hand-written launches of csrc/int8_blocks.cu (LN + row quant,
tensor-core s8 GEMMs with fused dequant/bias/GELU/residual epilogues, the
attention core). K8
replaces ::_qkv_kernel (wrapper fused_ln_qkv_int8) and K9 ::_out_mlp_kernel
(wrapper fused_attnout_res_mlp_int8), one launch each: a row tile's
activations, its f32 residual and its GELU codes stay in shared memory; K8
in bfloat16 runs persistent blocks of csrc/int8_time_block.cu on the tail's
weight stream (k8_plan), K9 in bfloat16 is K1's streamed tail with its own
prologue (k9_route). See
the sources for what bounds them and what the designs do about it. K11
replaces ::_space_block_allt_kernel (the `space_allt` route of
fused_space_block_int8; here its own wrapper, fused_space_block_allt_int8):
it computes K2's function, so it takes K2's route (k2_plan), its bf16 front
under a kernel name of its own. K10 replaces ::_dense_kernel
(fused_ln_dense_int8), one launch of csrc/int8_fused.cu, and K12
::_mlp_kernel (fused_ln_mlp_int8), one launch of csrc/int8_mlp_cluster.cu:
8-block thread-block clusters with resident weights and one fc1 pass
(k12_plan); its first body (csrc/int8_fused.cu, `_ln_mlp_first`) stays as
the yardstick it is held to bit for bit.

The two variant switches that change the function of every body here
(ops/kernels/variants.py) are the wrappers' `bf16_ln` (COTRACKER_BF16_LN:
`ln_rows(..., bf16=True)`) and `gelu_fold` (COTRACKER_GELU_QUANT_FOLD:
`quant_gelu(..., fold=True)`) arguments, in the plain versions and the
kernels alike.

Contract (quantization scheme of the JAX package):
  * weights: per-output-channel symmetric int8, scale max(absmax, 1e-20)/127,
    codes rint(w / scale) -- quantized once per forward (`quantize_linear`);
  * activations: per-row dynamic int8, codes rint(v * (1/scale));
  * LayerNorm (affine-free, eps 1e-6, two-pass f32 statistics), dequant,
    bias, tanh-GELU and residual adds in float32.

Each wrapper takes its plain PyTorch version for CPU tensors, and for CUDA
tensors launches the kernel chain or raises; `launches` counts the kernel
runs. The wrappers take any number of rows and tracks; K1 takes up to 256
frames in bfloat16 (its front holds a track's rows on chip) and 512 in
float32, K2 up to 512 virtual tokens, whose keys the attention core holds
in shared memory. Which of K1 or K8 -> K5 -> K9 a time block runs is the
JAX package's decision (ops/kernels/gates.py, models/blocks.py): the two
differ in bfloat16, where the split rounds the attention output to the token
dtype before K9 quantizes it and K1 quantizes it in float32.
"""

import ctypes
from typing import NamedTuple

import torch

from cotracker_tpu_torch.ops.kernels import _build

F32 = torch.float32
MODE_AFFINE, MODE_GELU, MODE_RESID = 0, 1, 2


class QLinear(NamedTuple):
    """int8 weight (out, in), per-output-channel f32 scale (out,), f32 bias."""

    w: torch.Tensor
    s: torch.Tensor
    b: torch.Tensor


class TimeBlockWeights(NamedTuple):
    qkv: QLinear  # to_q and to_kv stacked along the output axis: (3C, C)
    out: QLinear
    fc1: QLinear
    fc2: QLinear


class SpaceBlockWeights(NamedTuple):
    q: QLinear
    out: QLinear
    fc1: QLinear
    fc2: QLinear


def quantize_linear(weight, bias) -> QLinear:
    """Per-output-channel symmetric int8 quantization of an nn.Linear weight
    (out, in) (JAX quantize_weight on the (in, out) kernel)."""
    w32 = weight.detach().to(F32)
    s = w32.abs().amax(dim=1).clamp_min(1e-20) * (1.0 / 127.0)
    w8 = torch.round(w32 / s[:, None]).to(torch.int8)
    return QLinear(w8.contiguous(), s.contiguous(), bias.detach().to(F32).contiguous())


# ------------------------------------------------------------ plain versions


def ln_rows(x32, eps, bf16=False):
    """Two-pass float32 LayerNorm statistics over the last axis (no affine).

    bf16 (the bf16_ln variant, mlp_int8_pallas.py::_ln under
    COTRACKER_BF16_LN): the statistics in bf16, in the order XLA:CPU
    evaluates the JAX body (read from its compiled HLO): x rounded to bf16;
    mean = bf16(sum(x) * (1/C)) with an f32 sum; c = bf16(x - mean);
    var = bf16(sum(c * c) * (1/C)) with f32 products and sum;
    inv = bf16(rsqrt(var + eps)); the result c * inv in float32, not
    rounded to bf16 again."""
    if bf16:
        bf = torch.bfloat16
        inv_c = 1.0 / x32.shape[-1]
        xb = x32.to(bf).to(F32)
        mean = (xb.sum(dim=-1, keepdim=True) * inv_c).to(bf).to(F32)
        c = (xb - mean).to(bf).to(F32)
        var = ((c * c).sum(dim=-1, keepdim=True) * inv_c).to(bf).to(F32)
        return c * torch.rsqrt(var + eps).to(bf).to(F32)
    mean = x32.mean(dim=-1, keepdim=True)
    c = x32 - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    return c.mul_(torch.rsqrt(var + eps))


# The plain versions below evaluate in place where a temporary as large as
# the activations would be made: the same operations in the same order (so
# the same roundings), without the allocations that dominate on the CPU.


def quant_rows(v32):
    """Per-row symmetric int8: (codes, scale (rows, 1))."""
    lo, hi = torch.aminmax(v32, dim=-1, keepdim=True)  # the row's absmax, max(-lo, hi)
    s = torch.maximum(-lo, hi).clamp_min(1e-20) * (1.0 / 127.0)
    return (v32 * (1.0 / s)).round_().to(torch.int8), s


def gelu_tanh(x):
    """0.5 * x * (1 + tanh(0.7978845608028654 * (x + 0.044715 * x * x * x)))."""
    t = x * 0.044715
    t.mul_(x).mul_(x).add_(x).mul_(0.7978845608028654).tanh_().add_(1.0)
    return t.mul_(x * 0.5)


def quant_gelu(a32, fold=False):
    """Per-row int8 codes of gelu_tanh(a32) and their scales (rows, 1).

    fold (the gelu_quant_fold variant, mlp_int8_pallas.py::_quant_gelu_rows
    under COTRACKER_GELU_QUANT_FOLD): the scale comes from the PRE-GELU row
    max, max(gelu(max(rowmax(a), 0)), 0.1700001) / 127, which bounds
    |gelu(a)| without a pass over it."""
    if not fold:
        return quant_rows(gelu_tanh(a32))
    rm = a32.amax(dim=-1, keepdim=True).clamp_min(0.0)
    s = gelu_tanh(rm).clamp_min(0.1700001) * (1.0 / 127.0)
    return torch.round(gelu_tanh(a32) * (1.0 / s)).to(torch.int8), s


def qlinear_plain(a8, sa, lin: QLinear):
    """Dequantized s8 x s8 -> s32 product: acc * (row scale * column scale) + b."""
    return torch._int_mm(a8, lin.w.t()).to(F32).mul_(sa * lin.s).add_(lin.b)


def _attend(q, k, v, scale, out_dtype):
    """softmax(q.k * scale) in float32, probabilities rounded to `out_dtype`,
    P.V accumulated in float32. q/k/v (..., L, D)."""
    sim = torch.einsum("...id,...jd->...ij", q.to(F32), k.to(F32)).mul_(scale)
    p = torch.softmax(sim, dim=-1).to(out_dtype)
    return torch.einsum("...ij,...jd->...id", p.to(F32), v.to(F32))


def _mlp_tail_plain(a32, x32, w, eps, bf16_ln=False, gelu_fold=False):
    """r = x + to_out(a); return r + fc2(gelu(fc1(ln(r)))), all W8A8."""
    aq, sa = quant_rows(a32)
    r = x32 + torch._int_mm(aq, w.out.w.t()).to(F32) * (sa * w.out.s) + w.out.b
    hq, sr0 = quant_rows(ln_rows(r, eps, bf16_ln))
    uq, sr1 = quant_gelu(qlinear_plain(hq, sr0, w.fc1), gelu_fold)
    return r + torch._int_mm(uq, w.fc2.w.t()).to(F32) * (sr1 * w.fc2.s) + w.fc2.b


def ln_qkv_plain(x, wqkv: QLinear, eps=1e-6, bf16_ln=False):
    """Plain K8: x (..., C) -> (q (..., C), kv (..., 2C)) in x.dtype, from
    the stacked [to_q; to_kv] weights (3C, C)."""
    C = x.shape[-1]
    hq, sr = quant_rows(ln_rows(x.to(F32).reshape(-1, C), eps, bf16_ln))
    qkv = qlinear_plain(hq, sr, wqkv).to(x.dtype)
    lead = x.shape[:-1]
    return qkv[:, :C].reshape(*lead, C), qkv[:, C:].reshape(*lead, -1)


def attnout_mlp_plain(a, x, w: TimeBlockWeights, eps=1e-6, bf16_ln=False, gelu_fold=False):
    """Plain K9: a (..., C) the attention-core output, x (..., C) the
    residual stream -> (..., C) in x.dtype:

        r = x + to_out(a); return r + fc2(gelu(fc1(ln(r)))), all W8A8

    with the JAX body's additions: (x + product) + bias, r + (product + bias)."""
    C = x.shape[-1]
    x32 = x.to(F32).reshape(-1, C)
    aq, sa = quant_rows(a.to(F32).reshape(-1, C))
    r = x32 + torch._int_mm(aq, w.out.w.t()).to(F32) * (sa * w.out.s) + w.out.b
    hq, sh = quant_rows(ln_rows(r, eps, bf16_ln))
    uq, su = quant_gelu(qlinear_plain(hq, sh, w.fc1), gelu_fold)
    return (r + qlinear_plain(uq, su, w.fc2)).to(x.dtype).reshape(x.shape)


def time_block_plain(x, w: TimeBlockWeights, num_heads, dim_head, eps=1e-6, bf16_ln=False,
                     gelu_fold=False):
    """Plain K1: x (M, T, C) -> (M, T, C) in x.dtype."""
    M, T, C = x.shape
    x32 = x.to(F32).reshape(M * T, C)
    hq, sr = quant_rows(ln_rows(x32, eps, bf16_ln))
    qkv = qlinear_plain(hq, sr, w.qkv).to(x.dtype)  # q|kv rounded to the token dtype
    q, k, v = (
        t.reshape(M, T, num_heads, dim_head).transpose(1, 2) for t in qkv.split(C, dim=-1)
    )
    a = _attend(q, k, v, dim_head**-0.5, x.dtype).transpose(1, 2).reshape(M * T, C)
    return _mlp_tail_plain(a, x32, w, eps, bf16_ln, gelu_fold).to(x.dtype).reshape(M, T, C)


def space_block_plain(x, kv, w: SpaceBlockWeights, num_heads, dim_head, eps=1e-6, bf16_ln=False,
                      gelu_fold=False):
    """Plain K2 and K11: x (N, T, C) point tokens, kv (T, V, 2C) projected
    virtual keys|values -> (N, T, C) in x.dtype."""
    N, T, C = x.shape
    V = kv.shape[1]
    x32 = x.to(F32).reshape(N * T, C)
    hq, sr = quant_rows(ln_rows(x32, eps, bf16_ln))
    q = qlinear_plain(hq, sr, w.q).to(kv.dtype)  # q cast to the kv dtype
    q = q.reshape(N, T, num_heads, dim_head).permute(1, 2, 0, 3)  # (T, h, N, d)
    k, v = (t.reshape(T, V, num_heads, dim_head).transpose(1, 2) for t in kv.split(C, dim=-1))
    a = _attend(q, k, v, dim_head**-0.5, kv.dtype).permute(2, 0, 1, 3).reshape(N * T, C)
    return _mlp_tail_plain(a, x32, w, eps, bf16_ln, gelu_fold).to(x.dtype).reshape(N, T, C)


def ln_dense_plain(x, lin: QLinear, eps=1e-6, ln=False, gamma=None, beta=None, residual=False,
                   bf16_ln=False):
    """Plain K10: [x +] ((ln(x) [* gamma + beta]) @ W + b), W8A8; x (..., C)
    -> (..., N) in x.dtype. The affine applies with or without the LN, the
    residual after the bias (_dense_kernel)."""
    C = x.shape[-1]
    x32 = x.to(F32).reshape(-1, C)
    h = ln_rows(x32, eps, bf16_ln) if ln else x32
    if gamma is not None:
        h = h * gamma.to(F32) + beta.to(F32)
    hq, sr = quant_rows(h)
    y = qlinear_plain(hq, sr, lin)
    if residual:
        y = y + x32
    return y.to(x.dtype).reshape(*x.shape[:-1], lin.w.shape[0])


def ln_mlp_plain(x, fc1: QLinear, fc2: QLinear, eps=1e-6, ln=True, bf16_ln=False,
                 gelu_fold=False):
    """Plain K12: x + fc2(gelu(fc1(ln(x)))), W8A8; x (..., C) -> (..., C) in
    x.dtype (_mlp_kernel: x32 + (y * (s_row * s_w) + b2))."""
    C = x.shape[-1]
    x32 = x.to(F32).reshape(-1, C)
    hq, s0 = quant_rows(ln_rows(x32, eps, bf16_ln) if ln else x32)
    uq, s1 = quant_gelu(qlinear_plain(hq, s0, fc1), gelu_fold)
    return (x32 + qlinear_plain(uq, s1, fc2)).to(x.dtype).reshape(x.shape)


# ------------------------------------------------------------ CUDA chains

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_fns = {}


def _lib():
    """ctypes functions of csrc/int8_blocks.cu (shared with attention_cuda),
    csrc/int8_time_block.cu, csrc/int8_fused.cu and csrc/int8_mlp_cluster.cu."""
    if not _fns:
        lib = _build.load("int8_blocks")
        _fns["ln_quant"] = _build.bind(lib, "ct_ln_quant", _P, _I, _I, _I, _P, _P, _F, _I, _I, _P,
                                       _P, _P)
        _fns["gemm"] = _build.bind(lib, "ct_gemm_s8", _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I,
                                   _I, _I, _P)
        _fns["time_attn"] = _build.bind(lib, "ct_time_attention", _P, _I, _P, _I, _I, _I, _I, _F, _P)
        _fns["p2v_attn"] = _build.bind(lib, "ct_p2v_attention", _P, _P, _I, _P, _I, _I, _I, _I, _I,
                                       _F, _P)
        _fns["v2p_flash"] = _build.bind(lib, "ct_v2p_flash", _P, _P, _P, _I, _P, _P, _I, _I, _I,
                                        _I, _I, _I, _F, _P)
        _fns["k8"] = _build.bind(lib, "ct_k8_ln_qkv", _P, _I, _I, _I, _P, _P, _P, _F, _I, _P, _P,
                                 _P)
        _fns["k9"] = _build.bind(lib, "ct_k9_attnout_mlp", _P, _P, _I, _I, _I, _P, _P, _P, _P,
                                 _P, _P, _P, _P, _P, _F, _I, _I, _P, _P)
        k1 = _build.load("int8_time_block")
        _fns["k1"] = _build.bind(k1, "ct_k1_time_block", _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                 *([_P] * 12), _F, _F, _I, _I, _P, _P, _P, _P)
        _fns["k1_smem"] = _build.bind(k1, "ct_k1_smem", _I, _I, _I)
        _fns["k1_gelu_check"] = _build.bind(k1, "ct_k1_gelu_check", _P, _P, _P)
        _fns["k2"] = _build.bind(k1, "ct_k2_space_block", _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 *([_P] * 12), _F, _F, _I, _I, _P, _P, _P, _P)
        _fns["k2_smem"] = _build.bind(k1, "ct_k2_smem", _I)
        _fns["k8_stream"] = _build.bind(k1, "ct_k8_stream", _P, _I, _I, _P, _P, _P, _F, _I, _I,
                                        _P, _P, _P)
        _fns["k8_smem"] = _build.bind(k1, "ct_k8_smem")
        _fns["k9_tail"] = _build.bind(k1, "ct_k9_tail", _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                                      _P, _P, _P, _P, _F, _I, _I, _P, _P)
        _fns["k11"] = _build.bind(k1, "ct_k11_space_block", _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                  *([_P] * 12), _F, _F, _I, _I, _P, _P, _P, _P)
        fused = _build.load("int8_fused")
        _fns["k10"] = _build.bind(fused, "ct_k10_ln_dense", _P, _I, _I, _I, _I, _P, _P, _P, _P,
                                  _P, _F, _I, _I, _I, _P, _P)
        _fns["k12_first"] = _build.bind(fused, "ct_k12_ln_mlp", _P, _I, _I, _I, _I, _I, _P, _P,
                                        _P, _P, _P, _P, _F, _I, _I, _P, _P)
        k12 = _build.load("int8_mlp_cluster")
        _fns["k12"] = _build.bind(k12, "ct_k12_cluster", _P, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                                  _P, _P, _F, _I, _I, _I, _P, _P)
        _fns["k12_smem"] = _build.bind(k12, "ct_k12_smem")
        _fns["k12_max_clusters"] = _build.bind(k12, "ct_k12_max_clusters")
    return _fns


def _is_bf16(t) -> int:
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel tensors must be float32 or bfloat16, got {t.dtype}")
    return int(t.dtype == torch.bfloat16)


LN_BF16, GELU_FOLD = 1, 2  # ct_ln_quant's mode bits: the two variants


def ln_quant_cuda(x2d, eps=1e-6, ln=True, gamma=None, beta=None, mode=0):
    """(rows, C) float32|bf16 -> (int8 codes, f32 row scales (rows,)).
    mode: LN_BF16 | GELU_FOLD bits (GELU_FOLD quantizes gelu(x) with the
    fold's scale)."""
    rows, C = x2d.shape
    q = torch.empty((rows, C), dtype=torch.int8, device=x2d.device)
    s = torch.empty((rows,), dtype=F32, device=x2d.device)
    _build.check(_lib()["ln_quant"](
        _build.ptr(x2d), _is_bf16(x2d), rows, C, _build.ptr(gamma), _build.ptr(beta), eps,
        int(ln), mode, _build.ptr(q), _build.ptr(s), _build.stream_ptr(x2d)), "ct_ln_quant")
    return q, s


def gemm_cuda(a8, sa, lin: QLinear, mode, out_dtype, res=None):
    """epilogue(a8 . lin.w^T) with row scales sa; see csrc/int8_blocks.cu."""
    M, K = a8.shape
    N = lin.w.shape[0]
    out = torch.empty((M, N), dtype=out_dtype, device=a8.device)
    res_bf16 = 0 if res is None else _is_bf16(res)
    _build.check(_lib()["gemm"](
        _build.ptr(a8), _build.ptr(sa), _build.ptr(lin.w), _build.ptr(lin.s), _build.ptr(lin.b),
        _build.ptr(res), res_bf16, _build.ptr(out), _is_bf16(out), M, N, K, mode,
        _build.stream_ptr(a8)), "ct_gemm_s8")
    return out


def _mlp_tail_cuda(a32, x2d, w, eps, out_dtype, bf16_ln, gelu_fold):
    aq, sa = ln_quant_cuda(a32, ln=False)
    r = gemm_cuda(aq, sa, w.out, MODE_RESID, F32, res=x2d)
    hq, sr0 = ln_quant_cuda(r, eps, mode=LN_BF16 * bf16_ln)
    if gelu_fold:  # fc1 stays pre-GELU; the fold applies GELU as it quantizes
        u = gemm_cuda(hq, sr0, w.fc1, MODE_AFFINE, F32)
        uq, sr1 = ln_quant_cuda(u, ln=False, mode=GELU_FOLD)
    else:
        u = gemm_cuda(hq, sr0, w.fc1, MODE_GELU, F32)
        uq, sr1 = ln_quant_cuda(u, ln=False)
    return gemm_cuda(uq, sr1, w.fc2, MODE_RESID, out_dtype, res=r)


MAX_KEYS = 512  # frames (K1) or virtual tokens (K2) staged per block on chip
ALLT_MAX_V = 128  # virtual tokens K11 takes (the JAX body stages them per frame)


def _sms(device) -> int:
    """The card's SM count (the persistent kernels' block counts)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_cuda(*tensors, keys):
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"kernel inputs must all be CUDA tensors, got {t.device}")
    if keys > MAX_KEYS:
        raise ValueError(f"the attention core stages at most {MAX_KEYS} keys, got {keys}")


class K1Plan(NamedTuple):
    """The tiling of K1's two launches (csrc/int8_time_block.cu) for M
    tracks of T frames: `nc` 1 is the tile route (a front block holds
    `tracks` = 64 // T whole tracks in 64 rows, one 64-key chunk), 2 and 0
    the track route (one track a block, its rows padded to `rows_pad`, the
    time core's key chunks in registers (2) or in two passes (0)); shared
    memory of the front and the tail in bytes."""

    nc: int
    tracks: int
    rows_pad: int
    front_smem: int
    tail_smem: int
    front_blocks: int
    tail_blocks: int


K1_MAX_T = 256  # frames of one track the bf16 front holds on chip
# int8_time_block.cu's kGeluNegBound: |gelu_tanh(x)| stays under it for every
# f32 x < 0 (the card test runs ct_k1_gelu_check over every f32)
GELU_NEG_BOUND = 0.1701
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on an H100
_LDA_C = 384 + 16


def _ring_bytes(NW, NI, BK, STAGES):
    """RingGemm<MW, NW, MI, NI, BK, STAGES>::kRingBytes: STAGES buffers of
    BN = NW * NI * 8 weight rows of BK + 16 bytes."""
    return STAGES * (NW * NI * 8) * (BK + 16)


# int8_time_block.cu's rings, by their template parameters (the plan test
# reads them back from the source): FrontTileGemm = RingGemm<2, 4, 2, 9, 64,
# 3>, FrontTrackGemm = RingGemm<4, 2, 1, 9, 64, 4>; the tail's Stream:
# K1T_SLOTS slots of K1T_SLOT bytes, one full and one empty mbarrier each
K1_FRONT_TILE_RING = _ring_bytes(NW=4, NI=9, BK=64, STAGES=3)
K1_FRONT_TRACK_RING = _ring_bytes(NW=2, NI=9, BK=64, STAGES=4)
K1T_SLOTS, K1T_SLOT = 5, 384 * (32 + 16)


def k1_plan(M: int, T: int) -> K1Plan:
    """K1's tiling for M tracks of T frames in bfloat16 (the arithmetic of
    k1_front_smem / K1_TAIL_SMEM in csrc/int8_time_block.cu)."""
    if not 1 <= T <= K1_MAX_T or M < 1:
        raise ValueError(f"K1 in bfloat16 takes 1..{K1_MAX_T} frames (the frame gate sends at "
                         f"most 192), got M={M}, T={T}")
    if T <= 64:
        nc, tracks, rows_pad = 1, 64 // T, 64
    else:
        nc, tracks, rows_pad = (2 if T <= 128 else 0), 1, -(-T // 64) * 64
    tile = nc == 1
    front = (rows_pad * _LDA_C + rows_pad * 4 * (1 if tile else 3)
             + 3 * (2 if tile else 1) * rows_pad * 48 * 2
             + (K1_FRONT_TILE_RING + rows_pad * (384 + 4) * 4 if tile else K1_FRONT_TRACK_RING))
    tail = (64 * (384 + 8) * 4 + 64 * _LDA_C + 64 * (128 + 16) + K1T_SLOTS * K1T_SLOT
            + 5 * 64 * 4 + 2 * K1T_SLOTS * 8 + 16)
    return K1Plan(nc, tracks, rows_pad, front, tail, -(-M // tracks), -(-M * T // 64))


def _time_block_chain(x, w: TimeBlockWeights, num_heads, dim_head, eps, bf16_ln, gelu_fold):
    """K1 as the launch chain of csrc/int8_blocks.cu: the route of float32
    tokens (the fused front's bf16 time core does not take f32 operands)."""
    M, T, C = x.shape
    _check_cuda(x, w.qkv.w, keys=T)
    x2d = x.contiguous().reshape(M * T, C)
    hq, sr = ln_quant_cuda(x2d, eps, mode=LN_BF16 * bf16_ln)
    qkv = gemm_cuda(hq, sr, w.qkv, MODE_AFFINE, x.dtype)
    a = torch.empty((M * T, C), dtype=F32, device=x.device)
    _build.check(_lib()["time_attn"](
        _build.ptr(qkv), _is_bf16(qkv), _build.ptr(a), M, T, num_heads, dim_head,
        dim_head**-0.5, _build.stream_ptr(x)), "ct_time_attention")
    return _mlp_tail_cuda(a, x2d, w, eps, x.dtype, bf16_ln, gelu_fold).reshape(M, T, C)


def _time_block_fused(x, w: TimeBlockWeights, num_heads, dim_head, eps, bf16_ln, gelu_fold):
    """K1 in bfloat16: the two launches of ct_k1_time_block on k1_plan's
    tiling; a's int8 codes and row scales pass between them through device
    memory."""
    M, T, C = x.shape
    _check_cuda(x, w.qkv.w, keys=0)
    if C != SPLIT_C or num_heads * dim_head != C or tuple(w.fc1.w.shape) != (SPLIT_H, C):
        raise ValueError(f"K1 takes C={SPLIT_C}, hidden {SPLIT_H}, got x {tuple(x.shape)}, "
                         f"fc1 {tuple(w.fc1.w.shape)}")
    plan = k1_plan(M, T)
    x = x.contiguous()
    acode = torch.empty((M * T, C), dtype=torch.int8, device=x.device)
    ascale = torch.empty((M * T,), dtype=F32, device=x.device)
    out = torch.empty_like(x)
    ptrs = [_build.ptr(t) for lin in w for t in lin]
    _build.check(_lib()["k1"](
        _build.ptr(x), M, T, C, num_heads, dim_head, plan.nc, plan.tracks, plan.rows_pad, *ptrs,
        eps, dim_head**-0.5, int(bf16_ln), int(gelu_fold), _build.ptr(acode),
        _build.ptr(ascale), _build.ptr(out), _build.stream_ptr(x)), "ct_k1_time_block")
    return out


class K2Plan(NamedTuple):
    """K2's route for N tracks x T frames over V virtual tokens: "fused"
    (bfloat16 tokens and keys, V <= K2_MAX_V: csrc/int8_time_block.cu's
    front on `blocks` blocks, each a run of the `tiles` 64-track tiles of
    one frame after another, then K1's tail on `tail_blocks` 64-row tiles)
    or "chain" (float32, or more virtual tokens than the front stages: the
    launch chain of csrc/int8_blocks.cu); shared memory of the front and
    the tail in bytes (0 on the chain)."""

    route: str
    tiles: int = 0
    blocks: int = 0
    front_smem: int = 0
    tail_smem: int = 0
    tail_blocks: int = 0


K2_MAX_V = 64  # virtual tokens K2's front stages per frame (one key chunk)
# int8_time_block.cu's K2QGemm = RingGemm<2, 4, 2, 3, 64, 4> (the plan test
# reads it back from the source) and K2's front's shared memory: the frame's
# keys and values, the tile's x rows, its codes, a head pair's q, the ring,
# three row vectors and the x rows' mbarrier
K2_Q_RING = _ring_bytes(NW=4, NI=3, BK=64, STAGES=4)
K2_FRONT_SMEM = (2 * 8 * K2_MAX_V * 48 * 2 + 64 * 384 * 2 + 64 * _LDA_C + 2 * 64 * 48 * 2
                 + K2_Q_RING + 3 * 64 * 4 + 16)


def k2_plan(N: int, T: int, V: int, dtype, kv_dtype=None, sms: int = 132) -> K2Plan:
    """K2's route and tiling on a card of `sms` SMs (one front block an SM;
    the arithmetic of K2_FRONT_SMEM / K1_TAIL_SMEM in
    csrc/int8_time_block.cu)."""
    if N < 1 or T < 1 or V < 1:
        raise ValueError(f"K2 takes N, T, V >= 1, got N={N}, T={T}, V={V}")
    if dtype not in (F32, torch.bfloat16):
        raise TypeError(f"K2 takes float32 or bfloat16 tokens, got {dtype}")
    if dtype != torch.bfloat16 or (kv_dtype or dtype) != dtype or V > K2_MAX_V:
        return K2Plan("chain")
    tiles = -(-N // 64) * T
    return K2Plan("fused", tiles, min(tiles, sms), K2_FRONT_SMEM, k1_plan(1, 1).tail_smem,
                  -(-N * T // 64))


def _space_block_chain(x, kv, w: SpaceBlockWeights, num_heads, dim_head, eps, bf16_ln,
                       gelu_fold):
    """K2 as the launch chain of csrc/int8_blocks.cu: the route of float32
    tokens and of more virtual tokens than the fused front stages."""
    N, T, C = x.shape
    V = kv.shape[1]
    _check_cuda(x, kv, w.q.w, keys=V)
    x2d = x.contiguous().reshape(N * T, C)
    kv = kv.contiguous()
    hq, sr = ln_quant_cuda(x2d, eps, mode=LN_BF16 * bf16_ln)
    q = gemm_cuda(hq, sr, w.q, MODE_AFFINE, kv.dtype)
    a = torch.empty((N * T, C), dtype=F32, device=x.device)
    _build.check(_lib()["p2v_attn"](
        _build.ptr(q), _build.ptr(kv), _is_bf16(kv), _build.ptr(a), N, T, V, num_heads,
        dim_head, dim_head**-0.5, _build.stream_ptr(x)), "ct_p2v_attention")
    return _mlp_tail_cuda(a, x2d, w, eps, x.dtype, bf16_ln, gelu_fold).reshape(N, T, C)


def _space_block_fused(x, kv, w: SpaceBlockWeights, num_heads, dim_head, eps, bf16_ln,
                       gelu_fold, plan: K2Plan, entry="k2"):
    """K2 in bfloat16: the two launches of ct_k2_space_block on `plan`; a's
    int8 codes and row scales pass between them through device memory.
    entry="k11": the same launches from ct_k11_space_block, whose front
    runs under K11's kernel name."""
    N, T, C = x.shape
    V = kv.shape[1]
    if C != SPLIT_C or num_heads * dim_head != C or tuple(kv.shape) != (T, V, 2 * C) \
            or tuple(w.fc1.w.shape) != (SPLIT_H, C):
        raise ValueError(f"K2 takes C={SPLIT_C}, hidden {SPLIT_H}, kv (T, V, 2C); got x "
                         f"{tuple(x.shape)}, kv {tuple(kv.shape)}, fc1 {tuple(w.fc1.w.shape)}")
    x, kv = x.contiguous(), kv.contiguous()
    acode = torch.empty((N * T, C), dtype=torch.int8, device=x.device)
    ascale = torch.empty((N * T,), dtype=F32, device=x.device)
    out = torch.empty_like(x)
    ptrs = [_build.ptr(t) for lin in w for t in lin]
    _build.check(_lib()[entry](
        _build.ptr(x), _build.ptr(kv), N, T, V, C, num_heads, dim_head, plan.blocks, *ptrs, eps,
        dim_head**-0.5, int(bf16_ln), int(gelu_fold), _build.ptr(acode), _build.ptr(ascale),
        _build.ptr(out), _build.stream_ptr(x)), {"k2": "ct_k2_space_block",
                                                 "k11": "ct_k11_space_block"}[entry])
    return out


def fused_time_block_int8(x, w: TimeBlockWeights, num_heads, dim_head, eps=1e-6, bf16_ln=False,
                          gelu_fold=False):
    """K1: the whole pre-norm time-attention block, per track over T:

        q, kv = to_q(ln(x)), to_kv(ln(x)); a = attention over T
        r = x + to_out(a); return r + fc2(gelu(fc1(ln(r))))

    x (M, T, C) float32 or bfloat16 -> (M, T, C) in x.dtype. On the card,
    bfloat16 takes the two launches of ct_k1_time_block (k1_plan's tiling,
    up to K1_MAX_T frames), float32 the launch chain."""
    if x.device.type == "cpu":
        return time_block_plain(x, w, num_heads, dim_head, eps, bf16_ln, gelu_fold)
    if x.dtype == torch.bfloat16:
        out = _time_block_fused(x, w, num_heads, dim_head, eps, bf16_ln, gelu_fold)
    else:
        _is_bf16(x)
        out = _time_block_chain(x, w, num_heads, dim_head, eps, bf16_ln, gelu_fold)
    fused_time_block_int8.launches += 1
    return out


fused_time_block_int8.launches = 0


def fused_space_block_int8(x, kv, w: SpaceBlockWeights, num_heads, dim_head, eps=1e-6,
                           bf16_ln=False, gelu_fold=False):
    """K2: the whole points<-virtual block, per (track, frame):

        q = to_q(ln(x)); a = attention over that frame's V virtual keys|values
        r = x + to_out(a); return r + fc2(gelu(fc1(ln(r))))

    x (N, T, C) point tokens; kv (T, V, 2C) -> (N, T, C) in x.dtype. On the
    card, k2_plan's route: bfloat16 with up to K2_MAX_V virtual tokens the
    two launches of ct_k2_space_block, else the launch chain."""
    if x.device.type == "cpu":
        return space_block_plain(x, kv, w, num_heads, dim_head, eps, bf16_ln, gelu_fold)
    N, T, _ = x.shape
    _check_cuda(x, kv, w.q.w, keys=kv.shape[1])
    plan = k2_plan(N, T, kv.shape[1], x.dtype, kv.dtype, _sms(x.device))
    if plan.route == "fused":
        out = _space_block_fused(x, kv, w, num_heads, dim_head, eps, bf16_ln, gelu_fold, plan)
    else:
        out = _space_block_chain(x, kv, w, num_heads, dim_head, eps, bf16_ln, gelu_fold)
    fused_space_block_int8.launches += 1
    return out


fused_space_block_int8.launches = 0


def fused_space_block_allt_int8(x, kv, w: SpaceBlockWeights, num_heads, dim_head, eps=1e-6,
                                bf16_ln=False, gelu_fold=False):
    """K11: K2's function (space_block_plain) for the `space_allt` variant.
    The JAX body tiles 64 tracks x all T frames for the TPU's matrix unit;
    the function is K2's row for row, so on the card K11 takes K2's route
    (k2_plan): bfloat16 with up to K2_MAX_V virtual tokens K2's two
    launches (ct_k11_space_block: the front under K11's kernel name), else
    K2's launch chain. x (N, T, C) and kv (T, V, 2C) of one dtype, C = 384,
    V <= 128. The model takes it where gates.space_allt_tile(N, T, bf16)
    holds."""
    if x.device.type == "cpu":
        return space_block_plain(x, kv, w, num_heads, dim_head, eps, bf16_ln, gelu_fold)
    N, T, C = x.shape
    V = kv.shape[1]
    _check_cuda(x, kv, w.q.w, keys=0)
    if C != SPLIT_C or num_heads * dim_head != C or tuple(kv.shape) != (T, V, 2 * C) \
            or kv.dtype != x.dtype or V > ALLT_MAX_V:
        raise ValueError(f"K11 takes C={SPLIT_C}, kv (T, V <= {ALLT_MAX_V}, 2C) in x's dtype; got "
                         f"x {tuple(x.shape)} {x.dtype}, kv {tuple(kv.shape)} {kv.dtype}")
    plan = k2_plan(N, T, V, x.dtype, kv.dtype, _sms(x.device))
    if plan.route == "fused":
        out = _space_block_fused(x, kv, w, num_heads, dim_head, eps, bf16_ln, gelu_fold, plan,
                                 entry="k11")
    else:
        out = _space_block_chain(x, kv, w, num_heads, dim_head, eps, bf16_ln, gelu_fold)
    fused_space_block_allt_int8.launches += 1
    return out


fused_space_block_allt_int8.launches = 0


SPLIT_C, SPLIT_H = 384, 1536  # the widths K8-K12 are built for


class K8Plan(NamedTuple):
    """K8's body and tiling for `rows` token rows: "stream" (bfloat16:
    csrc/int8_time_block.cu's k8_ln_qkv_kernel, `blocks` persistent blocks,
    one an SM, each a contiguous run of the `tiles` 128-row tiles; `smem`
    bytes a block) or "tile" (float32: the PR 4 body of csrc/int8_blocks.cu,
    one block a 128-row tile)."""

    route: str
    tiles: int
    blocks: int
    smem: int


# int8_time_block.cu's row tile, weight-stream slots and x rows in flight a
# LayerNorm warp (8 of them)
K8_BM, K8_SLOTS, K8_XBUF = 128, 4, 3
# two code buffers, the slots, the LayerNorm warps' x rows, two row-scale
# buffers, the weight scales and biases, the mbarriers (full and empty a
# slot, full and empty a code buffer)
K8_SMEM = (2 * K8_BM * _LDA_C + K8_SLOTS * K1T_SLOT + 8 * K8_XBUF * 384 * 2 + 2 * K8_BM * 4
           + 2 * 3 * 384 * 4 + (2 * K8_SLOTS + 4) * 8)


def k8_plan(rows: int, dtype, sms: int = 132) -> K8Plan:
    """K8's route and tiling on a card of `sms` SMs."""
    if rows < 1:
        raise ValueError(f"K8 takes at least one row, got {rows}")
    tiles = -(-rows // K8_BM)
    if dtype == torch.bfloat16:
        return K8Plan("stream", tiles, min(tiles, sms), K8_SMEM)
    if dtype == F32:
        return K8Plan("tile", tiles, tiles, 0)
    raise TypeError(f"K8 takes float32 or bfloat16 tokens, got {dtype}")


def _ln_qkv_tile(x2d, wqkv: QLinear, eps, bf16_ln):
    """K8's PR 4 body (ct_k8_ln_qkv: one block a 128-row tile, the weights
    staged by plain loads), the route of float32 tokens; in bfloat16 the
    yardstick the streamed body is held to bit for bit."""
    rows, C = x2d.shape
    q = torch.empty((rows, C), dtype=x2d.dtype, device=x2d.device)
    kv = torch.empty((rows, 2 * C), dtype=x2d.dtype, device=x2d.device)
    _build.check(_lib()["k8"](
        _build.ptr(x2d), _is_bf16(x2d), rows, C, _build.ptr(wqkv.w), _build.ptr(wqkv.s),
        _build.ptr(wqkv.b), eps, int(bf16_ln), _build.ptr(q), _build.ptr(kv),
        _build.stream_ptr(x2d)), "ct_k8_ln_qkv")
    return q, kv


def _ln_qkv_stream(x2d, wqkv: QLinear, eps, bf16_ln, plan: K8Plan):
    """K8 in bfloat16: ct_k8_stream on `plan`'s blocks."""
    rows, C = x2d.shape
    if x2d.data_ptr() % 16:
        raise ValueError("K8 copies x's rows in 16-byte pieces: its data must be 16-byte aligned")
    q = torch.empty((rows, C), dtype=x2d.dtype, device=x2d.device)
    kv = torch.empty((rows, 2 * C), dtype=x2d.dtype, device=x2d.device)
    _build.check(_lib()["k8_stream"](
        _build.ptr(x2d), rows, C, _build.ptr(wqkv.w), _build.ptr(wqkv.s), _build.ptr(wqkv.b), eps,
        int(bf16_ln), plan.blocks, _build.ptr(q), _build.ptr(kv), _build.stream_ptr(x2d)),
        "ct_k8_stream")
    return q, kv


def fused_ln_qkv_int8(x, wqkv: QLinear, eps=1e-6, bf16_ln=False):
    """K8: the pre-norm attention entry, one LayerNorm and one row
    quantization feeding both projections:

        h = quant(ln(x)); q, kv = to_q(h), to_kv(h)

    x (..., C) float32 or bfloat16; wqkv the stacked [to_q; to_kv] (3C, C)
    (TimeBlockWeights.qkv). Returns (q (..., C), kv (..., 2C)) in x.dtype.
    One launch; the body is k8_plan(rows, x.dtype)'s."""
    if x.device.type == "cpu":
        return ln_qkv_plain(x, wqkv, eps, bf16_ln)
    C = x.shape[-1]
    _check_cuda(x, wqkv.w, keys=0)
    if C != SPLIT_C or tuple(wqkv.w.shape) != (3 * C, C):
        raise ValueError(f"K8 takes C={SPLIT_C} and (3C, C) weights, got x {tuple(x.shape)}, "
                         f"w {tuple(wqkv.w.shape)}")
    x2d = x.contiguous().reshape(-1, C)
    plan = k8_plan(x2d.shape[0], x.dtype, _sms(x.device))
    if plan.route == "stream":
        q, kv = _ln_qkv_stream(x2d, wqkv, eps, bf16_ln, plan)
    else:
        q, kv = _ln_qkv_tile(x2d, wqkv, eps, bf16_ln)
    fused_ln_qkv_int8.launches += 1
    lead = x.shape[:-1]
    return q.reshape(*lead, C), kv.reshape(*lead, 2 * C)


fused_ln_qkv_int8.launches = 0


def k9_route(dtype) -> str:
    """Which body K9 runs for tokens of `dtype` on the card: "tail" (bfloat16:
    K1's streamed tail in csrc/int8_time_block.cu with K9's prologue, which
    quantizes a in the tile, and K9's last residual r + (y + b2)) or "tile"
    (float32: the 64-row tile body of csrc/int8_blocks.cu)."""
    if dtype == torch.bfloat16:
        return "tail"
    if dtype == torch.float32:
        return "tile"
    raise TypeError(f"K9 takes float32 or bfloat16 tokens, got {dtype}")


def fused_attnout_res_mlp_int8(a, x, w: TimeBlockWeights, eps=1e-6, bf16_ln=False,
                               gelu_fold=False):
    """K9: the post-attention half of a pre-norm block:

        r = x + to_out(a); return r + fc2(gelu(fc1(ln(r)))), all W8A8

    a (..., C) the attention-core output and x (..., C) the residual stream,
    both in the token dtype (float32 or bfloat16); w the block's pack (its
    out, fc1, fc2). Returns (..., C) in x.dtype. One launch; the body is
    k9_route(x.dtype)'s."""
    if x.device.type == "cpu":
        return attnout_mlp_plain(a, x, w, eps, bf16_ln, gelu_fold)
    C = x.shape[-1]
    _check_cuda(a, x, w.out.w, keys=0)
    if a.shape != x.shape or a.dtype != x.dtype:
        raise ValueError(f"a {tuple(a.shape)} {a.dtype} and x {tuple(x.shape)} {x.dtype} "
                         "must match")
    if C != SPLIT_C or tuple(w.fc1.w.shape) != (SPLIT_H, C):
        raise ValueError(f"K9 takes C={SPLIT_C}, hidden {SPLIT_H}, got x {tuple(x.shape)}, "
                         f"fc1 {tuple(w.fc1.w.shape)}")
    a2d, x2d = a.contiguous().reshape(-1, C), x.contiguous().reshape(-1, C)
    out = torch.empty_like(x2d)
    ptrs = [_build.ptr(t) for lin in (w.out, w.fc1, w.fc2) for t in lin]
    key, name = {"tail": ("k9_tail", "ct_k9_tail"),
                 "tile": ("k9", "ct_k9_attnout_mlp")}[k9_route(x.dtype)]
    _build.check(_lib()[key](
        _build.ptr(a2d), _build.ptr(x2d), x2d.shape[0], C, SPLIT_H, *ptrs, eps, int(bf16_ln),
        int(gelu_fold), _build.ptr(out), _build.stream_ptr(x)), name)
    fused_attnout_res_mlp_int8.launches += 1
    return out.reshape(x.shape)


fused_attnout_res_mlp_int8.launches = 0


def _rows_tile(x, *widths) -> bool:
    """The JAX wrappers' shape gates: lane-aligned widths and a row count
    that _pick_tile can tile (a multiple of 8)."""
    rows = x.numel() // x.shape[-1]
    return all(n % 128 == 0 for n in widths) and rows % 8 == 0


def fused_ln_dense_int8(x, lin: QLinear, eps=1e-6, ln=False, gamma=None, beta=None,
                        residual=False, bf16_ln=False):
    """K10: [x +] ((ln(x) [* gamma + beta]) @ W + b) with W8A8, one pass:

    x (..., C) float32 or bfloat16; lin the quantized (N, C) weight. Returns
    (..., N) in x.dtype, or None where the JAX wrapper returns None: C or N
    not a multiple of 128, residual with N != C, or a row count that is not
    a multiple of 8."""
    C, N = x.shape[-1], lin.w.shape[0]
    if not _rows_tile(x, C, N) or (residual and N != C):
        return None
    if x.device.type == "cpu":
        return ln_dense_plain(x, lin, eps, ln, gamma, beta, residual, bf16_ln)
    _check_cuda(x, lin.w, keys=0)
    if C != SPLIT_C or (gamma is None) != (beta is None):
        raise ValueError(f"K10 takes C={SPLIT_C} and gamma with beta, got x {tuple(x.shape)}")
    x2d = x.contiguous().reshape(-1, C)
    rows = x2d.shape[0]
    g = None if gamma is None else gamma.detach().to(F32).contiguous()
    b = None if beta is None else beta.detach().to(F32).contiguous()
    out = torch.empty((rows, N), dtype=x.dtype, device=x.device)
    _build.check(_lib()["k10"](
        _build.ptr(x2d), _is_bf16(x2d), rows, C, N, _build.ptr(lin.w), _build.ptr(lin.s),
        _build.ptr(lin.b), _build.ptr(g), _build.ptr(b), eps, int(ln), int(residual),
        int(bf16_ln), _build.ptr(out), _build.stream_ptr(x)), "ct_k10_ln_dense")
    fused_ln_dense_int8.launches += 1
    return out.reshape(*x.shape[:-1], N)


fused_ln_dense_int8.launches = 0


class K12Plan(NamedTuple):
    """K12's tiling for `rows` token rows (csrc/int8_mlp_cluster.cu):
    `clusters` persistent clusters of K12_CLUSTER blocks (`blocks` in all),
    cluster c taking the 64-row tiles c, c + clusters, ... of the `tiles`;
    `smem` bytes a block."""

    tiles: int
    clusters: int
    blocks: int
    smem: int


# int8_mlp_cluster.cu's constants (the plan test reads them back from the
# source): 8 blocks a cluster, 64-row tiles; a block's shared memory holds
# its w1 rows (192 x (384 + 16)), its w2 rows (48 x (1,536 + 16)), the
# tile's codes A (64 x (384 + 16)), its own GELU codes and two buffers of a
# peer's (3 x 64 x (192 + 16)), the warps' x rows (8 x 384 f32), its
# scales and biases and four row vectors, and the weights' mbarrier
K12_CLUSTER, K12_BM = 8, 64
K12_SMEM = (192 * (384 + 16) + 48 * (1536 + 16) + 64 * _LDA_C + 3 * 64 * (192 + 16)
            + 8 * 384 * 4 + (2 * 192 + 2 * 48 + 4 * 64) * 4 + 16)


def k12_plan(rows: int, max_clusters: int) -> K12Plan:
    """K12's tiling for `rows` rows on a card that seats `max_clusters`
    8-block clusters at once (ct_k12_max_clusters: one block an SM, a
    cluster within one GPC)."""
    if rows < 1:
        raise ValueError(f"K12 takes at least one row, got {rows}")
    if max_clusters < 1:
        raise RuntimeError(f"K12: the card seats no {K12_CLUSTER}-block cluster of "
                           f"{K12_SMEM} bytes a block (max active clusters {max_clusters})")
    tiles = -(-rows // K12_BM)
    clusters = min(tiles, max_clusters)
    return K12Plan(tiles, clusters, K12_CLUSTER * clusters, K12_SMEM)


def k12_tiles(plan: K12Plan, cluster: int) -> range:
    """The 64-row tiles cluster `cluster` of `plan` takes, in order."""
    return range(cluster, plan.tiles, plan.clusters)


_k12_clusters = {}


def _k12_max_clusters(device) -> int:
    """ct_k12_max_clusters on `device`, asked once per device."""
    key = torch.device(device).index or 0
    if key not in _k12_clusters:
        with torch.cuda.device(device):
            n = _lib()["k12_max_clusters"]()
        if n < 0:
            raise RuntimeError(f"ct_k12_max_clusters failed with cudaError_t {-n}")
        _k12_clusters[key] = n
    return _k12_clusters[key]


def _ln_mlp_first(x2d, fc1: QLinear, fc2: QLinear, eps, ln, bf16_ln, gelu_fold):
    """K12's first body (ct_k12_ln_mlp: one block a 64-row tile, the
    weights staged by plain loads, fc1 twice): the yardstick the cluster
    body is held to bit for bit; no path calls it."""
    out = torch.empty_like(x2d)
    ptrs = [_build.ptr(t) for lin in (fc1, fc2) for t in lin]
    _build.check(_lib()["k12_first"](
        _build.ptr(x2d), _is_bf16(x2d), x2d.shape[0], x2d.shape[1], fc1.w.shape[0], int(ln),
        *ptrs, eps, int(bf16_ln), int(gelu_fold), _build.ptr(out), _build.stream_ptr(x2d)),
        "ct_k12_ln_mlp")
    return out


def _ln_mlp_cluster(x2d, fc1: QLinear, fc2: QLinear, eps, ln, bf16_ln, gelu_fold, plan: K12Plan):
    """K12: ct_k12_cluster on `plan`'s clusters."""
    params = [t for lin in (fc1, fc2) for t in lin]
    if any(t.data_ptr() % 16 for t in (x2d, *params)):
        raise ValueError("K12 copies x, its weights, scales and biases in 16-byte pieces: their "
                         "data must be 16-byte aligned")
    out = torch.empty_like(x2d)
    _build.check(_lib()["k12"](
        _build.ptr(x2d), _is_bf16(x2d), x2d.shape[0], x2d.shape[1], fc1.w.shape[0], int(ln),
        *map(_build.ptr, params), eps, int(bf16_ln), int(gelu_fold), plan.clusters,
        _build.ptr(out), _build.stream_ptr(x2d)), "ct_k12_cluster")
    return out


def fused_ln_mlp_int8(x, fc1: QLinear, fc2: QLinear, eps=1e-6, ln=True, bf16_ln=False,
                      gelu_fold=False):
    """K12: x + fc2(gelu(fc1(ln(x)))) with W8A8, one pass (ln=False skips
    the LayerNorm). x (..., C) float32 or bfloat16; fc1 (H, C), fc2 (C, H)
    quantized. Returns (..., C) in x.dtype, or None where the JAX wrapper
    returns None: C or H not a multiple of 128, or a row count that is not a
    multiple of 8. One launch: k12_plan's clusters."""
    C, H = x.shape[-1], fc1.w.shape[0]
    if not _rows_tile(x, C, H):
        return None
    if x.device.type == "cpu":
        return ln_mlp_plain(x, fc1, fc2, eps, ln, bf16_ln, gelu_fold)
    _check_cuda(x, fc1.w, keys=0)
    if C != SPLIT_C or H != SPLIT_H or tuple(fc2.w.shape) != (C, H):
        raise ValueError(f"K12 takes C={SPLIT_C}, hidden {SPLIT_H}, got x {tuple(x.shape)}, "
                         f"fc1 {tuple(fc1.w.shape)}")
    x2d = x.contiguous().reshape(-1, C)
    plan = k12_plan(x2d.shape[0], _k12_max_clusters(x.device))
    out = _ln_mlp_cluster(x2d, fc1, fc2, eps, ln, bf16_ln, gelu_fold, plan)
    fused_ln_mlp_int8.launches += 1
    return out.reshape(x.shape)


fused_ln_mlp_int8.launches = 0
