"""The attention kernels: K3 (virtual<-points with the context norm and kv
projection fused, W8A8) and the three stand-alone attention cores K5 (time),
K6 (points<-virtual) and K7 (virtual<-points) on projections computed outside.

K3 replaces cotracker_tpu/ops/kernels/attention_pallas.py::_v2p_proj_kernel
(wrapper fused_virtual_from_points_proj). Per frame, the V virtual queries
attend over all N point tokens, whose keys|values are
to_kv(affine_layer_norm(x)) computed W8A8 (LN eps 1e-5, two-pass f32
statistics, per-row int8, per-channel int8 weights), rounded to the query
dtype, with an online (flash) softmax over the keys: running max from
-0.7 * finfo(f32).max, f32 row sums of the unrounded probabilities, P.V with
probabilities rounded to the value dtype and f32 accumulation.

On the H100 the chain is csrc/int8_blocks.cu: ct_ln_quant (affine) ->
ct_gemm_s8 (kv) -> ct_v2p_flash. What bounds it at the bench shape
(N=10,240, T=60): the s8 projection is ~0.36 TOP (~0.18 ms at 1,979 TOP/s)
and the point tokens are ~0.47 GB in bf16 (~0.14 ms at 3.35 TB/s), so
compute and bytes are of the same order; this first version writes the
projected kv (~0.94 GB) to device memory and reads it back in the flash
pass, which the fused form would avoid.

K5, K6 and K7 replace attention_pallas.py::_kernel, ::_p2v_kernel and
::_v2p_kernel (wrappers fused_time_attention, fused_points_from_virtual,
fused_virtual_from_points): the attention products alone, in the dtype of
the operands (bfloat16 on the card, float32 in the CPU tests), for the
configuration that runs the attention-core kernels without W8A8. Common
contract: heads of 48 read as lane slices of the unsplit K|V projection,
float32 logits and softmax, probabilities rounded to the value dtype before
P.V, float32 accumulation, one rounding to the query dtype. The kernels are
csrc/attention_cores.cu (see there for what bounds them and the design);
they take any number of rows, tracks and frames (K5 past 512 frames on its
long route) and up to 512 virtual tokens (K6), and the JAX package's shape
gates decide where the model runs them (models/blocks.py). In bf16, K7 and
K3's core split the keys into ranges (`v2p_splits`) whose f32 partials the
wrapper allocates and a second launch merges.

Each wrapper takes its plain PyTorch version for CPU tensors, and for CUDA
tensors launches its kernel or raises; `launches` counts the kernel runs.
"""

import ctypes
import math

import torch

from cotracker_tpu_torch.ops.kernels import _build, mlp_int8_cuda
from cotracker_tpu_torch.ops.kernels.mlp_int8_cuda import (
    F32, MAX_KEYS, MODE_AFFINE, QLinear, _attend, gemm_cuda, ln_quant_cuda, ln_rows,
    qlinear_plain, quant_rows,
)

NEG_BIG = -0.7 * torch.finfo(torch.float32).max


def v2p_proj_plain(q, x, wkv: QLinear, gamma, beta, num_heads, dim_head, key_bias, eps=1e-5):
    """Plain K3: q (T, V, C) projected virtual queries; x (N, T, C) raw point
    tokens; key_bias (N,) f32 additive mask -> (T, V, C) in q.dtype."""
    T, V, C = q.shape
    N = x.shape[0]
    h = ln_rows(x.to(F32).reshape(N * T, C), eps) * gamma.to(F32) + beta.to(F32)
    hq, sr = quant_rows(h)
    kv = qlinear_plain(hq, sr, wkv).to(q.dtype).reshape(N, T, 2 * C)
    return v2p_plain(q, kv, num_heads, dim_head, key_bias)


def _v2p_proj_cuda(q, x, wkv, gamma, beta, num_heads, dim_head, key_bias, eps):
    T, V, C = q.shape
    N = x.shape[0]
    if x.device.type != "cuda" or wkv.w.device.type != "cuda":
        raise ValueError("kernel inputs must all be CUDA tensors")
    x2d = x.contiguous().reshape(N * T, C)
    g = gamma.detach().to(F32).contiguous()
    b = beta.detach().to(F32).contiguous()
    hq, sr = ln_quant_cuda(x2d, eps, gamma=g, beta=b)
    kv = gemm_cuda(hq, sr, wkv, MODE_AFFINE, q.dtype)
    return _v2p_core(mlp_int8_cuda._lib()["v2p_flash"], "ct_v2p_flash", q.contiguous(), kv,
                     key_bias.to(F32).contiguous(), N, num_heads, dim_head)


def fused_virtual_from_points_proj(q, x, wkv: QLinear, gamma, beta, num_heads, dim_head,
                                   key_bias, eps=1e-5):
    """K3. q (T, V, C); x (N, T, C); wkv the quantized to_kv; gamma/beta the
    context norm; key_bias (N,) (0 = valid key, -0.7 * finfo.max = masked).
    Returns (T, V, C) in q.dtype."""
    if q.device.type == "cpu":
        return v2p_proj_plain(q, x, wkv, gamma, beta, num_heads, dim_head, key_bias, eps)
    out = _v2p_proj_cuda(q, x, wkv, gamma, beta, num_heads, dim_head, key_bias, eps)
    fused_virtual_from_points_proj.launches += 1
    return out


fused_virtual_from_points_proj.launches = 0


# ------------------------------------------------------------ K5, K6, K7

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_fns = {}


def _cores_lib():
    """ctypes functions of csrc/attention_cores.cu."""
    if not _fns:
        lib = _build.load("attention_cores")
        _fns["k5"] = _build.bind(lib, "ct_k5_time_attention", _P, _P, _I, _P, _I, _I, _I, _I, _F, _P)
        _fns["k6"] = _build.bind(lib, "ct_k6_points_from_virtual", _P, _P, _I, _P, _I, _I, _I, _I,
                                 _I, _F, _P)
        _fns["k7"] = _build.bind(lib, "ct_k7_virtual_from_points", _P, _P, _P, _I, _P, _P, _I, _I,
                                 _I, _I, _I, _I, _F, _P)
    return _fns


def _heads(t, num_heads, dim_head):
    """(..., L, H*D) -> (..., H, L, D)."""
    return t.reshape(*t.shape[:-1], num_heads, dim_head).transpose(-2, -3)


def _flash_plain(q, k, v, dim_head, bias=None):
    """The flash kernels' arithmetic on (..., H, L, D) operands: f32 logits
    (+ additive key bias), exp against the row max (never below NEG_BIG, the
    kernels' starting max), unnormalized probabilities rounded to v's dtype
    before P.V, f32 accumulation, f32 row sums of the unrounded
    probabilities. (K5 and K6 normalize before the rounding: `_attend`.)"""
    s = torch.einsum("...id,...jd->...ij", q.to(F32), k.to(F32)).mul_(dim_head**-0.5)
    if bias is not None:
        s.add_(bias.to(F32))
    p = s.sub_(s.amax(dim=-1, keepdim=True).clamp_min(NEG_BIG)).exp_()
    out = torch.einsum("...ij,...jd->...id", p.to(v.dtype).to(F32), v.to(F32))
    return out / p.sum(dim=-1, keepdim=True)


def time_attention_plain(q, kv, num_heads, dim_head):
    """Plain K5: q (M, T, C); kv (M, T, 2C) = [K | V] -> (M, T, C) in q.dtype."""
    C = q.shape[-1]
    qh, kh, vh = (_heads(t, num_heads, dim_head) for t in (q, kv[..., :C], kv[..., C:]))
    out = _attend(qh, kh, vh, dim_head**-0.5, vh.dtype)  # (M, H, T, D)
    return out.transpose(1, 2).reshape(q.shape).to(q.dtype)


def p2v_plain(q, kv, num_heads, dim_head):
    """Plain K6: q (N, T, C) point queries; kv (T, V, 2C) the frames' virtual
    keys|values -> (N, T, C) in q.dtype."""
    C = q.shape[-1]
    qh = _heads(q.transpose(0, 1), num_heads, dim_head)  # (T, H, N, D)
    kh, vh = (_heads(t, num_heads, dim_head) for t in (kv[..., :C], kv[..., C:]))
    out = _attend(qh, kh, vh, dim_head**-0.5, vh.dtype)  # (T, H, N, D)
    return out.permute(2, 0, 1, 3).reshape(q.shape).to(q.dtype)


def v2p_plain(q, kv, num_heads, dim_head, key_bias=None):
    """Plain K7: q (T, V, C) virtual queries; kv (N, T, 2C) point keys|values;
    key_bias (N,) f32 additive (0 = valid key, NEG_BIG = masked) -> (T, V, C)
    in q.dtype. A row whose keys are all masked is the plain average of the
    values, as in the kernel."""
    C = q.shape[-1]
    qh = _heads(q, num_heads, dim_head)  # (T, H, V, D)
    kvt = kv.transpose(0, 1)
    kh, vh = (_heads(t, num_heads, dim_head) for t in (kvt[..., :C], kvt[..., C:]))
    out = _flash_plain(qh, kh, vh, dim_head, bias=key_bias)  # (T, H, V, D)
    return out.transpose(1, 2).reshape(q.shape).to(q.dtype)


V2P_RANGE_KEYS = 2048  # fewest keys a key range of the bf16 virtual<-points core takes


def v2p_splits(N, T, V, H, device) -> int:
    """Key ranges of the bf16 virtual<-points core (K7, K3's core). Each
    range takes at least V2P_RANGE_KEYS keys: fewer ranges keep the result
    closer to one walk over the keys (a range rounds its probabilities
    against its own running max, and the merge rescales them). Among the
    counts that allows, the one whose (head, range, frame, query group)
    blocks fill the card in the most nearly whole waves of four resident
    blocks an SM (127 registers x 128 threads a block), up to three waves,
    and of equals the most ranges: measured on an H100 at 10,240 keys, 4
    ranges take 0.152 ms at T=16 and 5 ranges 0.165 ms (1.2 waves)."""
    resident = 4 * torch.cuda.get_device_properties(device).multi_processor_count
    blocks = H * T * -(-V // 64)
    best, best_tail = 1, math.inf
    for s in range(1, max(1, min(16, N // V2P_RANGE_KEYS)) + 1):
        waves = s * blocks / resident
        if s > 1 and waves > 3:
            break
        tail = math.ceil(waves) / waves
        if tail <= best_tail * (1 + 1e-9):
            best, best_tail = s, tail
    return best


def _v2p_core(fn, what, q, kv, bias, N, num_heads, dim_head):
    """Launches a virtual<-points core entry (ct_k7_virtual_from_points or
    ct_v2p_flash) on contiguous operands: in bf16 with its key ranges and
    their f32 partials (allocated here), in f32 the first version."""
    T, V, C = q.shape
    bf16 = mlp_int8_cuda._is_bf16(q)
    splits = v2p_splits(N, T, V, num_heads, q.device) if bf16 else 1
    part = (torch.empty((splits * T * V * (C + 2 * num_heads),), dtype=F32, device=q.device)
            if bf16 else None)
    out = torch.empty_like(q)
    _build.check(fn(
        _build.ptr(q), _build.ptr(kv), _build.ptr(bias), bf16, _build.ptr(out), _build.ptr(part),
        splits, N, T, V, num_heads, dim_head, dim_head**-0.5, _build.stream_ptr(q)), what)
    return out


def _check_core(q, kv, num_heads, dim_head, kv_shape, keys=0):
    for t in (q, kv):
        if t.device.type != "cuda":
            raise ValueError(f"kernel inputs must all be CUDA tensors, got {t.device}")
    if q.dtype != kv.dtype:
        raise TypeError(f"q and kv must share a dtype, got {q.dtype} and {kv.dtype}")
    if q.shape[-1] != num_heads * dim_head or tuple(kv.shape) != kv_shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, kv {tuple(kv.shape)} (expected {kv_shape})")
    if keys > MAX_KEYS:
        raise ValueError(f"the attention core stages at most {MAX_KEYS} keys, got {keys}")
    return mlp_int8_cuda._is_bf16(q)


def fused_time_attention(q, kv, num_heads, dim_head):
    """K5: self-attention over axis 1, independently per row of axis 0.
    q (M, T, H*D); kv (M, T, 2*H*D), K in [:H*D] and V in [H*D:] (the
    unsplit to_kv projection). Returns (M, T, H*D) in q.dtype."""
    if q.device.type == "cpu":
        return time_attention_plain(q, kv, num_heads, dim_head)
    M, T, C = q.shape
    bf16 = _check_core(q, kv, num_heads, dim_head, (M, T, 2 * C))
    q, kv = q.contiguous(), kv.contiguous()
    out = torch.empty_like(q)
    _build.check(_cores_lib()["k5"](
        _build.ptr(q), _build.ptr(kv), bf16, _build.ptr(out), M, T, num_heads, dim_head,
        dim_head**-0.5, _build.stream_ptr(q)), "ct_k5_time_attention")
    fused_time_attention.launches += 1
    return out


fused_time_attention.launches = 0


def fused_points_from_virtual(q, kv, num_heads, dim_head):
    """K6: every (track, frame) query attends over that frame's V virtual
    keys|values. q (N, T, H*D) track-major; kv (T, V, 2*H*D). Returns
    (N, T, H*D) in q.dtype."""
    if q.device.type == "cpu":
        return p2v_plain(q, kv, num_heads, dim_head)
    N, T, C = q.shape
    V = kv.shape[1]
    bf16 = _check_core(q, kv, num_heads, dim_head, (T, V, 2 * C), keys=V)
    q, kv = q.contiguous(), kv.contiguous()
    out = torch.empty_like(q)
    _build.check(_cores_lib()["k6"](
        _build.ptr(q), _build.ptr(kv), bf16, _build.ptr(out), N, T, V, num_heads, dim_head,
        dim_head**-0.5, _build.stream_ptr(q)), "ct_k6_points_from_virtual")
    fused_points_from_virtual.launches += 1
    return out


fused_points_from_virtual.launches = 0


def fused_virtual_from_points(q, kv, num_heads, dim_head, key_bias=None):
    """K7: per frame, the V virtual queries attend over all N point tokens
    with an online softmax. q (T, V, H*D); kv (N, T, 2*H*D) track-major;
    key_bias (N,) f32 additive (0 = valid key, NEG_BIG = masked; None = no
    mask). Returns (T, V, H*D) in q.dtype."""
    if q.device.type == "cpu":
        return v2p_plain(q, kv, num_heads, dim_head, key_bias)
    T, V, C = q.shape
    N = kv.shape[0]
    _check_core(q, kv, num_heads, dim_head, (N, T, 2 * C))
    if key_bias is None:
        key_bias = torch.zeros((N,), dtype=F32, device=q.device)
    if key_bias.device.type != "cuda" or tuple(key_bias.shape) != (N,):
        raise ValueError(f"key_bias must be a CUDA tensor of shape ({N},)")
    out = _v2p_core(_cores_lib()["k7"], "ct_k7_virtual_from_points", q.contiguous(),
                    kv.contiguous(), key_bias.to(F32).contiguous(), N, num_heads, dim_head)
    fused_virtual_from_points.launches += 1
    return out


fused_virtual_from_points.launches = 0
