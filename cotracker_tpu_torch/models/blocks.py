"""Network building blocks (port of cotracker_tpu/models/blocks.py).

Module and parameter names follow the reference state_dict
(cotracker/models/core/cotracker/blocks.py), so a reference `.pth` loads with
`load_state_dict` after `models/checkpoint.py` renames one key. Convolutions
run NCHW inside the encoder; its input and output are channel-last like the
JAX package's. Statistics of every norm and softmax are float32 whatever the
compute dtype.

Two independent kernel switches, with the JAX package's meaning
(`quant_int8` and `use_pallas_attn` there) and precedence. With `quant_int8`,
AttnBlock and CrossAttnBlock run their bodies through the W8A8 kernels of
ops/kernels (K1 time block, or its split K8 -> K5 -> K9; K2 points<-virtual
block, K3 virtual<-points projection+attention). With `attn_kernels`,
Attention runs its products through the attention-core kernels (K5 time, K6
points<-virtual, K7 virtual<-points) between plain projections; a block with
both switches set runs the W8A8 kernel wherever that applies.

The kernels take any track and frame count, but the JAX package's shape
gates decide which function a block computes, and the port keeps them
(ops/kernels/gates.py): the space blocks run their kernels only where
`space_tile_ok(N)` holds, a time block runs W8A8 only with the
updateformer's `quant_ok` and a multiple of 8 rows (the attention core too),
and a W8A8 time block is K1 where `pick_time_tile` finds a track tile and the
split K8 -> K5 -> K9 where it does not.

The kernel-variant switches (ops/kernels/variants.py) reach the W8A8
blocks as `variants`: `bf16_ln` and `gelu_quant_fold` change the function
of every W8A8 body, and `space_allt` runs the points<-virtual block as K11
where `gates.space_allt_tile` holds (K2's function, one launch).
"""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from cotracker_tpu_torch.ops.bilinear import interp_matrix_1d
from cotracker_tpu_torch.ops.collectives import pmax_nograd, psum
from cotracker_tpu_torch.ops.kernels import attention_cuda, gates, mlp_int8_cuda
from cotracker_tpu_torch.ops.kernels.variants import OFF, KernelVariants

F32 = torch.float32
NEG = -torch.finfo(torch.float32).max  # the plain paths' additive mask bias


def instance_norm(x, eps: float = 1e-5):
    """Affine-free InstanceNorm2d of NCHW x with float32 statistics."""
    x32 = x.to(F32)
    mean = x32.mean(dim=(-2, -1), keepdim=True)
    var = x32.var(dim=(-2, -1), keepdim=True, unbiased=False)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def layer_norm(x, eps: float = 1e-6):
    """Affine-free LayerNorm over the last axis, one-pass float32 variance."""
    x32 = x.to(F32)
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 * x32).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def dense(lin: nn.Linear, x, dtype):
    """nn.Linear in `dtype`: input, weight and bias all cast, like flax's
    promote_dtype."""
    b = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), b)


class AffineLayerNorm(nn.Module):
    """LayerNorm with learnable weight/bias, one-pass float32 variance."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        x32 = x.to(F32)
        mean = x32.mean(dim=-1, keepdim=True)
        var = ((x32 * x32).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight.to(F32) + self.bias.to(F32)).to(x.dtype)


class Mlp(nn.Module):
    def __init__(self, in_features, hidden_features, out_features,
                 approximate_gelu: bool = False, dtype=F32):
        super().__init__()
        self.dtype = dtype
        self.approximate = "tanh" if approximate_gelu else "none"
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features)

    def forward(self, x):
        h = F.gelu(dense(self.fc1, x, self.dtype), approximate=self.approximate)
        return dense(self.fc2, h, self.dtype)


class ResidualBlock(nn.Module):
    """RAFT residual block with instance norm, NCHW."""

    def __init__(self, in_planes, planes, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        if stride != 1:
            self.downsample = nn.Sequential(nn.Conv2d(in_planes, planes, 1, stride=stride))

    def forward(self, x):
        y = F.relu(instance_norm(_conv(self.conv1, x)))
        y = F.relu(instance_norm(_conv(self.conv2, y)))
        if self.stride != 1:
            x = instance_norm(_conv(self.downsample[0], x))
        return F.relu(x + y)


def _conv(conv: nn.Conv2d, x):
    return F.conv2d(
        x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), conv.stride, conv.padding
    )


def _resize_nchw(x, out_hw):
    mh = interp_matrix_1d(x.shape[-2], out_hw[0], True, x.device).to(x.dtype)
    mw = interp_matrix_1d(x.shape[-1], out_hw[1], True, x.device).to(x.dtype)
    return torch.einsum("oh,bchw,pw->bcop", mh, x, mw)


class BasicEncoder(nn.Module):
    """RAFT feature encoder, output stride 4, 128 channels.
    Input (B, H, W, 3) -> output (B, H/stride, W/stride, output_dim)."""

    def __init__(self, input_dim: int = 3, output_dim: int = 128, stride: int = 4):
        super().__init__()
        self.stride = stride
        d = output_dim
        self.conv1 = nn.Conv2d(input_dim, d // 2, 7, stride=2, padding=3)
        self.layer1 = self._stage(d // 2, d // 2, 1)
        self.layer2 = self._stage(d // 2, d // 4 * 3, 2)
        self.layer3 = self._stage(d // 4 * 3, d, 2)
        self.layer4 = self._stage(d, d, 2)
        self.conv2 = nn.Conv2d(d * 3 + d // 4, d * 2, 3, padding=1)
        self.conv3 = nn.Conv2d(d * 2, d, 1)

    @staticmethod
    def _stage(cin, planes, stride):
        return nn.Sequential(ResidualBlock(cin, planes, stride), ResidualBlock(planes, planes, 1))

    def forward(self, x):
        H, W = x.shape[-3], x.shape[-2]
        out_hw = (H // self.stride, W // self.stride)
        x = x.permute(0, 3, 1, 2)
        x = F.relu(instance_norm(_conv(self.conv1, x)))
        a = self.layer1(x)
        b = self.layer2(a)
        c = self.layer3(b)
        d = self.layer4(c)
        x = torch.cat([_resize_nchw(t, out_hw) for t in (a, b, c, d)], dim=1)
        x = F.relu(instance_norm(_conv(self.conv2, x)))
        x = _conv(self.conv3, x)
        return x.permute(0, 2, 3, 1)


def _softmax_attend(q, k, v, scale, bias=None):
    """(..., i, d) x (..., j, d): float32 logits and softmax, probabilities in
    v's dtype."""
    sim = torch.einsum("...id,...jd->...ij", q.to(F32), k.to(F32)) * scale
    if bias is not None:
        sim = sim + bias
    attn = torch.softmax(sim, dim=-1).to(v.dtype)
    return torch.einsum("...ij,...jd->...id", attn, v)


class Attention(nn.Module):
    """Multi-head attention, heads * dim_head == 384, float32 softmax."""

    def __init__(self, query_dim, num_heads=8, dim_head=48, qkv_bias=False, dtype=F32,
                 attn_kernels: bool = False):
        super().__init__()
        inner = num_heads * dim_head
        self.num_heads, self.dim_head, self.dtype = num_heads, dim_head, dtype
        self.attn_kernels = attn_kernels
        self.to_q = nn.Linear(query_dim, inner, bias=qkv_bias)
        self.to_kv = nn.Linear(query_dim, inner * 2, bias=qkv_bias)
        self.to_out = nn.Linear(inner, query_dim)

    def forward(self, x, context=None, attn_bias=None):
        h, d = self.num_heads, self.dim_head
        if self.attn_kernels and context is None and attn_bias is None and x.shape[0] % 8 == 0:
            q = dense(self.to_q, x, self.dtype)
            kv = dense(self.to_kv, x, self.dtype)  # K|V unsplit: the kernel slices heads
            out = attention_cuda.fused_time_attention(q, kv, h, d)
            return dense(self.to_out, out, self.dtype)
        context = x if context is None else context
        q = dense(self.to_q, x, self.dtype)
        k, v = dense(self.to_kv, context, self.dtype).chunk(2, dim=-1)
        B, N1, _ = q.shape
        N2 = k.shape[1]
        q = q.reshape(B, N1, h, d).transpose(1, 2)
        k = k.reshape(B, N2, h, d).transpose(1, 2)
        v = v.reshape(B, N2, h, d).transpose(1, 2)
        out = _softmax_attend(q, k, v, d**-0.5, attn_bias)
        return dense(self.to_out, out.transpose(1, 2).reshape(B, N1, h * d), self.dtype)

    def virtual_from_points(self, virtual, points, key_mask=None, group=None):
        """Queries virtual (B, T, V, C); keys/values points (B, N, T, C);
        key_mask (B, N) True = valid key. Returns (B, T, V, C_out).

        group: a process group over which N (the keys) is sharded. The
        softmax then takes two passes (JAX blocks.py:264-289): the local row
        max and the group's max of it, with no gradient; the exponentials;
        the local numerator and denominator summed over the group
        (ops/collectives.psum, whose backward sums the cotangents); the
        division. Masked keys take -finfo(float32).max, so a rank whose keys
        are all masked adds zeros. K7 normalises locally and never runs
        here."""
        h, d = self.num_heads, self.dim_head
        B, T, V, _ = virtual.shape
        N = points.shape[1]
        if group is not None:
            return self._virtual_from_points_sharded(virtual, points, key_mask, group)
        if self.attn_kernels and gates.space_tile_ok(N):
            q = dense(self.to_q, virtual, self.dtype)  # (B, T, V, C)
            kv = dense(self.to_kv, points, self.dtype)  # (B, N, T, 2C)
            bias = None
            if key_mask is not None:
                bias = torch.where(key_mask, 0.0, attention_cuda.NEG_BIG)
            out = torch.stack([
                attention_cuda.fused_virtual_from_points(
                    q[b], kv[b], h, d, key_bias=None if bias is None else bias[b])
                for b in range(B)
            ])
            return dense(self.to_out, out, self.dtype)
        q = dense(self.to_q, virtual, self.dtype).reshape(B, T, V, h, d).permute(0, 1, 3, 2, 4)
        k, v = dense(self.to_kv, points, self.dtype).chunk(2, dim=-1)
        k = k.reshape(B, N, T, h, d).permute(0, 2, 3, 1, 4)  # (B, T, h, N, d)
        v = v.reshape(B, N, T, h, d).permute(0, 2, 3, 1, 4)
        bias = None
        if key_mask is not None:
            bias = torch.where(key_mask, 0.0, NEG)[:, None, None, None, :]
        out = _softmax_attend(q, k, v, d**-0.5, bias)  # (B, T, h, V, d)
        out = out.permute(0, 1, 3, 2, 4).reshape(B, T, V, h * d)
        return dense(self.to_out, out, self.dtype)

    def _virtual_from_points_sharded(self, virtual, points, key_mask, group):
        h, d = self.num_heads, self.dim_head
        B, T, V, _ = virtual.shape
        N = points.shape[1]
        q = dense(self.to_q, virtual, self.dtype).reshape(B, T, V, h, d).permute(0, 1, 3, 2, 4)
        k, v = dense(self.to_kv, points, self.dtype).chunk(2, dim=-1)
        k = k.reshape(B, N, T, h, d).permute(0, 2, 3, 1, 4)  # (B, T, h, N, d)
        v = v.reshape(B, N, T, h, d).permute(0, 2, 3, 1, 4)
        sim = torch.einsum("...id,...jd->...ij", q.to(F32), k.to(F32)) * d**-0.5  # (B, T, h, V, N)
        if key_mask is not None:
            sim = sim + torch.where(key_mask, 0.0, NEG)[:, None, None, None, :]
        m = pmax_nograd(sim.amax(dim=-1), group)  # (B, T, h, V)
        p = torch.exp(sim - m[..., None])
        num, den = psum((torch.einsum("...ij,...jd->...id", p.to(v.dtype), v), p.sum(dim=-1)),
                        group)
        out = num / den[..., None].to(num.dtype)  # (B, T, h, V, d)
        out = out.permute(0, 1, 3, 2, 4).reshape(B, T, V, h * d)
        return dense(self.to_out, out, self.dtype)

    def points_from_virtual(self, points, virtual, query_mask=None):
        """Queries points (B, N, T, C); keys/values virtual (B, T, V, C);
        a masked query attends uniformly (reference v2 convention)."""
        h, d = self.num_heads, self.dim_head
        B, N, T, _ = points.shape
        V = virtual.shape[2]
        if self.attn_kernels and query_mask is None and gates.space_tile_ok(N):
            q = dense(self.to_q, points, self.dtype)  # (B, N, T, C)
            kv = dense(self.to_kv, virtual, self.dtype)  # (B, T, V, 2C)
            out = torch.stack([
                attention_cuda.fused_points_from_virtual(q[b], kv[b], h, d) for b in range(B)
            ])
            return dense(self.to_out, out, self.dtype)
        q = dense(self.to_q, points, self.dtype).reshape(B, N, T, h, d).permute(0, 2, 3, 1, 4)
        k, v = dense(self.to_kv, virtual, self.dtype).chunk(2, dim=-1)
        k = k.reshape(B, T, V, h, d).transpose(2, 3)  # (B, T, h, V, d)
        v = v.reshape(B, T, V, h, d).transpose(2, 3)
        bias = None
        if query_mask is not None:
            bias = torch.where(query_mask, 0.0, NEG)[:, None, None, :, None]
        out = _softmax_attend(q, k, v, d**-0.5, bias)  # (B, T, h, N, d)
        out = out.permute(0, 3, 1, 2, 4).reshape(B, N, T, h * d)
        return dense(self.to_out, out, self.dtype)


class AttnBlock(nn.Module):
    """Pre-norm self-attention + MLP block. With `quant_int8`, `quant_ok`, no
    mask and a multiple of 8 rows, the body is W8A8: the K1 whole-block
    kernel where the JAX tile gate finds a track tile, else K8 -> K5 -> K9.
    Otherwise, with `attn_kernels` (and no mask), its attention core is the
    K5 kernel between plain projections."""

    def __init__(self, hidden_size=384, num_heads=8, mlp_ratio=4.0, dtype=F32,
                 attn_kernels: bool = False, quant_int8: bool = False,
                 variants: KernelVariants = OFF):
        super().__init__()
        self.num_heads, self.dtype, self.quant_int8 = num_heads, dtype, quant_int8
        self.dim_head = hidden_size // num_heads
        self.variants = variants
        self.attn = Attention(hidden_size, num_heads, self.dim_head, qkv_bias=True, dtype=dtype,
                              attn_kernels=attn_kernels)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio), hidden_size,
                       approximate_gelu=True, dtype=dtype)

    def quantize(self):
        """W8A8 weight pack for the K1 kernel (once per forward)."""
        a = self.attn
        return mlp_int8_cuda.TimeBlockWeights(
            qkv=mlp_int8_cuda.quantize_linear(
                torch.cat([a.to_q.weight, a.to_kv.weight]),
                torch.cat([a.to_q.bias, a.to_kv.bias]),
            ),
            out=mlp_int8_cuda.quantize_linear(a.to_out.weight, a.to_out.bias),
            fc1=mlp_int8_cuda.quantize_linear(self.mlp.fc1.weight, self.mlp.fc1.bias),
            fc2=mlp_int8_cuda.quantize_linear(self.mlp.fc2.weight, self.mlp.fc2.bias),
        )

    def forward(self, x, mask: Optional[torch.Tensor] = None, pack=None, quant_ok: bool = True,
                max_tokens: int = gates.FLAT_TOKENS):
        """x (M, T, C). quant_ok: the updateformer's track gate; max_tokens:
        the token cap of the JAX whole-block kernel's tile for these tokens."""
        M, T = x.shape[:2]
        if self.quant_int8 and quant_ok and mask is None and M % 8 == 0:
            pack = self.quantize() if pack is None else pack
            h, d = self.num_heads, self.dim_head
            ln, fold = self.variants.bf16_ln, self.variants.gelu_quant_fold
            if gates.pick_time_tile(M, T, max_tokens) is not None:
                return mlp_int8_cuda.fused_time_block_int8(x, pack, h, d, bf16_ln=ln,
                                                           gelu_fold=fold)
            q, kv = mlp_int8_cuda.fused_ln_qkv_int8(x, pack.qkv, bf16_ln=ln)
            a = attention_cuda.fused_time_attention(q, kv, h, d)
            return mlp_int8_cuda.fused_attnout_res_mlp_int8(a, x, pack, bf16_ln=ln,
                                                            gelu_fold=fold)
        attn_bias = None
        if mask is not None:
            pm = mask[:, None, :] & mask[:, :, None]
            attn_bias = torch.where(pm, 0.0, NEG)[:, None]
        x = x + self.attn(layer_norm(x), attn_bias=attn_bias)
        return x + self.mlp(layer_norm(x))


class CrossAttnBlock(nn.Module):
    """Pre-norm cross-attention + MLP block; `key_mask` masks context keys.
    With `quant_int8` the points-side work of the two factorized space
    attentions runs through the K2/K3 kernels; otherwise, with
    `attn_kernels`, their attention cores are the K6/K7 kernels. Either only
    where `space_tile_ok(N)` holds: elsewhere both run plain, as in JAX.
    With the `space_allt` variant the points<-virtual block is K11 where
    `space_allt_tile` holds."""

    def __init__(self, hidden_size=384, context_dim=384, num_heads=8, mlp_ratio=4.0,
                 dtype=F32, attn_kernels: bool = False, quant_int8: bool = False,
                 variants: KernelVariants = OFF):
        super().__init__()
        self.num_heads, self.dtype, self.quant_int8 = num_heads, dtype, quant_int8
        self.variants = variants
        self.dim_head = hidden_size // num_heads
        self.norm_context = AffineLayerNorm(context_dim, eps=1e-5)
        self.cross_attn = Attention(hidden_size, num_heads, self.dim_head, qkv_bias=True,
                                    dtype=dtype, attn_kernels=attn_kernels)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio), hidden_size,
                       approximate_gelu=True, dtype=dtype)

    def forward(self, x, context, key_mask=None, query_mask=None):
        attn_bias = None
        if key_mask is not None:
            attn_bias = torch.where(key_mask, 0.0, NEG)[:, None, None, :]
        if query_mask is not None:
            qb = torch.where(query_mask, 0.0, NEG)[:, None, :, None]
            attn_bias = qb if attn_bias is None else attn_bias + qb
        x = x + self.cross_attn(layer_norm(x), context=self.norm_context(context),
                                attn_bias=attn_bias)
        return x + self.mlp(layer_norm(x))

    def quantize_v2p(self):
        """W8A8 to_kv for the K3 kernel."""
        kv = self.cross_attn.to_kv
        return mlp_int8_cuda.quantize_linear(kv.weight, kv.bias)

    def quantize_p2v(self):
        """W8A8 pack for the K2 kernel."""
        a = self.cross_attn
        return mlp_int8_cuda.SpaceBlockWeights(
            q=mlp_int8_cuda.quantize_linear(a.to_q.weight, a.to_q.bias),
            out=mlp_int8_cuda.quantize_linear(a.to_out.weight, a.to_out.bias),
            fc1=mlp_int8_cuda.quantize_linear(self.mlp.fc1.weight, self.mlp.fc1.bias),
            fc2=mlp_int8_cuda.quantize_linear(self.mlp.fc2.weight, self.mlp.fc2.bias),
        )

    def virtual_from_points(self, virtual, points, key_mask=None, pack=None, group=None):
        """virtual (B, T, V, C) queries; points (B, N, T, C) keys/values.
        group: N sharded over this process group, the two-pass softmax of
        Attention.virtual_from_points; K3 normalises locally and is
        bypassed (JAX blocks.py:542-551). The virtual side's residual and
        MLP are computed alike on every rank."""
        if self.quant_int8 and group is None and gates.space_tile_ok(points.shape[1]):
            pack = self.quantize_v2p() if pack is None else pack
            return self._quant_virtual_from_points(virtual, points, key_mask, pack)
        ctx = self.norm_context(points)
        virtual = virtual + self.cross_attn.virtual_from_points(
            layer_norm(virtual), ctx, key_mask=key_mask, group=group
        )
        return virtual + self.mlp(layer_norm(virtual))

    def _quant_virtual_from_points(self, virtual, points, key_mask, pack):
        at, nc = self.cross_attn, self.norm_context
        B, N = points.shape[:2]
        q = dense(at.to_q, layer_norm(virtual), self.dtype)  # (B, T, V, C)
        if key_mask is None:
            bias = torch.zeros((B, N), dtype=F32, device=points.device)
        else:
            bias = torch.where(key_mask, 0.0, attention_cuda.NEG_BIG)
        out = torch.stack([
            attention_cuda.fused_virtual_from_points_proj(
                q[b], points[b], pack, nc.weight, nc.bias, self.num_heads,
                self.dim_head, key_bias=bias[b], eps=nc.eps,
            )
            for b in range(B)
        ])
        virtual = virtual + dense(at.to_out, out, self.dtype)
        return virtual + self.mlp(layer_norm(virtual))

    def points_from_virtual(self, points, virtual, query_mask=None, pack=None):
        """points (B, N, T, C) queries; virtual (B, T, V, C) keys/values."""
        if self.quant_int8 and query_mask is None and gates.space_tile_ok(points.shape[1]):
            pack = self.quantize_p2v() if pack is None else pack
            kv = dense(self.cross_attn.to_kv, self.norm_context(virtual), self.dtype)
            v = self.variants
            N, T = points.shape[1:3]
            allt = v.space_allt and gates.space_allt_tile(
                N, T, points.dtype == torch.bfloat16) is not None
            block = (mlp_int8_cuda.fused_space_block_allt_int8 if allt
                     else mlp_int8_cuda.fused_space_block_int8)
            return torch.stack([
                block(points[b], kv[b], pack, self.num_heads, self.dim_head,
                      bf16_ln=v.bf16_ln, gelu_fold=v.gelu_quant_fold)
                for b in range(points.shape[0])
            ])
        ctx = self.norm_context(virtual)
        points = points + self.cross_attn.points_from_virtual(
            layer_norm(points), ctx, query_mask=query_mask
        )
        return points + self.mlp(layer_norm(points))
