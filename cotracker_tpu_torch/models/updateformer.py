"""EfficientUpdateFormer (port of cotracker_tpu/models/updateformer.py).

Interleaved time attention (per track, over frames) and factorized space
attention through `num_virtual_tracks` virtual tokens:
virtual <- points, virtual <- virtual, points <- virtual. Point and virtual
tokens stay separate tensors; the shared time block runs on both. Module
names follow the reference state_dict (parameter `virtual_tracks` is the
reference's `virual_tracks`, renamed by models/checkpoint.py).

The JAX package's gates hold here too (ops/kernels/gates.py): where the
space blocks cannot tile N tracks, the W8A8 time blocks are off as well
(`quant_ok`), and a W8A8 time block's tile cap is 1,024 tokens for the point
tokens (the JAX 4D entry, taken whenever the W8A8 space blocks run) and
1,536 for the virtual tokens. The kernel-variant switches (`variants`,
ops/kernels/variants.py) reach the W8A8 time blocks and the two cross
blocks.

Two switches serve the legacy CoTracker2 model (models/cotracker2.py), as
in JAX: `linear_layer_for_vis_conf=False` leaves one `flow_head` of
`output_dim` outputs and no vis/conf head, and `v2_masking` makes the track
mask also a query mask of points <- virtual (a masked query attends
uniformly to the virtual tokens).
"""

from typing import Optional

import torch
import torch.nn as nn

from cotracker_tpu_torch.models.blocks import AttnBlock, CrossAttnBlock, dense
from cotracker_tpu_torch.ops.kernels import gates
from cotracker_tpu_torch.ops.kernels.variants import OFF, KernelVariants

F32 = torch.float32


class EfficientUpdateFormer(nn.Module):
    def __init__(
        self,
        space_depth: int = 3,
        time_depth: int = 3,
        input_dim: int = 1110,
        hidden_size: int = 384,
        num_heads: int = 8,
        output_dim: int = 4,
        mlp_ratio: float = 4.0,
        num_virtual_tracks: int = 64,
        add_space_attn: bool = True,
        dtype=F32,
        attn_kernels: bool = False,
        quant_int8: bool = False,
        variants: KernelVariants = OFF,
        linear_layer_for_vis_conf: bool = True,
        v2_masking: bool = False,
    ):
        super().__init__()
        self.time_depth, self.space_depth = time_depth, space_depth
        self.hidden_size, self.dtype = hidden_size, dtype
        self.add_space_attn, self.quant_int8 = add_space_attn, quant_int8
        self.v2_masking = v2_masking
        self.input_transform = nn.Linear(input_dim, hidden_size)
        self.virtual_tracks = nn.Parameter(torch.randn(1, num_virtual_tracks, 1, hidden_size))
        blk = dict(num_heads=num_heads, mlp_ratio=mlp_ratio, dtype=dtype)
        # the two kernel switches (attention cores K5-K7, W8A8 blocks K1-K3)
        # reach the time blocks and the two cross blocks; the virtual
        # self-attention blocks get neither, as in the JAX package
        kern = dict(attn_kernels=attn_kernels, quant_int8=quant_int8, variants=variants, **blk)
        self.time_blocks = nn.ModuleList(
            AttnBlock(hidden_size, **kern) for _ in range(time_depth)
        )
        if add_space_attn:
            self.space_virtual_blocks = nn.ModuleList(
                AttnBlock(hidden_size, **blk) for _ in range(space_depth)
            )
            self.space_point2virtual_blocks = nn.ModuleList(
                CrossAttnBlock(hidden_size, hidden_size, **kern) for _ in range(space_depth)
            )
            self.space_virtual2point_blocks = nn.ModuleList(
                CrossAttnBlock(hidden_size, hidden_size, **kern) for _ in range(space_depth)
            )
        if linear_layer_for_vis_conf:
            self.flow_head = nn.Linear(hidden_size, output_dim - 2)
            self.vis_conf_head = nn.Linear(hidden_size, 2)
        else:
            self.flow_head = nn.Linear(hidden_size, output_dim)
            self.vis_conf_head = None

    def quantize(self):
        """W8A8 weight packs of every kernel block, built once per forward."""
        packs = {"time": [b.quantize() if b.quant_int8 else None for b in self.time_blocks]}
        if self.add_space_attn:
            packs["v2p"] = [
                b.quantize_v2p() if b.quant_int8 else None for b in self.space_virtual2point_blocks
            ]
            packs["p2v"] = [
                b.quantize_p2v() if b.quant_int8 else None for b in self.space_point2virtual_blocks
            ]
        return packs

    def forward(self, x, track_mask: Optional[torch.Tensor] = None, x_is_tokens: bool = False,
                packs=None):
        """x (B, N, T, input_dim), or tokens (B, N, T, hidden) with
        x_is_tokens -> (B, N, T, output_dim). track_mask (B, N) True = real
        track: padded tracks are excluded as keys of virtual <- points (and,
        with v2_masking, are masked queries of points <- virtual)."""
        B, N, T, _ = x.shape
        C = self.hidden_size
        packs = self.quantize() if packs is None else packs
        tokens = x if x_is_tokens else dense(self.input_transform, x, self.dtype)
        V = self.virtual_tracks.shape[1]
        virtual = self.virtual_tracks.to(tokens.dtype).expand(B, V, T, C)
        quant_ok = gates.space_tile_ok(N) if self.quant_int8 and self.add_space_attn else True
        point_cap = gates.POINT_TOKENS if self.add_space_attn else gates.FLAT_TOKENS
        j = 0
        for i in range(self.time_depth):
            tb, tp = self.time_blocks[i], packs["time"][i]
            tokens = tb(tokens.reshape(B * N, T, C), pack=tp, quant_ok=quant_ok,
                        max_tokens=point_cap).reshape(B, N, T, C)
            virtual = tb(virtual.reshape(B * V, T, C), pack=tp,
                         quant_ok=quant_ok).reshape(B, V, T, C)
            if self.add_space_attn and i % (self.time_depth // self.space_depth) == 0:
                vt = virtual.transpose(1, 2)  # (B, T, V, C)
                vt = self.space_virtual2point_blocks[j].virtual_from_points(
                    vt, tokens, key_mask=track_mask, pack=packs["v2p"][j]
                )
                vt = self.space_virtual_blocks[j](vt.reshape(B * T, V, C)).reshape(B, T, V, C)
                tokens = self.space_point2virtual_blocks[j].points_from_virtual(
                    tokens, vt, query_mask=track_mask if self.v2_masking else None,
                    pack=packs["p2v"][j],
                )
                virtual = vt.transpose(1, 2)
                j += 1
        if self.vis_conf_head is None:
            return dense(self.flow_head, tokens, self.dtype)
        # flow and vis/conf heads as one matmul over concatenated weights
        w = torch.cat([self.flow_head.weight, self.vis_conf_head.weight]).to(self.dtype)
        b = torch.cat([self.flow_head.bias, self.vis_conf_head.bias]).to(self.dtype)
        return tokens.to(self.dtype) @ w.t() + b
