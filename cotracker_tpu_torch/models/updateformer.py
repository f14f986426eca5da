"""EfficientUpdateFormer (port of cotracker_tpu/models/updateformer.py).

Interleaved time attention (per track, over frames) and factorized space
attention through `num_virtual_tracks` virtual tokens:
virtual <- points, virtual <- virtual, points <- virtual. Point and virtual
tokens stay separate tensors; the shared time block runs on both. Module
names follow the reference state_dict (parameter `virtual_tracks` is the
reference's `virual_tracks`, renamed by models/checkpoint.py).
"""

from typing import Optional

import torch
import torch.nn as nn

from cotracker_tpu_torch.models.blocks import AttnBlock, CrossAttnBlock, dense

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
    ):
        super().__init__()
        self.time_depth, self.space_depth = time_depth, space_depth
        self.hidden_size, self.dtype = hidden_size, dtype
        self.add_space_attn = add_space_attn
        self.input_transform = nn.Linear(input_dim, hidden_size)
        self.virtual_tracks = nn.Parameter(torch.randn(1, num_virtual_tracks, 1, hidden_size))
        blk = dict(num_heads=num_heads, mlp_ratio=mlp_ratio, dtype=dtype)
        # the two kernel switches (attention cores K5-K7, W8A8 blocks K1-K3)
        # reach the time blocks and the two cross blocks; the virtual
        # self-attention blocks get neither, as in the JAX package
        kern = dict(attn_kernels=attn_kernels, quant_int8=quant_int8, **blk)
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
        self.flow_head = nn.Linear(hidden_size, output_dim - 2)
        self.vis_conf_head = nn.Linear(hidden_size, 2)

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
        track: padded tracks are excluded as keys of virtual <- points."""
        B, N, T, _ = x.shape
        C = self.hidden_size
        packs = self.quantize() if packs is None else packs
        tokens = x if x_is_tokens else dense(self.input_transform, x, self.dtype)
        V = self.virtual_tracks.shape[1]
        virtual = self.virtual_tracks.to(tokens.dtype).expand(B, V, T, C)
        j = 0
        for i in range(self.time_depth):
            tb, tp = self.time_blocks[i], packs["time"][i]
            tokens = tb(tokens.reshape(B * N, T, C), pack=tp).reshape(B, N, T, C)
            virtual = tb(virtual.reshape(B * V, T, C), pack=tp).reshape(B, V, T, C)
            if self.add_space_attn and i % (self.time_depth // self.space_depth) == 0:
                vt = virtual.transpose(1, 2)  # (B, T, V, C)
                vt = self.space_virtual2point_blocks[j].virtual_from_points(
                    vt, tokens, key_mask=track_mask, pack=packs["v2p"][j]
                )
                vt = self.space_virtual_blocks[j](vt.reshape(B * T, V, C)).reshape(B, T, V, C)
                tokens = self.space_point2virtual_blocks[j].points_from_virtual(
                    tokens, vt, pack=packs["p2v"][j]
                )
                virtual = vt.transpose(1, 2)
                j += 1
        # flow and vis/conf heads as one matmul over concatenated weights
        w = torch.cat([self.flow_head.weight, self.vis_conf_head.weight]).to(self.dtype)
        b = torch.cat([self.flow_head.bias, self.vis_conf_head.bias]).to(self.dtype)
        return tokens.to(self.dtype) @ w.t() + b
