"""Hand-written CUDA kernels of the port (csrc/) and their PyTorch wrappers.

K1 mlp_int8_cuda.fused_time_block_int8          <- mlp_int8_pallas._time_block_kernel
K2 mlp_int8_cuda.fused_space_block_int8         <- mlp_int8_pallas._space_block_kernel
K3 attention_cuda.fused_virtual_from_points_proj <- attention_pallas._v2p_proj_kernel
K4 corr_cuda.corr_volume_int8                   <- corr_pallas._kernel (fuse_combine, int8)
K4r corr_cuda.corr_volume_raw_int8              <- corr_pallas._kernel (int8, no combine)
K4f corr_cuda.corr_volume_float                 <- corr_pallas._kernel (float, no combine)
K4m corr_cuda.corr_mlp1_int8                  <- corr_pallas._kernel (fuse_mlp1)
K5 attention_cuda.fused_time_attention          <- attention_pallas._kernel
K6 attention_cuda.fused_points_from_virtual     <- attention_pallas._p2v_kernel
K7 attention_cuda.fused_virtual_from_points     <- attention_pallas._v2p_kernel
K8 mlp_int8_cuda.fused_ln_qkv_int8              <- mlp_int8_pallas._qkv_kernel
K9 mlp_int8_cuda.fused_attnout_res_mlp_int8     <- mlp_int8_pallas._out_mlp_kernel
K10 mlp_int8_cuda.fused_ln_dense_int8           <- mlp_int8_pallas._dense_kernel
K11 mlp_int8_cuda.fused_space_block_allt_int8   <- mlp_int8_pallas._space_block_allt_kernel
K12 mlp_int8_cuda.fused_ln_mlp_int8             <- mlp_int8_pallas._mlp_kernel

Every wrapper runs its plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors (or raises); `wrapper.launches` counts launches.
The JAX package's kernel-variant switches are `variants.KernelVariants`;
the shape gates that pick a kernel are in `gates`.
"""
