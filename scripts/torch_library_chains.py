"""Library chains: the functions of some of the port's kernels computed by
PyTorch library calls (layer_norm, torch._int_mm through
mlp_int8_cuda.qlinear_plain, torch.bmm). chip_smoke.py and
scripts/torch_cores.py time them beside the kernels, as the kernel table's
library column; the port never calls them. No entry point: imported by
those two scripts (with scripts/ on sys.path).
"""

import torch

from cotracker_tpu_torch.ops.kernels import mlp_int8_cuda

C = 384  # the updateformer's width


def k4f_windows(fm, starts):
    """K4f's 8 x 8 windows gathered from the level map fm (F, Hp, Wp, 128)
    at starts (NP, Tp, 3) = (frame, wy, wx), as (NP, Tp * 64, 128): torch.bmm
    of them with the support's transpose is K4f's contraction alone."""
    n, Tp, _ = starts.shape
    d = torch.arange(8, device=fm.device)
    return fm[starts[..., 0].long()[..., None, None],
              (starts[..., 1].long()[..., None] + d)[..., :, None],
              (starts[..., 2].long()[..., None] + d)[..., None, :]].reshape(n, Tp * 64, 128)


def k10_library_chain(x, lin_, ln, gamma, beta, residual):
    """K10: LN in torch, the affine, the row codes, torch._int_mm, the
    dequant and bias, the residual."""
    x32 = x.float()
    h = torch.nn.functional.layer_norm(x32, (C,), eps=1e-6) if ln else x32
    if gamma is not None:
        h = h * gamma + beta
    y = mlp_int8_cuda.qlinear_plain(*mlp_int8_cuda.quant_rows(h), lin_)
    return (y + x32 if residual else y).to(x.dtype)


def k12_library_chain(x, fc1, fc2, ln):
    """K12: LN in torch, the row codes, torch._int_mm for fc1, the plain GELU
    codes, torch._int_mm for fc2, the residual."""
    x32 = x.float()
    h = torch.nn.functional.layer_norm(x32, (C,), eps=1e-6) if ln else x32
    hq, s0 = mlp_int8_cuda.quant_rows(h)
    uq, s1 = mlp_int8_cuda.quant_gelu(mlp_int8_cuda.qlinear_plain(hq, s0, fc1))
    return (x32 + mlp_int8_cuda.qlinear_plain(uq, s1, fc2)).to(x.dtype)
