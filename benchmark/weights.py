"""Seeded float32 weights of a configuration, made on the device.

One generator on the device, seeded from --seed, draws every parameter's
values in one call; each parameter is then its slice, scaled to the
variance of PyTorch's default initialisation (uniform in +-1/sqrt(fan_in),
standard deviation 1/sqrt(3 fan_in)). Affine LayerNorms start at weight 1
and bias 0, the virtual tracks at unit variance, and the flow and vis/conf
heads at `head_scale` times the default (the configuration's `assumed`
value): small updates keep the six refinements contractive, so rounding
differences stay proportional to the precision that made them.
"""

import math

import torch

from reference.spec import param_spec


def make_state_dict(cfg, seed, device):
    """{name: float32 tensor on `device`} for every parameter of `cfg`."""
    spec = param_spec(cfg)
    total = sum(math.prod(shape) for _, shape, _, _ in spec)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, fan_in, role in spec:
        n = math.prod(shape)
        x = flat[at:at + n].view(shape)
        at += n
        if role == "norm_weight":
            x = torch.ones(shape, device=device)
        elif role == "norm_bias":
            x = torch.zeros(shape, device=device)
        elif role != "virtual":
            std = 1.0 / math.sqrt(3.0 * fan_in)
            if role in ("head", "head_bias"):
                std *= cfg["head_scale"]
            x = x * std
        out[name] = x
    return out
