"""cotracker_tpu_torch — the PyTorch/CUDA port of cotracker_tpu for NVIDIA Hopper.

The package mirrors the JAX package's module names (`ops/`, `models/`,
`predictor.py`, `training/`, `datasets/`, `evaluation/`) and its public
layouts: channel-last feature maps (B, T, H, W, C), track-major tokens
(B, N, T, C), videos (B, T, 3, H, W) at the predictor. Plain tensor code is
PyTorch; the kernels (K1-K12, K4r, K4f, K4m) are hand-written CUDA for sm_90a
(`csrc/`), built at first use and bound through ctypes
(`ops/kernels/_build.py`).

    from cotracker_tpu_torch import CoTrackerPredictor, CoTrackerOnlinePredictor

Entry points run on the GPU by default: `device="cuda"` raises when no CUDA
device is present, and `device="cpu"` selects the plain PyTorch versions of
every kernel (what the CPU tests run).
"""

import torch

__version__ = "0.2.0"
__all__ = ["CoTrackerOnlinePredictor", "CoTrackerPredictor", "resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """Return `device` as a torch.device, raising if CUDA is asked for and
    absent (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


# after resolve_device, which the model factory imports from here
from cotracker_tpu_torch.predictor import (  # noqa: E402
    CoTrackerOnlinePredictor, CoTrackerPredictor,
)
