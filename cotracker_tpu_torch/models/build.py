"""Model factories (port of cotracker_tpu/models/build.py: CoTracker3 and the
legacy CoTracker2 family; and of the model that
cotracker_tpu/training/trainer.py builds)."""

from typing import Optional, Tuple

import torch

from cotracker_tpu_torch import resolve_device
from cotracker_tpu_torch.models.cotracker2 import CoTracker2
from cotracker_tpu_torch.models.cotracker3 import CoTrackerThree
from cotracker_tpu_torch.ops.kernels.variants import KernelVariants


def build_cotracker(
    checkpoint: Optional[str] = None,
    offline: bool = True,
    window_len: Optional[int] = None,
    dtype=torch.float32,
    model_resolution: Tuple[int, int] = (384, 512),
    fast: bool = False,
    device="cuda",
    seed: int = 0,
    variants: Optional[KernelVariants] = None,
    v2: bool = False,
):
    """Build a CoTrackerThree, or with `v2` a CoTracker2, on `device` (CUDA
    by default; raises without one unless device="cpu"), from a reference
    `.pth` checkpoint or randomly initialised from `seed` (the global RNG is
    left untouched).

    variants: the kernel-variant switches; None reads the JAX package's
    environment variables now (`KernelVariants.from_env()`), a
    KernelVariants overrides them.

    fast=True is the inference fast path: bf16 compute with float32
    coords/vis/conf carries, N chunks of 2048 in the correlation, the K4
    int8 correlation kernel, the folded input projection and the W8A8 block
    kernels K1-K3. On a CPU device the kernel wrappers run their plain
    PyTorch versions.

    v2: the legacy model, window_len 8 (v2) unless given (16 is v2.1);
    `offline` and `variants` do not apply to it, and fast=True is bf16
    compute and nothing else: no kernel runs on its path, as in JAX."""
    dev = resolve_device(device)
    if v2:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = CoTracker2(window_len=window_len or 8, model_resolution=model_resolution,
                               dtype=torch.bfloat16 if fast else dtype)
        return _load(model, checkpoint).to(dev).eval()
    if window_len is None:
        window_len = 60 if offline else 16
    kw = (
        dict(dtype=torch.bfloat16, corr_chunk=2048, fold_input_proj=True, kernels=True)
        if fast else dict(dtype=dtype)
    )
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = CoTrackerThree(
            window_len=window_len, model_resolution=model_resolution,
            variants=KernelVariants.from_env() if variants is None else variants, **kw)
    return _load(model, checkpoint).to(dev).eval()


def _load(model, checkpoint: Optional[str]):
    """Fill `model` from a reference `.pth` checkpoint, if one is given."""
    if checkpoint is not None:
        from cotracker_tpu_torch.models.checkpoint import load_checkpoint

        load_checkpoint(model, checkpoint)
    return model


def build_training_model(
    offline: bool = False,
    window_len: Optional[int] = None,
    model_resolution: Tuple[int, int] = (384, 512),
    corr_kernels: bool = True,
    corr_quant_int8: bool = True,
    remat_iterations: bool = False,
    device="cuda",
    seed: int = 0,
    corr_fuse_mlp1: Optional[bool] = None,
) -> CoTrackerThree:
    """The model the trainer trains (JAX trainer.py:228-236): float32, the
    unfolded iteration with plain updateformer blocks (K1-K7 off), and by
    default the fast training configuration: each level's correlation
    through K4r and the autograd wrapper (`corr_kernels`, int8 with
    `corr_quant_int8`, K4f without), every iteration rematerialised (on
    whenever corr_kernels is, as in JAX). Randomly initialised from `seed`,
    in training mode, on `device` (CUDA by default).

    corr_fuse_mlp1: the wrapper's forward through K4m (the corr_fuse_mlp1
    variant; raises with K4f, as JAX asserts); None reads
    COTRACKER_CORR_FUSE_MLP1 now (`KernelVariants.from_env()`), as the JAX
    training wrapper reads it at trace time."""
    dev = resolve_device(device)
    if window_len is None:
        window_len = 60 if offline else 16
    fuse = KernelVariants.from_env(corr_fuse_mlp1=corr_fuse_mlp1).corr_fuse_mlp1
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = CoTrackerThree(
            window_len=window_len, model_resolution=model_resolution, dtype=torch.float32,
            corr_kernels=corr_kernels, corr_quant_int8=corr_kernels and corr_quant_int8,
            remat_iterations=remat_iterations or corr_kernels,
            variants=KernelVariants(corr_fuse_mlp1=corr_kernels and fuse),
        )
    return model.to(dev).train()
