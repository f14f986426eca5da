"""What the parts probes (scripts/torch_*_parts.py) share: copies of one
kernel source under build/<prefix>_parts/ with parts of its work edited
out, all built at once (one nvcc process each, the flags of
ops/kernels/_build.py), their entry bound through ctypes like the kernel's
own, and CUDA-event timing. No entry point: imported by the probes.
"""

import ctypes
import shutil
import subprocess
import sys

import torch

from cotracker_tpu_torch.ops.kernels import _build


def card(probe: str) -> str:
    """The card's name and power limit as nvidia-smi prints them; exits
    without a CUDA device."""
    if not torch.cuda.is_available():
        sys.exit(f"{probe}: needs a CUDA device")
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def fresh_dir(prefix: str):
    """build/<prefix>_parts/, emptied."""
    out = _build.BUILD_DIR.parent / f"{prefix}_parts"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    return out


def edited_copies(source: str, prefix: str, variants: dict) -> dict:
    """The headers and, for each variant (name: its (old, new) text edits),
    a copy of csrc/<source> with its edits made, in fresh_dir(prefix);
    returns each variant's .cu path."""
    out = fresh_dir(prefix)
    for f in _build.CSRC.glob("*.cuh"):
        shutil.copy(f, out / f.name)
    src = (_build.CSRC / source).read_text()
    paths = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{source}: the part {name} is not where this probe expects it")
            text = text.replace(old, new)
        paths[name] = out / f"{prefix}_{name}.cu"
        paths[name].write_text(text)
    return paths


def build(paths: dict, entry: str, *argtypes) -> dict:
    """Builds every copy at once and binds `entry` (int-returning, the
    given ctypes argument types) in each."""
    procs = {n: subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                                  str(p.with_suffix(".so")), str(p)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for n, p in paths.items()}
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{paths[name].name} did not build:\n{log[-3000:]}")
        fns[name] = _build.bind(ctypes.CDLL(str(paths[name].with_suffix(".so"))), entry, *argtypes)
    return fns


def time_ms(fn, reps=20):
    """Mean ms a call over `reps` calls after one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps
