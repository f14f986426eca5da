"""Profiling surface of the port (port of cotracker_tpu/utils/profiling.py):
torch.profiler traces and per-stage timers.

The users' metric is points·frames per second on the card, so a stage's
time must include the device work it queued: `StageTimer` synchronises the
stage's CUDA device before it reads the clock.
"""

import contextlib
import os
import time
from typing import Dict

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the host and, where a CUDA device is
    present, the device, and write it as a Chrome trace to
    `log_dir/trace.json` (Perfetto or chrome://tracing). Yields the
    profiler, whose key_averages() sum the time by kernel."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _synchronize(sync) -> None:
    """Wait for the CUDA device of `sync` (a tensor, a torch.device or a
    device string); CPU work has finished when it returns."""
    dev = sync.device if isinstance(sync, torch.Tensor) else torch.device(sync)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulating wall-clock timers that include the device work:

        with timer.stage("corr", sync=out_device):
            out = corr_fn(...)   # the device is synchronised on exit
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        if sync is not None:
            _synchronize(sync)  # earlier queued work is not this stage's
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _synchronize(sync)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for k in sorted(self.totals, key=lambda k: -self.totals[k]):
            lines.append(
                f"{k}: {self.totals[k] * 1000:.1f} ms total, "
                f"{self.totals[k] / max(self.counts[k], 1) * 1000:.2f} ms/call x{self.counts[k]}"
            )
        return "\n".join(lines)


def points_frames_per_sec(n_points: int, n_frames: int, seconds: float) -> float:
    """The users' throughput metric."""
    return n_points * n_frames / max(seconds, 1e-9)
