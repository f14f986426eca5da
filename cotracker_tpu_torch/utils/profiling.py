"""Profiling surface of the port (port of cotracker_tpu/utils/profiling.py):
torch.profiler traces, per-stage timers, and three readings of one call of
a function on the card: its device launches (from a CUDA graph, or by
kernel name from the profiler) and its device time by kernel.

The users' metric is points·frames per second on the card, so a stage's
time must include the device work it queued: `StageTimer` synchronises the
stage's CUDA device before it reads the clock.
"""

import contextlib
import os
import tempfile
import time
from typing import Callable, Dict

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


def device_launches(fn: Callable[[], object]) -> int:
    """Kernel launches one call of fn makes on the current CUDA device: the
    kernel nodes of a CUDA graph captured from the call (as
    cudaGraphDebugDotPrint writes them). fn runs once before the capture."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        fn()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "call.dot")
        graph.debug_dump(path)
        with open(path) as dot:
            return dot.read().count("{KERNEL")


def kernel_ms(fn: Callable[[], object], reps: int = 10) -> Dict[str, float]:
    """Device ms per call of fn by kernel name (torch.profiler's CUDA
    activity over `reps` calls after one warm call)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: Dict[str, float] = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if t > 0 and e.device_type.name == "CUDA":
            out[e.key] = out.get(e.key, 0.0) + t / 1e3 / reps
    return out


def kernel_launches(fn: Callable[[], object]) -> Dict[str, int]:
    """Device kernel launches of one call of fn by kernel name (torch.
    profiler's CUDA activity over one call after a warm one; its Memcpy and
    Memset events are not kernels and are left out): for a call that cannot
    be captured in a CUDA graph, such as a model forward that copies a host
    value to the device."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: Dict[str, int] = {}
    for e in prof.key_averages():
        if (e.device_type.name == "CUDA" and e.count
                and not e.key.startswith(("Memcpy", "Memset"))):
            out[e.key] = out.get(e.key, 0) + e.count
    return out


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
