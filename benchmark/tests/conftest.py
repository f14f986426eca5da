"""The benchmark's own tests: the harness, the yardstick and the reference
on the CPU at tiny sizes (tests marked `cuda` need the card and skip here).

    python -m pytest benchmark/tests -q
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# a CPU-sized cell of each driver: the program's fast path (its kernels'
# plain versions on the CPU) at 96 x 128, 529 grid points
TINY_HW = [96, 128]
# (each reports the metrics of the real cell named last)
TINY = {
    "tiny-offline": ("cotracker3_offline", {
        "driver": "offline", "grid_size": 23, "frames": 8, "videos": 2},
        "v3-offline-grid10k-t60"),
    "tiny-stream": ("cotracker3_online", {
        "driver": "stream", "grid_size": 23, "stream_frames": 16, "capacity": 16, "videos": 2,
        "warm_up_windows": 1}, "v3-online-grid10k"),
}
# limits of the tiny cells: above what the program reads there on the CPU
# (track_med_px <= 0.02, track_max_px <= 0.04, vis / conf <= 0.002 on seeds
# 1-2) and below what the control reads (>= 0.14, 0.34, 0.014)
TINY_LIMITS = {"track_med_px": 0.06, "track_max_px": 0.15, "vis_max": 0.008, "conf_max": 0.008}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one (run on the card)")


def write_tiny_root(root: Path):
    """A checkout-shaped directory holding tiny cells, for the harness."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "benchmark").mkdir(parents=True)
    for sub in ("metrics", "drivers"):
        shutil.copytree(BENCH / sub, root / "benchmark" / sub)
    for sub in ("configs", "traffic", "workloads"):
        (root / "benchmark" / sub).mkdir()
    bench["configs"], bench["workloads"] = [], []
    for cell, (config, mix, _) in TINY.items():
        cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
        cfg.update(name=f"{cell}-cfg", model_resolution=TINY_HW,
                   window_len=8 if mix["driver"] == "stream" else cfg["window_len"])
        cfg_file = f"benchmark/configs/{cell}-cfg.json"
        (root / cfg_file).write_text(json.dumps(cfg))
        mix = dict(mix, name=cell, height=TINY_HW[0], width=TINY_HW[1],
                   scene={"objects": 3, "max_speed_px": 2.0})
        (root / "benchmark" / "traffic" / f"{cell}.json").write_text(json.dumps(mix))
        (root / "benchmark" / "workloads" / f"{cell}.json").write_text(
            json.dumps({"limits": TINY_LIMITS}))
        bench["configs"].append({"name": f"{cell}-cfg", "source": "tiny", "file": cfg_file,
                                 "reduced": [], "why": "tiny"})
        bench["workloads"].append({"name": cell, "config": f"{cell}-cfg", "traffic": cell,
                                   "chips": 1, "why": "tiny"})
    like = {real: tiny for tiny, (_, _, real) in TINY.items()}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [like[w] for w in m["workloads"] if w in like]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return write_tiny_root(tmp_path / "checkout")
