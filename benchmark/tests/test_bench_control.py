"""The comparison that decides `correct`, shown to fail: the control (the
reference one precision step below the configuration's) and the timed path
broken in each way a cell can break, driven through the rest of a run on
the CPU at a tiny size."""

import math
import subprocess
import sys
import time

import pytest
import torch

import check
import harness
from conftest import ROOT, TINY_LIMITS
from reference import cotracker3 as ref
from reference import predict
from scene import make_video
from weights import make_state_dict

SEED = 2**31 + 11


def run(tiny_root, cell, control=False):
    spec = harness.load_cell(cell, tiny_root)
    _, correct, table, _ = harness.run_cell(spec, SEED, 0.5, 0, "cpu", time.perf_counter(),
                                            log=lambda m: None, control=control)
    return correct, {k: v["value"] for k, v in table.items()}


def test_sound_run_passes_and_the_control_fails(tiny_root):
    correct, nums = run(tiny_root, "tiny-offline")
    assert correct, nums
    # the control takes the program's place in the same run's check
    correct, ctrl = run(tiny_root, "tiny-offline", control=True)
    assert not correct, ctrl
    # the control misses by several times the room the program leaves
    assert ctrl["track_max_px"] > 2 * TINY_LIMITS["track_max_px"]
    # by hand: the reference at the control's rounding against the reference
    spec = harness.load_cell("tiny-offline", tiny_root)
    cfg, mix = spec["cfg"], spec["mix"]
    p = make_state_dict(cfg, SEED, "cpu")
    video = make_video(SEED, 0, mix["frames"], *cfg["model_resolution"], mix["scene"], "cpu")
    with ref.reference_mode():
        r = [predict.offline_predict(p, cfg, video, mix["grid_size"])]
        c = [predict.offline_predict(p, cfg, video, mix["grid_size"], ref.control_rounding)]
    ok, _ = check.judge(check.numbers(c, r), TINY_LIMITS)
    assert not ok


def _altered_answer(monkeypatch):
    from cotracker_tpu_torch.models.cotracker3 import CoTrackerThree

    forward = CoTrackerThree.forward

    def altered(self, *a, **k):  # one track's answer moved by 16 pixels where it is made
        coords, vis, conf, extra = forward(self, *a, **k)
        coords = coords.clone()
        coords[:, :, 3, 0] += 16.0
        return coords, vis, conf, extra

    monkeypatch.setattr(CoTrackerThree, "forward", altered)


def _half_left_out(monkeypatch):
    from cotracker_tpu_torch.models.cotracker3 import CoTrackerThree

    forward = CoTrackerThree.forward

    def half(self, video, queries, *a, **k):  # the second half of the tracks never moves
        coords, vis, conf, extra = forward(self, video, queries, *a, **k)
        n = queries.shape[1] // 2
        coords = coords.clone()
        coords[:, :, n:] = queries[:, None, n:, 1:]
        return coords, vis, conf, extra

    monkeypatch.setattr(CoTrackerThree, "forward", half)


def _state_unchanged(monkeypatch):
    from cotracker_tpu_torch.models.cotracker3 import CoTrackerThree

    def unchanged(self, state, video_chunk, queries, **k):  # the window's state handed back
        S = video_chunk.shape[1]
        return (state._replace(ind=state.ind + S // 2), state.coords.clone(),
                torch.sigmoid(state.vis), torch.sigmoid(state.conf))

    monkeypatch.setattr(CoTrackerThree, "online_step", unchanged)


@pytest.mark.parametrize("fault, cell", [
    (_altered_answer, "tiny-offline"),
    (_half_left_out, "tiny-offline"),
    (_state_unchanged, "tiny-stream"),
])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault, cell):
    fault(monkeypatch)
    correct, nums = run(tiny_root, cell)
    assert not correct, nums


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "v3-offline-grid10k-t60", "--seed", str(SEED), "--seconds", "3",
                          "--trace", "0"], capture_output=True, text=True, timeout=900,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    import json

    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and math.isfinite(line["metrics"]["pf_per_s"]["value"])
