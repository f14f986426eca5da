"""Whether the timed path's answers are right: the program's results, kept
on the host during the window, against the plain float32 reference on the
same weights and videos, after the window has closed.

The sample is the driver's (`drivers/<driver>.py`, `Driver.sample`), drawn
from the seed: offline one completed video, streaming every window of one
whole stream. Compared over every frame and query point of the sample:

- track_med_px, track_max_px: median and largest distance between the
  program's and the reference's tracks (input pixels);
- vis_max, conf_max: largest gap between the two sides' vis and conf
  probabilities (the visibility flags are thresholds of these).

A cell compares the numbers its `workloads/<cell>.json` gives a limit,
set from readings of the program and of the control (PERF.md §2); a number
whose two readings do not separate gets none.
"""

import torch


def numbers(prog, refs):
    """prog, refs: lists of (tracks, visible, vis, conf) host tensors."""
    d = torch.cat([(a[0] - b[0]).norm(dim=-1).flatten() for a, b in zip(prog, refs)])

    def gap(i):
        return max(float((a[i] - b[i]).abs().max()) for a, b in zip(prog, refs))

    finite = all(bool(torch.isfinite(t).all()) for a in prog for t in (a[0], a[2], a[3]))
    nan = float("nan")
    return {
        "track_med_px": float(d.median()) if finite else nan,
        "track_max_px": float(d.max()) if finite else nan,
        "vis_max": gap(2) if finite else nan,
        "conf_max": gap(3) if finite else nan,
    }


def judge(nums, limits):
    """(correct, {number: {"value", "limit"}}): every number at or under
    its limit (a NaN fails)."""
    table = {k: {"value": nums[k], "limit": lim} for k, lim in limits.items()}
    return all(v["value"] <= v["limit"] for v in table.values()), table
