"""Readings for a cell's correctness limits, in one process, through the
same code path that decides a run's `correct` (harness.run_cell):

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 7 8 9] [--out calibrate.jsonl]

For each of --seeds, the cell's timed path runs one unit (and on, untimed,
until the check's sample is whole), and the sample is compared with the
reference as a run compares it. Beside the program's numbers each line
holds the reference's motion (its tracks' distance from their queries,
median and largest) and what three faults planted in the program's answers
as they come back would read: `half_left_out` (the second half of the
tracks never leaves its queries), `at_queries` (no track leaves its query:
what an online step that hands its state back answers) and `moved_16px`
(one track moved 16 pixels). For each of --control-seeds the control
takes the program's place (run_cell's `control`). Prints one JSON line a
reading and appends them to --out. The benchmark's runs do not run this.
"""

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

import torch  # noqa: E402

import check  # noqa: E402
from harness import load_cell, run_cell  # noqa: E402


def planted(answers, queries, fault):
    """The program's answers with `fault` planted in them."""
    out = []
    for tracks, visible, vis, conf in answers:
        tracks = tracks.clone()
        n = tracks.shape[1]
        if fault == "half_left_out":
            tracks[:, n // 2:] = queries[n // 2:]
        elif fault == "at_queries":
            tracks[:] = queries
        elif fault == "moved_16px":
            tracks[:, 3, 0] += 16.0
        out.append((tracks, visible, vis, conf))
    return out


def motion(refs, queries):
    d = torch.cat([(r[0] - queries).norm(dim=-1).flatten() for r in refs])
    return {"median": float(d.median()), "max": float(d.max())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    spec = load_cell(args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    out = open(args.out, "a") if args.out else None
    runs = [(s, False) for s in args.seeds] + [(s, True) for s in args.control_seeds]
    for seed, control in runs:
        t0 = time.perf_counter()
        _, correct, table, (driver, sample, answers, refs) = run_cell(
            spec, seed, None, 0, device, t0, log=lambda m: None, max_units=1, control=control)
        row = {"cell": args.workload, "side": "control" if control else "program",
               "seed": seed, "numbers": {k: v["value"] for k, v in table.items()},
               "correct": correct, "units": len(sample), "seconds": time.perf_counter() - t0}
        if not control:
            q = driver.queries_px(sample)
            row["ref_motion_px"] = motion(refs, q)
            row["faults"] = {f: check.numbers(planted(answers, q, f), refs)
                             for f in ("half_left_out", "at_queries", "moved_16px")}
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del driver, sample, answers, refs
        if device == "cuda":
            torch.cuda.empty_cache()
    if out:
        out.close()


if __name__ == "__main__":
    main()
