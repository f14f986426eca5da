"""One run of one benchmark cell (see run.py for the command).

Everything a cell is made of is found by name: the cell in BENCHMARK.json
names its configuration (`configs[].file`) and its traffic mix
(`benchmark/traffic/<mix>.json`), the mix names its driver
(`benchmark/drivers/<driver>.py`, see traffic.py); the cell's correctness
limits are `benchmark/workloads/<cell>.json`; each metric it reports, end to
end or per layer, is read by `benchmark/metrics/<metric>.py` from the run's
record (a quantity split by the end-to-end metric its cells report,
`<metric>.<part>`, is read by `<metric>.py` unless it has a file of its
own). Adding a cell, a configuration, a mix, a driver or a metric adds
files and entries and edits none.
"""

import argparse
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

import check
import spans as spans_mod
from reference import cotracker3 as ref
from traffic import load_driver, run_window
from weights import make_state_dict

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "cotracker_tpu")


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name, root=ROOT):
    """The cell's entry, configuration, mix, limits and metric entries."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    files = {c["name"]: c["file"] for c in bench["configs"]}

    def reported(m):
        return name in m.get("workloads", [name])

    return {
        "root": root,
        "cell": cell,
        "cfg": _json(root / files[cell["config"]]),
        "mix": _json(root / "benchmark" / "traffic" / f"{cell['traffic']}.json"),
        "limits": _json(root / "benchmark" / "workloads" / f"{name}.json")["limits"],
        "end_to_end": [m for m in bench["end_to_end"] if reported(m)],
        "per_layer": [m for m in bench["per_layer"] if reported(m)],
    }


def metric_reader(name, root=ROOT):
    """read(record) of benchmark/metrics/<name>.py, or of the file of the
    quantity `<name>` splits (the part before its first dot)."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    if not path.is_file():
        path = path.with_name(f"{name.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_info():
    name = torch.cuda.get_device_name(0)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable ({e})"
    return name, torch.cuda.device_count(), smi


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(spec, seed, seconds, trace, device, t0, log=print, max_units=None,
             control=False):
    """Set up the program, warm it up, measure `seconds` (or `max_units`
    units), check the sample against the reference. With `control`, the
    reference one precision step below the configuration's
    (reference.cotracker3.control_rounding) takes the program's place in the
    check. Returns (record, correct, checks table, (driver, sample, answers,
    reference answers))."""
    cfg, mix = spec["cfg"], spec["mix"]
    cuda = torch.device(device).type == "cuda"
    steps = [("imports", time.perf_counter())]
    driver = load_driver(mix["driver"], spec["root"])(cfg, mix, seed, device)
    steps.append(("predictor built, videos made", time.perf_counter()))
    params = make_state_dict(cfg, seed, device)
    driver.model.load_state_dict(params, strict=True)
    _sync(device)
    steps.append(("weights made", time.perf_counter()))
    spans = None
    if trace:
        spans = spans_mod.Spans()
        spans_mod.instrument(driver.model, spans)
    driver.warm_up()
    _sync(device)
    steps.append(("warm-up (kernels built or loaded)", time.perf_counter()))
    setup_s = steps[-1][1] - t0
    log("set-up: " + ", ".join(f"{name} {b - a:.2f} s" for (name, b), (_, a)
                                in zip(steps, [("start", t0)] + steps[:-1])))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    timeline = None
    if trace:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            spans.open_window()
            window_s, work, lat = run_window(driver, seconds, max_units)
            spans.close_window()
        t_red = time.perf_counter()
        timeline = spans_mod.reduce_timeline(spans_mod.device_ops(prof), spans.marks)
        del prof
        log(f"trace reduced in {time.perf_counter() - t_red:.1f} s; "
            f"{timeline['lost_marks']} of {len(spans.marks)} markers lost from it")
    else:
        window_s, work, lat = run_window(driver, seconds, max_units)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    record = {"cfg": cfg, "mix": mix, "setup_s": setup_s, "window_s": window_s, "work": work,
              "latencies_s": lat, "units": driver.unit_shapes(), "peak_bytes": peak,
              "trace": timeline}
    # a unit cut by the window's close runs on, untimed, until the sample is
    # whole: an answer that comes late is late, not wrong
    for _ in range(1000):
        if driver.sample(seed) is not None:
            break
        run_window(driver, None, max_units=1)
    sample = driver.sample(seed)
    answers = driver.answers(sample)
    # the program's state goes before the reference runs on the same card
    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    if control:
        answers = driver.reference(params, sample, ref.control_rounding)
    refs = driver.reference(params, sample)
    correct, table = check.judge(check.numbers(answers, refs), spec["limits"])
    log(f"check of {len(sample)} {driver.unit}(s) against the reference in "
        f"{time.perf_counter() - t_ref:.1f} s")
    return record, correct, table, (driver, sample, answers, refs)


def silent_layers(spec, out):
    """The per-layer metrics the cell lists that a traced run's line lacks:
    a layer whose span lost its calls or its time reads nothing, and the
    run gives no result rather than a line without it."""
    return [m["name"] for m in spec["per_layer"] if m["name"] not in out["metrics"]]


def result_line(spec, record, correct, table, trace, device_kind, count):
    entries = spec["per_layer"] if trace else spec["end_to_end"]
    metrics = {}
    for m in entries:
        v = metric_reader(m["name"], spec["root"])(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_kind, "count": count,
              "memory_peak_bytes": record["peak_bytes"]}
    out = {"correct": bool(correct), "attempted": len(record["latencies_s"]), "failed": 0,
           "metrics": metrics, "device": device}
    if trace and record["trace"] is not None:
        device["busy_s"] = record["trace"]["busy_s"]
        device["window_s"] = record["trace"]["window_s"]
        out["breakdown"] = {"device_ops": record["trace"]["device_ops"],
                            "idle_gaps": record["trace"]["idle_gaps"]}
    out["checks"] = {k: {"value": None if v["value"] != v["value"] else v["value"],
                         "limit": v["limit"]} for k, v in table.items()}
    return out


def main(argv, t0):
    args = parse(argv)
    spec = load_cell(args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s), this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    kind, count, smi = card_info()
    print(f"card: {kind}; devices {count}; nvidia-smi name, power.limit: {smi}", flush=True)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    record, correct, table, _ = run_cell(spec, args.seed, args.seconds, args.trace, "cuda", t0,
                                         log)
    found = forbidden_modules()
    if found:
        print(f"no result: the run loaded {found}, which the port must not use",
              file=sys.stderr)
        return 4
    out = result_line(spec, record, correct, table, args.trace, kind, chips)
    silent = silent_layers(spec, out) if args.trace else []
    if silent:
        print(f"no result: the traced run read nothing for {silent} (a span that lost its "
              "calls or its time)", file=sys.stderr)
        return 5
    print(f"correct: {out['correct']}", file=sys.stderr)
    for k, v in table.items():
        print(f"check {k} = {v['value']!r} limit {v['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0

