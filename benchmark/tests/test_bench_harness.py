"""The harness on the CPU: the cells' files, BENCHMARK.json against the
contract, the result line, the arithmetic of rates, percentiles and idle
shares, metrics found by name, and the import check."""

import json
import os
import re
import subprocess
import sys

import pytest

import harness
import spans
from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_finds_its_files_by_name():
    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    for w in b["workloads"]:
        cfg = configs[w["config"]]
        assert (ROOT / cfg["file"]).is_file() and cfg["file"].startswith("benchmark/")
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{mix['driver']}.py").is_file()
        assert "limits" in json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        spec = harness.load_cell(w["name"])
        for m in spec["end_to_end"] + spec["per_layer"]:
            assert callable(harness.metric_reader(m["name"]))
        names = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2 and spec["per_layer"]


def test_benchmark_json_keeps_the_contract():
    b = bench()
    assert set(b) == KEYS and 1 <= b["run_seconds"] <= 51
    assert b["command"][:2] == ["python3", "benchmark/run.py"] and b["paths"] == ["benchmark"]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                    "higher")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m) <= {"name", "unit", "better", "source", "layer",
                                                 "moves", "workloads"}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    names = [w["name"] for w in b["workloads"]]
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(names)
    assert all(w["chips"] in (1, 4) and len(w["why"]) <= 200 for w in b["workloads"])
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(names) // 4)
    for c in b["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["source"]) <= 200
    assert len(json.dumps(b)) < 64 * 1024


def _record(**kw):
    cfg = json.loads((BENCH / "configs" / "cotracker3_online.json").read_text())
    rec = {"cfg": cfg, "mix": {"driver": "stream"}, "setup_s": 12.5, "window_s": 4.0,
           "work": 800_000, "latencies_s": [0.3] * 9 + [0.9], "units": [(10_000, 16, 8)] * 10,
           "peak_bytes": 3 * 2**30, "trace": None}
    rec.update(kw)
    return rec


def test_result_line_has_the_contracts_keys(tiny_root):
    spec = harness.load_cell("tiny-stream", tiny_root)
    table = {"track_max_px": {"value": 0.1, "limit": 0.2}}
    out = harness.result_line(spec, _record(), True, table, 0, "NVIDIA H100 80GB HBM3", 1)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["metrics"]) == {"pf_per_s.stream", "window_p90_ms", "peak_gib", "setup_s"}
    trace = {"window_s": 4.0, "busy_s": 3.0, "spans": {}, "device_ops": [["k", 1.0]],
             "idle_gaps": [["gap", 0.1]]}
    out = harness.result_line(spec, _record(trace=trace), True, table, 1, "H100", 1)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert out["device"]["busy_s"] == 3.0 and out["device"]["window_s"] == 4.0
    assert out["metrics"]["device_idle_pct.stream"]["value"] == pytest.approx(25.0)
    # the layers whose spans read nothing: the run gives no result without them
    assert set(harness.silent_layers(spec, out)) == {
        f"{m}.stream" for m in ("encoder_ms", "corr_ms", "corr_roofline", "uf_ms",
                                "uf_roofline")}
    trace["spans"] = {s: {"device_s": 0.5, "count": 2} for s in ("encoder", "corr", "uf")}
    trace["spans"]["corr"]["device_s"] = 0.0  # calls, but their time lost
    out = harness.result_line(spec, _record(trace=trace), True, table, 1, "H100", 1)
    assert set(harness.silent_layers(spec, out)) == {"corr_ms.stream", "corr_roofline.stream"}


def test_rate_is_all_work_over_all_time_and_p90_is_over_every_window(tiny_root):
    read = {m: harness.metric_reader(m, tiny_root) for m in ("pf_per_s", "window_p90_ms")}
    # two streams: one fast window and nine slow ones in the first, the
    # reverse in the second; chunk medians (0.9 and 0.3) would miss the tail
    lat = [0.1] + [0.9] * 9 + [0.3] * 9 + [1.5]
    rec = _record(latencies_s=lat, work=1_600_000, window_s=sum(lat) + 0.4)
    assert read["pf_per_s"](rec) == pytest.approx(1_600_000 / (sum(lat) + 0.4))
    assert read["window_p90_ms"](rec) == pytest.approx(900.0)
    assert read["window_p90_ms"](_record(mix={"driver": "offline"})) is None


def _marker(t, code):  # a marker record of the length that carries `code`
    return ("spin_kernel", t, t + (1_000, 10_000, 30_000, 70_000)[code])


def test_idle_share_and_spans_of_a_synthetic_timeline():
    us = 1_000
    marks = [("window", "warm")] * 3 + [("window", "open"), ("uf", "enter"), ("uf", "exit"),
                                        ("corr", "enter"), ("corr", "exit"),
                                        ("window", "close")]
    ops = [_marker(-900 * us, 1), _marker(-800 * us, 2),  # the first warm marker lost
           _marker(0, 3), ("conv", 100 * us, 200 * us), _marker(210 * us, 0),
           ("k1_front_kernel", 220 * us, 340 * us), ("k1_tail_kernel", 300 * us, 400 * us),
           _marker(410 * us, 1), ("elementwise", 600 * us, 700 * us),
           _marker(710 * us, 2),  # corr's entry; its exit's record lost
           ("corr_volume_kernel", 750 * us, 800 * us), _marker(1000 * us, 0)]
    t = spans.reduce_timeline(ops, marks)
    assert t["window_s"] == pytest.approx(1001e-6) and t["lost_marks"] == 2
    assert t["busy_s"] == pytest.approx((100 + 180 + 100 + 50) * 1e-6)  # overlap once
    assert t["spans"]["uf"] == {"device_s": pytest.approx(220e-6), "count": 1}
    assert t["spans"]["corr"] == {"device_s": pytest.approx(50e-6), "count": 1}
    assert t["idle_gaps"][0] == ["window end: after corr_volume_kernel", pytest.approx(201e-6)]
    assert t["device_ops"][0][0].startswith("K1 front")
    with pytest.raises(ValueError):  # the window's own marker lost
        spans.reduce_timeline([o for o in ops if o[1] != 0], marks)


def test_a_metric_file_is_found_by_name(tiny_root):
    (tiny_root / "benchmark" / "metrics" / "throwaway_windows.py").write_text(
        "def read(rec):\n    return float(len(rec['latencies_s']))\n")
    b = json.loads((tiny_root / "BENCHMARK.json").read_text())
    b["per_layer"].append({"name": "throwaway_windows", "unit": "windows", "better": "higher",
                           "source": "program_counter", "layer": "device",
                           "moves": "pf_per_s.stream"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(b))
    spec = harness.load_cell("tiny-stream", tiny_root)
    out = harness.result_line(spec, _record(), True, {}, 1, "H100", 1)
    assert out["metrics"]["throwaway_windows"] == {"value": 10.0, "unit": "windows"}
    # a split quantity is read by its base file unless it has one of its own
    assert harness.metric_reader("pf_per_s.stream", tiny_root)(_record()) == 200_000.0
    (tiny_root / "benchmark" / "metrics" / "pf_per_s.stream.py").write_text(
        "def read(rec):\n    return -1.0\n")
    assert harness.metric_reader("pf_per_s.stream", tiny_root)(_record()) == -1.0


def test_a_driver_and_its_cell_are_added_as_files(tiny_root):
    """A new traffic driver is a file found by the name its mix gives; the
    cell that uses it is data alone: no file of the harness is edited."""
    bench = tiny_root / "benchmark"
    (bench / "drivers" / "throwaway.py").write_text(
        "import importlib.util, pathlib\n"
        "p = pathlib.Path(__file__).with_name('offline.py')\n"
        "s = importlib.util.spec_from_file_location('throwaway_base', p)\n"
        "m = importlib.util.module_from_spec(s); s.loader.exec_module(m)\n"
        "class Driver(m.Driver):\n    unit = 'clip'\n")
    mix = json.loads((bench / "traffic" / "tiny-offline.json").read_text())
    (bench / "traffic" / "throwaway-mix.json").write_text(
        json.dumps(dict(mix, name="throwaway-mix", driver="throwaway", frames=6)))
    (bench / "workloads" / "tiny-throwaway.json").write_text(
        (bench / "workloads" / "tiny-offline.json").read_text())
    b = json.loads((tiny_root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "tiny-throwaway", "config": "tiny-offline-cfg",
                           "traffic": "throwaway-mix", "chips": 1, "why": "throwaway"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "tiny-offline" in m.get("workloads", []):
            m["workloads"].append("tiny-throwaway")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(b))
    spec = harness.load_cell("tiny-throwaway", tiny_root)
    record, correct, table, (driver, sample, _, _) = harness.run_cell(
        spec, 2**31 + 3, None, 0, "cpu", 0.0, log=lambda m: None, max_units=1)
    assert type(driver).__name__ == "Driver" and driver.unit == "clip"
    assert correct, table
    out = harness.result_line(spec, record, correct, table, 0, "H100", 1)
    assert set(out["metrics"]) == {"pf_per_s", "setup_s"}  # no peak without a card
    assert record["units"] == [(23 * 23, 6, 6)]


def test_import_check_compares_whole_top_level_names():
    code = ("import sys; sys.path[:0] = [%r, %r]; import harness, traffic, check, spans, "
            "calibrate; from cotracker_tpu_torch.predictor import CoTrackerPredictor; "
            "print(harness.forbidden_modules()); import types; "
            "sys.modules['flax.linen'] = types.ModuleType('flax.linen'); "
            "print(harness.forbidden_modules())") % (str(BENCH), str(ROOT))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["[]", "['flax']"]


@pytest.mark.parametrize("where", ["checkout", "benchmark_only"])
def test_no_result_without_a_card_or_without_the_program(tmp_path, where):
    root = ROOT
    if where == "benchmark_only":  # BENCHMARK.json and the files under paths alone
        import shutil
        root = tmp_path / "co"
        shutil.copytree(BENCH, root / "benchmark",
                        ignore=shutil.ignore_patterns("__pycache__", "tests"))
        shutil.copy(ROOT / "BENCHMARK.json", root)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "v3-online-grid10k", "--seed", str(2**31 + 5), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=root)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
