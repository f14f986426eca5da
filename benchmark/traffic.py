"""The one traffic generator. A mix file (`traffic/<mix>.json`) is data: the
`driver` that sends it and that driver's parameters. A driver is a file of
its own, `drivers/<driver>.py`, found by that name, whose `Driver` class
builds the program under test as the configuration states, makes the
mix's inputs from the seed, sends them in a closed loop (the next unit
leaves when the last one's results are on the host), keeps every result
on the host, and knows how its answers are checked:

    Driver(cfg, mix, seed, device)       the program built, its inputs made
    .model                               the model, for the spans and the weights
    .unit                                what one unit of work is ("video", "window")
    .warm_up()                           the cell's own shapes, once each
    .units()                             yields (work, seconds) a completed unit, without end
    .unit_shapes()                       (points, frames in the call, frames encoded) a kept unit
    .sample(seed)                        the kept results the check compares, or None
    .answers(sample)                     the program's (tracks, visible, vis, conf) on the host
    .reference(params, sample, rq)       the plain reference's, on the same inputs
    .queries_px(sample)                  the sample's query positions, input pixels
    .release()                           drop the program's state before the reference runs

A new driver is a new file; a new mix for an existing driver is data alone.
"""

import importlib.util
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def load_driver(name, root=ROOT):
    """The `Driver` class of benchmark/drivers/<name>.py."""
    path = root / "benchmark" / "drivers" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no traffic driver {name!r} ({path} does not exist)")
    spec = importlib.util.spec_from_file_location(f"bench_driver_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Driver


def run_window(driver, seconds, max_units=None):
    """Units until `seconds` have passed (or `max_units` are done): the
    window closes when the unit that crossed the time returns. Returns
    (window seconds, work, unit latencies). The driver's loop goes on where
    it stopped at the next call."""
    if getattr(driver, "loop", None) is None:
        driver.loop = driver.units()
    work, lat = 0, []
    t0 = time.perf_counter()
    for w, dt in driver.loop:
        work += w
        lat.append(dt)
        if (max_units is not None and len(lat) >= max_units) or (
                max_units is None and time.perf_counter() - t0 >= seconds):
            break
    return time.perf_counter() - t0, work, lat
