"""The plain float32 reference held to the port's plain float32 path at a
tiny size, on the same seeded weights (the test may import both; the
reference imports nothing of the program)."""

import json
import subprocess
import sys

import torch

from conftest import BENCH, ROOT
from reference import cotracker3 as ref
from reference import predict
from reference.spec import param_spec
from scene import make_video
from weights import make_state_dict

HW = (64, 96)
TOL_PX = 1e-3  # float32 in another order of operations: ~1e-5 px measured


def cfg(name, **kw):
    c = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    c.update(model_resolution=list(HW), **kw)
    return c


def test_spec_is_the_ports_state_dict():
    from cotracker_tpu_torch.models.cotracker3 import CoTrackerThree

    with torch.device("meta"):
        model = CoTrackerThree()
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {name: shape for name, shape, _, _ in param_spec(cfg("cotracker3_offline"))}
    assert got == want


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import reference.cotracker3, "
            "reference.predict, reference.spec; "
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('cotracker')))"
            ) % str(BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def test_offline_reference_matches_the_ports_plain_path():
    from cotracker_tpu_torch.predictor import CoTrackerPredictor

    c = cfg("cotracker3_offline", window_len=8)
    p = make_state_dict(c, 123, "cpu")
    pred = CoTrackerPredictor(window_len=8, model_resolution=HW, fast=False, device="cpu")
    pred.model.load_state_dict(p, strict=True)
    cap = {}
    pred.model.register_forward_hook(lambda m, a, o: cap.update(vis=o[1], conf=o[2]))
    video = make_video(5, 0, 10, *HW, {"objects": 3, "max_speed_px": 2.0}, "cpu")
    tracks, visible = pred(video[None], grid_size=5)
    with ref.reference_mode():
        rt, rvisible, rvis, rconf = predict.offline_predict(p, c, video, 5)
    assert float((tracks[0] - rt).abs().max()) < TOL_PX
    assert torch.equal(visible[0], rvisible)
    assert float((cap["vis"][0, :, :25] - rvis).abs().max()) < 1e-5
    assert float((cap["conf"][0, :, :25] - rconf).abs().max()) < 1e-5


def test_online_reference_matches_the_ports_plain_path():
    from cotracker_tpu_torch.predictor import CoTrackerOnlinePredictor

    c = cfg("cotracker3_online", window_len=8)
    p = make_state_dict(c, 321, "cpu")
    op = CoTrackerOnlinePredictor(window_len=8, capacity=24, model_resolution=HW, fast=False,
                                  device="cpu")
    op.model.load_state_dict(p, strict=True)
    video = make_video(5, 1, 24, *HW, {"objects": 3, "max_speed_px": 2.0}, "cpu")
    op(video[None, :1], is_first_step=True, grid_size=4)
    prog = [op(video[None, ind:ind + 8]) for ind in range(0, 17, 4)]
    with ref.reference_mode():
        wins = predict.online_windows(p, c, video, 4, 24, len(prog))
    for (tracks, visible), (ind, rt, rvisible, _, _) in zip(prog, wins):
        assert float((tracks[0, ind:ind + 8] - rt).abs().max()) < TOL_PX
        assert torch.equal(visible[0, ind:ind + 8], rvisible)
