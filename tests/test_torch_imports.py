"""Import hygiene of the port: cotracker_tpu_torch, chip_smoke.py and the
port's scripts (scripts/torch_*.py) load nothing of JAX, flax or the JAX
package, and the package (its inference, evaluation and training surface
included) loads without OpenCV or PIL. The package is checked in a fresh interpreter,
because tests/conftest.py has already imported JAX in this one."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "cotracker_tpu")

_PROBE = """
import importlib, pkgutil, sys
import cotracker_tpu_torch
for m in pkgutil.walk_packages(cotracker_tpu_torch.__path__, "cotracker_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules if n.split(".")[0] in {forbidden!r})
print("MODULES", len([n for n in sys.modules if n.startswith("cotracker_tpu_torch")]))
print("FORBIDDEN", bad)
print("SURFACE", all(("cotracker_tpu_torch." + m) in sys.modules for m in {surface!r}))
print("CV2", "cv2" in sys.modules)
print("PIL", "PIL" in sys.modules)
"""
# the inference, evaluation and training surface: it loads without OpenCV
# or PIL, which the GPU machine does not have (video files and mp4s import
# cv2 when used, JPEG frames PIL)
SURFACE = ("hub", "models.cotracker2", "demo", "online_demo", "interactive_demo",
           "utils.visualizer", "datasets.annotations", "datasets.dynamic_replica", "datasets.png",
           "datasets.image_ops", "datasets.kubric", "ops.masked", "evaluation.evaluate",
           "training.train_utils", "training.trainer", "datasets.real_videos",
           "evaluation.bootstap_predictor", "training.distill", "training.distill_trainer")


def test_port_imports_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(forbidden=set(FORBIDDEN), surface=SURFACE)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    assert int(lines["MODULES"]) >= 15, out.stdout
    assert lines["FORBIDDEN"] == "[]", out.stdout
    assert lines["SURFACE"] == "True" and lines["CV2"] == "False", out.stdout
    assert lines["PIL"] == "False", out.stdout


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert any(n.startswith("cotracker_tpu_torch") for n in names), names
    assert not [n for n in names if n.split(".")[0] in FORBIDDEN], names


def _imported_names(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("script", ["torch_ubench.py", "torch_breakdown.py", "torch_cores.py",
                                    "torch_k3_parts.py", "torch_k8_parts.py",
                                    "torch_k12_parts.py", "torch_k4f_parts.py", "torch_k4r_parts.py",
                                    "torch_parts.py", "torch_library_chains.py"])
def test_port_scripts_import_no_jax(script):
    names = _imported_names(os.path.join(REPO, "scripts", script))
    assert any(n.startswith("cotracker_tpu_torch") for n in names), names
    assert not [n for n in names if n.split(".")[0] in FORBIDDEN], names
