"""The yardstick from shapes alone: the frozen W8A8 bounds against
chip_smoke's numbers, and the FLOP count and correlation bound."""

import json

import pytest

import bounds
import flops
from conftest import BENCH


def cfg(name="cotracker3_offline"):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_k1_and_k2_bounds_reproduce_chip_smoke():
    # chip_smoke's K1 / K2 bounds at 10,240 tracks x 60 frames (ops-bound)
    assert 1e3 * bounds.k1_bound(10240, 60) == pytest.approx(1.156, abs=5e-4)
    assert 1e3 * bounds.k2_bound(10240, 60, 64) == pytest.approx(0.977, abs=5e-4)


def test_flops_and_correlation_bound_follow_the_shapes():
    c = cfg()
    # ~34 MFLOP a track, frame and iteration, most of it the correlation MLP
    per = flops.iteration_flops(10_000, 60, c) / 600_000
    assert 30e6 < per < 38e6
    assert flops.encoder_flops(384, 512) == pytest.approx(51.8e9, rel=0.01)
    one, two = bounds.corr_call_s(5_000, 60, c), bounds.corr_call_s(10_000, 60, c)
    assert two == pytest.approx(2 * one, rel=1e-6)  # ops-bound: linear in the tracks
    assert 1e3 * two == pytest.approx(22.18, abs=0.01)
    assert 1e3 * bounds.uf_call_s(10_000, 60, c) == pytest.approx(41.91, abs=0.01)
