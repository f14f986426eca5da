"""The port's evaluation layer against the JAX package's, on the CPU: the
TAP-Vid and Dynamic Replica metrics, the samplers, the TAP-Vid reader, the
EvaluationPredictor (joint and single-point) with the plain float32 model,
and the evaluation CLI's flags and a dry run writing its result files.

Tolerances: the metrics are the same numpy formulas (1e-6); the sampler
and reader outputs are the same numbers (exact), except where the reader
resizes frames: PyTorch's bilinear against OpenCV's fixed-point INTER_LINEAR,
within one uint8 code. The predictor: the golden tolerances of
tests/test_models.py at iters=2 (tracks rtol 1e-3 / atol 2e-2 pixels,
vis * conf 1e-3).
"""

import io
import json
import os
import pickle

import numpy as np
import pytest
import torch

from cotracker_tpu.datasets.tap_vid import TapVidDataset as JaxTapVidDataset
from cotracker_tpu.evaluation import eval_utils as jax_eval_utils
from cotracker_tpu.evaluation.evaluation_predictor import (
    EvaluationPredictor as JaxEvaluationPredictor,
)
from cotracker_tpu.models.cotracker3 import CoTrackerThree as JaxCoTrackerThree
from cotracker_tpu.ops import samplers as jax_samplers
from cotracker_tpu_torch.datasets.tap_vid import TapVidDataset, resize_video
from cotracker_tpu_torch.datasets.utils import collate_fn
from cotracker_tpu_torch.evaluation import eval_utils
from cotracker_tpu_torch.evaluation.evaluate import DefaultConfig, parse_config, run_eval
from cotracker_tpu_torch.evaluation.evaluation_predictor import EvaluationPredictor
from cotracker_tpu_torch.models.checkpoint import from_jax_params
from cotracker_tpu_torch.models.cotracker3 import CoTrackerThree
from cotracker_tpu_torch.ops import samplers
from test_torch_model import random_params

torch.set_num_threads(2)


def _metric_case(rng, B=2, N=13, T=9):
    qf = rng.integers(0, T, (B, N)).astype(np.float64)
    query_points = np.stack([qf, rng.random((B, N)) * 255, rng.random((B, N)) * 255], axis=-1)
    gt_occ = rng.random((B, N, T)) > 0.7
    gt_occ[np.arange(B)[:, None], np.arange(N)[None], qf.astype(int)] = False
    gt_tracks = rng.random((B, N, T, 2)) * 255
    pred_occ = rng.random((B, N, T)) > 0.6
    pred_tracks = gt_tracks + rng.normal(0, 4, gt_tracks.shape)
    return query_points, gt_occ, gt_tracks, pred_occ, pred_tracks


@pytest.mark.parametrize("mode", ["first", "strided"])
def test_tapvid_metrics_match_jax(mode):
    rng = np.random.default_rng(0)
    for _ in range(3):
        case = _metric_case(rng)
        ours = eval_utils.compute_tapvid_metrics(*case, query_mode=mode)
        ref = jax_eval_utils.compute_tapvid_metrics(*case, query_mode=mode)
        assert set(ours) == set(ref) and len(ours) == 13
        for k in ref:
            np.testing.assert_allclose(ours[k], ref[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_dynamic_replica_metrics_match_jax():
    rng = np.random.default_rng(1)
    gt = rng.random((1, 12, 20, 2)) * [95, 63]
    pred = gt + rng.normal(0, 3, gt.shape)
    vis = (rng.random((1, 12, 20)) > 0.3).astype(np.float64)
    ours = eval_utils.compute_dynamic_replica_metrics(pred, gt, vis, (64, 96))
    ref = jax_eval_utils.compute_dynamic_replica_metrics(pred, gt, vis, (64, 96))
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_samplers_match_jax():
    pytest.importorskip("cv2")
    ours = samplers.get_uniformly_sampled_pts(17, 30, (48, 64), rng=np.random.default_rng(3))
    ref = jax_samplers.get_uniformly_sampled_pts(17, 30, (48, 64), rng=np.random.default_rng(3))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    tg = samplers.get_uniformly_sampled_pts(17, 30, (48, 64), rng=torch.Generator().manual_seed(3))
    assert tg.shape == (1, 17, 3) and float(tg[..., 0].max()) < 30
    assert float(tg[..., 1].max()) < 64 and float(tg[..., 2].max()) < 48
    video = (np.random.default_rng(4).random((1, 8, 48, 64, 3)) * 255).astype(np.float32)
    ours = samplers.get_sift_sampled_pts(video, 16, 8, (48, 64), rng=np.random.default_rng(5))
    ref = jax_samplers.get_sift_sampled_pts(video, 16, 8, (48, 64), rng=np.random.default_rng(5))
    assert ours.shape[1] > 0
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def _davis_pickle(path, T=10, H=256, W=256, N=6, seed=1):
    rng = np.random.default_rng(seed)
    data = {}
    for name in ("seq_a", "seq_b"):
        occ = rng.random((N, T)) > 0.6
        occ[:, 0] = False
        occ[0] = True  # a track never visible: dropped by the 'first' sampling
        data[name] = {"video": (rng.random((T, H, W, 3)) * 255).astype(np.uint8),
                      "points": rng.random((N, T, 2)).astype(np.float32), "occluded": occ}
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return str(path)


@pytest.mark.parametrize("queried_first", [True, False], ids=["first", "strided"])
def test_tapvid_reader_matches_jax(tmp_path, queried_first):
    """At the raster size the resize is the identity on both sides: exact."""
    pytest.importorskip("cv2")
    p = _davis_pickle(tmp_path / "davis.pkl")
    ours = TapVidDataset(p, "davis", queried_first=queried_first)
    ref = JaxTapVidDataset(p, "davis", queried_first=queried_first)
    assert len(ours) == len(ref) == 2
    for i in range(2):
        a, b = ours[i], ref[i]
        assert a.seq_name == b.seq_name
        for k in ("video", "trajectory", "visibility", "query_points"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    batch = collate_fn([ours[0], ours[0]])
    assert batch.video.shape == (2, *ours[0].video.shape) and batch.valid is None
    assert batch.seq_name == ["seq_a", "seq_a"]


def test_tapvid_resize_and_jpeg_frames_within_one_code(tmp_path):
    """A Kinetics-format shard (JPEG frames, decoded with PIL) at 60x80
    resized to the 256x256 raster, and a downscale: within one code of
    OpenCV's INTER_LINEAR."""
    cv2 = pytest.importorskip("cv2")
    from PIL import Image

    rng = np.random.default_rng(2)
    for shape, out in (((3, 60, 80, 3), (256, 256)), ((3, 300, 420, 3), (256, 256))):
        v = (rng.random(shape) * 255).astype(np.uint8)
        ref = np.stack([cv2.resize(f, out[::-1], interpolation=cv2.INTER_LINEAR) for f in v])
        assert np.abs(resize_video(v, out).astype(int) - ref).max() <= 1
    frames = []
    for f in (rng.random((5, 60, 80, 3)) * 255).astype(np.uint8):
        buf = io.BytesIO()
        Image.fromarray(f).save(buf, format="JPEG")
        frames.append(buf.getvalue())
    entry = {"video": frames, "points": rng.random((4, 5, 2)).astype(np.float32),
             "occluded": np.zeros((4, 5), bool)}
    with open(tmp_path / "0000_of_0010.pkl", "wb") as f:
        pickle.dump([entry], f)
    a = TapVidDataset(str(tmp_path), "kinetics")[0]
    b = JaxTapVidDataset(str(tmp_path), "kinetics")[0]
    assert np.abs(a.video - b.video).max() <= 1
    np.testing.assert_array_equal(a.trajectory, b.trajectory)
    np.testing.assert_array_equal(a.query_points, b.query_points)


@pytest.fixture(scope="module")
def eval_predictors():
    """One predictor per framework, shared by both modes: the single-point
    forwards pad to the joint forward's track count, so JAX compiles once."""
    params = random_params(JaxCoTrackerThree(), seed=7)
    jm = JaxCoTrackerThree(window_len=8, model_resolution=(32, 48))
    model = from_jax_params(CoTrackerThree(window_len=8, model_resolution=(32, 48)), params)
    kw = dict(interp_shape=(32, 48), grid_size=2, local_grid_size=2, n_iters=2)
    return JaxEvaluationPredictor(jm, params, **kw), EvaluationPredictor(model.eval(), **kw)


@pytest.mark.parametrize("single_point", [False, True], ids=["joint", "single_point"])
def test_evaluation_predictor_matches_jax(eval_predictors, single_point):
    rng = np.random.default_rng(8)
    video = (rng.random((1, 8, 3, 40, 40)) * 255).astype(np.float32)
    n = 3 if single_point else 5
    queries = np.stack([rng.integers(0, 8, n), rng.random(n) * 39, rng.random(n) * 39],
                       -1)[None].astype(np.float32)
    for pred in eval_predictors:
        pred.single_point = single_point
    ref, ours = (pred(video, queries) for pred in eval_predictors)
    assert ours[0].shape == (1, 8, n, 2) and ours[1].shape == (1, 8, n)
    np.testing.assert_allclose(ours[0], np.asarray(ref[0]), rtol=1e-3, atol=2e-2)
    np.testing.assert_allclose(ours[1], np.asarray(ref[1]), rtol=1e-3, atol=1e-3)


def test_cli_flag_surface(tmp_path, monkeypatch):
    assert parse_config([]).offline_model is True
    assert parse_config([]).device == "cuda"
    assert parse_config(["--no-offline_model"]).offline_model is False
    assert parse_config(["--online"]).offline_model is False
    assert parse_config(["--single_point", "--fast"]).single_point is True
    cfg = parse_config(["--device", "cpu", "--window_len", "16", "--n_iters", "2",
                        "--checkpoint", "w.pth"])
    assert (cfg.device, cfg.window_len, cfg.n_iters, cfg.checkpoint) == ("cpu", 16, 2, "w.pth")
    # --v2 reaches build_cotracker: the legacy model, on the CUDA device the
    # configuration names (which raises here, without one, before anything runs)
    assert parse_config(["--v2"]).v2 is True and DefaultConfig().v2 is False
    built = {}

    def probe(*a, **kw):
        built.update(kw)
        raise RuntimeError("built")

    monkeypatch.setattr("cotracker_tpu_torch.models.build.build_cotracker", probe)
    with pytest.raises(RuntimeError, match="built"):
        run_eval(parse_config(["--v2", "--window_len", "16", "--dataset_root",
                               _davis_pickle(tmp_path / "d.pkl", T=4, H=8, W=8, N=2),
                               "--exp_dir", str(tmp_path / "v2")]))
    assert built["v2"] is True and built["window_len"] == 16 and built["device"] == "cuda"
    # Dynamic Replica reads {root}/valid/frame_annotations_valid.jgz before
    # anything is built or written
    exp = tmp_path / "exp"
    with pytest.raises(FileNotFoundError, match="frame_annotations_valid.jgz"):
        run_eval(DefaultConfig(dataset_name="dynamic_replica", dataset_root=str(tmp_path),
                               exp_dir=str(exp)))
    assert not exp.exists()


@pytest.mark.parametrize("mode", ["joint", "online"])
def test_cli_dry_run_on_cpu(tmp_path, mode):
    p = _davis_pickle(tmp_path / "davis.pkl", T=8, H=40, W=40, N=4)
    cfg = DefaultConfig(exp_dir=str(tmp_path / "exp"), dataset_root=p,
                        dataset_name="tapvid_davis_first", model_res="32x48", window_len=8,
                        n_iters=2, grid_size=2, device="cpu", offline_model=mode == "joint",
                        online_capacity=16)
    metrics = run_eval(cfg)
    assert set(metrics) == {"seq_a", "seq_b", "avg"}
    with open(os.path.join(cfg.exp_dir, "expconfig.json")) as f:
        assert json.load(f)["device"] == "cpu"
    with open(os.path.join(cfg.exp_dir, "result_eval_.json")) as f:
        res = json.load(f)
    assert "average_jaccard" in res["avg"] and np.isfinite(res["time"])
    assert all(np.isfinite(v) for v in res["avg"].values())
    assert os.path.exists(os.path.join(cfg.exp_dir, "result_tapvid_davis_first.json"))
