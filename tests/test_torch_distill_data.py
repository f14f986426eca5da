"""The distillation slice's parts that need no model compile, against the
JAX package on the CPU: the SuperPoint sampler and the query sampling
(SIFT, SuperPoint, the uniform fallback), the local-video reader, the
TAPIR wrapper, the teacher ensemble's pick and support stripping; the
ImportErrors where the JAX package falls back without a word; the
default ensemble's wiring (the v3 online teacher runs one offline
forward, as in JAX); the command line; resuming and restoring a student.

Everything here matches JAX exactly (the same numpy Generators, the same
OpenCV calls), except the TAPIR wrapper's resized frames: two separable
float32 matmuls in each framework, within 1e-5 of the [-1, 1] range.
"""

import dataclasses
import json
from dataclasses import asdict
import os
import sys

import numpy as np
import pytest
import torch

from cotracker_tpu.datasets import real_videos as JR
from cotracker_tpu.evaluation import bootstap_predictor as JB
from cotracker_tpu.ops import samplers as JS
from cotracker_tpu.training import distill as JD
from cotracker_tpu.training import distill_trainer as JT
from cotracker_tpu_torch.datasets import real_videos as R
from cotracker_tpu_torch.evaluation import bootstap_predictor as B
from cotracker_tpu_torch.models import build as build_module
from cotracker_tpu_torch.models.checkpoint import save_reference_checkpoint
from cotracker_tpu_torch.models.cotracker3 import CoTrackerThree
from cotracker_tpu_torch.ops import samplers as S
from cotracker_tpu_torch.training import distill as D
from cotracker_tpu_torch.training import distill_trainer as DT

from test_torch_distill import drift_teacher, no_tensorflow, write_clips  # noqa: F401

torch.set_num_threads(2)


def _video(seed, T, H, W):
    """(1, T, 3, H, W) float32 frames: a smooth texture with noise on its
    left half (SIFT finds some keypoints, fewer than asked for)."""
    rng = np.random.default_rng(seed)
    base = np.kron(rng.random((T, 3, H // 8, W // 8)), np.ones((1, 1, 8, 8))) * 255
    base[..., : W // 2] = rng.random((T, 3, H, W // 2)) * 255
    return base[None].astype(np.float32)


def _extractor(seed, k=60):
    """A stand-in detector: k random keypoints a frame, from its own Generator."""
    rng = np.random.default_rng(seed)

    def extract(frame):
        h, w = frame.shape[:2]
        return np.stack([rng.random(k) * (w - 1), rng.random(k) * (h - 1)], -1)

    return extract


def test_superpoint_sampler_matches_jax():
    """get_superpoint_sampled_pts with an injected detector: the frames
    drawn, the frames given to the detector (float32 / 255), the 48-point
    cap a frame and the truncation to `size` equal JAX's; the default
    detector raises an ImportError naming lightglue."""
    video = _video(0, 20, 32, 48).transpose(0, 1, 3, 4, 2)
    for size in (300, 500):
        seen = {}
        for name, fn in (("port", S.get_superpoint_sampled_pts),
                         ("jax", JS.get_superpoint_sampled_pts)):
            frames, extract = [], _extractor(9)
            q = fn(video, size, 20, (32, 48), rng=np.random.default_rng(3),
                   extract_fn=lambda f: frames.append(f) or extract(f))
            seen[name] = (np.asarray(q), frames)
        (q, frames), (ref, ref_frames) = seen["port"], seen["jax"]
        assert q.dtype == np.float32 and q.shape == (1, min(size, 8 * 48), 3)
        np.testing.assert_array_equal(q, ref)
        for a, b in zip(frames, ref_frames):
            np.testing.assert_array_equal(a, b)
        assert (q[0, :, 0] < 5).all()
    with pytest.raises(ImportError, match="lightglue"):
        S.get_superpoint_sampled_pts(video, 8, 20, (32, 48))


@pytest.mark.parametrize("method", ["sift", "superpoint"])
def test_distill_queries_match_jax(method):
    """sample_distill_queries: the detector's points, then the uniform
    fallback from the same Generator, equal to JAX's; the Generators end in
    the same state."""
    video = _video(1, 12, 48, 64)
    rngs = np.random.default_rng(5), np.random.default_rng(5)
    kw = dict(superpoint_extract_fn=_extractor(2, k=3)) if method == "superpoint" else {}
    q = D.sample_distill_queries(video, 400, rngs[0], method=method, **kw)
    kw = dict(superpoint_extract_fn=_extractor(2, k=3)) if method == "superpoint" else {}
    ref = JD.sample_distill_queries(video, 400, rngs[1], method=method, **kw)
    assert q.dtype == np.float32 and q.shape == (1, 400, 3)
    np.testing.assert_array_equal(q, ref)
    assert rngs[0].random() == rngs[1].random()
    found = (S.get_sift_sampled_pts(video[0].transpose(0, 2, 3, 1)[None], 400, 12, (48, 64),
                                    rng=np.random.default_rng(5)).shape[1]
             if method == "sift" else 8 * 3)
    assert 0 < found < 400  # both the detector's points and the fallback's


def test_import_errors_where_jax_falls_back(monkeypatch, tmp_path):
    """Without OpenCV, SIFT queries and the video reader raise ImportErrors
    naming cv2, and SuperPoint queries without lightglue one naming it,
    where JAX's sample_distill_queries answers uniform points alone; an
    unknown method raises a ValueError where JAX runs SIFT."""
    video = _video(1, 12, 48, 64)
    uniform = JS.get_uniformly_sampled_pts(16, 12, (48, 64), rng=np.random.default_rng(5))
    np.testing.assert_array_equal(  # JAX: no lightglue here, uniform points, no word
        JD.sample_distill_queries(video, 16, np.random.default_rng(5), method="superpoint"),
        np.asarray(uniform))
    with pytest.raises(ImportError, match="lightglue"):
        D.sample_distill_queries(video, 16, np.random.default_rng(5), method="superpoint")
    with pytest.raises(ValueError, match="query method"):
        D.sample_distill_queries(video, 16, np.random.default_rng(5), method="orb")
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(
        JD.sample_distill_queries(video, 16, np.random.default_rng(5), method="sift"),
        np.asarray(uniform))
    with pytest.raises(ImportError, match="cv2"):
        D.sample_distill_queries(video, 16, np.random.default_rng(5), method="sift")
    with pytest.raises(ImportError, match="cv2"):
        R.LocalVideoDataset(str(tmp_path))


def test_local_video_dataset_matches_jax(tmp_path):
    """LocalVideoDataset against JAX's on the same files, every item read
    twice (the frame rate and start drawn from each dataset's Generator):
    a 5-frame clip loop-padded to 8, a 40-frame clip at a random frame rate
    and start, resized from 32x48 to 24x40; a file that decodes to nothing
    is (None, False); other extensions are skipped. The clips are JAX's bit
    for bit. RealDataset raises, as in JAX."""
    write_clips(str(tmp_path / "a"), n_videos=1, T=5, H=32, W=48, seed=1)
    write_clips(str(tmp_path / "b"), n_videos=1, T=40, H=32, W=48, seed=2)
    os.replace(tmp_path / "a" / "vid0.avi", tmp_path / "short.avi")
    os.replace(tmp_path / "b" / "vid0.avi", tmp_path / "long.AVI")
    (tmp_path / "empty.mp4").write_bytes(b"")
    (tmp_path / "notes.txt").write_text("not a video")
    ours = R.LocalVideoDataset(str(tmp_path), crop_size=(24, 40), seq_len=8, seed=3)
    ref = JR.LocalVideoDataset(str(tmp_path), crop_size=(24, 40), seq_len=8, seed=3)
    assert [os.path.basename(p) for p in ours.paths] == ["empty.mp4", "long.AVI",
                                                          "short.avi"]
    assert ours.paths == ref.paths
    for i in [0, 1, 2, 1, 2, 1]:
        (s, ok), (r, rok) = ours[i], ref[i]
        assert ok == rok and ok == (i != 0)
        if ok:
            assert s.video.dtype == np.float32 and s.video.shape == (8, 3, 24, 40)
            np.testing.assert_array_equal(s.video, r.video)
            assert s.seq_name == r.seq_name
    with pytest.raises(ValueError, match="cannot release"):
        R.RealDataset()
    with pytest.raises(ValueError, match="cannot release"):
        JR.RealDataset()


def test_tapir_wrapper_matches_jax():
    """TAPIRPredictor around one stub model_fn (it echoes each query's
    point as a constant track; occlusion and expected-distance logits set
    per track): the queries it is given ((t, y, x), plain-ratio rescale),
    the tracks and the visibility equal JAX's; the resized frames within
    1e-5. Without model_fn the constructor raises an ImportError naming
    tapnet and model_fn (JAX builds tapnet's model when it is installed)."""
    T, H, W = 4, 48, 64
    rng = np.random.default_rng(0)
    video = (rng.random((1, T, 3, H, W)) * 255).astype(np.float32)
    queries = np.array([[[0, 10.0, 20.0], [1, 32.0, 8.0], [2, 63.0, 47.0]]], np.float32)

    def stub(seen):
        def model_fn(frames, query_points):
            seen.update(frames=frames, qp=query_points)
            n = query_points.shape[1]
            xy = query_points[0, :, 1:][:, ::-1]
            occ = np.full((1, n, T), -10.0, np.float32)
            occ[0, 1] = 10.0
            expd = np.full((1, n, T), -10.0, np.float32)
            expd[0, 2, 0] = 10.0
            return {"tracks": np.broadcast_to(xy[None, :, None], (1, n, T, 2)).copy(),
                    "occlusion": occ, "expected_dist": expd}
        return model_fn

    seen, ref_seen = {}, {}
    tracks, vis = B.TAPIRPredictor(model_fn=stub(seen))(torch.from_numpy(video), queries)
    ref_tracks, ref_vis = JB.TAPIRPredictor(model_fn=stub(ref_seen))(video, queries)
    assert seen["frames"].shape == (1, T, 256, 256, 3) and seen["frames"].dtype == np.float32
    np.testing.assert_allclose(seen["frames"], np.asarray(ref_seen["frames"]), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(seen["qp"], ref_seen["qp"])
    np.testing.assert_array_equal(tracks, ref_tracks)
    np.testing.assert_array_equal(vis, ref_vis)
    assert tracks.shape == (1, T, 3, 2) and vis.shape == (1, T, 3)
    np.testing.assert_array_equal(B.postprocess_occlusions(np.array([-3.0, 0.5]), np.zeros(2)),
                                  JB.postprocess_occlusions(np.array([-3.0, 0.5]), np.zeros(2)))
    with pytest.raises(ImportError, match="tapnet.*model_fn"):
        B.TAPIRPredictor()


def test_teacher_ensemble_matches_jax():
    """Twelve pseudo_label calls on three stand-in teachers: the teacher
    picked each time, the queries it gets (the user's, then the 5x5
    support grid at frame 0) and the stripped answers equal JAX's for the
    same seed."""
    def teachers(log):
        def make(k):
            def teacher(video, q):
                log.append((k, np.asarray(q).copy()))
                n = q.shape[1]
                return (np.asarray(q)[:, None, :, 1:] + k * np.ones((1, video.shape[1], n, 2)),
                        np.full((1, video.shape[1], n), 0.1 * k, np.float32))
            return teacher
        return [make(k) for k in range(3)]

    ours_log, ref_log = [], []
    ours = D.TeacherEnsemble(teachers(ours_log), support_grid_size=5, seed=7)
    ref = JD.TeacherEnsemble(teachers(ref_log), support_grid_size=5, seed=7)
    video = np.zeros((1, 6, 3, 48, 64), np.float32)
    rng = np.random.default_rng(1)
    for _ in range(12):
        q = (rng.random((1, 7, 3)) * [5, 63, 47]).astype(np.float32)
        a, b = ours.pseudo_label(torch.from_numpy(video), q), ref.pseudo_label(video, q)
        for x, y in zip(a, b):
            assert x.shape[2] == 7
            np.testing.assert_array_equal(x, y)
    assert [k for k, _ in ours_log] == [k for k, _ in ref_log]
    assert len({k for k, _ in ours_log}) == 3
    for (_, x), (_, y) in zip(ours_log, ref_log):
        assert x.shape == (1, 7 + 25, 3)
        np.testing.assert_array_equal(x, y)


def test_default_teacher_ensemble_wiring(monkeypatch, tmp_path):
    """default_teacher_ensemble builds JAX's ensemble in JAX's order on the
    device asked for: v2.1 (v2, window 16), the v3 online (offline=False)
    and offline models, each an EvaluationPredictor in joint mode with no
    grid of its own; a TAPIR checkpoint raises before any model is built,
    no checkpoint is a ValueError. The v3 online teacher runs the whole
    video through one offline forward, never forward_windows (JAX's
    EvaluationPredictor does the same), here 20 frames past its window of
    16."""
    real, calls = build_module.build_cotracker, []

    def small(checkpoint=None, **kw):
        calls.append((checkpoint, kw))
        return real(None, **{**kw, "model_resolution": (32, 32)})

    monkeypatch.setattr(build_module, "build_cotracker", small)
    with pytest.raises(ImportError, match="tapnet"):
        D.default_teacher_ensemble(v21_checkpoint="v21.pth", tapir_checkpoint="tapir.npy",
                                   device="cpu")
    with pytest.raises(ValueError, match="no teacher"):
        D.default_teacher_ensemble(device="cpu")
    assert calls == []
    ens = D.default_teacher_ensemble("v21.pth", "online.pth", "offline.pth", device="cpu",
                                     seed=3)
    assert calls == [("v21.pth", dict(v2=True, window_len=16, device="cpu")),
                     ("online.pth", dict(offline=False, fast=False, device="cpu")),
                     ("offline.pth", dict(offline=True, fast=False, device="cpu"))]
    for t in ens.teachers:
        assert (t.grid_size, t.local_grid_size, t.single_point, t.interp_shape) == (
            0, 0, False, (384, 512))
    assert ens.support_grid_size == 5
    online = ens.teachers[1]
    assert online.model.window_len == 16
    online.interp_shape = (32, 32)
    frames = []
    forward = online.model.forward

    def spy(video, *a, **kw):
        frames.append(video.shape[1])
        return forward(video, *a, **kw)

    monkeypatch.setattr(online.model, "forward", spy)
    monkeypatch.setattr(online.model, "forward_windows", None)
    tracks, vis = online(torch.rand(1, 20, 3, 32, 32) * 255, np.zeros((1, 3, 3), np.float32))
    assert frames == [20] and tracks.shape == (1, 20, 3, 2) and vis.shape == (1, 20, 3)


def test_command_line_flags():
    """The flags are DistillTrainerArgs' fields, as JAX's main parses them:
    the defaults with none; a bool flag sets the opposite of its default
    (--offline_model trains the online student); crop_size is not a flag.
    The fields and their defaults are JAX's, and the device and correlation
    switches the supervised trainer's."""
    assert DT.parse_args([]) == DT.DistillTrainerArgs()
    args = DT.parse_args(["--offline_model", "--model_window_len", "16", "--use_corr_kernels",
                          "--train_only_visible", "--teacher_v21", "v21.pth", "--query_method",
                          "superpoint", "--lr", "1e-4", "--device", "cpu"])
    assert args == dataclasses.replace(
        DT.DistillTrainerArgs(), offline_model=False, model_window_len=16,
        use_corr_kernels=False, train_only_visible=True, teacher_v21="v21.pth",
        query_method="superpoint", lr=1e-4, device="cpu")
    with pytest.raises(SystemExit):
        DT.parse_args(["--crop_size", "32", "32"])
    ours, ref = DT.DistillTrainerArgs(), JT.DistillTrainerArgs()
    names, jax_names = set(asdict(ours)), set(asdict(ref))
    assert names - jax_names == {"device", "use_corr_kernels", "corr_quant_int8"}
    assert jax_names <= names and all(getattr(ours, k) == getattr(ref, k) for k in jax_names)


def test_resume_and_restore(tmp_path, no_tensorflow):
    """distill_train on the CPU (offline student, 32x32, iters=1, K4r's
    plain version): 2 steps with a checkpoint at 2, then to 3 steps, which
    resumes at step 2 (the log's steps 0, 1, 2); an eval cadence with
    neither eval_datasets nor a hook raises before any step; a student
    restored from the port's checkpoint and from its reference-format
    export equals the trained one."""
    videos = write_clips(str(tmp_path / "videos"))
    args = DT.DistillTrainerArgs(exp_dir=str(tmp_path / "exp"), dataset_root=videos,
                                 crop_size=(32, 32), seq_len=8, sift_size=8, num_steps=2,
                                 train_iters=1, save_every_n_steps=2, model_window_len=8,
                                 device="cpu")
    teacher = D.TeacherEnsemble([drift_teacher], support_grid_size=0)
    DT.distill_train(args, teacher=teacher)
    model = DT.distill_train(dataclasses.replace(args, num_steps=3), teacher=teacher)
    log = [json.loads(line) for line in open(tmp_path / "exp" / "train_log.jsonl")]
    assert [r["step"] for r in log] == [0, 1, 2]
    assert all(np.isfinite(r["total_loss"]) for r in log)
    assert model.corr_kernels and model.corr_quant_int8
    with pytest.raises(ValueError, match="eval_datasets or an eval_hook"):
        DT.distill_train(dataclasses.replace(args, exp_dir=str(tmp_path / "x"),
                                             eval_every_n_steps=1), teacher=teacher)
    assert not (tmp_path / "x").exists()

    ref_pth = str(tmp_path / "student.pth")
    save_reference_checkpoint(ref_pth, model)
    want = model.state_dict()
    for path in (str(tmp_path / "exp" / "checkpoints" / "model_final.pth"), ref_pth):
        restored = DT._build_student(dataclasses.replace(args, restore_ckpt=path),
                                     torch.device("cpu"))
        assert isinstance(restored, CoTrackerThree) and restored.training
        for k, v in restored.state_dict().items():
            assert torch.equal(v, want[k]), k
