"""Dynamic Replica in the port against the JAX package, on the CPU: the
typed annotation hydration (values and every error message, exactly), the
DynamicReplicaDataset on a synthetic tree written here (every array
exactly: the same files, the same seeded track draw), the Evaluator's
overlay hook on that dataset, and a dry run of the evaluation CLI's
dynamic_replica branch with the plain float32 model at a small model
resolution (port only; finite metrics, result files written)."""

import dataclasses
import gzip
import json
import os

import numpy as np
import pytest
import torch

from cotracker_tpu.datasets import annotations as jax_annotations
from cotracker_tpu.datasets.dynamic_replica import DynamicReplicaDataset as JaxDataset
from cotracker_tpu_torch.datasets import annotations
from cotracker_tpu_torch.datasets.dynamic_replica import DynamicReplicaDataset
from cotracker_tpu_torch.evaluation.evaluate import DefaultConfig, run_eval
from cotracker_tpu_torch.evaluation.evaluator import Evaluator

torch.set_num_threads(2)

H, W = 24, 32


def _annot(seq, t, camera="left"):
    return {"sequence_name": seq, "frame_number": t, "frame_timestamp": t / 24.0,
            "image": {"path": f"{seq}/images/{t:05d}.png", "size": [H, W]},
            "camera_name": camera, "trajectories": {"path": f"{seq}/traj/{t:05d}.pth"}}


def write_tree(root, seqs=(("seq_a", 14), ("seq_b", 12)), N=20, seed=3):
    """A Dynamic Replica tree: left-camera frames of each sequence, one
    right-camera record, uint8 frames and N tracks a frame drifting by a
    pixel a frame, some leaving the frame; track 0 is seen in 10 frames
    only (the filter drops it)."""
    split = os.path.join(root, "valid")
    records, rng = [], np.random.default_rng(seed)
    for seq, T in seqs:
        records += [_annot(seq, t) for t in range(T)]
        records.append(_annot(seq, 0, camera="right"))
        start = rng.random((N, 2)) * [W - 1, H - 1]
        vel = rng.uniform(-1.5, 1.5, (N, 2))
        vis = rng.random((T, N)) > 0.1
        vis[:, 0] = np.arange(T) < 10
        os.makedirs(os.path.join(split, seq, "traj"), exist_ok=True)
        for t in range(T):
            xy = start + vel * t
            torch.save({"img": torch.from_numpy((rng.random((H, W, 3)) * 255).astype(np.uint8)),
                        "traj_2d": torch.from_numpy(
                            np.concatenate([xy, np.ones((N, 1))], 1).astype(np.float32)),
                        "verts_inds_vis": torch.from_numpy(vis[t])},
                       os.path.join(split, seq, "traj", f"{t:05d}.pth"))
    with gzip.open(os.path.join(split, "frame_annotations_valid.jgz"), "wt") as f:
        json.dump(records, f)
    return root


def test_annotations_match_jax(tmp_path):
    good = _annot("s", 3)
    a = annotations.hydrate(good, annotations.DynamicReplicaFrameAnnotation)
    b = jax_annotations.hydrate(good, jax_annotations.DynamicReplicaFrameAnnotation)
    assert dataclasses.asdict(a) == dataclasses.asdict(b) and a.image.size == (H, W)
    bad = [{**good, "bogus": 1}, {k: v for k, v in good.items() if k != "sequence_name"},
           {**good, "frame_number": "zero"}, {**good, "frame_timestamp": True},
           {**good, "image": {"path": "p"}}, {**good, "image": {"path": "p", "size": [1, 2, 3]}},
           {**good, "image": [1]}, {**good, "meta": [1]}, {**good, "camera_name": 3}]
    messages = []
    for record in bad:
        with pytest.raises(annotations.AnnotationError) as ours:
            annotations.hydrate(record, annotations.DynamicReplicaFrameAnnotation)
        with pytest.raises(jax_annotations.AnnotationError) as ref:
            jax_annotations.hydrate(record, jax_annotations.DynamicReplicaFrameAnnotation)
        assert str(ours.value) == str(ref.value)
        messages.append(str(ours.value))
    assert "unknown key(s) ['bogus']" in messages[0] and "missing required" in messages[1]
    root = write_tree(str(tmp_path), seqs=(("s", 2),), N=3)
    path = os.path.join(root, "valid", "frame_annotations_valid.jgz")
    assert ([dataclasses.asdict(r) for r in annotations.load_frame_annotations(path)]
            == [dataclasses.asdict(r) for r in jax_annotations.load_frame_annotations(path)])
    with gzip.open(path, "wt") as f:
        json.dump({"not": "a list"}, f)
    with pytest.raises(annotations.AnnotationError, match="JSON list"):
        annotations.load_frame_annotations(path)


@pytest.mark.parametrize("kw", [dict(traj_per_sample=20),
                                dict(traj_per_sample=8, crop_size=(20, 24), sample_len=6,
                                     only_first_n_samples=2, seed=5)],
                         ids=["whole", "crop_samples"])
def test_dataset_matches_jax(tmp_path, kw):
    root = write_tree(str(tmp_path))
    ours, ref = DynamicReplicaDataset(root, **kw), JaxDataset(root, **kw)
    assert len(ours) == len(ref) == (2 if "crop_size" not in kw else 4)
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert a.seq_name == b.seq_name
        for f in ("video", "trajectory", "visibility", "valid"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), (i, f)
    if "crop_size" not in kw:  # every track drawn, shuffled; the one seen 10 times goes
        s = ours[0]
        assert s.video.shape == (14, 3, H, W) and s.trajectory.shape[1] < 20
        assert (s.visibility.sum(0) > 10).all()


def test_evaluator_draws_overlays(tmp_path):
    """A predictor that returns the ground truth: perfect Dynamic Replica
    metrics, and an overlay of every second sequence (the first of two)
    through the hook."""
    pytest.importorskip("cv2")  # the overlays are written as mp4s
    from cotracker_tpu_torch.utils.visualizer import Visualizer

    root = write_tree(str(tmp_path / "dr"))
    ds = DynamicReplicaDataset(root, traj_per_sample=8)
    twin = DynamicReplicaDataset(root, traj_per_sample=8)  # the same seeded draws
    truth = iter([twin[i] for i in range(len(twin))])

    def oracle(video, queries):
        s = next(truth)
        assert np.array_equal(queries[0, :, 1:], s.trajectory[0])
        return s.trajectory[None], s.visibility[None]

    out = tmp_path / "overlays"
    metrics = Evaluator().evaluate_sequence(
        oracle, ds, "dynamic_replica", verbose=False,
        visualizer=Visualizer(save_dir=str(out), show_first_frame=0), visualize_every=2)
    assert set(metrics) == {"seq_a", "seq_b", "avg"}
    assert metrics["avg"]["accuracy"] == pytest.approx(100.0)
    assert os.listdir(out) == ["dynamic_replica_seq_a.mp4"]


def test_cli_dry_run_on_cpu(tmp_path):
    root = write_tree(str(tmp_path / "dr"), seqs=(("seq_a", 12),), N=12)
    cfg = DefaultConfig(exp_dir=str(tmp_path / "exp"), dataset_root=root,
                        dataset_name="dynamic_replica", model_res="32x48", window_len=12,
                        n_iters=2, grid_size=2, device="cpu")
    metrics = run_eval(cfg)
    assert set(metrics) == {"seq_a", "avg"}
    with open(os.path.join(cfg.exp_dir, "result_eval_.json")) as f:
        res = json.load(f)
    assert res["avg"] and all(np.isfinite(v) for v in res["avg"].values())
    assert np.isfinite(res["time"])
    for name in ("expconfig.json", "result_dynamic_replica.json"):
        assert os.path.exists(os.path.join(cfg.exp_dir, name))
