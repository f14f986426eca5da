"""Evaluator: drives a predictor over a dataset and aggregates metrics (port
of cotracker_tpu/evaluation/evaluator.py): the per-sequence loop, the
(t, y, x) -> (t, x, y) query conversion, the strided protocol's backward
pass, TAP-Vid / Dynamic Replica metrics with running averages, the
optional track overlays, and the per-sequence results file. Predictions
arrive as numpy arrays or tensors on any device and are compared on the
host."""

import json
import logging
import os
from typing import Optional

import numpy as np
import torch

from cotracker_tpu_torch.evaluation.eval_utils import (
    compute_dynamic_replica_metrics, compute_tapvid_metrics,
)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Evaluator:
    def __init__(self, exp_dir: Optional[str] = None):
        self.exp_dir = exp_dir

    def compute_metrics(self, metrics, sample, pred_trajectory, pred_visibility, dataset_name):
        """Metrics of one sequence into `metrics[seq_name]`, and the running
        average over the sequences so far into `metrics["avg"]`."""
        if "tapvid" in dataset_name:
            traj = np.asarray(sample.trajectory)
            traj = traj[None] if traj.ndim == 3 else traj
            vis_gt = np.asarray(sample.visibility)
            vis_gt = vis_gt[None] if vis_gt.ndim == 2 else vis_gt
            N = traj.shape[2]
            pred_visibility = _host(pred_visibility)
            if pred_visibility.dtype != bool:
                pred_visibility = pred_visibility > 0.6
            pred_trajectory = _host(pred_trajectory)[:, :, :N]
            pred_visibility = pred_visibility[:, :, :N]
            qp = np.asarray(sample.query_points)
            qp = qp[None] if qp.ndim == 2 else qp
            out = compute_tapvid_metrics(
                qp,
                ~vis_gt.transpose(0, 2, 1).astype(bool),
                traj.transpose(0, 2, 1, 3),
                ~pred_visibility.transpose(0, 2, 1),
                pred_trajectory.transpose(0, 2, 1, 3),
                query_mode="strided" if "strided" in dataset_name else "first",
            )
            out = {k: float(np.mean(v)) for k, v in out.items()}
        elif dataset_name in ("dynamic_replica", "pointodyssey"):
            vis_gt = np.asarray(sample.visibility)
            vis_gt = vis_gt[None] if vis_gt.ndim == 2 else vis_gt
            traj = np.asarray(sample.trajectory)
            traj = traj[None] if traj.ndim == 3 else traj
            H, W = np.asarray(sample.video).shape[-2:]
            out = compute_dynamic_replica_metrics(
                _host(pred_trajectory)[..., :2], traj[..., :2], vis_gt.astype(np.float64), (H, W))
        else:
            raise ValueError(f"unknown dataset {dataset_name}")
        metrics[sample.seq_name] = out
        metrics["avg"] = {
            k: float(np.mean([v[k] for name, v in metrics.items() if name != "avg"]))
            for k in out
        }
        logging.info("%s: %s", sample.seq_name, out)
        return out

    def evaluate_sequence(self, predictor, dataset, dataset_name: str, verbose: bool = True,
                          visualizer=None, visualize_every: int = 1, writer=None, step: int = 0):
        """predictor: callable (video (1, T, 3, H, W), queries (1, N, 3) as
        (t, x, y)) -> (tracks, vis); an online predictor goes through
        OnlineWrapper. With a `visualizer` (utils.visualizer.Visualizer) the
        tracks of every `visualize_every`-th sequence are drawn over its
        video and saved (to `writer`, a TensorBoard SummaryWriter, at
        `step`, if given). With exp_dir set, the per-sequence metrics and
        their average are written to result_<dataset_name>.json."""
        metrics = {}
        for ind in range(len(dataset)):
            sample = dataset[ind]
            video = np.asarray(sample.video)[None]  # (1, T, 3, H, W)
            if "tapvid" in dataset_name:
                qp = np.asarray(sample.query_points, np.float32)
                queries = np.stack([qp[:, 0], qp[:, 2], qp[:, 1]], axis=1)[None]
            else:
                traj = np.asarray(sample.trajectory)
                queries = np.concatenate(
                    [np.zeros_like(traj[0, :, :1]), traj[0]], axis=1)[None].astype(np.float32)
            pred_tracks, pred_vis = (_host(o) for o in predictor(video, queries))
            if "strided" in dataset_name:
                # queries after frame 0: the reversed video fills the frames
                # before each query, where the forward pass left zeros
                inv_queries = queries.copy()
                inv_queries[:, :, 0] = video.shape[1] - inv_queries[:, :, 0] - 1
                inv_tracks, inv_vis = (
                    _host(o)[:, ::-1] for o in predictor(video[:, ::-1].copy(), inv_queries))
                mask = pred_tracks == 0
                pred_tracks = np.where(mask, inv_tracks, pred_tracks)
                pred_vis = np.where(mask[..., 0], inv_vis, pred_vis)
            if visualizer is not None and ind % max(1, visualize_every) == 0:
                visualizer.visualize(
                    video, pred_tracks, pred_vis if pred_vis.dtype == bool else pred_vis > 0.6,
                    filename=f"{dataset_name}_{sample.seq_name}", writer=writer, step=step)
            self.compute_metrics(metrics, sample, pred_tracks, pred_vis, dataset_name)
            if verbose:
                print(f"[{ind + 1}/{len(dataset)}] {sample.seq_name}: avg={metrics['avg']}")
        if self.exp_dir is not None:
            os.makedirs(self.exp_dir, exist_ok=True)
            with open(os.path.join(self.exp_dir, f"result_{dataset_name}.json"), "w") as f:
                json.dump(metrics, f, indent=2, default=float)
        return metrics


class OnlineWrapper:
    """Adapts CoTrackerOnlinePredictor to the (video, queries) interface by
    driving its window loop; returns host arrays."""

    def __init__(self, online_predictor):
        self.p = online_predictor

    def __call__(self, video, queries):
        T = video.shape[1]
        self.p(video[:, :1], is_first_step=True, queries=queries, add_support_grid=False)
        step = self.p.step
        tracks = vis = None
        for ind in range(0, T - step, step):
            tracks, vis = self.p(video[:, ind : ind + step * 2])
        fs = self.p.frames_seen  # the valid prefix of full-capacity buffers
        return _host(tracks[:, :fs]), _host(vis[:, :fs])
