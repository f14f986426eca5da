"""TAP-Vid and Dynamic Replica metrics, numpy (port of
cotracker_tpu/evaluation/eval_utils.py, itself the reference's
cotracker/evaluation/core/eval_utils.py with the corrected eval-frame masks):
in 'first' mode only frames strictly after the query frame are scored, in
'strided' mode every frame but the query frame. Coordinates are in the
256x256 raster; results are fractions in [0, 1] (TAP-Vid) or percentages
(Dynamic Replica).
"""

from typing import Mapping

import numpy as np

THRESHOLDS = (1, 2, 4, 8, 16)


def eval_frame_mask(query_frames: np.ndarray, num_frames: int, query_mode: str) -> np.ndarray:
    """(B, N) integer query frames -> (B, N, T) bool mask of scored frames."""
    t = np.arange(num_frames)
    qf = np.round(query_frames).astype(np.int32)[..., None]
    if query_mode == "first":
        return t[None, None, :] > qf
    if query_mode == "strided":
        return t[None, None, :] != qf
    raise ValueError(f"unknown query mode {query_mode}")


def compute_tapvid_metrics(
    query_points: np.ndarray,
    gt_occluded: np.ndarray,
    gt_tracks: np.ndarray,
    pred_occluded: np.ndarray,
    pred_tracks: np.ndarray,
    query_mode: str,
) -> Mapping[str, np.ndarray]:
    """query_points (B, N, 3) as (t, y, x); gt/pred_occluded (B, N, T) bool;
    gt/pred_tracks (B, N, T, 2) as (x, y). Returns per-video metric arrays
    (shape (B,)): occlusion_accuracy, pts_within_{thr}, jaccard_{thr},
    average_pts_within_thresh (δ_avg), average_jaccard (AJ)."""
    num_frames = gt_tracks.shape[2]
    scored = eval_frame_mask(query_points[..., 0], num_frames, query_mode)

    metrics = {}
    metrics["occlusion_accuracy"] = np.sum(
        (pred_occluded == gt_occluded) & scored, axis=(1, 2)
    ) / np.sum(scored)

    gt_visible = ~gt_occluded
    pred_visible = ~pred_occluded
    sq_dist = np.sum(np.square(pred_tracks - gt_tracks), axis=-1)

    frac_list, jac_list = [], []
    for thr in THRESHOLDS:
        within = sq_dist < thr**2
        correct_visible = within & gt_visible

        n_correct = np.sum(correct_visible & scored, axis=(1, 2))
        n_gt_visible = np.sum(gt_visible & scored, axis=(1, 2))
        frac = n_correct / n_gt_visible
        metrics[f"pts_within_{thr}"] = frac
        frac_list.append(frac)

        tp = np.sum(correct_visible & pred_visible & scored, axis=(1, 2))
        # FP = predicted visible but (gt occluded or too far); TP+FN = gt visible
        fp = (pred_visible & ~gt_visible) | (pred_visible & ~within)
        fp = np.sum(fp & scored, axis=(1, 2))
        jac = tp / (n_gt_visible + fp)
        metrics[f"jaccard_{thr}"] = jac
        jac_list.append(jac)

    metrics["average_jaccard"] = np.mean(np.stack(jac_list, axis=1), axis=1)
    metrics["average_pts_within_thresh"] = np.mean(np.stack(frac_list, axis=1), axis=1)
    return metrics


def compute_dynamic_replica_metrics(
    pred_tracks: np.ndarray,
    gt_tracks: np.ndarray,
    gt_visibility: np.ndarray,
    image_hw,
) -> Mapping[str, float]:
    """Dynamic Replica accuracy@thr (visible / occluded / all) and
    survival@50px, mirroring the reference evaluator
    (evaluator.py:94-161). pred/gt_tracks (B, T, N, 2) in image pixels;
    gt_visibility (B, T, N) in {0,1}; thresholds in 256x256 units."""
    H, W = image_hw
    B, T, N = gt_visibility.shape
    scale = np.array([(W - 1) / 255.0, (H - 1) / 255.0]).reshape(1, 1, 1, 2)
    d = np.linalg.norm(pred_tracks / scale - gt_tracks / scale, axis=-1)  # (B,T,N)

    first_visible = np.argmax(gt_visibility, axis=1)  # (B, N)
    frame_ids = np.arange(T)[None, :, None]
    started = frame_ids > first_visible[:, None, :]

    def masked_mean(x, m):
        m = m.astype(np.float64)
        return float(np.sum(x * m) / (1e-6 + np.sum(m)))

    out = {}
    occ_sum = vis_sum = all_sum = 0.0
    for thr in THRESHOLDS:
        ok = (d < thr).astype(np.float64)
        a_occ = masked_mean(ok, (1 - gt_visibility) * started) * 100.0
        a_vis = masked_mean(ok, gt_visibility * started) * 100.0
        a_all = masked_mean(ok, started) * 100.0
        out[f"accuracy_occ_{thr}"] = a_occ
        out[f"accuracy_vis_{thr}"] = a_vis
        out[f"accuracy_{thr}"] = a_all
        occ_sum += a_occ
        vis_sum += a_vis
        all_sum += a_all

    dist_ok = 1.0 - (d > 50).astype(np.float64) * gt_visibility
    survival = np.cumprod(dist_ok, axis=1)
    out["survival"] = float(np.mean(survival)) * 100.0
    out["accuracy_occ"] = occ_sum / len(THRESHOLDS)
    out["accuracy_vis"] = vis_sum / len(THRESHOLDS)
    out["accuracy"] = all_sum / len(THRESHOLDS)
    return out
