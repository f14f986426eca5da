"""Pseudo-label distillation on real videos (port of
cotracker_tpu/training/distill.py).

  * queries: SIFT (or SuperPoint) keypoints from the first 25% of the
    frames, topped up with uniform random points where the detector finds
    too few;
  * a teacher picked uniformly at random per step from an ensemble of
    frozen trackers, run with a support grid that is stripped from its
    output;
  * pseudo ground truth: the teacher's tracks, visible where its
    visibility exceeds 0.9;
  * the student: a Huber (delta 6) sequence loss x0.05 on visible points
    and L1 x0.01 on invisible ones, no visibility or confidence loss, the
    vis_conf_head frozen, the gradient clipped to a global norm of 10.

Stricter than the JAX package: a missing detector package (cv2, lightglue)
raises its ImportError where JAX falls back to uniform queries without a
word, and an unknown query method raises a ValueError.
"""

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from cotracker_tpu_torch.ops.samplers import (
    get_points_on_a_grid, get_sift_sampled_pts, get_superpoint_sampled_pts,
    get_uniformly_sampled_pts,
)
from cotracker_tpu_torch.training.losses import sequence_loss
from cotracker_tpu_torch.training.train_step import apply_gradients, make_optimizer, window_targets

FROZEN_HEAD = "vis_conf_head"


class DistillConfig(NamedTuple):
    iters: int = 4
    flow_weight: float = 0.05
    invisible_flow_weight: float = 0.01
    teacher_vis_threshold: float = 0.9
    lr: float = 5e-5
    wdecay: float = 1e-5
    num_steps: int = 15000
    grad_clip: float = 10.0
    sift_size: int = 384
    restart_from: Optional[str] = None
    # online (sliding-window) student: the multi-window forward, a loss per window
    offline_model: bool = True
    sliding_window_len: int = 16
    # the invisible points' L1 term left out of the total
    train_only_visible: bool = False


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def sample_distill_queries(video_np, num_queries: int, rng: np.random.Generator,
                           method: str = "sift", superpoint_extract_fn=None) -> np.ndarray:
    """num_queries (t, x, y) queries, (1, num_queries, 3) float32 numpy:
    keypoints of the detector `method` ("sift" or "superpoint", from
    `rng` in the JAX package's order), then uniform random points from the
    same Generator where it found fewer. video_np: (1, T, 3, H, W) in
    [0, 255], numpy or a tensor. A detector's ImportError passes through."""
    if method not in ("sift", "superpoint"):
        raise ValueError(f"query method {method!r}: 'sift' or 'superpoint'")
    video = _host(video_np)
    T, H, W = video.shape[1], video.shape[3], video.shape[4]
    vid_cl = video[0].transpose(0, 2, 3, 1)[None]
    if method == "superpoint":
        q = get_superpoint_sampled_pts(vid_cl, num_queries, T, (H, W), rng=rng,
                                       extract_fn=superpoint_extract_fn).numpy()
    else:
        q = get_sift_sampled_pts(vid_cl, num_queries, T, (H, W), rng=rng).numpy()
    if q.shape[1] < num_queries:
        extra = get_uniformly_sampled_pts(num_queries - q.shape[1], T, (H, W), rng=rng).numpy()
        q = np.concatenate([q, extra], axis=1)
    return q.astype(np.float32)


def distill_loss(model, video, queries, teacher_tracks, teacher_vis, cfg: DistillConfig,
                 track_mask=None):
    """The student's loss (JAX `make_distill_loss`): video (B, T, H, W, 3)
    in [0, 255]; queries (B, N, 3); teacher_tracks (B, T, N, 2) model
    pixels; teacher_vis (B, T, N) the thresholded teacher visibility. The
    offline student: its single-window forward; the online student
    (cfg.offline_model False): the multi-window forward, each window's
    loss on the teacher's frames of that window (train_step.window_targets)
    averaged over windows. Returns (total, {flow_loss, invis_loss,
    total_loss}), the two terms weighted."""
    teacher_vis = teacher_vis.to(torch.float32)
    valids = torch.ones_like(teacher_vis)
    if track_mask is not None:
        valids = valids * track_mask[:, None, :].to(torch.float32)

    def terms(coords, traj_gt, vis_gt, val):
        flow = sequence_loss(coords, traj_gt, val, vis=vis_gt, gamma=0.8, add_huber_loss=True,
                             loss_only_for_visible=True)
        invis = sequence_loss(coords, traj_gt, val, vis=1.0 - vis_gt, gamma=0.8,
                              add_huber_loss=False, loss_only_for_visible=True)
        return flow, invis

    if cfg.offline_model:
        *_, train_data = model(video, queries, iters=cfg.iters, is_train=True,
                               track_mask=track_mask)
        flow, invis = terms(train_data[0], teacher_tracks, teacher_vis, valids)
    else:
        *_, train_data = model.forward_windows(video, queries, iters=cfg.iters, is_train=True,
                                               track_mask=track_mask)
        coords_w, valid_mask = train_data[0], train_data[3]
        flow = invis = 0.0
        targets = window_targets(len(coords_w), cfg.sliding_window_len, teacher_tracks,
                                 teacher_vis, valids, valid_mask)
        for coords, (traj_gt, vis_gt, val, _) in zip(coords_w, targets):
            f, i = terms(coords, traj_gt, vis_gt, val)
            flow, invis = flow + f, invis + i
        flow, invis = flow / len(coords_w), invis / len(coords_w)

    total = flow * cfg.flow_weight
    if not cfg.train_only_visible:
        total = total + invis * cfg.invisible_flow_weight
    return total, {"flow_loss": flow * cfg.flow_weight,
                   "invis_loss": invis * cfg.invisible_flow_weight, "total_loss": total}


def make_distill_optimizer(model, cfg: DistillConfig):
    """AdamW (eps 1e-8, weight decay cfg.wdecay) on the one-cycle schedule
    (peak cfg.lr over num_steps + 100) over every parameter but the frozen
    vis_conf_head's, which takes no update, moment or weight decay (JAX
    `make_distill_optimizer`'s multi_transform with set_to_zero). The
    clip's norm covers the head too: see distill_step."""
    trainable = [p for n, p in model.named_parameters() if FROZEN_HEAD not in n.split(".")]
    return make_optimizer(model, cfg.lr, cfg.wdecay, cfg.num_steps, params=trainable)


def distill_step(model, optimizer, scheduler, video, queries, teacher_tracks, teacher_vis,
                 cfg: DistillConfig, track_mask=None):
    """The loss and its gradient with respect to every parameter, the clip
    by the global norm of all of them (the frozen head's included, as optax
    clips the whole tree ahead of its multi_transform), and the update of
    the optimizer's parameters (JAX `distill_step_fn`). Returns the loss
    terms, detached."""
    model.zero_grad(set_to_none=True)
    total, aux = distill_loss(model, video, queries, teacher_tracks, teacher_vis, cfg,
                              track_mask=track_mask)
    total.backward()
    apply_gradients(optimizer, scheduler, cfg.grad_clip, clip_over=model.parameters())
    return {k: v.detach() for k, v in aux.items()}


class TeacherEnsemble:
    """Frozen teacher trackers for pseudo-labelling. Each teacher is a
    callable (video (1, T, 3, H, W), queries (1, N, 3)) -> (tracks,
    visibility probabilities); one is picked uniformly per call from the
    ensemble's own Generator (`seed`), and a support grid is added to the
    queries and stripped from the answer."""

    def __init__(self, teachers: Sequence[Callable], support_grid_size: int = 5, seed: int = 0):
        self.teachers = list(teachers)
        self.support_grid_size = support_grid_size
        self.rng = np.random.default_rng(seed)

    def pseudo_label(self, video, queries_np):
        """video (1, T, 3, H, W) (numpy, or a tensor on the teachers'
        device); queries_np (1, N, 3). Returns the teacher's (tracks
        (1, T, N, 2), vis (1, T, N)) of the N queries, numpy."""
        teacher = self.teachers[int(self.rng.integers(0, len(self.teachers)))]
        n_user = queries_np.shape[1]
        q = queries_np
        if self.support_grid_size > 0:
            H, W = video.shape[3], video.shape[4]
            grid = get_points_on_a_grid(self.support_grid_size, (H, W)).numpy()
            grid = np.concatenate([np.zeros_like(grid[:, :, :1]), grid], axis=2)
            q = np.concatenate([q, grid.astype(np.float32)], axis=1)
        tracks, vis = teacher(video, q)
        return _host(tracks)[:, :, :n_user], _host(vis)[:, :, :n_user]


def default_teacher_ensemble(
    v21_checkpoint=None,
    v3_online_checkpoint=None,
    v3_offline_checkpoint=None,
    tapir_checkpoint=None,
    support_grid_size: int = 5,
    seed: int = 0,
    fast: bool = False,
    device="cuda",
) -> TeacherEnsemble:
    """The reference's ensemble, [CoTracker2.1, CoTracker3 online,
    CoTracker3 offline, TAPIR], from local reference-format checkpoints;
    a teacher whose checkpoint is None is left out. Each CoTracker is an
    EvaluationPredictor in joint mode (no support grid of its own),
    returning (tracks, vis * conf) for the 0.9 threshold downstream, on
    `device` (CUDA by default).

    As in the JAX package, the v3 online teacher (window 16) runs the
    whole video in one offline forward: the evaluation predictor calls the
    model's forward, not forward_windows. TAPIR needs the external tapnet
    model: a tapir_checkpoint raises TAPIRPredictor's ImportError (build a
    TeacherEnsemble with a TAPIRPredictor(model_fn=...) instead).

    fast: the v3 teachers on the inference fast path (bf16 compute, the
    K1-K4 kernels), whose pseudo-labels then carry bf16 and int8 roundings;
    off by default, as in the JAX package. On an H100 it takes a v3
    teacher's call at the distillation shape (384 queries + the 5x5 grid,
    64 frames at 384x512) from ~0.55 s to ~0.17 s (chip_smoke phase 24,
    PERF.md §5). The v2.1 teacher has no fast path."""
    from cotracker_tpu_torch.evaluation.bootstap_predictor import TAPIRPredictor
    from cotracker_tpu_torch.evaluation.evaluation_predictor import EvaluationPredictor
    from cotracker_tpu_torch.models.build import build_cotracker

    tapir = None if tapir_checkpoint is None else TAPIRPredictor(tapir_checkpoint)

    def wrap(model):
        return EvaluationPredictor(model, grid_size=0, local_grid_size=0, single_point=False)

    teachers = []
    if v21_checkpoint is not None:
        teachers.append(wrap(build_cotracker(v21_checkpoint, v2=True, window_len=16,
                                             device=device)))
    if v3_online_checkpoint is not None:
        teachers.append(wrap(build_cotracker(v3_online_checkpoint, offline=False, fast=fast,
                                             device=device)))
    if v3_offline_checkpoint is not None:
        teachers.append(wrap(build_cotracker(v3_offline_checkpoint, offline=True, fast=fast,
                                             device=device)))
    if tapir is not None:
        teachers.append(tapir)
    if not teachers:
        raise ValueError("no teacher checkpoints given")
    return TeacherEnsemble(teachers, support_grid_size=support_grid_size, seed=seed)
