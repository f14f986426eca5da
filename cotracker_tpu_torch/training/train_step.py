"""Supervised training step (port of cotracker_tpu/training/train_step.py):
query sampling from ground truth, the offline and online loss assembly,
AdamW with global-norm clipping and the one-cycle cosine schedule.
"""

import math
from typing import NamedTuple, Optional

import torch

from cotracker_tpu_torch.training.losses import (
    sequence_bce_loss, sequence_loss, sequence_prob_loss,
)


class TrainConfig(NamedTuple):
    iters: int = 4
    flow_weight: float = 0.05
    invisible_flow_weight: float = 0.01
    add_huber_loss: bool = False
    train_only_on_visible: bool = False
    offline_model: bool = True
    sliding_window_len: int = 16
    query_sampling_method: str = "first_visible"  # or "random"


def sample_queries_from_gt(trajs_g, vis_g, generator: torch.Generator,
                           method: str = "first_visible"):
    """Training queries (B, N, 3) (t, x, y) from ground truth: trajs_g
    (B, T, N, 2), vis_g (B, T, N) in {0, 1}.

    "first_visible": each track at its first visible frame, except the first
    N//4 tracks, which go to a visible frame drawn uniformly; "random": every
    track at a visible frame drawn uniformly. The draw is the Gumbel argmax
    over the visible frames, from `generator` (its own device; the result
    moves to the tracks' device)."""
    B, T, N = vis_g.shape
    dev = vis_g.device
    first_positive = torch.argmax(vis_g, dim=1)  # (B, N), the first maximum
    u = torch.rand((B, T, N), generator=generator, device=generator.device)
    gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7))).to(dev)
    logits = torch.where(vis_g > 0, gumbel, torch.full_like(gumbel, -math.inf))
    rand_vis = torch.argmax(logits, dim=1)
    if method == "random":
        inds = rand_vis
    else:
        track_ix = torch.arange(N, device=dev)[None, :]
        inds = torch.where(track_ix < N // 4, rand_vis, first_positive)
    xys = torch.gather(trajs_g, 1, inds[:, None, :, None].expand(B, 1, N, 2))[:, 0]
    return torch.cat([inds[..., None].to(trajs_g.dtype), xys], dim=-1)


def window_targets(num_windows: int, S: int, trajs_g, vis_g, valids, valid_mask):
    """For each of an online forward's windows (S frames at step S//2): the
    ground truth sliced to its frames and zero-padded past T, valids gated
    by the "query started" mask, and the frame mask (None where the window
    lies inside the video; else (S,), 0 on the padded frames, which also
    zeroes their valids). Yields (traj_gt, vis_gt, val, frame_mask)."""
    T = vis_g.shape[1]
    step = S // 2
    gated_valids = valids * valid_mask
    for w in range(num_windows):
        ind = w * step
        n_real = min(S, T - ind)

        def sl(x):
            part = x[:, ind : ind + n_real]
            if n_real == S:
                return part
            pad = part.new_zeros((part.shape[0], S - n_real) + part.shape[2:])
            return torch.cat([part, pad], dim=1)

        frame_mask = None
        traj_gt, vis_gt, val = sl(trajs_g), sl(vis_g), sl(gated_valids)
        if n_real < S:
            frame_mask = (torch.arange(S, device=vis_g.device) < n_real).to(torch.float32)
            val = val * frame_mask[None, :, None]
        yield traj_gt, vis_gt, val, frame_mask


def _online_loss_assembly(train_data, trajs_g, vis_g, valids, cfg: TrainConfig):
    """Per-window losses of the online model, averaged over windows (the
    targets of window_targets)."""
    coords_w, vis_w, conf_w, valid_mask = train_data
    flow = invis = vis_l = conf_l = 0.0
    targets = window_targets(len(coords_w), cfg.sliding_window_len, trajs_g, vis_g, valids,
                             valid_mask)
    for w, (traj_gt, vis_gt, val, frame_mask) in enumerate(targets):
        flow = flow + sequence_loss(coords_w[w], traj_gt, val, vis=vis_gt, gamma=0.8,
                                    add_huber_loss=cfg.add_huber_loss, loss_only_for_visible=True)
        if not cfg.train_only_on_visible:
            invis = invis + sequence_loss(coords_w[w], traj_gt, val, vis=1.0 - vis_gt, gamma=0.8,
                                          add_huber_loss=False, loss_only_for_visible=True)
        vis_l = vis_l + sequence_bce_loss(vis_w[w], vis_gt, frame_mask=frame_mask)
        conf_l = conf_l + sequence_prob_loss(coords_w[w], conf_w[w], traj_gt, vis_gt,
                                             frame_mask=frame_mask).mean()
    n = len(coords_w)
    return flow / n, invis / n, vis_l / n, conf_l / n


def tracker_loss_fn(model, video, trajs_g, vis_g, valids, queries, cfg: TrainConfig,
                    track_mask: Optional[torch.Tensor] = None):
    """Training loss: the single-window forward for the offline model, the
    warm-started multi-window forward and per-window assembly for the online
    model (cfg.offline_model=False). video (B, T, H, W, 3); trajs_g
    (B, T, N, 2); vis_g, valids (B, T, N). Returns (total loss, dict of
    its weighted terms)."""
    if track_mask is not None:
        valids = valids * track_mask[:, None, :].to(valids.dtype)
    if not cfg.offline_model:
        *_, train_data = model.forward_windows(video, queries, iters=cfg.iters, is_train=True,
                                               track_mask=track_mask)
        flow_loss, invis_loss, vis_loss, conf_loss = _online_loss_assembly(
            train_data, trajs_g, vis_g, valids, cfg)
    else:
        *_, train_data = model(video, queries, iters=cfg.iters, is_train=True,
                               track_mask=track_mask)
        coord_preds, vis_preds, conf_preds, _ = train_data
        flow_loss = sequence_loss(coord_preds, trajs_g, valids, vis=vis_g, gamma=0.8,
                                  add_huber_loss=cfg.add_huber_loss, loss_only_for_visible=True)
        conf_loss = sequence_prob_loss(coord_preds, conf_preds, trajs_g, vis_g).mean()
        vis_loss = sequence_bce_loss(vis_preds, vis_g)
        invis_loss = None
        if not cfg.train_only_on_visible:
            invis_loss = sequence_loss(coord_preds, trajs_g, valids, vis=1.0 - vis_g, gamma=0.8,
                                       add_huber_loss=False, loss_only_for_visible=True)
    total = flow_loss * cfg.flow_weight + vis_loss + conf_loss
    aux = {"flow_loss": flow_loss * cfg.flow_weight, "vis_loss": vis_loss, "conf_loss": conf_loss}
    if not cfg.train_only_on_visible:
        total = total + invis_loss * cfg.invisible_flow_weight
        aux["invisible_flow_loss"] = invis_loss * cfg.invisible_flow_weight
    aux["total_loss"] = total
    return total, aux


def onecycle_lr(count: int, peak_value: float, transition_steps: int, pct_start: float = 0.05,
                div_factor: float = 25.0, final_div_factor: float = 1e4) -> float:
    """optax.cosine_onecycle_schedule at step `count`: cosine from
    peak/div_factor up to the peak at int(pct_start * transition_steps),
    then cosine down to peak/(div_factor * final_div_factor) at
    transition_steps, constant after."""
    init = peak_value / div_factor
    bounds = (0, int(pct_start * transition_steps), int(transition_steps))
    values = (init, init * div_factor, init * div_factor / (div_factor * final_div_factor))
    if count >= bounds[2]:
        return values[2]
    k = 0 if count < bounds[1] else 1
    pct = (count - bounds[k]) / (bounds[k + 1] - bounds[k])
    return values[k + 1] + (values[k] - values[k + 1]) / 2.0 * (math.cos(math.pi * pct) + 1)


def make_optimizer(model: torch.nn.Module, lr: float = 5e-4, wdecay: float = 1e-5,
                   num_steps: int = 50000, params=None):
    """AdamW (beta 0.9 / 0.999, eps 1e-8, decoupled weight decay `wdecay`)
    over `params` (every parameter of `model` by default), and a LambdaLR
    that follows the one-cycle cosine schedule over num_steps + 100 steps
    with its peak `lr` (the JAX package's optax chain). Step with
    `apply_gradients`."""
    optimizer = torch.optim.AdamW(model.parameters() if params is None else params, lr=lr,
                                  betas=(0.9, 0.999), eps=1e-8, weight_decay=wdecay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda c: onecycle_lr(c, lr, num_steps + 100) / lr)
    return optimizer, scheduler


def apply_gradients(optimizer, scheduler, max_norm: float = 1.0, clip_over=None):
    """One optimizer update from the parameters' .grad: clip by the global
    norm (scaled by max_norm/norm where norm >= max_norm, as optax does), an
    AdamW step at the schedule's rate, the schedule advanced. The norm is
    taken over `clip_over` (default: the optimizer's parameters): a wider
    set is optax's clip ahead of a multi_transform that freezes part of the
    tree, whose gradients count in the norm and which no update moves. A
    parameter without a gradient takes a zero one, so its moments and
    weight decay advance as they do in optax."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    clipped = params if clip_over is None else list(clip_over)
    for p in params + clipped:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    norm = torch.sqrt(sum((p.grad ** 2).sum() for p in clipped))
    keep = norm < max_norm  # on the device: no synchronisation
    for p in params:
        p.grad.copy_(torch.where(keep, p.grad, p.grad / norm * max_norm))
    optimizer.step()
    scheduler.step()


def train_step(model, optimizer, scheduler, batch, generator: torch.Generator,
               cfg: TrainConfig):
    """Queries from the ground truth, the loss and its gradient, one update.
    batch: video, trajs_g, vis_g, valids [, track_mask] on the model's
    device. Returns the loss terms, detached."""
    queries = sample_queries_from_gt(batch["trajs_g"], batch["vis_g"], generator,
                                     cfg.query_sampling_method)
    optimizer.zero_grad(set_to_none=True)
    total, aux = tracker_loss_fn(model, batch["video"], batch["trajs_g"], batch["vis_g"],
                                 batch["valids"], queries, cfg, track_mask=batch.get("track_mask"))
    total.backward()
    apply_gradients(optimizer, scheduler)
    return {k: v.detach() for k, v in aux.items()}
