"""Training losses (port of cotracker_tpu/training/losses.py).

Every loss takes per-iteration stacked predictions (iters, B, T, N, ...).
`group` is the JAX package's mesh `axis_name`: a process group over which B
and N are sharded; every mean then sums its numerator and denominator over
the group, so it covers the global (B, N), with the gradient of the local
terms alone (ops/collectives.psum_value; the sharded step sums the
parameters' gradients over every rank).
"""

import torch

from cotracker_tpu_torch.ops.collectives import psum_value
from cotracker_tpu_torch.ops.masked import reduce_masked_mean


def huber(x, y, delta: float = 1.0):
    """Elementwise Huber loss."""
    diff = x - y
    a = diff.abs()
    flag = (a <= delta).to(x.dtype)
    return flag * 0.5 * diff**2 + (1 - flag) * delta * (a - 0.5 * delta)


def sequence_loss(flow_preds, flow_gt, valids, vis=None, gamma: float = 0.8,
                  add_huber_loss: bool = False, loss_only_for_visible: bool = False,
                  group=None):
    """Gamma-discounted per-iteration flow loss. flow_preds (iters, B, T, N, 2);
    flow_gt (B, T, N, 2); valids (B, T, N); vis (B, T, N) optional gate."""
    iters = flow_preds.shape[0]
    total = 0.0
    for i in range(iters):
        w = gamma ** (iters - i - 1)
        if add_huber_loss:
            i_loss = huber(flow_preds[i], flow_gt, delta=6.0)
        else:
            i_loss = (flow_preds[i] - flow_gt).abs()
        i_loss = i_loss.mean(dim=3)  # B, T, N
        valid = valids
        if loss_only_for_visible and vis is not None:
            valid = valid * vis
        total = total + w * reduce_masked_mean(i_loss, valid, group=group)
    return total / iters


def _bce(prob, target):
    # binary cross-entropy on probabilities with the log terms floored at a
    # NORMAL float32 (1e-37; a subnormal floor flushes to zero on devices
    # that flush, bringing back 0 * inf = NaN in the gradient) and capped at
    # -100, as the JAX package does
    tiny = 1e-37
    log_p = torch.log(prob.clamp_min(tiny)).clamp_min(-100.0)
    log_1mp = torch.log((1.0 - prob).clamp_min(tiny)).clamp_min(-100.0)
    return -(target * log_p + (1.0 - target) * log_1mp)


def sequence_bce_loss(vis_preds, vis_gt, frame_mask=None, group=None):
    """Mean BCE over iterations. vis_preds (iters, B, T, N) probabilities;
    vis_gt (B, T, N) in {0, 1}; frame_mask optional (T,) validity, the
    padded frames of a window past the video's end excluded from the mean."""
    iters = vis_preds.shape[0]
    total = 0.0
    for i in range(iters):
        bce = _bce(vis_preds[i], vis_gt)
        if frame_mask is None:
            num, den = bce.sum(), float(bce.numel())
        else:
            m = frame_mask[None, :, None]
            num = (bce * m).sum()
            den = m.sum() * bce.shape[0] * bce.shape[2]
        if group is not None:
            den = num.new_tensor(den) if frame_mask is None else den
            num, den = psum_value(num, group), psum_value(den, group)
        total = total + num / den
    return total / iters


def sequence_prob_loss(tracks, confidence, target_points, visibility,
                       expected_dist_thresh: float = 12.0, frame_mask=None, group=None):
    """Confidence loss, classifying "error <= 12 px"; no gradient reaches
    `tracks`. tracks (iters, B, T, N, 2); confidence (iters, B, T, N)
    probabilities; target_points (B, T, N, 2); visibility (B, T, N);
    frame_mask as in sequence_bce_loss. Returns (B,); with `group` the
    scalar global mean (the caller's mean over B is then the identity), as
    in JAX."""
    iters = tracks.shape[0]
    total = 0.0
    for i in range(iters):
        err = ((tracks[i].detach() - target_points) ** 2).sum(dim=-1)
        valid = (err <= expected_dist_thresh**2).to(torch.float32)
        logprob = _bce(confidence[i], valid) * visibility
        if group is not None:
            if frame_mask is None:
                num = logprob.sum()
                den = num.new_tensor(float(logprob.numel()))
            else:
                num = (logprob * frame_mask[None, :, None]).sum()
                den = frame_mask.sum() * logprob.shape[0] * logprob.shape[2]
            total = total + psum_value(num, group) / psum_value(den, group)
        elif frame_mask is None:
            total = total + logprob.mean(dim=(1, 2))
        else:
            m = frame_mask[None, :, None]
            total = total + (logprob * m).sum(dim=(1, 2)) / (frame_mask.sum() * logprob.shape[2])
    return total / iters
