"""Plain float32 CoTracker3, the benchmark's reference.

CoTracker3 (Karaev et al., arXiv:2410.11831) as published in
facebookresearch/co-tracker: `cotracker/models/core/cotracker/
cotracker3_offline.py` (the whole video as one window) and
`cotracker3_online.py` (one window of a stream per call, the support
features accumulated as queries arrive, each window warm-started from the
last), with the RAFT encoder, the 4-level pyramid, the 7x7 support and
7x7 neighbourhood correlation through the 2401->384->256 MLP, and the
EfficientUpdateFormer (3 time blocks, 3 space rounds through 64 virtual
tracks). Written from the published equations in plain torch operations:
it imports nothing of the program under test, and every product runs in
float32 with TF32 off (`reference_mode`).

Batch 1. Layouts: frames (T, H, W, 3) in [0, 255], feature maps
(T, H/4, W/4, 128), coordinates (x, y) in pixels of the level they index,
tracks (T, N, 2). Parameters are a dict keyed by `spec.param_spec` names.

Every product's operands go through `rq(x, kind)` before it is taken. The
reference passes the identity. The benchmark's control passes
`control_rounding`: operands that the program under test holds in int8
(`"i8"`: the correlation volume and its first MLP layer, the update
transformer's point-side W8A8 products) are rounded to int4, all others
(`"bf"`) to fp8 e4m3: one step below each precision the configuration
states.

Work is split in blocks of tracks or rows so that the float32 activations
of the largest cell fit beside each other on one card.
"""

import contextlib
import math

import torch
import torch.nn.functional as F

F32 = torch.float32
ROWS = 1 << 17  # rows of a token matrix a linear layer takes at once
CORR_POINT_FRAMES = 1 << 16  # (track, frame) pairs whose correlation is built at once


def identity(x, kind):
    return x


def _round_int4(x):
    """Symmetric int4 codes a row (absmax over the last axis), dequantized."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / 7.0
    return torch.round(x / s).clamp(-7.0, 7.0) * s


def _round_fp8(x):
    """fp8 e4m3 with one absmax scale a tensor, dequantized."""
    s = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


def control_rounding(x, kind):
    return _round_int4(x) if kind == "i8" else _round_fp8(x)


@contextlib.contextmanager
def reference_mode():
    """float32 products without TF32 on the card, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def linear(p, name, x, rq, kind="bf"):
    """x @ W.T + b of parameter group `name`, ROWS rows at a time."""
    w, b = rq(p[name + ".weight"], kind), p.get(name + ".bias")
    flat = x.reshape(-1, x.shape[-1])
    out = torch.cat([F.linear(rq(flat[i:i + ROWS], kind), w, b)
                     for i in range(0, flat.shape[0], ROWS)])
    return out.reshape(*x.shape[:-1], w.shape[0])


# ------------------------------------------------------------------ encoder


def _conv(p, name, x, rq, stride=1, padding=0):
    return F.conv2d(rq(x, "bf"), rq(p[name + ".weight"], "bf"), p[name + ".bias"],
                    stride=stride, padding=padding)


def _residual(p, name, x, rq, stride):
    y = F.relu(F.instance_norm(_conv(p, name + ".conv1", x, rq, stride, 1)))
    y = F.relu(F.instance_norm(_conv(p, name + ".conv2", y, rq, 1, 1)))
    if stride != 1:
        x = F.instance_norm(_conv(p, name + ".downsample.0", x, rq, stride))
    return F.relu(x + y)


def encode(p, frames, rq, chunk=8):
    """frames (T, H, W, 3) in [0, 255] -> L2-normalised feature maps
    (T, H/4, W/4, 128): the RAFT BasicEncoder, `chunk` frames at a time."""
    out = []
    for i in range(0, frames.shape[0], chunk):
        x = (2.0 * (frames[i:i + chunk].to(F32) / 255.0) - 1.0).permute(0, 3, 1, 2)
        H, W = x.shape[-2:]
        x = F.relu(F.instance_norm(_conv(p, "fnet.conv1", x, rq, 2, 3)))
        feats = []
        for layer, stride in (("layer1", 1), ("layer2", 2), ("layer3", 2), ("layer4", 2)):
            x = _residual(p, f"fnet.{layer}.0", x, rq, stride)
            x = _residual(p, f"fnet.{layer}.1", x, rq, 1)
            feats.append(x)
        x = torch.cat([F.interpolate(f, (H // 4, W // 4), mode="bilinear", align_corners=True)
                       for f in feats], dim=1)
        x = F.relu(F.instance_norm(_conv(p, "fnet.conv2", x, rq, 1, 1)))
        x = _conv(p, "fnet.conv3", x, rq).permute(0, 2, 3, 1)
        out.append(x / torch.sqrt((x * x).sum(-1, keepdim=True).clamp_min(1e-12)))
    return torch.cat(out)


def pyramid(fmaps, levels=4):
    pyr = [fmaps]
    for _ in range(levels - 1):
        x = F.avg_pool2d(pyr[-1].permute(0, 3, 1, 2), 2, 2)
        pyr.append(x.permute(0, 2, 3, 1))
    return pyr


# ------------------------------------------------------------------ sampling


def _offsets(radius, device):
    """(P, P, 2) offsets, the first axis stepping x (the published
    `get_support_points` meshgrid)."""
    d = torch.arange(-radius, radius + 1, dtype=F32, device=device)
    dx, dy = torch.meshgrid(d, d, indexing="ij")
    return torch.stack([dx, dy], dim=-1)


def bilinear(fmap, xy):
    """fmap (H, W, C) at pixel points xy (..., 2), border clamp
    (grid_sample with align_corners=True, padding_mode="border")."""
    H, W, C = fmap.shape
    x = xy[..., 0].clamp(0, W - 1)
    y = xy[..., 1].clamp(0, H - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
    flat = fmap.reshape(H * W, C)

    def tap(yy, xx):
        return flat[yy * W + xx]

    return ((tap(y0, x0) * (1 - wx) + tap(y0, x1) * wx) * (1 - wy)
            + (tap(y1, x0) * (1 - wx) + tap(y1, x1) * wx) * wy)


def support_features(fmaps, frames, coords, radius=3):
    """The 7x7 support patch of each query at its frame (trilinear in t,
    border clamp): fmaps (T, H, W, C), frames (N,), coords (N, 2) in this
    level's pixels -> (N, P*P, C), x-major. Queries are taken a frame at a
    time."""
    T = fmaps.shape[0]
    t = frames.to(F32).clamp(0, T - 1)
    t0 = torch.floor(t)
    wt = (t - t0)[:, None, None]
    t0 = t0.long()
    pts = (coords[:, None, None, :] + _offsets(radius, coords.device)).reshape(
        coords.shape[0], -1, 2)
    out = torch.empty(coords.shape[0], pts.shape[1], fmaps.shape[-1], dtype=F32,
                      device=fmaps.device)
    for f in torch.unique(t0).tolist():
        sel = (t0 == f).nonzero()[:, 0]
        a = bilinear(fmaps[f], pts[sel])
        b = bilinear(fmaps[min(f + 1, T - 1)], pts[sel])
        out[sel] = a * (1 - wt[sel]) + b * wt[sel]
    return out


# ------------------------------------------------------------------ correlation


def corr_embedding(p, fmaps, support, coords, rq, radius=3):
    """One level: fmaps (T, H, W, C), support (N, P*P, C), coords (T, N, 2)
    in this level's pixels -> (T, N, 256): each frame's 7x7 neighbourhood
    correlated with the 7x7 support (the 49 x 49 volume, flattened as
    (x offset, y offset, support tap)) through the correlation MLP.

    The 49 taps of a neighbourhood are one point plus integer offsets, so
    they share their fractional position: each bilinear tap is the same
    4-term blend of the 8 x 8 integer pixels around the point (indices
    clamped to the map: the border clamp of every tap), and the blend,
    being linear, is taken after the products with the support."""
    T, H, W, C = fmaps.shape
    N = coords.shape[1]
    P = 2 * radius + 1
    d = torch.arange(P + 1, device=coords.device)
    frame = torch.arange(T, device=coords.device)[:, None, None, None] * (H * W)
    flat = fmaps.reshape(T * H * W, C)
    chunk = max(16, CORR_POINT_FRAMES // T)
    out = []
    for s0 in range(0, N, chunk):
        c = coords[:, s0:s0 + chunk]
        n = c.shape[1]
        fl = torch.floor(c)
        fx, fy = (c - fl).unbind(-1)  # (T, n)
        xs = (fl[..., 0].long()[..., None] - radius + d).clamp(0, W - 1)  # (T, n, 8)
        ys = (fl[..., 1].long()[..., None] - radius + d).clamp(0, H - 1)
        win = flat[frame + ys[..., :, None] * W + xs[..., None, :]]  # (T, n, 8(y), 8(x), C)
        win = rq(win, "i8").reshape(T, n, -1, C).transpose(0, 1).reshape(n, -1, C)
        g = torch.bmm(win, rq(support[s0:s0 + n], "i8").transpose(1, 2))  # (n, T*64, 49)
        g = g.reshape(n, T, P + 1, P + 1, -1).transpose(0, 1)  # (T, n, y, x, 49)
        wx, wy = fx[..., None, None, None], fy[..., None, None, None]
        vol = ((1 - wy) * ((1 - wx) * g[:, :, :P, :P] + wx * g[:, :, :P, 1:])
               + wy * ((1 - wx) * g[:, :, 1:, :P] + wx * g[:, :, 1:, 1:]))  # (T, n, y, x, 49)
        vol = vol.transpose(2, 3).reshape(T, n, -1)  # x offset, y offset, support tap
        h = F.gelu(linear(p, "corr_mlp.fc1", vol, rq, "i8"))
        out.append(linear(p, "corr_mlp.fc2", h, rq, "bf"))
    return torch.cat(out, dim=1)


def posenc(x, min_deg=0, max_deg=10):
    scales = torch.tensor([2.0**i for i in range(min_deg, max_deg)], dtype=x.dtype,
                          device=x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))], dim=-1)


def time_embedding(dim, window_len, T, device):
    """The 1-D sin-cos embedding of the window's frames (float64 grid),
    linearly resized (align_corners=False) to T frames: (T, dim)."""
    omega = 1.0 / 10000 ** (torch.arange(dim // 2, dtype=torch.float64) / (dim / 2.0))
    pos = torch.arange(window_len, dtype=torch.float64)[:, None] * omega
    emb = torch.cat([torch.sin(pos), torch.cos(pos)], dim=1).to(F32)
    if T != window_len:
        emb = F.interpolate(emb.t()[None], size=T, mode="linear", align_corners=False)[0].t()
    return emb.to(device)


# ------------------------------------------------------------------ update transformer


def _layer_norm(x, eps=1e-6):
    return F.layer_norm(x, x.shape[-1:], eps=eps)


def attention(p, name, x, ctx, rq, kind_q="bf", kind_kv="bf", heads=8):
    """Multi-head attention, queries x (G, L, C) over keys/values ctx
    (G, S, C) with the group axis G batched; float32 softmax."""
    G, L, C = x.shape
    d = C // heads
    q = linear(p, name + ".to_q", x, rq, kind_q).reshape(G, L, heads, d).transpose(1, 2)
    k, v = linear(p, name + ".to_kv", ctx, rq, kind_kv).chunk(2, dim=-1)
    k = k.reshape(G, -1, heads, d).transpose(1, 2)
    v = v.reshape(G, -1, heads, d).transpose(1, 2)
    sim = torch.matmul(rq(q, "bf"), rq(k, "bf").transpose(-1, -2)) * d**-0.5
    out = torch.matmul(rq(torch.softmax(sim, dim=-1), "bf"), rq(v, "bf"))
    return linear(p, name + ".to_out", out.transpose(1, 2).reshape(G, L, C), rq, kind_q)


def _mlp(p, name, x, rq, kind):
    h = F.gelu(linear(p, name + ".fc1", x, rq, kind), approximate="tanh")
    return linear(p, name + ".fc2", h, rq, kind)


def _groups(x, group_rows):
    step = max(1, ROWS // group_rows)
    return [slice(i, i + step) for i in range(0, x.shape[0], step)]


def attn_block(p, name, x, rq, kind):
    """Pre-norm self-attention + tanh-GELU MLP block over x (G, L, C)."""
    out = torch.empty_like(x)
    for sl in _groups(x, x.shape[1]):
        y = x[sl]
        n = _layer_norm(y)
        y = y + attention(p, name + ".attn", n, n, rq, kind, kind)
        out[sl] = y + _mlp(p, name + ".mlp", _layer_norm(y), rq, kind)
    return out


def cross_block(p, name, x, ctx, rq, kind_q, kind_kv):
    """Pre-norm cross-attention of x (G, L, C) over the affine-normalised
    ctx (G, S, C), then the MLP."""
    out = torch.empty_like(x)
    for sl in _groups(x, max(x.shape[1], ctx.shape[1])):
        c = F.layer_norm(ctx[sl], ctx.shape[-1:], p[name + ".norm_context.weight"],
                         p[name + ".norm_context.bias"], eps=1e-5)
        y = x[sl]
        y = y + attention(p, name + ".cross_attn", _layer_norm(y), c, rq, kind_q, kind_kv)
        out[sl] = y + _mlp(p, name + ".mlp", _layer_norm(y), rq, kind_q)
    return out


def update_transformer(p, tokens, rq, depth=3):
    """tokens (N, T, 384) -> (N, T, 4): time attention per track, then
    virtual <- points, virtual self-attention and points <- virtual per
    frame, `depth` times; the flow and vis/conf heads."""
    N, T, C = tokens.shape
    virtual = p["updateformer.virtual_tracks"][0, :, 0][:, None].expand(-1, T, C)
    for i in range(depth):
        blk = f"updateformer.time_blocks.{i}"
        tokens = attn_block(p, blk, tokens, rq, "i8")
        virtual = attn_block(p, blk, virtual, rq, "i8")
        vt = cross_block(p, f"updateformer.space_virtual2point_blocks.{i}",
                         virtual.transpose(0, 1), tokens.transpose(0, 1), rq, "bf", "i8")
        vt = attn_block(p, f"updateformer.space_virtual_blocks.{i}", vt, rq, "bf")
        pt = cross_block(p, f"updateformer.space_point2virtual_blocks.{i}",
                         tokens.transpose(0, 1).contiguous(), vt, rq, "i8", "bf")
        tokens, virtual = pt.transpose(0, 1).contiguous(), vt.transpose(0, 1).contiguous()
    return torch.cat([linear(p, "updateformer.flow_head", tokens, rq),
                      linear(p, "updateformer.vis_conf_head", tokens, rq)], dim=-1)


# ------------------------------------------------------------------ model


def iterate(p, pyr, supports, coords, vis, conf, rq, iters, window_len, stride=4,
            model_hw=(384, 512)):
    """`iters` updates of one window. coords (T, N, 2) in level-0 pixels,
    vis / conf (T, N) logits. Returns the last coords (model pixels), vis
    and conf logits."""
    T, N = coords.shape[:2]
    scale = torch.tensor([model_hw[1] / stride, model_hw[0] / stride], device=coords.device)
    temb = time_embedding(p["updateformer.input_transform.weight"].shape[1], window_len, T,
                          coords.device)
    for _ in range(iters):
        embs = torch.cat([corr_embedding(p, f, s, coords / 2**i, rq)
                          for i, (f, s) in enumerate(zip(pyr, supports))], dim=-1)
        rel_fwd = F.pad(coords[:-1] - coords[1:], (0, 0, 0, 0, 0, 1))
        rel_bwd = F.pad(coords[1:] - coords[:-1], (0, 0, 0, 0, 1, 0))
        rel = posenc(torch.cat([rel_fwd / scale, rel_bwd / scale], dim=-1))
        x = torch.cat([vis[..., None], conf[..., None], embs, rel], dim=-1) + temb[:, None]
        del embs, rel
        tokens = linear(p, "updateformer.input_transform", x.transpose(0, 1), rq)
        del x
        delta = update_transformer(p, tokens, rq).transpose(0, 1)  # (T, N, 4)
        coords = coords + delta[..., :2]
        vis = vis + delta[..., 2]
        conf = conf + delta[..., 3]
    return coords * stride, vis, conf


def offline_forward(p, frames, queries, rq=identity, iters=6, window_len=60, stride=4):
    """CoTracker3 offline: frames (T, H, W, 3) in [0, 255] at the model
    resolution, queries (N, 3) as (t, x, y) model pixels. Returns tracks
    (T, N, 2) model pixels, vis and conf probabilities (T, N)."""
    pyr = pyramid(encode(p, frames, rq))
    qf, qxy = queries[:, 0], queries[:, 1:] / stride
    supports = [support_features(f, qf, qxy / 2**i) for i, f in enumerate(pyr)]
    T = frames.shape[0]
    coords = qxy[None].expand(T, -1, -1).contiguous()
    zeros = torch.zeros(coords.shape[:2], dtype=F32, device=coords.device)
    c, v, k = iterate(p, pyr, supports, coords, zeros, zeros.clone(), rq, iters, window_len,
                      stride, tuple(frames.shape[1:3]))
    return c, torch.sigmoid(v), torch.sigmoid(k)


class OnlineStream:
    """CoTracker3 online, one stream: `step(chunk)` takes the window
    [ind, ind + S) (S = window_len frames at the model resolution) and
    returns that window's tracks (model pixels), vis and conf probabilities;
    `ind` then moves on by S/2. Each query's support is accumulated once,
    in the window whose fresh frames hold its frame; a window starts from
    the last one's predictions on their overlap."""

    def __init__(self, p, queries, capacity, rq=identity, iters=6, window_len=16, stride=4):
        self.p, self.rq, self.iters, self.S, self.stride = p, rq, iters, window_len, stride
        self.queries = queries
        N, dev = queries.shape[0], queries.device
        C = p["fnet.conv3.weight"].shape[0]
        self.support = [torch.zeros(N, 49, C, device=dev) for _ in range(4)]
        self.coords = torch.zeros(capacity, N, 2, device=dev)
        self.vis = torch.zeros(capacity, N, device=dev)
        self.conf = torch.zeros(capacity, N, device=dev)
        self.ind = 0

    def step(self, chunk):
        S, step, ind, st = self.S, self.S // 2, self.ind, self.stride
        pyr = pyramid(encode(self.p, chunk, self.rq))
        qf, qxy = self.queries[:, 0], self.queries[:, 1:] / st
        left, right = (0 if ind == 0 else ind + step), ind + S
        new = (qf >= left) & (qf < right)
        if bool(new.any()):
            sel = new.nonzero()[:, 0]
            for i, f in enumerate(pyr):
                self.support[i][sel] += support_features(f, qf[sel] - ind,
                                                                 qxy[sel] / 2**i)
        coords = qxy[None].expand(S, -1, -1).clone()
        vis = torch.zeros(S, qf.shape[0], device=qf.device)
        conf = vis.clone()
        if ind > 0:  # warm start from the previous window on the overlap
            ov = S - step
            carry = qf < ind + ov

            def warm(buf, init, scale=1.0):
                prev = buf[ind:ind + ov] / scale
                prev = torch.cat([prev, prev[-1:].expand(S - ov, *prev.shape[1:])])
                m = carry.reshape((1, -1) + (1,) * (buf.dim() - 2))
                return torch.where(m, prev, init)

            coords, vis, conf = (warm(self.coords, coords, float(st)), warm(self.vis, vis),
                                 warm(self.conf, conf))
        c, v, k = iterate(self.p, pyr, self.support, coords, vis, conf, self.rq, self.iters,
                          S, st, tuple(chunk.shape[1:3]))
        self.coords[ind:ind + S], self.vis[ind:ind + S], self.conf[ind:ind + S] = c, v, k
        self.ind = ind + step
        return c, torch.sigmoid(v), torch.sigmoid(k)
