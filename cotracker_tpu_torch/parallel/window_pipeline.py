"""Window sharding over ranks: a pipeline for long-video sliding-window
inference (port of cotracker_tpu/parallel/window_pipeline.py).

The window-16 online model tracks a long video as a chain of sliding
windows: window w warm-starts from window w-1's overlap frames. Two kinds of
parallelism survive the chain, and the pipeline takes both:

  * the frame encoder (fnet) and the pyramid are per frame: each stage
    encodes only its own slab of frames (with an `overlap`-frame halo);
  * the chain pipelines over videos (GPipe): the "window" axis is split
    into stages, stage s owns a contiguous block of windows, and the warm
    start (the overlap frames' coords, vis and conf, O(overlap * N) bytes)
    hops from stage s to stage s+1. At step t stage s runs video b = t - s,
    over B + stages - 1 steps, so with B videos in flight the stages are
    busy B / (B + stages - 1) of the time.

A query's support patches are sampled by the stage that owns its query
frame and summed over "window" to every stage. With a 2-D ("window",
"track") mesh each stage also splits its tracks, and virtual <- points sums
over "track" inside the stage.

The result equals `CoTrackerThree.forward_windows` (the same warm start,
masks and overwrite order): windows that pad the chain past its last real
window never write, and the stitch takes the frames past the chain's body
from the stage that owns the last real window, which need not be the last
stage.
"""

from typing import Optional

import torch
import torch.distributed as dist

from cotracker_tpu_torch.ops.collectives import psum
from cotracker_tpu_torch.parallel.mesh import Mesh, gather

F32 = torch.float32


def make_window_mesh(n_stages: Optional[int] = None, n_track: int = 1) -> Mesh:
    """A ("window",) mesh over every rank (n_stages of them: all by
    default), or with n_track > 1 a ("window", "track") mesh of n_stages x
    n_track: pipeline stages over the first axis, each stage's tracks split
    over the second."""
    world = dist.get_world_size()
    n_stages = n_stages or world // n_track
    if n_track > 1:
        return Mesh((n_stages, n_track), ("window", "track"))
    return Mesh((n_stages,), ("window",))


def _carry_hop(carry, mesh: Mesh):
    """Stage s's carry to stage s+1 (and the last stage's to the first, a
    ring as JAX's ppermute), the sends and receives posted together so no
    ring of blocking sends can hang. gloo sends CPU tensors only, so over
    gloo a CUDA carry goes through host memory (chosen by the backend)."""
    stages = mesh.ranks("window")
    s, n = mesh.index["window"], len(stages)
    host = dist.get_backend(mesh.group("window")) == "gloo" and carry[0].is_cuda
    out, ops = [], []
    for x in carry:
        send = x.contiguous().cpu() if host else x.contiguous()
        recv = torch.empty_like(send)
        ops += [dist.P2POp(dist.isend, send, stages[(s + 1) % n], group=mesh.group("window")),
                dist.P2POp(dist.irecv, recv, stages[(s - 1) % n], group=mesh.group("window"))]
        out.append(recv)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return tuple(r.to(x.device) for r, x in zip(out, carry))


def window_pipeline_forward(model, mesh: Mesh, iters: int = 4):
    """The pipelined equivalent of `model.forward_windows`. model: a
    CoTrackerThree with the online window length (e.g. 16); mesh: from
    make_window_mesh. With a "track" axis N must divide over it.

    Returns fn(video, queries, track_mask=None) -> (coords (B, T, N, 2)
    pixels, vis, conf (B, T, N) probabilities), forward_windows' first three
    outputs, whole on every rank: every rank passes the whole video
    (B, T, H, W, 3) and queries (B, N, 3). One video (B=1) gains only the
    frame-parallel encoder from the "window" axis: the pipeline is a tool
    for batches of videos (for one video, split its tracks). Runs without
    gradients; the model's parameters must be equal on every rank."""
    S = model.window_len
    step = S // 2
    overlap = S - step
    stride = model.stride
    Sd = mesh.shape["window"]
    s = mesh.index["window"]
    tracked = "track" in mesh.axis_names
    track_group = mesh.group("track") if tracked else None
    window_group = mesh.group("window")

    def stage_fn(slab, queries, track_mask, wloc, num_windows):
        """This stage's windows of every video: slab (B, L, H, W, 3) its
        frames (halo included), queries and track_mask its tracks. Returns
        its (B, L, N, ...) output buffers."""
        B, L = slab.shape[:2]
        N = queries.shape[1]
        offset = s * wloc * step  # the stage's first owned frame
        qf = queries[..., 0].to(F32)  # (B, N) global query frames
        qc = queries[..., 1:3].to(F32) / stride

        pyr = model.build_pyramid(model.compute_fmaps(slab))
        # support patches: sampled by the stage that owns the query frame
        # (the halo keeps the t+1 neighbour of the blend resident), summed
        # over "window" to every stage
        owner = torch.clamp(torch.floor(qf).long() // (wloc * step), max=Sd - 1)
        local_qf = (qf - float(offset)).clamp(0.0, float(L - 1))
        mine = (owner == s)[:, None, :, None]
        sup = [psum(x * mine.to(x.dtype), window_group)
               for x in model.track_feat_pyramid(pyr, local_qf, qc)]
        sup = [x * track_mask[:, None, :, None].to(x.dtype) for x in sup]

        out_c = torch.zeros((B, L, N, 2), dtype=F32, device=slab.device)  # model pixels
        out_v = torch.zeros((B, L, N), dtype=F32, device=slab.device)  # logits
        out_f = torch.zeros_like(out_v)

        def one_video(b, cin):
            """Video b through this stage's windows, warm-started from cin
            (the left stage's overlap tail); writes its buffers, returns
            its own tail."""
            qf_b, qc_b, tm_b = qf[b : b + 1], qc[b : b + 1], track_mask[b : b + 1]
            bufs = (out_c[b : b + 1], out_v[b : b + 1], out_f[b : b + 1])
            # windows that pad the chain past its last real window neither
            # run nor write (forward_windows has none)
            for wl in range(min(wloc, num_windows - s * wloc)):
                indl = wl * step
                ind_g = offset + indl
                coords_init = qc_b[:, None].expand(1, S, N, 2)
                zero = torch.zeros((1, S, N), dtype=F32, device=slab.device)
                inits = [coords_init, zero, zero]
                if ind_g > 0:
                    # warm start (reference cotracker3_online.py:456-482): the
                    # previous window's overlap tail, then its last frame
                    tails = cin if wl == 0 else [x[:, indl : indl + overlap] for x in bufs]
                    copy_over = (qf_b < float(ind_g + overlap))[:, None, :]
                    for k, tail in enumerate(tails):
                        tail = tail / float(stride) if k == 0 else tail
                        prev = torch.cat([tail, tail[:, -1:].expand(-1, step, *tail.shape[2:])],
                                         dim=1)
                        cw = copy_over[..., None] if k == 0 else copy_over
                        inits[k] = torch.where(cw, prev, inits[k])
                active = qf_b < float(ind_g + S)
                supw = [x[b : b + 1] * active[:, None, :, None].to(x.dtype) for x in sup]
                cp, vp, fp = model.iterate(
                    [f[b : b + 1, indl : indl + S] for f in pyr], supw, inits[0].contiguous(),
                    inits[1], inits[2], iters, track_mask=active & tm_b,
                    track_group=track_group)
                for buf, new in zip(bufs, (cp[-1], vp[-1], fp[-1])):
                    buf[:, indl : indl + S] = new
            return tuple(x[:, L - overlap :].clone() for x in bufs)

        # GPipe: at step t stage s runs video b = t - s; the tail it sends
        # reaches stage s+1 just when that stage takes video b
        carry = (torch.zeros((1, overlap, N, 2), dtype=F32, device=slab.device),
                 torch.zeros((1, overlap, N), dtype=F32, device=slab.device),
                 torch.zeros((1, overlap, N), dtype=F32, device=slab.device))
        for t in range(B + Sd - 1):
            b = t - s
            cout = one_video(b, carry) if 0 <= b < B else tuple(torch.zeros_like(x)
                                                                 for x in carry)
            carry = _carry_hop(cout, mesh) if Sd > 1 else cout
        return out_c, out_v, out_f

    @torch.no_grad()
    def fn(video, queries, track_mask=None):
        B, T = video.shape[:2]
        num_windows = max(1, -(-(T - S) // step) + 1)
        wloc = -(-num_windows // Sd)  # windows a stage (the last stages pad)
        T_buf = step * (wloc * Sd - 1) + S
        if T_buf > T:  # repeat the last frame
            video = torch.cat([video, video[:, -1:].expand(-1, T_buf - T, -1, -1, -1)], dim=1)
        L = wloc * step + overlap
        slab = video[:, s * wloc * step : s * wloc * step + L].to(mesh.device)
        if track_mask is None:
            track_mask = torch.ones(queries.shape[:2], dtype=torch.bool)
        q = queries.to(mesh.device)
        tm = track_mask.to(mesh.device)
        if tracked:
            n_local = q.shape[1] // mesh.shape["track"]
            if q.shape[1] % mesh.shape["track"]:
                raise ValueError(f"{q.shape[1]} tracks do not split over "
                                 f"{mesh.shape['track']} track ranks (pad and mask)")
            lo = mesh.index["track"] * n_local
            q, tm = q[:, lo : lo + n_local], tm[:, lo : lo + n_local]
        oc, ov, of = stage_fn(slab, q, tm, wloc, num_windows)  # (B, L, N_local, ...)
        # every stage's buffers, then every track rank's: (Sd, B, L, N, ...)
        parts = gather(mesh, [x[None] for x in (oc, ov, of)],
                       ("window", None, None, "track" if tracked else None))

        # the last writer of global frame g (forward_windows' order) is window
        # min(g // step, num_windows - 1): for g < step * num_windows its
        # stage's body slice; the frames past that from the last real
        # window's stage, (num_windows - 1) // wloc, not always the last one
        owner_last = (num_windows - 1) // wloc
        body_T = min(T, step * num_windows)
        tail_len = T - body_T
        tail_lo = body_T - owner_last * wloc * step

        def stitch(x):
            body = x[:, :, : wloc * step].transpose(0, 1).reshape(
                (B, Sd * wloc * step) + x.shape[3:])[:, :body_T]
            if not tail_len:
                return body
            return torch.cat([body, x[owner_last, :, tail_lo : tail_lo + tail_len]], dim=1)

        c, v, f = (stitch(x) for x in parts)
        return c, torch.sigmoid(v), torch.sigmoid(f)

    return fn
