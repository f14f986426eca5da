"""Streams back to back: `videos` seeded videos of `stream_frames` frames at
`height` x `width`, cycled, each through `CoTrackerOnlinePredictor`
(`capacity` frames) with a `grid_size` x `grid_size` query grid at frame
0: the registering first step, then a window of `window_len` frames every
`window_len / 2`. A unit is one window; its work is points x the frames it
adds (the whole window for a stream's first). The check compares one whole
stream drawn from the seed, every window of it, its last included: the
reference streams the same chunks with its own state from the first step,
so a fault in the state carried to any window shows."""

import time

import numpy as np

from reference import cotracker3 as ref
from reference import predict
from scene import make_video


def make_predictor(cfg, mix, device):
    """The program under test, built as the configuration states."""
    from cotracker_tpu_torch.ops.kernels.variants import KernelVariants
    from cotracker_tpu_torch.predictor import CoTrackerOnlinePredictor

    return CoTrackerOnlinePredictor(capacity=mix["capacity"], window_len=cfg["window_len"],
                                    model_resolution=tuple(cfg["model_resolution"]),
                                    fast=cfg["fast"], device=device,
                                    variants=KernelVariants(**cfg["kernel_variants"]))


class Driver:
    unit = "window"

    def __init__(self, cfg, mix, seed, device):
        self.cfg, self.mix = cfg, mix
        self.pred = make_predictor(cfg, mix, device)
        self.model = self.pred.model
        self.videos = [make_video(seed, i, mix["stream_frames"], mix["height"], mix["width"],
                                  mix["scene"], device) for i in range(mix["videos"])]
        self.S = cfg["window_len"]
        self.step = self.S // 2
        self.starts = range(0, mix["stream_frames"] - self.S + 1, self.step)
        self.results = []  # per unit: (stream, video, ind, tracks, visible, vis, conf)
        self.vis = self.conf = None  # the model's probabilities as they pass, for the check
        online_step = self.model.online_step

        def captured(*a, **k):
            out = online_step(*a, **k)
            self.vis, self.conf = out[2], out[3]
            return out

        self.model.online_step = captured

    def _stream(self, s, keep, windows=None):
        v = self.videos[s % len(self.videos)]
        n = self.mix["grid_size"] ** 2
        self.pred(v[None, :1], is_first_step=True, grid_size=self.mix["grid_size"])
        for w, ind in enumerate(self.starts):
            if windows is not None and w >= windows:
                return
            t0 = time.perf_counter()
            tracks, visible = self.pred(v[None, ind:ind + self.S])
            end = ind + self.S
            host = (tracks[0, ind:end].cpu(), visible[0, ind:end].cpu(),
                    self.vis[0, ind:end, :n].float().cpu(),
                    self.conf[0, ind:end, :n].float().cpu())
            dt = time.perf_counter() - t0
            if keep:
                self.results.append((s, s % len(self.videos), ind) + host)
            yield n * (self.S if ind == 0 else self.step), dt

    def warm_up(self):
        for _ in self._stream(0, keep=False, windows=self.mix["warm_up_windows"]):
            pass

    def units(self):
        s = 0
        while True:
            yield from self._stream(s, keep=True)
            s += 1

    def unit_shapes(self):
        n = self.mix["grid_size"] ** 2
        return [(n, self.S, self.S if r[2] == 0 else self.step) for r in self.results]

    def sample(self, seed):
        """Every window of one whole stream, drawn from the seed among the
        streams that completed; None before one has."""
        by_stream = {}
        for r in self.results:
            by_stream.setdefault(r[0], []).append(r)
        done = [rs for _, rs in sorted(by_stream.items()) if len(rs) == len(self.starts)]
        if not done:
            return None
        return done[int(np.random.default_rng(int(seed) % (1 << 63)).integers(len(done)))]

    def answers(self, sample):
        return [tuple(r[3:7]) for r in sample]

    def reference(self, params, sample, rq=ref.identity):
        with ref.reference_mode():
            wins = predict.online_windows(params, self.cfg, self.videos[sample[0][1]],
                                          self.mix["grid_size"], self.mix["capacity"],
                                          len(sample), rq)
        assert [w[0] for w in wins] == [r[2] for r in sample]
        return [tuple(t.cpu() for t in w[1:]) for w in wins]

    def queries_px(self, sample):
        hw = tuple(self.cfg["model_resolution"])
        v = self.videos[sample[0][1]]
        return (predict.grid_points(self.mix["grid_size"], *hw)
                * predict.input_scale(v, hw).cpu())

    def release(self):
        self.pred = self.model = self.loop = None
