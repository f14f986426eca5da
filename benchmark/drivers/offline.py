"""Offline videos back to back: `videos` seeded videos of `frames` frames
at `height` x `width`, cycled, each through `CoTrackerPredictor.__call__`
with a `grid_size` x `grid_size` query grid at frame 0. A unit is one
video; its work is points x frames. The check compares one completed
video drawn from the seed, over every frame and point."""

import time

import numpy as np

from reference import cotracker3 as ref
from reference import predict
from scene import make_video


def make_predictor(cfg, device):
    """The program under test, built as the configuration states."""
    from cotracker_tpu_torch.ops.kernels.variants import KernelVariants
    from cotracker_tpu_torch.predictor import CoTrackerPredictor

    return CoTrackerPredictor(offline=True, window_len=cfg["window_len"],
                              model_resolution=tuple(cfg["model_resolution"]),
                              fast=cfg["fast"], device=device,
                              variants=KernelVariants(**cfg["kernel_variants"]))


class Driver:
    unit = "video"

    def __init__(self, cfg, mix, seed, device):
        self.cfg, self.mix = cfg, mix
        self.pred = make_predictor(cfg, device)
        self.model = self.pred.model
        self.videos = [make_video(seed, i, mix["frames"], mix["height"], mix["width"],
                                  mix["scene"], device) for i in range(mix["videos"])]
        self.results = []  # per unit: (video index, tracks, visible, vis, conf) on the host
        self.vis = self.conf = None  # the model's probabilities as they pass, for the check

        def hook(module, args, out):
            self.vis, self.conf = out[1], out[2]

        self.model.register_forward_hook(hook)

    def _call(self, i, keep):
        v = self.videos[i % len(self.videos)]
        tracks, visible = self.pred(v[None], grid_size=self.mix["grid_size"])
        n = tracks.shape[2]
        host = (tracks[0].cpu(), visible[0].cpu(), self.vis[0, :, :n].float().cpu(),
                self.conf[0, :, :n].float().cpu())
        if keep:
            self.results.append((i % len(self.videos),) + host)
        return n * v.shape[0]

    def warm_up(self):
        self._call(0, keep=False)

    def units(self):
        i = 0
        while True:
            t0 = time.perf_counter()
            work = self._call(i, keep=True)
            yield work, time.perf_counter() - t0
            i += 1

    def unit_shapes(self):
        n = self.mix["grid_size"] ** 2
        return [(n, self.mix["frames"], self.mix["frames"])] * len(self.results)

    def sample(self, seed):
        if not self.results:
            return None
        rng = np.random.default_rng(int(seed) % (1 << 63))
        return [self.results[int(rng.integers(len(self.results)))]]

    def answers(self, sample):
        return [tuple(r[1:5]) for r in sample]

    def reference(self, params, sample, rq=ref.identity):
        with ref.reference_mode():
            return [tuple(t.cpu() for t in predict.offline_predict(
                params, self.cfg, self.videos[r[0]], self.mix["grid_size"], rq))
                for r in sample]

    def queries_px(self, sample):
        return sample[0][1][0]  # every query is at frame 0, where its track is snapped

    def release(self):
        self.pred = self.model = self.loop = None
