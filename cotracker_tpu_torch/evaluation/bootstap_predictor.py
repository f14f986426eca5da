"""The TAPIR / BootsTAPIR distillation teacher's wrapper (port of
cotracker_tpu/evaluation/bootstap_predictor.py).

The wrapper converts between the port's conventions and TAPIR's: frames
resized to 256x256 and scaled to [-1, 1], queries from (t, x, y) to
(t, y, x) with a plain-ratio rescale, visibility from the occlusion and
expected-distance logits, tracks scaled back to the input resolution.
TAPIR itself is the external `tapnet` package's JAX model, which the port
does not import: the model comes in as `model_fn`, and without one the
constructor raises an ImportError.
"""

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from cotracker_tpu_torch.ops.bilinear import resize_bilinear


def postprocess_occlusions(occlusions, expected_dist):
    """visible = (1 - sigmoid(occ)) * (1 - sigmoid(expd)) > 0.5; both inputs
    are logits of one shape (numpy)."""
    sig = lambda x: 1.0 / (1.0 + np.exp(-x))  # noqa: E731
    return (1.0 - sig(occlusions)) * (1.0 - sig(expected_dist)) > 0.5


class TAPIRPredictor:
    """Callable (video (1, T, 3, H, W) in [0, 255], numpy or tensor;
    queries (1, N, 3) (t, x, y)) -> (tracks (1, T, N, 2) at the input
    resolution, visibility (1, T, N) in {0, 1} float32), as numpy.

    model_fn: (frames (1, T, rh, rw, 3) float32 in [-1, 1], query_points
    (1, N, 3) (t, y, x) in model pixels), both numpy -> a dict of "tracks"
    (1, N, T, 2) (x, y in model pixels), "occlusion" and "expected_dist"
    (1, N, T) logits: the tapnet TAPIR output contract."""

    def __init__(
        self,
        checkpoint: Optional[str] = None,
        resolution: Tuple[int, int] = (256, 256),
        model_fn: Optional[Callable] = None,
    ):
        if model_fn is None:
            raise ImportError(
                "TAPIRPredictor needs model_fn: TAPIR is the external `tapnet` package's JAX "
                "model, which the PyTorch port does not import; pass a TAPIR model "
                f"(checkpoint {checkpoint!r} loaded by its own code) as model_fn")
        self.resolution = resolution
        self._model_fn = model_fn

    def __call__(self, video, queries):
        B, T, C, H, W = video.shape
        assert B == 1
        rh, rw = self.resolution
        frames = torch.as_tensor(video)[0].permute(0, 2, 3, 1).to(torch.float32)
        frames = resize_bilinear(frames, (rh, rw), align_corners=False)
        frames = (frames / 255.0) * 2.0 - 1.0  # TAPIR's input range

        # (t, x, y) -> TAPIR's (t, y, x), each axis scaled by the plain ratio
        q = np.array(torch.as_tensor(queries).cpu()[0], np.float32, copy=True)
        qt = np.stack([q[:, 0], q[:, 2] * rh / H, q[:, 1] * rw / W], axis=-1)

        out = self._model_fn(frames.cpu().numpy()[None], qt[None])
        tracks = np.asarray(out["tracks"])[0].transpose(1, 0, 2)  # (T, N, 2) x, y
        occ = np.asarray(out["occlusion"])[0].T  # (T, N)
        expd = np.asarray(out["expected_dist"])[0].T
        vis = postprocess_occlusions(occ, expd).astype(np.float32)
        tracks = tracks * np.array([W / rw, H / rh], np.float32)  # back to the input's pixels
        return tracks[None], vis[None]
