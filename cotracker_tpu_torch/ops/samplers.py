"""Query-point samplers (port of cotracker_tpu/ops/samplers.py): regular
grids, uniform random points, SIFT and SuperPoint keypoints. All return
float32 CPU tensors."""

from typing import Optional, Tuple, Union

import numpy as np
import torch


def get_points_on_a_grid(
    size: int, extent: Tuple[float, ...], center: Optional[Tuple[float, ...]] = None
) -> torch.Tensor:
    """A size x size grid of (x, y) points covering extent = (H, W) with a
    margin of W/64 from the border, row-major. Returns (1, size*size, 2)
    float32 on the CPU."""
    if size == 1:
        return torch.tensor([[[extent[1] / 2, extent[0] / 2]]], dtype=torch.float32)
    if center is None:
        center = [extent[0] / 2, extent[1] / 2]
    margin = extent[1] / 64
    range_y = (margin - extent[0] / 2 + center[0], extent[0] / 2 + center[0] - margin)
    range_x = (margin - extent[1] / 2 + center[1], extent[1] / 2 + center[1] - margin)
    grid_y, grid_x = np.meshgrid(
        np.linspace(range_y[0], range_y[1], size),
        np.linspace(range_x[0], range_x[1], size),
        indexing="ij",
    )
    pts = np.stack([grid_x, grid_y], axis=-1).reshape(1, -1, 2)
    return torch.from_numpy(pts.astype(np.float32))


def get_uniformly_sampled_pts(
    size: int, num_frames: int, extent: Tuple[float, ...],
    rng: Union[np.random.Generator, torch.Generator, None] = None,
) -> torch.Tensor:
    """Random (t, x, y) queries: t uniform over the frames, (x, y) uniform
    over extent = (H, W). Returns (1, size, 3). With a numpy Generator (or
    none: a fresh one) the numbers are the JAX package's for the same
    generator; a torch.Generator draws the same distribution from torch."""
    wh = np.asarray([extent[1], extent[0]], np.float32)
    if isinstance(rng, torch.Generator):
        t = torch.randint(0, num_frames, (size, 1), generator=rng).float()
        xy = torch.rand((size, 2), generator=rng) * torch.from_numpy(wh)
        return torch.cat([t, xy], dim=1)[None]
    rng = rng or np.random.default_rng()
    t = rng.integers(0, num_frames, size=(size, 1)).astype(np.float32)
    xy = rng.random((size, 2)).astype(np.float32) * wh
    return torch.from_numpy(np.concatenate([t, xy], axis=1)[None])


def get_sift_sampled_pts(
    video,
    size: int,
    num_frames: int,
    extent: Tuple[float, ...],
    num_sampled_frames: int = 8,
    sampling_length_percent: float = 0.25,
    rng: Optional[np.random.Generator] = None,
) -> torch.Tensor:
    """SIFT keypoints as (t, x, y) queries from random frames among the first
    `sampling_length_percent` of the video; `video` (1, T, H, W, 3) in
    [0, 255] (numpy or torch). Returns (1, <= size, 3). Needs OpenCV: raises
    ImportError without it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "SIFT support points need OpenCV (the cv2 module), which is not installed; "
            "use grid or uniformly sampled support points instead") from e
    video = np.asarray(torch.as_tensor(video).cpu())
    rng = rng or np.random.default_rng()
    sift = cv2.SIFT_create(nfeatures=size // num_sampled_frames)
    points = []
    for _ in range(num_sampled_frames):
        frame_num = int(rng.integers(0, max(int(num_frames * sampling_length_percent), 1)))
        key_points, _ = sift.detectAndCompute(video[0, frame_num].astype(np.uint8), None)
        points += [[frame_num, int(kp.pt[0]), int(kp.pt[1])] for kp in key_points]
    if not points:
        return torch.zeros((1, 0, 3), dtype=torch.float32)
    return torch.from_numpy(np.asarray(points[:size], dtype=np.float32)[None])


def _superpoint_extractor(max_num_keypoints: int):
    """The `lightglue` package's SuperPoint as an extract_fn (a float32
    (H, W, 3) frame in [0, 1] -> (K, 2) xy numpy), on the CPU. lightglue
    reads its pretrained weights as it always does; this module fetches
    nothing. Raises ImportError naming lightglue where it is missing."""
    try:
        from lightglue import SuperPoint
    except ImportError as e:
        raise ImportError(
            "SuperPoint query sampling needs the `lightglue` package, which is not "
            "installed; pass extract_fn= (a frame -> (K, 2) xy detector) or sample SIFT "
            "queries") from e
    extractor = SuperPoint(max_num_keypoints=max_num_keypoints).eval()

    def extract_fn(frame):
        with torch.no_grad():
            t = torch.from_numpy(np.ascontiguousarray(frame)).permute(2, 0, 1).float()
            out = extractor.extract(t, resize=None)
        return out["keypoints"][0].cpu().numpy()

    return extract_fn


def get_superpoint_sampled_pts(
    video,
    size: int,
    num_frames: int,
    extent: Tuple[float, ...],
    num_sampled_frames: int = 8,
    sampling_length_percent: float = 0.25,
    max_num_keypoints: int = 48,
    rng: Optional[np.random.Generator] = None,
    extract_fn=None,
) -> torch.Tensor:
    """SuperPoint keypoints as (t, x, y) queries: at most max_num_keypoints
    from each of num_sampled_frames random frames among the first
    `sampling_length_percent` of the video, concatenated and truncated to
    `size`; `video` (1, T, H, W, 3) in [0, 255] (numpy or torch). Returns
    (1, <= size, 3); the frame draws are the JAX package's for the same
    Generator. extract_fn: a (H, W, 3) float32 frame in [0, 1] -> (K, 2)
    xy detector; None builds lightglue's SuperPoint (ImportError without
    it)."""
    rng = rng or np.random.default_rng()
    if extract_fn is None:
        extract_fn = _superpoint_extractor(max_num_keypoints)
    video = np.asarray(torch.as_tensor(video).cpu())
    points = []
    for _ in range(num_sampled_frames):
        frame_num = int(rng.integers(0, max(int(num_frames * sampling_length_percent), 1)))
        frame = np.asarray(video[0, frame_num], np.float32) / 255.0
        kps = np.asarray(extract_fn(frame), np.float32)[:max_num_keypoints]
        points += [[frame_num, xy[0], xy[1]] for xy in kps]
    if not points:
        return torch.zeros((1, 0, 3), dtype=torch.float32)
    return torch.from_numpy(np.asarray(points[:size], dtype=np.float32)[None])
