"""TAP-Vid evaluation datasets: DAVIS, Kinetics, RoboTAP and RGB-Stacking
(port of cotracker_tpu/datasets/tap_vid.py, the same on-disk formats):

  * davis / stacking: one pickle (a dict of videos / a list of videos);
  * kinetics: sharded `*_of_0010.pkl` pickles of list entries;
  * robotap: `robotap_split*.pkl` dict shards.

Videos resize to 256x256 (the TAP-Vid metric raster) with coordinates
scaled so x = 1 maps to 255. The resize is PyTorch's bilinear interpolation
(half-pixel centres, no antialiasing) rounded to uint8: the sampling of
OpenCV's INTER_LINEAR, within one code of it (OpenCV's fixed-point weights),
with no OpenCV needed. Videos stored as JPEG bytes (Kinetics) decode with
PIL, imported when such a video is read. Queries: 'first' (each track's
first visible frame) or 'strided' (every 5 frames where visible).
"""

import glob
import io
import os
import pickle
import random
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cotracker_tpu_torch.datasets.utils import CoTrackerData


def _decode_frames(frames):
    if isinstance(frames[0], bytes):
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError("this TAP-Vid split stores JPEG frames, which need PIL "
                              "(the Pillow package) to decode") from e
        return np.stack([np.array(Image.open(io.BytesIO(b))) for b in frames])
    return np.asarray(frames)


def resize_video(video: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """(T, H, W, 3) uint8 -> (T, H', W', 3) uint8, bilinear (see above)."""
    x = torch.from_numpy(np.ascontiguousarray(video)).permute(0, 3, 1, 2).float()
    y = F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False,
                      antialias=False)
    return y.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).numpy()


def sample_queries_first(occluded: np.ndarray, points: np.ndarray, frames: np.ndarray):
    """Queries at each track's first visible frame; tracks never visible are
    dropped. occluded (N, T) bool; points (N, T, 2) in raster pixels."""
    valid = np.sum(~occluded, axis=1) > 0
    points = points[valid]
    occluded = occluded[valid]
    first = np.argmax(~occluded, axis=1)
    xy = points[np.arange(points.shape[0]), first]  # (N, 2) as (x, y)
    return {
        "video": frames[None],
        "query_points": np.stack([first, xy[:, 1], xy[:, 0]], axis=-1)[None],  # (t, y, x)
        "target_points": points[None],
        "occluded": occluded[None],
    }


def sample_queries_strided(occluded: np.ndarray, points: np.ndarray, frames: np.ndarray,
                           query_stride: int = 5):
    """One query per (track, visible frame at a multiple of query_stride);
    tracks repeat per query, with the index of the track each came from."""
    queries, tracks, occs, groups = [], [], [], []
    trackgroup = np.arange(occluded.shape[0])
    for i in range(0, occluded.shape[1], query_stride):
        mask = occluded[:, i] == 0
        query = np.stack(
            [i * np.ones(occluded.shape[0]), points[:, i, 1], points[:, i, 0]], axis=-1)
        queries.append(query[mask])
        tracks.append(points[mask])
        occs.append(occluded[mask])
        groups.append(trackgroup[mask])
    return {
        "video": frames[None],
        "query_points": np.concatenate(queries, axis=0)[None],
        "target_points": np.concatenate(tracks, axis=0)[None],
        "occluded": np.concatenate(occs, axis=0)[None],
        "trackgroup": np.concatenate(groups, axis=0)[None],
    }


class TapVidDataset:
    def __init__(
        self,
        data_root: str,
        dataset_type: str = "davis",
        resize_to: Optional[Tuple[int, int]] = (256, 256),
        queried_first: bool = True,
        fast_eval: bool = False,
    ):
        """fast_eval: a 50-video subset drawn with random.Random(42) from the
        sorted shards (kinetics) or the sorted keys (robotap), as the JAX
        package draws it."""
        rng = random.Random(42)
        self.dataset_type = dataset_type
        self.resize_to = resize_to
        self.queried_first = queried_first
        if dataset_type == "kinetics":
            entries = []
            for p in sorted(glob.glob(os.path.join(data_root, "*_of_0010.pkl"))):
                with open(p, "rb") as f:
                    entries += pickle.load(f)
            if fast_eval:
                entries = rng.sample(entries, min(50, len(entries)))
            self.points_dataset = entries
            self.video_names = list(range(len(entries)))
        elif dataset_type == "robotap":
            data = {}
            for p in sorted(glob.glob(os.path.join(data_root, "robotap_split*.pkl"))):
                with open(p, "rb") as f:
                    data.update(pickle.load(f))
            if fast_eval:
                keys = rng.sample(sorted(data.keys()), min(50, len(data)))
                data = {k: data[k] for k in keys}
            self.points_dataset = data
            self.video_names = list(data.keys())
        else:
            with open(data_root, "rb") as f:
                self.points_dataset = pickle.load(f)
            if dataset_type == "davis":
                self.video_names = list(self.points_dataset.keys())
            else:  # stacking
                self.video_names = list(range(len(self.points_dataset)))

    def __len__(self):
        return len(self.video_names)

    def __getitem__(self, index) -> CoTrackerData:
        name = self.video_names[index]
        entry = self.points_dataset[name]
        frames = _decode_frames(entry["video"])
        points = np.array(entry["points"], dtype=np.float64, copy=True)
        if self.resize_to is not None:
            frames = resize_video(frames, self.resize_to)
            points = points * np.array([self.resize_to[1] - 1, self.resize_to[0] - 1])
        else:
            points = points * np.array([frames.shape[2] - 1, frames.shape[1] - 1])
        occluded = np.asarray(entry["occluded"], bool)
        sample = sample_queries_first if self.queried_first else sample_queries_strided
        conv = sample(occluded, points, frames)
        return CoTrackerData(
            video=frames.transpose(0, 3, 1, 2).astype(np.float32),
            trajectory=conv["target_points"][0].transpose(1, 0, 2).astype(np.float32),
            visibility=~conv["occluded"][0].T,
            seq_name=str(name),
            query_points=conv["query_points"][0].astype(np.float32),
        )
