"""Real videos for pseudo-label distillation (port of
cotracker_tpu/datasets/real_videos.py).

The reference corpus was never released, so `RealDataset` raises;
`LocalVideoDataset` reads a directory of video files instead and yields
fixed-length clips: short videos loop-padded with their reverse, a random
frame rate of at most 4 and a random start, each frame resized to the crop.
Decoding needs OpenCV (cv2), which is imported when the dataset is made and
raises an ImportError naming it where it is missing.
"""

import os
from typing import Tuple

import numpy as np

from cotracker_tpu_torch.datasets.utils import CoTrackerData

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("LocalVideoDataset decodes video files with OpenCV (the cv2 module), "
                          "which is not installed") from e
    return cv2


class RealDataset:
    """The reference's web-video corpus, which was not released: raises."""

    def __init__(self, *a, **k):
        raise ValueError(
            "We cannot release this dataset. Use LocalVideoDataset with your "
            "own video files instead."
        )


class LocalVideoDataset:
    """Clips of `seq_len` frames at `crop_size` (H, W) from the video files
    in data_root (sorted, by extension). Item i is (CoTrackerData with a
    float32 (T, 3, H, W) video in [0, 255], True), or (None, False) where
    the file decodes to no frame. The frame rate and start are drawn from
    the dataset's own Generator (`seed`), in the JAX package's order, so
    its clips are the JAX reader's bit for bit."""

    def __init__(
        self,
        data_root: str,
        crop_size: Tuple[int, int] = (384, 512),
        seq_len: int = 64,
        random_frame_rate: bool = True,
        max_frame_rate: int = 4,
        seed: int = 0,
    ):
        self.cv2 = _cv2()
        self.data_root = data_root
        self.crop_size = crop_size
        self.seq_len = seq_len
        self.random_frame_rate = random_frame_rate
        self.max_frame_rate = max_frame_rate
        self.rng = np.random.default_rng(seed)
        self.paths = sorted(
            os.path.join(data_root, f)
            for f in os.listdir(data_root)
            if f.lower().endswith(VIDEO_EXTS)
        )

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index):
        cv2 = self.cv2
        cap = cv2.VideoCapture(self.paths[index])
        frames = []
        try:
            while True:
                ok, f = cap.read()
                if not ok:
                    break
                frames.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
        finally:
            cap.release()
        if not frames:
            return None, False

        video = np.stack(frames)
        while len(video) < self.seq_len:  # loop-pad with the reversed clip
            video = np.concatenate([video, video[::-1]], axis=0)

        frame_rate = 1
        if self.random_frame_rate:
            max_fr = max(1, min(self.max_frame_rate, len(video) // self.seq_len))
            frame_rate = int(self.rng.integers(1, max_fr + 1))
        max_start = len(video) - self.seq_len * frame_rate
        start = int(self.rng.integers(0, max_start + 1)) if max_start > 0 else 0
        video = video[start : start + self.seq_len * frame_rate : frame_rate]

        ch, cw = self.crop_size
        video = np.stack([cv2.resize(f, (cw, ch), interpolation=cv2.INTER_LINEAR) for f in video])
        return (
            CoTrackerData(
                video=video.transpose(0, 3, 1, 2).astype(np.float32),
                seq_name=os.path.basename(self.paths[index]),
            ),
            True,
        )
