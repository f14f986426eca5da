"""Dynamic Replica evaluation dataset (port of
cotracker_tpu/datasets/dynamic_replica.py; the reference's
DynamicReplicaDataset).

`{root}/{split}/frame_annotations_{split}.jgz` holds the frame records
(`datasets/annotations.py`); each record's `trajectories["path"]` is a
per-frame `.pth` with `img` (H, W, 3), `traj_2d` (N, >= 2) and
`verts_inds_vis` (N,). The left camera's frames are grouped per sequence
and cut into samples of `sample_len` frames. A sample keeps
`traj_per_sample` tracks drawn by `np.random.default_rng(seed)` (the JAX
package's draw, so both pick the same tracks), optionally centre-cropped;
points outside the frame are marked invisible, and tracks visible in 10
frames or fewer are dropped. Samples are numpy `CoTrackerData`.
"""

import os
from collections import defaultdict
from typing import Optional, Tuple

import numpy as np
import torch

from cotracker_tpu_torch.datasets.annotations import load_frame_annotations
from cotracker_tpu_torch.datasets.utils import CoTrackerData


class DynamicReplicaDataset:
    def __init__(
        self,
        root: str,
        split: str = "valid",
        traj_per_sample: int = 256,
        crop_size: Optional[Tuple[int, int]] = None,
        sample_len: int = -1,
        only_first_n_samples: int = -1,
        seed: int = 0,
    ):
        self.root = root
        self.split = split
        self.traj_per_sample = traj_per_sample
        self.crop_size = crop_size
        self.rng = np.random.default_rng(seed)

        path = os.path.join(root, split, f"frame_annotations_{split}.jgz")
        seq_annot = defaultdict(list)
        for fa in load_frame_annotations(path):
            if fa.camera_name == "left":
                seq_annot[fa.sequence_name].append(fa)

        self.sample_list = []
        for frames in seq_annot.values():
            step = sample_len if sample_len > 0 else len(frames)
            for count, ref in enumerate(range(0, len(frames), step), start=1):
                self.sample_list.append(frames[ref : ref + step])
                if only_first_n_samples > 0 and count >= only_first_n_samples:
                    break

    def __len__(self):
        return len(self.sample_list)

    def __getitem__(self, index) -> CoTrackerData:
        sample = self.sample_list[index]
        T = len(sample)
        H, W = sample[0].image.size
        rgbs, visibility, traj_2d = [], [], []
        for fa in sample:
            path = os.path.join(self.root, self.split, fa.trajectories["path"])
            traj = torch.load(path, map_location="cpu", weights_only=True)
            visibility.append(traj["verts_inds_vis"].numpy())
            rgbs.append(traj["img"].numpy())
            traj_2d.append(traj["traj_2d"].numpy()[..., :2])
        traj_2d, visibility = np.stack(traj_2d), np.stack(visibility)

        keep = self.rng.permutation(traj_2d.shape[1])[: self.traj_per_sample]
        traj_2d, visibility = traj_2d[:, keep], visibility[:, keep]

        if self.crop_size is not None:
            ch, cw = self.crop_size
            y0 = 0 if ch >= H else (H - ch) // 2
            x0 = 0 if cw >= W else (W - cw) // 2
            rgbs = [r[y0 : y0 + ch, x0 : x0 + cw] for r in rgbs]
            traj_2d[:, :, 0] -= x0
            traj_2d[:, :, 1] -= y0
            H, W = rgbs[0].shape[:2]

        x, y = traj_2d[:, :, 0], traj_2d[:, :, 1]
        visibility[(x > W - 1) | (x < 0) | (y > H - 1) | (y < 0)] = False

        seen = visibility.sum(0) > 10
        traj_2d, visibility = traj_2d[:, seen], visibility[:, seen]

        video = np.stack(rgbs).reshape(T, H, W, 3).transpose(0, 3, 1, 2).astype(np.float32)
        return CoTrackerData(
            video=video,
            trajectory=traj_2d.astype(np.float32),
            visibility=visibility,
            valid=np.ones((T, traj_2d.shape[1]), np.float32),
            seq_name=sample[0].sequence_name,
        )
