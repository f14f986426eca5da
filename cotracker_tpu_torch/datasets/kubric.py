"""Kubric MOVi-f supervised training data (port of
cotracker_tpu/datasets/kubric.py), with no OpenCV: PNG frames decode with
`datasets.png` and the augmentations' HSV conversion, Gaussian blur and
resize are `datasets.image_ops`, OpenCV's codes.

The colour jitter's HSV -> RGB is OpenCV's vector loop
(`hsv_to_rgb(..., truncate=True)`), which cv2.cvtColor runs on every pixel
of a row whose width is a multiple of 64, as MOVi-f's 512 is.

A tree holds one folder a sequence, `<seq>/frames/*.png` and
`<seq>/<seq>.npy`, a pickled dict of "coords" (N, T, 2) pixels and
"visibility" (N, T), which holds occlusion flags. A read draws the clip's
length, frame rate and track count, crops (or augments: eraser, replace,
colour jitter and blur; padding, a drifting scale and crop, flips), clears
the visibility outside the crop, drops runaway tracks and samples
`traj_per_sample` tracks visible at the first, middle (and optionally last)
frame; too few leave the sample failed (`gotit` False) and zeroed.

Every random draw is the JAX reader's, in its order, from one numpy
Generator: `__getitem__` draws from the dataset's own (`seed`), as JAX
does; `get(index, rng)`, the training loader's interface, from the caller's.
From the same Generator state both read the JAX reader's sample. Two
differences, neither visible in a sample JAX returns:
  * only the frames the clip keeps are decoded (the JAX reader decodes the
    whole sequence first), which draws nothing;
  * a frame-rate draw that leaves fewer frames than the middle (or last)
    frame it samples from fails the sample, before any frame is read:
    there the JAX reader raises an IndexError. On 24-frame MOVi-f
    sequences with random_frame_rate (the online trainer's default) most
    draws do.
"""

import os
from typing import Tuple

import numpy as np

from cotracker_tpu_torch.datasets.image_ops import (
    gaussian_blur_u8, resize_linear, rgb_to_hsv_u8,
)
from cotracker_tpu_torch.datasets.png import read_pngs
from cotracker_tpu_torch.datasets.utils import CoTrackerData
from cotracker_tpu_torch.training.data_loader import Sample
from cotracker_tpu_torch.utils.visualizer import hsv_to_rgb


def _color_jitter(rng, img, brightness=0.2, contrast=0.2, saturation=0.2, hue=0.25 / 3.14):
    """Brightness, contrast, saturation and hue jitter of a uint8 HWC image,
    in the JAX reader's float32 arithmetic and truncations."""
    out = img.astype(np.float32)
    out = out * rng.uniform(1 - brightness, 1 + brightness)
    mean = out.mean()
    out = (out - mean) * rng.uniform(1 - contrast, 1 + contrast) + mean
    out = np.clip(out, 0, 255).astype(np.uint8)
    hsv = rgb_to_hsv_u8(out).astype(np.float32)
    hsv[..., 1] *= rng.uniform(1 - saturation, 1 + saturation)
    hsv[..., 0] = (hsv[..., 0] + rng.uniform(-hue, hue) * 180.0) % 180.0
    hsv[..., 1] = np.clip(hsv[..., 1], 0, 255)
    return hsv_to_rgb(hsv.astype(np.uint8), truncate=True)


def _gaussian_blur(rng, img, ksize=11, sigma=(0.1, 2.0)):
    return gaussian_blur_u8(img, ksize, rng.uniform(*sigma))


def _box(rng, W, H, bounds):
    """A box of random centre and size, clipped to the image: x0, x1, y0, y1."""
    xc, yc = rng.integers(0, W), rng.integers(0, H)
    dx = rng.integers(*bounds)
    dy = rng.integers(*bounds)
    x0 = int(np.clip(xc - dx / 2, 0, W - 1).round())
    x1 = int(np.clip(xc + dx / 2, 0, W - 1).round())
    y0 = int(np.clip(yc - dy / 2, 0, H - 1).round())
    y1 = int(np.clip(yc + dy / 2, 0, H - 1).round())
    return x0, x1, y0, y1


def _occlude(trajs, visibles, i, x0, x1, y0, y1):
    """Frame i's tracks inside the box become invisible."""
    occ = ((trajs[i, :, 0] >= x0) & (trajs[i, :, 0] < x1)
           & (trajs[i, :, 1] >= y0) & (trajs[i, :, 1] < y1))
    visibles[i, occ] = 0


class CoTrackerDataset:
    """The augmentation pipeline (JAX kubric.py:49-248). Every method that
    draws takes the Generator to draw from."""

    # a read is thousands of numpy calls (PNG decoding, augmentations): the
    # training loader runs it in a process of each worker's own
    read_in_processes = True

    def __init__(
        self,
        data_root: str,
        crop_size: Tuple[int, int] = (384, 512),
        seq_len: int = 24,
        traj_per_sample: int = 768,
        sample_vis_last_frame: bool = False,
        use_augs: bool = False,
        seed: int = 0,
    ):
        self.data_root = data_root
        self.crop_size = crop_size
        self.seq_len = seq_len
        self.traj_per_sample = traj_per_sample
        self.sample_vis_last_frame = sample_vis_last_frame
        self.use_augs = use_augs
        self.rng = np.random.default_rng(seed)

        self.blur_aug_prob = 0.25
        self.color_aug_prob = 0.25
        self.eraser_aug_prob = 0.5
        self.eraser_bounds = [2, 100]
        self.eraser_max = 10
        self.replace_aug_prob = 0.5
        self.replace_bounds = [2, 100]
        self.replace_max = 10
        self.pad_bounds = [0, 100]
        self.resize_lim = [0.25, 2.0]
        self.resize_delta = 0.2
        self.max_crop_offset = 50
        self.do_flip = True
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.5

    def _zeros(self):
        return CoTrackerData(
            video=np.zeros((self.seq_len, 3, *self.crop_size), np.float32),
            trajectory=np.zeros((self.seq_len, self.traj_per_sample, 2), np.float32),
            visibility=np.zeros((self.seq_len, self.traj_per_sample), np.float32),
            valid=np.zeros((self.seq_len, self.traj_per_sample), np.float32),
        )

    def __getitem__(self, index):
        """(CoTrackerData, gotit), drawn from the dataset's own Generator; a
        failed sample is zeroed at seq_len frames."""
        sample, gotit = self.getitem_helper(index, self.rng)
        return (sample if gotit else self._zeros()), gotit

    def get(self, index, rng):
        """(training_loader.Sample, ok), drawn from `rng` (the training
        loader's interface)."""
        sample, ok = self.getitem_helper(index, rng)
        if not ok:
            sample = self._zeros()
        return Sample(sample.video, sample.trajectory, sample.visibility, sample.valid), ok

    # ------------------------------------------------------------ photometric

    def add_photometric_augs(self, rng, rgbs, trajs, visibles, eraser=True, replace=True):
        """rgbs: a list of (H, W, 3) uint8 frames; trajs (S, N, 2) and
        visibles (S, N) are updated in place where boxes hide tracks."""
        S = len(rgbs)
        H, W = rgbs[0].shape[:2]

        if eraser:
            rgbs = [r.astype(np.float32) for r in rgbs]
            for i in range(1, S):
                if rng.random() < self.eraser_aug_prob:
                    for _ in range(rng.integers(1, self.eraser_max + 1)):
                        x0, x1, y0, y1 = _box(rng, W, H, self.eraser_bounds)
                        if x1 <= x0 or y1 <= y0:
                            continue
                        rgbs[i][y0:y1, x0:x1] = rgbs[i][y0:y1, x0:x1].reshape(-1, 3).mean(0)
                        _occlude(trajs, visibles, i, x0, x1, y0, y1)
            rgbs = [r.astype(np.uint8) for r in rgbs]

        if replace:
            rgbs_alt = [_color_jitter(rng, _color_jitter(rng, r)) for r in rgbs]
            rgbs = [r.astype(np.float32) for r in rgbs]
            for i in range(1, S):
                if rng.random() < self.replace_aug_prob:
                    for _ in range(rng.integers(1, self.replace_max + 1)):
                        x0, x1, y0, y1 = _box(rng, W, H, self.replace_bounds)
                        wid, hei = x1 - x0, y1 - y0
                        if wid <= 0 or hei <= 0 or H - hei <= 0 or W - wid <= 0:
                            continue
                        y00 = rng.integers(0, H - hei)
                        x00 = rng.integers(0, W - wid)
                        fr = rng.integers(0, S)
                        rgbs[i][y0:y1, x0:x1] = rgbs_alt[fr][y00 : y00 + hei, x00 : x00 + wid]
                        _occlude(trajs, visibles, i, x0, x1, y0, y1)
            rgbs = [r.astype(np.uint8) for r in rgbs]

        if rng.random() < self.color_aug_prob:
            rgbs = [_color_jitter(rng, r) for r in rgbs]
        if rng.random() < self.blur_aug_prob:
            rgbs = [_gaussian_blur(rng, r) for r in rgbs]
        return rgbs, trajs, visibles

    # ---------------------------------------------------------------- spatial

    def add_spatial_augs(self, rng, rgbs, trajs, visibles, crop_size):
        """Padding, a drifting scale and stretch, a drifting crop around the
        tracks visible at frame 0, and flips. Returns (S, h, w, 3) float32
        frames and the tracks (updated in place)."""
        S = len(rgbs)
        rgbs = [r.astype(np.float32) for r in rgbs]

        pad_x0, pad_x1 = rng.integers(*self.pad_bounds), rng.integers(*self.pad_bounds)
        pad_y0, pad_y1 = rng.integers(*self.pad_bounds), rng.integers(*self.pad_bounds)
        rgbs = [np.pad(r, ((pad_y0, pad_y1), (pad_x0, pad_x1), (0, 0))) for r in rgbs]
        trajs[:, :, 0] += pad_x0
        trajs[:, :, 1] += pad_y0
        H, W = rgbs[0].shape[:2]

        scale = rng.uniform(*self.resize_lim)
        scale_x = scale_y = scale
        dx = dy = 0.0
        scaled = []
        for s in range(S):
            if s == 1:
                dx = rng.uniform(-self.resize_delta, self.resize_delta)
                dy = rng.uniform(-self.resize_delta, self.resize_delta)
            elif s > 1:
                dx = dx * 0.8 + rng.uniform(-self.resize_delta, self.resize_delta) * 0.2
                dy = dy * 0.8 + rng.uniform(-self.resize_delta, self.resize_delta) * 0.2
            scale_x += dx
            scale_y += dy
            mid = (scale_x + scale_y) * 0.5
            scale_x = scale_x * 0.5 + mid * 0.5
            scale_y = scale_y * 0.5 + mid * 0.5
            scale_x = float(np.clip(scale_x, 0.2, 2.0))
            scale_y = float(np.clip(scale_y, 0.2, 2.0))
            H_new = max(int(H * scale_y), crop_size[0] + 10)
            W_new = max(int(W * scale_x), crop_size[1] + 10)
            sx = (W_new - 1) / float(W - 1)
            sy = (H_new - 1) / float(H - 1)
            scaled.append(resize_linear(rgbs[s], (H_new, W_new)))
            trajs[s, :, 0] *= sx
            trajs[s, :, 1] *= sy
        rgbs = scaled

        ok = visibles[0] > 0
        if ok.sum() > 0:
            mid_x = float(np.mean(trajs[0, ok, 0]))
            mid_y = float(np.mean(trajs[0, ok, 1]))
        else:
            mid_y, mid_x = crop_size
        x0 = int(mid_x - crop_size[1] // 2)
        y0 = int(mid_y - crop_size[0] // 2)
        off_x = off_y = 0
        for s in range(S):
            if s == 1:
                off_x = int(rng.integers(-self.max_crop_offset, self.max_crop_offset))
                off_y = int(rng.integers(-self.max_crop_offset, self.max_crop_offset))
            elif s > 1:
                off_x = int(off_x * 0.8 + rng.integers(-self.max_crop_offset,
                                                       self.max_crop_offset + 1) * 0.2)
                off_y = int(off_y * 0.8 + rng.integers(-self.max_crop_offset,
                                                       self.max_crop_offset + 1) * 0.2)
            x0 += off_x
            y0 += off_y
            H_new, W_new = rgbs[s].shape[:2]
            y0 = 0 if H_new == crop_size[0] else min(max(0, y0), H_new - crop_size[0] - 1)
            x0 = 0 if W_new == crop_size[1] else min(max(0, x0), W_new - crop_size[1] - 1)
            rgbs[s] = rgbs[s][y0 : y0 + crop_size[0], x0 : x0 + crop_size[1]]
            trajs[s, :, 0] -= x0
            trajs[s, :, 1] -= y0

        H_new, W_new = crop_size
        if self.do_flip:
            if rng.random() < self.h_flip_prob:
                rgbs = [r[:, ::-1] for r in rgbs]
                trajs[:, :, 0] = W_new - trajs[:, :, 0]
            if rng.random() < self.v_flip_prob:
                rgbs = [r[::-1] for r in rgbs]
                trajs[:, :, 1] = H_new - trajs[:, :, 1]
        return np.stack(rgbs), trajs

    def crop(self, rng, rgbs, trajs, crop_size):
        """A centred crop in height and a random one in width."""
        H, W = rgbs[0].shape[:2]
        y0 = 0 if crop_size[0] >= H else (H - crop_size[0]) // 2
        x0 = 0 if crop_size[1] >= W else int(rng.integers(0, W - crop_size[1]))
        rgbs = [r[y0 : y0 + crop_size[0], x0 : x0 + crop_size[1]] for r in rgbs]
        trajs[:, :, 0] -= x0
        trajs[:, :, 1] -= y0
        return np.stack(rgbs), trajs


class KubricMovifDataset(CoTrackerDataset):
    def __init__(
        self,
        data_root: str,
        crop_size: Tuple[int, int] = (384, 512),
        seq_len: int = 24,
        traj_per_sample: int = 768,
        sample_vis_last_frame: bool = False,
        use_augs: bool = False,
        random_seq_len: bool = False,
        random_frame_rate: bool = False,
        random_number_traj: bool = False,
        split: str = "train",
        seed: int = 0,
    ):
        super().__init__(
            data_root, crop_size, seq_len, traj_per_sample, sample_vis_last_frame, use_augs, seed
        )
        self.random_seq_len = random_seq_len
        self.random_frame_rate = random_frame_rate
        self.random_number_traj = random_number_traj
        # Kubric's gentler spatial ranges (JAX kubric.py:272-276)
        self.pad_bounds = [0, 25]
        self.resize_lim = [0.75, 1.25]
        self.resize_delta = 0.05
        self.max_crop_offset = 15
        self.split = split

        self.seq_names = sorted(
            f for f in os.listdir(data_root) if os.path.isdir(os.path.join(data_root, f))
        )
        if split == "valid":
            self.seq_names = self.seq_names[:30]
            if use_augs:
                raise ValueError("the valid split is read without augmentations (use_augs=False)")

    def __len__(self):
        return len(self.seq_names)

    def _schedule(self, rng):
        """(seq_len, frame_rate, final_num_traj) of one read (JAX
        kubric.py:309-327)."""
        frame_rate = 1
        final_num_traj = self.traj_per_sample
        if self.random_seq_len and self.random_number_traj:
            final_num_traj = int(rng.integers(1, self.traj_per_sample))
            alpha = final_num_traj / float(self.traj_per_sample)
            seq_len = int(alpha * 10 + (1 - alpha) * self.seq_len)
            seq_len = int(rng.integers(seq_len - 2, seq_len + 2))
        elif self.random_number_traj:
            final_num_traj = int(rng.integers(1, self.traj_per_sample))
            alpha = final_num_traj / float(self.traj_per_sample)
            seq_len = 8 * int(alpha * 2 + (1 - alpha) * self.seq_len // 8)
        elif self.random_seq_len:
            seq_len = int(rng.integers(self.seq_len // 2, self.seq_len))
        else:
            seq_len = self.seq_len
        if self.random_frame_rate:
            frame_rate = int(rng.integers(1, int(120 / seq_len) + 1))
        return seq_len, frame_rate, final_num_traj

    def getitem_helper(self, index, rng):
        """(CoTrackerData, gotit) of sequence `index`, drawn from `rng`."""
        gotit = True
        seq_name = self.seq_names[index]
        npy_path = os.path.join(self.data_root, seq_name, seq_name + ".npy")
        rgb_path = os.path.join(self.data_root, seq_name, "frames")
        frames = sorted(os.listdir(rgb_path))

        annot = np.load(npy_path, allow_pickle=True).item()
        traj_2d = np.transpose(annot["coords"], (1, 0, 2)).astype(np.float64)
        visibility = np.transpose(~np.asarray(annot["visibility"], bool), (1, 0))

        seq_len, frame_rate, final_num_traj = self._schedule(rng)
        keep = np.arange(len(frames))
        if seq_len < len(frames):
            if seq_len * frame_rate < len(frames):
                start = int(rng.integers(0, len(frames) - seq_len * frame_rate))
            else:
                start = 0
            keep = keep[start : start + seq_len * frame_rate : frame_rate]
            traj_2d, visibility = traj_2d[keep], visibility[keep]
        sampled = [seq_len // 2] + ([seq_len - 1] if self.sample_vis_last_frame else [])
        if not all(-len(keep) <= t < len(keep) for t in sampled):
            return self._zeros(), False  # the JAX reader raises an IndexError here
        rgbs = read_pngs([os.path.join(rgb_path, frames[i]) for i in keep])

        if self.use_augs:
            rgbs, traj_2d, visibility = self.add_photometric_augs(
                rng, rgbs, traj_2d, visibility, replace=False
            )
            rgbs, traj_2d = self.add_spatial_augs(rng, rgbs, traj_2d, visibility, self.crop_size)
        else:
            rgbs, traj_2d = self.crop(rng, rgbs, traj_2d, self.crop_size)

        ch, cw = self.crop_size
        visibility[traj_2d[:, :, 0] > cw - 1] = False
        visibility[traj_2d[:, :, 0] < 0] = False
        visibility[traj_2d[:, :, 1] > ch - 1] = False
        visibility[traj_2d[:, :, 1] < 0] = False

        # runaway tracks (JAX kubric.py:355-358)
        center = np.array([cw, ch]) / 2.0
        close = np.all(np.linalg.norm(traj_2d - center, axis=-1) < 1000.0, axis=0)
        traj_2d = traj_2d[:, close]
        visibility = visibility[:, close]

        cand = np.concatenate(
            [np.nonzero(visibility[0])[0], np.nonzero(visibility[seq_len // 2])[0]]
        )
        if self.sample_vis_last_frame:
            cand = np.concatenate([cand, np.nonzero(visibility[seq_len - 1])[0]])
        perm = rng.permutation(len(cand))[: self.traj_per_sample]
        if len(perm) < self.traj_per_sample:
            gotit = False
        chosen = cand[perm]

        trajs = traj_2d[:, chosen].astype(np.float32)[:, :final_num_traj]
        visibles = visibility[:, chosen].astype(np.float32)[:, :final_num_traj]
        valids = np.ones_like(visibles)

        sample = CoTrackerData(
            video=rgbs.transpose(0, 3, 1, 2).astype(np.float32),
            trajectory=trajs,
            visibility=visibles,
            valid=valids,
            seq_name=seq_name,
        )
        return sample, gotit
