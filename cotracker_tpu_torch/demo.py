"""Offline tracking demo (port of the JAX package's demo.py): track a grid,
or a grid inside a segmentation mask, through a video and draw the tracks.

    python -m cotracker_tpu_torch.demo --video_path clip.npy --grid_size 10 \\
        [--checkpoint scaled_offline.pth] [--mask_path mask.npy] \\
        [--backward_tracking] [--grid_query_frame 0] [--device cuda]

A video ending in `.npy` is a (T, H, W, 3) uint8 array and a mask ending in
`.npy` an (H, W) array, nonzero where points are kept; other files are
decoded with OpenCV (a mask image is kept where it is brighter than 127).
The rendered video is written as an mp4, which needs OpenCV: where cv2 is
missing the demo raises after tracking. `track_video` returns the tracks
and the rendered frames without writing anything.
"""

import argparse
import os

import numpy as np


def read_video(path, max_frames=None):
    """(T, H, W, 3) uint8 RGB from a .npy array or, through OpenCV, a video
    file; at most `max_frames` frames."""
    if path.endswith(".npy"):
        video = np.load(path)
    else:
        from cotracker_tpu_torch.utils.visualizer import read_video_from_path

        video = read_video_from_path(path)
        if video is None:
            raise ValueError(f"no frame could be decoded from {path}")
    return np.asarray(video[:max_frames] if max_frames else video, np.uint8)


def read_mask(path):
    """(H, W) float32 mask, 1 where points are kept: a .npy array's nonzero
    entries, or an image's pixels brighter than 127 (OpenCV)."""
    if path.endswith(".npy"):
        return (np.load(path) != 0).astype(np.float32)
    from cotracker_tpu_torch.utils.visualizer import import_cv2

    cv2 = import_cv2("reading a mask image")
    m = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if m is None:
        raise ValueError(f"cannot read the mask image {path}")
    return (m > 127).astype(np.float32)


def track_video(video, predictor=None, checkpoint=None, grid_size=10, grid_query_frame=0,
                backward_tracking=False, segm_mask=None, device="cuda"):
    """video (T, H, W, 3) uint8; segm_mask (H, W) or None. Runs
    `predictor` (default: CoTrackerPredictor(checkpoint, device=device))
    and draws its tracks. Returns tracks (1, T, N, 2), visibility
    (1, T, N) and the rendered frames (T', H', W', 3) uint8."""
    from cotracker_tpu_torch.predictor import CoTrackerPredictor
    from cotracker_tpu_torch.utils.visualizer import Visualizer

    if predictor is None:
        predictor = CoTrackerPredictor(checkpoint=checkpoint, device=device)
    video_b = video.transpose(0, 3, 1, 2)[None].astype(np.float32)
    tracks, visibility = predictor(
        video_b, grid_size=grid_size,
        segm_mask=None if segm_mask is None else segm_mask[None, None],
        grid_query_frame=grid_query_frame, backward_tracking=backward_tracking)
    frames = Visualizer(pad_value=120, linewidth=3).visualize(
        video_b, tracks, visibility, query_frame=grid_query_frame, save_video=False)
    return tracks, visibility, frames


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--video_path", required=True)
    p.add_argument("--mask_path", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--grid_size", type=int, default=10)
    p.add_argument("--grid_query_frame", type=int, default=0)
    p.add_argument("--backward_tracking", action="store_true")
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--save_dir", default="./saved_videos")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from cotracker_tpu_torch.utils.visualizer import Visualizer

    video = read_video(args.video_path, args.max_frames)
    segm_mask = read_mask(args.mask_path) if args.mask_path else None
    tracks, _, frames = track_video(
        video, checkpoint=args.checkpoint, grid_size=args.grid_size,
        grid_query_frame=args.grid_query_frame, backward_tracking=args.backward_tracking,
        segm_mask=segm_mask, device=args.device)
    print("computed tracks:", tuple(tracks.shape))
    name = os.path.splitext(os.path.basename(args.video_path))[0]
    return Visualizer(save_dir=args.save_dir, pad_value=120, linewidth=3).save_video(
        frames, filename=name)


if __name__ == "__main__":
    main()
