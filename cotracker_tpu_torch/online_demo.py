"""Streaming tracking demo (port of the JAX package's online_demo.py):
feed a video frame by frame, track a grid window by window, draw the
tracks.

    python -m cotracker_tpu_torch.online_demo --video_path clip.npy --grid_size 10 \\
        [--checkpoint scaled_online.pth] [--grid_query_frame 0] [--device cuda]

A video ending in `.npy` is a (T, H, W, 3) uint8 array; other files are
decoded with OpenCV. Every `step` frames the last 2 * step frames go to the
online predictor; the frames left at the end go in one last chunk. The
rendered video is written as an mp4, which needs OpenCV: where cv2 is
missing the demo raises after tracking. `track_stream` returns the tracks
without rendering or writing anything.
"""

import argparse
import os

import numpy as np


def track_stream(frames, predictor, grid_size=10, grid_query_frame=0):
    """Drive `predictor` (a CoTrackerOnlinePredictor) over `frames`, an
    iterable of (H, W, 3) uint8 frames: the first chunk registers the grid,
    then a chunk of the last 2 * step frames every step frames, then the
    tail. Returns tracks (1, T', N, 2), visibility (1, T', N) of the last
    call, and the frames read, (T, H, W, 3)."""
    window_frames = []
    state = {"first": True, "out": (None, None)}

    def process(num):
        chunk = np.stack(window_frames[-num:]).transpose(0, 3, 1, 2)[None].astype(np.float32)
        if state["first"]:
            predictor(chunk[:, :1], is_first_step=True, grid_size=grid_size,
                      grid_query_frame=grid_query_frame)
            state["first"] = False
        state["out"] = predictor(chunk)

    i = 0
    for frame in frames:
        window_frames.append(frame)
        if i % predictor.step == 0 and i != 0:
            process(predictor.step * 2)
        i += 1
    process(i % predictor.step + predictor.step)  # the tail
    tracks, visibility = state["out"]
    return tracks, visibility, np.stack(window_frames)


def render(video, tracks, visibility):
    """The tracks drawn over the frames they cover: (T', H', W', 3) uint8."""
    from cotracker_tpu_torch.utils.visualizer import Visualizer

    video_b = video.transpose(0, 3, 1, 2)[None].astype(np.float32)
    T = min(video_b.shape[1], tracks.shape[1])
    return Visualizer(pad_value=120, linewidth=3).visualize(
        video_b[:, :T], tracks[:, :T], visibility[:, :T], save_video=False)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--video_path", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--grid_size", type=int, default=10)
    p.add_argument("--grid_query_frame", type=int, default=0)
    p.add_argument("--save_dir", default="./saved_videos")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from cotracker_tpu_torch.demo import read_video
    from cotracker_tpu_torch.predictor import CoTrackerOnlinePredictor
    from cotracker_tpu_torch.utils.visualizer import Visualizer

    predictor = CoTrackerOnlinePredictor(checkpoint=args.checkpoint, device=args.device)
    tracks, visibility, video = track_stream(read_video(args.video_path), predictor,
                                             args.grid_size, args.grid_query_frame)
    print("tracks:", tuple(tracks.shape))
    name = os.path.splitext(os.path.basename(args.video_path))[0] + "_online"
    return Visualizer(save_dir=args.save_dir).save_video(
        render(video, tracks, visibility), filename=name)


if __name__ == "__main__":
    main()
