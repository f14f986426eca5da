"""Points x frames a second: the real query points times the frames each
completed unit tracked (offline: the video's frames; streaming: the frames
a window adds), summed over the window, over the window's seconds."""


def read(rec):
    return rec["work"] / rec["window_s"] if rec["window_s"] > 0 else None
