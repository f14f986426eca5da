"""The sample container and its collation, for evaluation and training (port of
cotracker_tpu/datasets/utils.py): numpy arrays, moved to the card by the
predictor that reads them."""

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(eq=False)
class CoTrackerData:
    """One video sample.

    video: (T, 3, H, W) float [0, 255]
    trajectory: (T, N, 2) float (x, y)
    visibility: (T, N) bool or float
    valid: (T, N) optional validity mask
    segmentation: (1, H, W) optional
    seq_name: str
    query_points: (N, 3) optional (t, y, x), the TAP-Vid convention
    """

    video: np.ndarray
    trajectory: Optional[np.ndarray] = None
    visibility: Optional[np.ndarray] = None
    valid: Optional[np.ndarray] = None
    segmentation: Optional[np.ndarray] = None
    seq_name: str = ""
    query_points: Optional[np.ndarray] = None


def collate_fn(batch):
    """Stack a list of CoTrackerData into one with a leading batch axis."""
    out = {}
    for f in dataclasses.fields(CoTrackerData):
        vals = [getattr(b, f.name) for b in batch]
        if f.name == "seq_name":
            out[f.name] = vals
        elif vals[0] is None:
            out[f.name] = None
        else:
            out[f.name] = np.stack([np.asarray(v) for v in vals])
    return CoTrackerData(**out)


def collate_fn_train(batch):
    """Training collation of (CoTrackerData, gotit) pairs (bare samples count
    as read): the stacked samples and the list of gotit flags."""
    samples = [b[0] if isinstance(b, tuple) else b for b in batch]
    gotit = [b[1] if isinstance(b, tuple) else True for b in batch]
    return collate_fn(samples), gotit
