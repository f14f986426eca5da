"""Model zoo surface (port of cotracker_tpu/hub.py; the reference's hubconf.py).

The published checkpoints are reference-format `.pth` files that load
directly (`models/checkpoint.py`). Nothing is downloaded: the constructors
take a local path, and a URL-shaped argument raises with the URL to fetch
by hand.

    from cotracker_tpu_torch import hub
    pred = hub.cotracker3_offline("scaled_offline.pth", fast=True)
    tracks, vis = pred(video, grid_size=10)

`**kw` reaches the predictor (`fast`, `device`, `model_resolution`, ...);
the device is CUDA unless `device="cpu"` is passed. The legacy CoTracker2
family loads the same way: `cotracker2` / `cotracker2_online` (window 8)
from cotracker2.pth, `cotracker2v1` / `cotracker2v1_online` (window 16)
from cotracker2v1.pth.
"""

from typing import Optional

CHECKPOINT_URLS = {
    "cotracker3_offline": "https://huggingface.co/facebook/cotracker3/resolve/main/scaled_offline.pth",
    "cotracker3_online": "https://huggingface.co/facebook/cotracker3/resolve/main/scaled_online.pth",
    "baseline_offline": "https://huggingface.co/facebook/cotracker3/resolve/main/baseline_offline.pth",
    "baseline_online": "https://huggingface.co/facebook/cotracker3/resolve/main/baseline_online.pth",
    "cotracker2": "https://huggingface.co/facebook/cotracker/resolve/main/cotracker2.pth",
    "cotracker2v1": "https://huggingface.co/facebook/cotracker/resolve/main/cotracker2v1.pth",
}


def _resolve(checkpoint: Optional[str], name: str) -> Optional[str]:
    if checkpoint and checkpoint.startswith(("http://", "https://")):
        raise ValueError(
            f"no downloads here; fetch {CHECKPOINT_URLS.get(name, checkpoint)} "
            "by hand and pass the local path"
        )
    return checkpoint


def cotracker3_offline(checkpoint: Optional[str] = None, **kw):
    """Offline CoTracker3 predictor (window_len=60)."""
    from cotracker_tpu_torch.predictor import CoTrackerPredictor

    return CoTrackerPredictor(
        checkpoint=_resolve(checkpoint, "cotracker3_offline"), offline=True, window_len=60, **kw
    )


def cotracker3_online(checkpoint: Optional[str] = None, **kw):
    """Online (streaming) CoTracker3 predictor (window_len=16, step 8)."""
    from cotracker_tpu_torch.predictor import CoTrackerOnlinePredictor

    return CoTrackerOnlinePredictor(
        checkpoint=_resolve(checkpoint, "cotracker3_online"), window_len=16, **kw
    )


def cotracker2(checkpoint: Optional[str] = None, **kw):
    """Legacy CoTracker2 offline predictor (window_len=8)."""
    from cotracker_tpu_torch.predictor import CoTrackerPredictor

    return CoTrackerPredictor(
        checkpoint=_resolve(checkpoint, "cotracker2"), window_len=8, v2=True, **kw
    )


def cotracker2_online(checkpoint: Optional[str] = None, **kw):
    """Legacy CoTracker2 online predictor (window_len=8, step 4)."""
    from cotracker_tpu_torch.predictor import CoTrackerOnlinePredictor

    return CoTrackerOnlinePredictor(
        checkpoint=_resolve(checkpoint, "cotracker2"), window_len=8, v2=True, **kw
    )


def cotracker2v1(checkpoint: Optional[str] = None, **kw):
    """Legacy CoTracker2.1 offline predictor (window_len=16)."""
    from cotracker_tpu_torch.predictor import CoTrackerPredictor

    return CoTrackerPredictor(
        checkpoint=_resolve(checkpoint, "cotracker2v1"), window_len=16, v2=True, **kw
    )


def cotracker2v1_online(checkpoint: Optional[str] = None, **kw):
    """Legacy CoTracker2.1 online predictor (window_len=16, step 8)."""
    from cotracker_tpu_torch.predictor import CoTrackerOnlinePredictor

    return CoTrackerOnlinePredictor(
        checkpoint=_resolve(checkpoint, "cotracker2v1"), window_len=16, v2=True, **kw
    )
