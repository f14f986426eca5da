"""The port's reference-format export and its model zoo surface, on the CPU:
`export_reference_state_dict` against the JAX package's
`export_torch_state_dict` of the same random parameters (key for key, value
for value; the parameter tree comes from eval_shape, nothing compiles), the
round trip through `save_reference_checkpoint` and
`load_reference_state_dict` (bit for bit), the census of unmapped keys, and
`hub`: a local checkpoint loads, a URL raises with the URL, the four
legacy CoTracker2 constructors build their predictors."""

import numpy as np
import pytest
import torch

from cotracker_tpu.models.checkpoint import export_torch_state_dict
from cotracker_tpu.models.cotracker3 import CoTrackerThree as JaxCoTrackerThree
from cotracker_tpu_torch import hub
from cotracker_tpu_torch.models.checkpoint import (
    export_reference_state_dict, from_jax_params, load_reference_state_dict,
    save_reference_checkpoint,
)
from cotracker_tpu_torch.models.cotracker2 import CoTracker2
from cotracker_tpu_torch.models.cotracker3 import CoTrackerThree
from cotracker_tpu_torch.predictor import CoTrackerOnlinePredictor, CoTrackerPredictor
from test_torch_model import random_params

RES = (32, 48)


@pytest.fixture(scope="module")
def params():
    return random_params(JaxCoTrackerThree(), seed=11)


def test_export_matches_jax(params):
    ours = export_reference_state_dict(from_jax_params(CoTrackerThree(), params))
    ref = export_torch_state_dict(params)
    assert ours.keys() == ref.keys() and "updateformer.virual_tracks" in ours
    for k, v in ref.items():
        assert ours[k].dtype == torch.float32 and np.array_equal(ours[k].numpy(), v), k


def test_reference_checkpoint_round_trip(params, tmp_path):
    model = from_jax_params(CoTrackerThree(), params)
    path = str(tmp_path / "exported.pth")
    save_reference_checkpoint(path, model)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    assert set(sd) == {"model"} and not any(k.endswith("_emb") for k in sd["model"])
    loaded = load_reference_state_dict(CoTrackerThree(), sd)
    a, b = model.state_dict(), loaded.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_export_refuses_an_unmapped_key():
    model = CoTrackerThree(model_resolution=RES)
    model.register_buffer("calibration", torch.zeros(3))
    with pytest.raises(KeyError, match="calibration"):
        export_reference_state_dict(model)


@pytest.mark.parametrize("online", [False, True], ids=["offline", "online"])
def test_hub_loads_a_local_checkpoint(tmp_path, online):
    src = CoTrackerThree(model_resolution=RES)
    with torch.no_grad():
        for p in src.parameters():
            p.normal_(0.0, 0.1)
    path = str(tmp_path / "w.pth")
    save_reference_checkpoint(path, src)
    build = hub.cotracker3_online if online else hub.cotracker3_offline
    pred = build(path, model_resolution=RES, device="cpu")
    assert pred.device == torch.device("cpu") and pred.model.window_len == (16 if online else 60)
    for k, v in src.state_dict().items():
        assert torch.equal(pred.model.state_dict()[k], v), k


def test_hub_refuses_urls_and_legacy_models():
    url = hub.CHECKPOINT_URLS["cotracker3_offline"]
    with pytest.raises(ValueError, match=url.replace(".", r"\.")):
        hub.cotracker3_offline("https://example.org/w.pth")
    with pytest.raises(ValueError, match="scaled_online"):
        hub.cotracker3_online("http://example.org/w.pth")
    # the legacy constructors: window lengths 8 / 8 / 16 / 16, offline or
    # online as named, on the CPU when asked; a URL still raises with the URL
    for name, window, online in (("cotracker2", 8, False), ("cotracker2_online", 8, True),
                                 ("cotracker2v1", 16, False), ("cotracker2v1_online", 16, True)):
        pred = getattr(hub, name)(model_resolution=RES, device="cpu")
        assert isinstance(pred.model, CoTracker2) and pred.model.window_len == window, name
        assert isinstance(pred, CoTrackerOnlinePredictor if online else CoTrackerPredictor)
        assert pred.device == torch.device("cpu")
        url = hub.CHECKPOINT_URLS[name.removesuffix("_online")]
        with pytest.raises(ValueError, match=url.replace(".", r"\.")):
            getattr(hub, name)("https://example.org/w.pth")
