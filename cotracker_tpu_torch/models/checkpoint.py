"""Weight bridge into the port's CoTrackerThree and CoTracker2.

Two loaders fill the same module, of either family:
  * `from_jax_params(model, params)`: the JAX package's flax parameter tree
    as nested dicts of numpy arrays (CoTrackerThree: params["fnet"],
    params["iter_core"]; CoTracker2: params["fnet"],
    params["window_core"]["iter_core"], params["window_core"]["vis_predictor"]);
  * `load_reference_state_dict(model, sd)`: the reference `.pth` format
    (cotracker/models/core/cotracker/cotracker3_offline.py and, for v2 /
    v2.1, cotracker.py state_dicts).
`export_reference_state_dict(model)` and `save_reference_checkpoint(path,
model)` write that format back (the JAX package's export_torch_state_dict /
export_torch_state_dict_v2 / save_torch_checkpoint).

The port's module and parameter names are the reference's, so the flax tree
maps onto them by name: conv kernels (kh, kw, in, out) -> (out, in, kh, kw),
dense kernels (in, out) -> (out, in), LayerNorm scale -> weight, indexed
submodules `name_i` -> `name.i`, the corr MLP's flat `fc1_kernel` ->
`fc1.weight`; CoTracker2's updateformer and GroupNorm `norm` move out of the
window and iteration cores to the top level, and its two Linear layers are
the reference's Sequential entries `track_feat_updater.0` and
`vis_predictor.0`. The reference spells the virtual-track parameter
`virual_tracks`; the time/position embedding buffers are rebuilt by the
constructor and dropped on load, as the reference's own restore path does.
"""

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


def _key(path):
    parts = []
    for p in path:
        m = re.fullmatch(r"(.+)_(\d+)", p)
        if m and not p.endswith(("_kernel", "_bias")):
            parts += [m.group(1), m.group(2)]
        elif p == "downsample":
            parts += ["downsample", "0"]
        else:
            parts.append(p)
    return parts


def _convert(path, value):
    """One flax leaf -> (torch state_dict key, array)."""
    leaf = path[-1]
    parts = _key(path[:-1])
    if leaf in ("fc1_kernel", "fc2_kernel", "fc1_bias", "fc2_bias"):
        fc, kind = leaf.split("_")
        parts.append(fc)
        leaf = kind
    v = np.asarray(value)
    if leaf == "kernel":
        v = np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v.T
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    return ".".join(parts + [leaf]), v


def jax_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Flax CoTrackerThree or CoTracker2 params -> the port's state_dict
    (numpy values)."""
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
            else:
                key, arr = _convert(path + (k,), v)
                out[key] = arr

    walk(params.get("fnet", {}), ("fnet",))
    if "window_core" in params:  # CoTracker2
        window_core = params["window_core"]
        iter_core = window_core.get("iter_core", {})
        walk(iter_core.get("norm", {}), ("norm",))
        walk(iter_core.get("track_feat_updater", {}), ("track_feat_updater", "0"))
        walk(window_core.get("vis_predictor", {}), ("vis_predictor", "0"))
    else:
        iter_core = params.get("iter_core", {})
        walk(iter_core.get("corr_mlp", {}), ("corr_mlp",))
    walk(iter_core.get("updateformer", {}), ("updateformer",))
    return out


def _load(model: torch.nn.Module, sd: Mapping[str, Any]) -> torch.nn.Module:
    ref = model.state_dict()
    tensors = {}
    for k, v in sd.items():
        t = v.detach() if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
        if k in ref and tuple(t.shape) != tuple(ref[k].shape):
            raise ValueError(f"{k}: shape {tuple(t.shape)} != model {tuple(ref[k].shape)}")
        tensors[k] = t
    model.load_state_dict(tensors, strict=True)
    return model


def from_jax_params(model: torch.nn.Module, params: Mapping[str, Any]) -> torch.nn.Module:
    """Fill `model` from a flax parameter tree (nested dicts of numpy arrays)."""
    return _load(model, jax_params_to_state_dict(params))


def load_reference_state_dict(model: torch.nn.Module, sd: Mapping[str, Any]) -> torch.nn.Module:
    """Fill `model` from a reference-format state_dict (plain or
    {"model": ...}-wrapped, optional "module." prefixes)."""
    if "model" in sd and isinstance(sd["model"], Mapping):
        sd = sd["model"]
    out = {}
    for key, val in sd.items():
        key = key.removeprefix("module.")
        if key.endswith("num_batches_tracked") or key.split(".")[-1] in ("time_emb", "pos_emb"):
            continue
        out[key.replace("updateformer.virual_tracks", "updateformer.virtual_tracks")] = val
    return _load(model, out)


# the reference's parameter names, module by module (the census of the JAX
# package's _export_fnet / _export_updateformer and of
# export_torch_state_dict_v2); `virual_tracks` apart
_REFERENCE_KEYS = re.compile("|".join((
    r"fnet\.conv[123]\.(weight|bias)",
    r"fnet\.layer\d\.\d\.(conv1|conv2|downsample\.0)\.(weight|bias)",
    r"corr_mlp\.fc[12]\.(weight|bias)",
    r"updateformer\.(input_transform|flow_head|vis_conf_head)\.(weight|bias)",
    r"updateformer\.(time_blocks|space_virtual_blocks|space_point2virtual_blocks"
    r"|space_virtual2point_blocks)\.\d+\.((attn|cross_attn)\.to_(q|kv|out)|mlp\.fc[12]"
    r"|norm_context)\.(weight|bias)",
    r"norm\.(weight|bias)",
    r"(track_feat_updater|vis_predictor)\.0\.(weight|bias)",
)))


def export_reference_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The port's CoTrackerThree or CoTracker2 -> a reference-format state_dict (CPU
    tensors, the parameters' own bits): `virtual_tracks` back to the
    reference's `virual_tracks`, no time/position embedding buffers (load
    them with strict=False, as the reference's restore path does). A key
    outside the reference's modules raises instead of being dropped."""
    out = {}
    for key, val in model.state_dict().items():
        if key.split(".")[-1] in ("time_emb", "pos_emb"):
            continue
        if key == "updateformer.virtual_tracks":
            key = "updateformer.virual_tracks"
        elif not _REFERENCE_KEYS.fullmatch(key):
            raise KeyError(f"no reference name for the port's state_dict key {key}")
        out[key] = val.detach().cpu().clone()
    return out


def save_reference_checkpoint(path: str, model: torch.nn.Module) -> None:
    """Write `model` as a reference-loadable `.pth`: {"model": state_dict}."""
    torch.save({"model": export_reference_state_dict(model)}, path)


def load_checkpoint(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a reference `.pth` checkpoint file into `model`."""
    return load_reference_state_dict(model, torch.load(path, map_location="cpu", weights_only=True))
