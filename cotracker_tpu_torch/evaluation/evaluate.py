"""Benchmark evaluation CLI of the port (the JAX package's
cotracker_tpu/evaluation/evaluate.py flags, plus --device):

    python -m cotracker_tpu_torch.evaluation.evaluate \\
        --dataset_name tapvid_davis_first --dataset_root /path/to/tapvid_davis.pkl \\
        --checkpoint scaled_offline.pth --fast

Runs on the GPU (`--device cuda`, the default; it raises without one) or,
asked, on the CPU (`--device cpu`, the plain PyTorch path). `--fast` is the
bf16 kernel path; a video longer than 128 frames runs its time blocks
through the split K8 -> K5 -> K9. `--online` evaluates the streaming
predictor. Writes expconfig.json and result_eval_.json (the metrics'
average and the wall time) into --exp_dir, and the per-sequence metrics
into result_<dataset_name>.json.

Not ported yet: the legacy model (`--v2`) and the Dynamic Replica reader
(`--dataset_name dynamic_replica`); both raise.
"""

import argparse
import dataclasses
import json
import os
import time
from dataclasses import dataclass
from typing import Optional


@dataclass
class DefaultConfig:
    exp_dir: str = "./outputs/cotracker_tpu_torch_eval"
    dataset_name: str = "tapvid_davis_first"
    dataset_root: str = "./"
    checkpoint: Optional[str] = None
    single_point: bool = False
    grid_size: int = 5
    local_grid_size: int = 8
    sift_size: int = 0
    num_uniformly_sampled_pts: int = 0
    n_iters: int = 6
    offline_model: bool = True
    window_len: int = 60
    fast_eval: bool = False
    local_extent: int = 50
    v2: bool = False
    model_res: str = "384x512"  # model input resolution "HxW"
    online_capacity: int = 4096  # the online predictor's prediction buffer (frames)
    fast: bool = False  # bf16 + the CUDA kernels (build_cotracker)
    device: str = "cuda"


def run_eval(cfg: DefaultConfig):
    from cotracker_tpu_torch.datasets.tap_vid import TapVidDataset
    from cotracker_tpu_torch.evaluation.evaluation_predictor import EvaluationPredictor
    from cotracker_tpu_torch.evaluation.evaluator import Evaluator, OnlineWrapper
    from cotracker_tpu_torch.models.build import build_cotracker
    from cotracker_tpu_torch.predictor import CoTrackerOnlinePredictor

    if cfg.v2:
        raise NotImplementedError("the legacy CoTracker2 model is not ported yet "
                                  "(ROADMAP.md queue 1 item 12)")
    name = cfg.dataset_name
    if name == "dynamic_replica":
        raise NotImplementedError("the Dynamic Replica reader is not ported yet "
                                  "(ROADMAP.md queue 1 item 10)")
    if "tapvid" not in name:
        raise ValueError(f"unknown dataset {name}")
    os.makedirs(cfg.exp_dir, exist_ok=True)
    with open(os.path.join(cfg.exp_dir, "expconfig.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)

    h, _, w = cfg.model_res.partition("x")
    model_resolution = (int(h), int(w))
    if cfg.offline_model:
        model = build_cotracker(cfg.checkpoint, offline=True, window_len=cfg.window_len,
                                model_resolution=model_resolution, fast=cfg.fast,
                                device=cfg.device)
        predictor = EvaluationPredictor(
            model, interp_shape=model_resolution, grid_size=cfg.grid_size,
            local_grid_size=cfg.local_grid_size, single_point=cfg.single_point,
            sift_size=cfg.sift_size, num_uniformly_sampled_pts=cfg.num_uniformly_sampled_pts,
            n_iters=cfg.n_iters, local_extent=cfg.local_extent,
        )
    else:
        predictor = OnlineWrapper(CoTrackerOnlinePredictor(
            cfg.checkpoint, window_len=cfg.window_len, capacity=cfg.online_capacity,
            model_resolution=model_resolution, fast=cfg.fast, return_full_buffers=True,
            device=cfg.device))

    dataset = TapVidDataset(
        data_root=cfg.dataset_root, dataset_type=name.split("_")[1],
        queried_first="strided" not in name, fast_eval=cfg.fast_eval)
    t0 = time.time()
    metrics = Evaluator(cfg.exp_dir).evaluate_sequence(predictor, dataset, dataset_name=name)
    dt = time.time() - t0
    result = {"avg": metrics.get("avg", {}), "time": dt}
    print(f"Dataset: {name}")
    print(f"Metrics: {result['avg']}")
    print(f"Evaluation took {dt:.1f} seconds")
    with open(os.path.join(cfg.exp_dir, "result_eval_.json"), "w") as f:
        json.dump(result, f, indent=2)
    return metrics


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    for f in dataclasses.fields(DefaultConfig):
        if isinstance(f.default, bool):  # --flag / --no-flag; --flag means True
            p.add_argument(f"--{f.name}", action=argparse.BooleanOptionalAction, default=f.default)
        else:
            p.add_argument(f"--{f.name}", default=f.default,
                           type=str if f.default is None else type(f.default))
    p.add_argument("--online", action="store_true",
                   help="evaluate the online (streaming) predictor; alias for --no-offline_model")
    return p


def parse_config(argv=None) -> DefaultConfig:
    args = vars(build_parser().parse_args(argv))
    if args.pop("online"):
        args["offline_model"] = False
    return DefaultConfig(**args)


def main():
    run_eval(parse_config())


if __name__ == "__main__":
    main()
