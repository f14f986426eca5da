"""Training auxiliaries (port of cotracker_tpu/training/train_utils.py): the
SLURM signal handlers and the benchmark evaluation run during training."""

import os
import signal
import socket
import subprocess
from typing import Dict, Optional

import torch


def sig_handler(signum, frame):
    """SIGUSR1: requeue this SLURM job before it is preempted, then exit."""
    print("caught signal", signum, socket.gethostname(), os.getpid())
    job_id = os.environ.get("SLURM_JOB_ID")
    if job_id and os.environ.get("SLURM_PROCID", "0") == "0":
        print(f"requeuing job {job_id}")
        subprocess.run(["scontrol", "requeue", job_id], check=False)
    os._exit(0)


def term_handler(signum, frame):
    """SIGTERM: ignored, so that SIGUSR1 handles preemption."""
    print("bypassing sigterm")


def install_slurm_handlers():
    signal.signal(signal.SIGUSR1, sig_handler)
    signal.signal(signal.SIGTERM, term_handler)


def run_test_eval(
    model,
    dataset_specs: Dict[str, str],
    exp_dir: str,
    single_point: bool = False,
    n_iters: int = 6,
    fast_eval: bool = True,
    writer=None,
    step: Optional[int] = None,
):
    """Evaluate the model being trained on TAP-Vid datasets.

    dataset_specs: {dataset_name: dataset_root}, for example
    {"tapvid_davis_first": "/data/tapvid_davis/tapvid_davis.pkl"}. The model
    runs in eval mode under inference_mode (its offline forward, the video
    resized to its model_resolution) and is put back in training mode after;
    nothing is drawn from any generator of the trainer. Returns
    {dataset_name: the metrics' average}; with a writer and a step, each
    average is logged as eval/<name>/<metric>."""
    from cotracker_tpu_torch.datasets.tap_vid import TapVidDataset
    from cotracker_tpu_torch.evaluation.evaluation_predictor import EvaluationPredictor
    from cotracker_tpu_torch.evaluation.evaluator import Evaluator

    results = {}
    predictor = EvaluationPredictor(model, interp_shape=tuple(model.model_resolution),
                                    single_point=single_point, n_iters=n_iters)
    evaluator = Evaluator(exp_dir)
    model.eval()
    try:
        with torch.inference_mode():
            for name, root in dataset_specs.items():
                dataset_type = name.split("_")[1] if "tapvid" in name else name
                ds = TapVidDataset(data_root=root, dataset_type=dataset_type,
                                   queried_first="strided" not in name, fast_eval=fast_eval)
                metrics = evaluator.evaluate_sequence(predictor, ds, dataset_name=name,
                                                      verbose=False)
                results[name] = metrics.get("avg", {})
    finally:
        model.train()
    if writer is not None and step is not None:
        for name, avg in results.items():
            for k, v in avg.items():
                writer.add_scalar(f"eval/{name}/{k}", v, step)
    return results
