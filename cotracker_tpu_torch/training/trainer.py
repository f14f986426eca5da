"""Supervised training on one GPU (port of cotracker_tpu/training/trainer.py).

    from cotracker_tpu_torch.training.trainer import TrainerArgs, train
    model = train(TrainerArgs(exp_dir="runs/a", offline_model=False, model_window_len=16),
                  dataset=my_dataset)

AdamW with the one-cycle schedule and global-norm clipping, checkpoints with
auto-resume, a JSONL log of every step (and TensorBoard when it imports),
and the eval / visualisation hooks on their cadences. The dataset is
injected (see data_loader for its interface): the Kubric reader, the
default eval hook (the evaluation slice), the default visualiser,
distillation and the mesh / multi-host paths are not ported yet (ROADMAP
queue 1 items 10, 11 and 13), and asking for them raises.
"""

import json
import os
import time
from dataclasses import asdict, dataclass
from typing import Tuple

import torch

from cotracker_tpu_torch import resolve_device
from cotracker_tpu_torch.models.build import build_training_model
from cotracker_tpu_torch.training.data_loader import PrefetchLoader, RepeatedDataset
from cotracker_tpu_torch.training.train_step import TrainConfig, make_optimizer, train_step


@dataclass
class TrainerArgs:
    exp_dir: str = "./outputs/train"
    batch_size: int = 1
    seq_len: int = 24
    traj_per_sample: int = 768
    num_steps: int = 50000
    lr: float = 5e-4
    wdecay: float = 1e-5
    train_iters: int = 4
    save_every_n_steps: int = 5000
    eval_every_n_steps: int = 0
    evaluate_at_start: bool = False
    save_vis_every_n_steps: int = 0
    num_loader_workers: int = 4
    loader_prefetch: int = 4
    dataset_repeats: int = 4
    crop_size: Tuple[int, int] = (384, 512)
    offline_model: bool = True
    model_window_len: int = 60
    seed: int = 0
    add_huber_loss: bool = False
    train_only_on_visible: bool = False
    query_sampling_method: str = "first_visible"
    # the correlation through K4r / K4f and the autograd wrapper, with every
    # iteration rematerialised (JAX `use_pallas_corr`, there off by default:
    # on the GPU this is the trainer's fast configuration)
    use_corr_kernels: bool = True
    # K4r (int8 windows; a straight-through estimator) rather than K4f
    corr_quant_int8: bool = True
    # rematerialise the iterations without the correlation kernels too
    remat_iterations: bool = False
    device: str = "cuda"


class Logger:
    """Per-step scalars to `train_log.jsonl` in exp_dir, to TensorBoard
    when torch.utils.tensorboard imports, and a mean to the console every
    100 steps."""

    def __init__(self, exp_dir):
        self.writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.writer = SummaryWriter(log_dir=os.path.join(exp_dir, "runs"))
        except ImportError:
            pass
        self.running = {}
        self.count = 0
        self.jsonl = os.path.join(exp_dir, "train_log.jsonl")

    def push(self, metrics, step):
        self.count += 1
        vals = {k: float(v) for k, v in metrics.items()}
        for k, v in vals.items():
            self.running[k] = self.running.get(k, 0.0) + v
            if self.writer is not None:
                self.writer.add_scalar(k, v, step)
        with open(self.jsonl, "a") as f:
            f.write(json.dumps({"step": step, "t": time.time(), **vals}) + "\n")
        if self.count % 100 == 0:
            means = {k: v / 100 for k, v in self.running.items()}
            print(f"step {step}: " + ", ".join(f"{k}={v:.4f}" for k, v in means.items()))
            self.running = {}

    def close(self):
        if self.writer is not None:
            self.writer.close()


def save_checkpoint(path, model, optimizer, scheduler, generator, step):
    """Model, optimizer, schedule, query generator and step counter, written
    to `path` through a `.tmp` file and an atomic rename."""
    blob = {
        "model": model.state_dict(),
        "optimizer": optimizer.state_dict(),
        "scheduler": scheduler.state_dict(),
        "generator": generator.get_state(),
        "total_steps": step,
    }
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)


def load_checkpoint(path, model, optimizer, scheduler, generator):
    """Restore what save_checkpoint wrote; returns its step."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(blob["model"])
    optimizer.load_state_dict(blob["optimizer"])
    scheduler.load_state_dict(blob["scheduler"])
    generator.set_state(blob["generator"])
    return blob["total_steps"]


def find_auto_resume(ckpt_dir):
    """The latest step checkpoint in ckpt_dir (the final one excluded), or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = sorted(f for f in os.listdir(ckpt_dir)
                   if f.startswith("model_") and f.endswith(".pth") and "final" not in f)
    return os.path.join(ckpt_dir, cands[-1]) if cands else None


def train(args: TrainerArgs, dataset=None, model=None, eval_hook=None, vis_hook=None):
    """Train for args.num_steps steps, resuming from the latest checkpoint in
    exp_dir/checkpoints. eval_hook(model, step) -> results and
    vis_hook(model, batch, step) run every eval_every_n_steps /
    save_vis_every_n_steps steps. On CUDA, float32 products and
    convolutions run without TF32 (this process-wide setting is what an f32
    model trains with in the JAX package). Returns the model."""
    if dataset is None:
        raise NotImplementedError("the Kubric reader is not ported (ROADMAP queue 1 item 11): "
                                  "pass dataset=")
    if eval_hook is None and (args.eval_every_n_steps or args.evaluate_at_start):
        raise NotImplementedError("the default eval hook needs the evaluation slice (ROADMAP "
                                  "queue 1 item 10): pass eval_hook=")
    if vis_hook is None and args.save_vis_every_n_steps:
        raise NotImplementedError("the default visualisation hook is not ported (ROADMAP queue 1 "
                                  "item 11): pass vis_hook=")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.exp_dir, exist_ok=True)
    with open(os.path.join(args.exp_dir, "meta.json"), "w") as f:
        json.dump(asdict(args), f, indent=2)

    if model is None:
        model = build_training_model(
            offline=args.offline_model, window_len=args.model_window_len,
            model_resolution=args.crop_size, corr_kernels=args.use_corr_kernels,
            corr_quant_int8=args.corr_quant_int8, remat_iterations=args.remat_iterations,
            device=dev, seed=args.seed)
    model.train()
    cfg = TrainConfig(
        iters=args.train_iters, add_huber_loss=args.add_huber_loss,
        train_only_on_visible=args.train_only_on_visible, offline_model=args.offline_model,
        sliding_window_len=args.model_window_len,
        query_sampling_method=args.query_sampling_method,
    )
    optimizer, scheduler = make_optimizer(model, args.lr, args.wdecay, args.num_steps)
    generator = torch.Generator().manual_seed(args.seed)

    step0 = 0
    ckpt_dir = os.path.join(args.exp_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    resume = find_auto_resume(ckpt_dir)
    if resume:
        step0 = load_checkpoint(resume, model, optimizer, scheduler, generator)
        print(f"auto-resumed from {resume} at step {step0}")

    logger = Logger(args.exp_dir)
    eval_records = os.path.join(args.exp_dir, "eval_records.jsonl")
    last_eval = [-1]

    def run_eval(step):
        if eval_hook is None or last_eval[0] == step:
            return
        last_eval[0] = step
        res = eval_hook(model, step)
        with open(eval_records, "a") as f:
            f.write(json.dumps({"step": step, "results": res}, default=float) + "\n")
        print(f"eval @ step {step}: {res}")

    if args.evaluate_at_start and step0 == 0:
        run_eval(0)
    data = RepeatedDataset(dataset, args.dataset_repeats) if args.dataset_repeats > 1 else dataset
    loader = PrefetchLoader(data, args.batch_size, seed=args.seed,
                            num_workers=args.num_loader_workers, prefetch=args.loader_prefetch)
    t_start = time.time()
    try:
        for step in range(step0, args.num_steps):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in next(loader).items()}
            aux = train_step(model, optimizer, scheduler, batch, generator, cfg)
            logger.push(aux, step)
            if args.save_every_n_steps and (step + 1) % args.save_every_n_steps == 0:
                save_checkpoint(os.path.join(ckpt_dir, f"model_{step + 1:09d}.pth"), model,
                                optimizer, scheduler, generator, step + 1)
            if args.eval_every_n_steps and (step + 1) % args.eval_every_n_steps == 0:
                run_eval(step + 1)
            if args.save_vis_every_n_steps and (step + 1) % args.save_vis_every_n_steps == 0:
                vis_hook(model, batch, step + 1)
    finally:
        loader.close()
        logger.close()
    save_checkpoint(os.path.join(ckpt_dir, "model_final.pth"), model, optimizer, scheduler,
                    generator, args.num_steps)
    if args.eval_every_n_steps:
        run_eval(args.num_steps)
    print(f"training done in {time.time() - t_start:.0f}s")
    return model
