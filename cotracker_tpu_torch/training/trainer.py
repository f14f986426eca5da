"""Supervised training on one GPU (port of cotracker_tpu/training/trainer.py).

    python -m cotracker_tpu_torch.training.trainer --dataset_root /data/kubric_movi_f \
        --exp_dir runs/a [--eval_datasets tapvid_davis_first=/data/tapvid_davis.pkl \
        --eval_every_n_steps 5000] [--save_vis_every_n_steps 1000] [--device cpu]

    from cotracker_tpu_torch.training.trainer import TrainerArgs, train
    model = train(TrainerArgs(dataset_root="/data/kubric_movi_f", offline_model=False,
                              model_window_len=16))

AdamW with the one-cycle schedule and global-norm clipping, checkpoints with
auto-resume, a JSONL log of every step (and TensorBoard when it imports),
the Kubric MOVi-f reader (`datasets.kubric`; or an injected dataset, see
data_loader for the interface), TAP-Vid evaluation (`train_utils.
run_test_eval`) and track overlays of a training batch on their cadences,
and the SLURM handlers. The command line's flags are TrainerArgs' fields,
as in the JAX package: a bool whose default is True is a flag that turns it
off (`--use_augs` trains without augmentations); crop_size is not a flag.
Pseudo-label distillation on real videos is `training.distill_trainer`,
which shares this module's logger, checkpoints and command-line parsing.
Not ported yet: the mesh and multi-host paths (ROADMAP queue 1 item 13).
"""

import argparse
import dataclasses
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
from cotracker_tpu_torch.training.train_utils import install_slurm_handlers, run_test_eval


@dataclass
class TrainerArgs:
    exp_dir: str = "./outputs/train"
    dataset_root: str = ""  # a Kubric MOVi-f tree (datasets/kubric.py)
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
    # comma-separated name=root TAP-Vid specs for the default eval hook, e.g.
    # "tapvid_davis_first=/data/tapvid_davis/tapvid_davis.pkl"
    eval_datasets: str = ""
    fast_eval: bool = True
    # track overlays of a training batch every N steps
    save_vis_every_n_steps: int = 0
    num_loader_workers: int = 4
    loader_prefetch: int = 4
    dataset_repeats: int = 4
    crop_size: Tuple[int, int] = (384, 512)
    offline_model: bool = True
    model_window_len: int = 60
    use_augs: bool = True
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
    """Model, optimizer, schedule, query generator (None: a loop without
    one) and step counter, written to `path` through a `.tmp` file and an
    atomic rename."""
    blob = {
        "model": model.state_dict(),
        "optimizer": optimizer.state_dict(),
        "scheduler": scheduler.state_dict(),
        "generator": None if generator is None else generator.get_state(),
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
    if generator is not None:
        generator.set_state(blob["generator"])
    return blob["total_steps"]


def find_auto_resume(ckpt_dir):
    """The latest step checkpoint in ckpt_dir (the final one excluded), or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = sorted(f for f in os.listdir(ckpt_dir)
                   if f.startswith("model_") and f.endswith(".pth") and "final" not in f)
    return os.path.join(ckpt_dir, cands[-1]) if cands else None


def _parse_eval_specs(spec: str):
    """"name=root,name=root" -> {name: root}."""
    out = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        name, _, root = part.partition("=")
        out[name] = root
    return out


def render_train_batch(model, batch, iters, visualizer):
    """The visualisation hook's work on one training batch: queries at each
    track's first visible frame (from batch["vis_g"] and batch["trajs_g"]),
    the model's offline forward at `iters` in eval mode under
    inference_mode, and the tracks (visible where vis > 0.5) drawn over the
    batch's first video. Returns the rendered (T', H, W, 3) uint8 frames."""
    first = batch["vis_g"].argmax(dim=1)  # (B, N)
    xy = torch.gather(batch["trajs_g"], 1, first[:, None, :, None].expand(-1, 1, -1, 2))[:, 0]
    queries = torch.cat([first[..., None].to(xy.dtype), xy], dim=-1)
    model.eval()
    try:
        with torch.inference_mode():
            tracks, vis, _, _ = model(batch["video"], queries, iters=iters)
    finally:
        model.train()
    return visualizer.visualize(batch["video"].permute(0, 1, 4, 2, 3), tracks, vis > 0.5,
                                save_video=False)


def train(args: TrainerArgs, dataset=None, model=None, eval_hook=None, vis_hook=None):
    """Train for args.num_steps steps, resuming from the latest checkpoint in
    exp_dir/checkpoints. The data: `dataset`, else the Kubric reader on
    args.dataset_root. eval_hook(model, step) -> results and
    vis_hook(model, batch, step) run every eval_every_n_steps /
    save_vis_every_n_steps steps; by default run_test_eval on
    args.eval_datasets and render_train_batch saved by the Visualizer (to
    TensorBoard with moviepy, else an mp4 through OpenCV: without either,
    the cadence raises an ImportError naming cv2 before the first step).
    Installs the SLURM handlers (SIGUSR1, SIGTERM). On CUDA, float32
    products and convolutions run without TF32 (this process-wide setting
    is what an f32 model trains with in the JAX package). Returns the model."""
    install_slurm_handlers()
    dev = resolve_device(args.device)
    eval_specs = _parse_eval_specs(args.eval_datasets)
    if eval_hook is None and not eval_specs and (args.eval_every_n_steps
                                                 or args.evaluate_at_start):
        raise ValueError("an eval cadence (eval_every_n_steps, evaluate_at_start) needs "
                         "--eval_datasets or an eval_hook")
    if dataset is None:
        if not args.dataset_root:
            raise ValueError("no training data: pass --dataset_root (a Kubric MOVi-f tree) or "
                             "dataset=")
        from cotracker_tpu_torch.datasets.kubric import KubricMovifDataset

        dataset = KubricMovifDataset(
            data_root=args.dataset_root, crop_size=args.crop_size, seq_len=args.seq_len,
            traj_per_sample=args.traj_per_sample, use_augs=args.use_augs,
            random_seq_len=not args.offline_model, random_frame_rate=not args.offline_model,
            seed=args.seed)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.exp_dir, exist_ok=True)
    with open(os.path.join(args.exp_dir, "meta.json"), "w") as f:
        json.dump(asdict(args), f, indent=2)

    logger = Logger(args.exp_dir)
    try:
        if vis_hook is None and args.save_vis_every_n_steps:
            from cotracker_tpu_torch.utils.visualizer import Visualizer

            Visualizer.video_sink(logger.writer)  # cv2's ImportError, before any step
            visualizer = Visualizer(save_dir=args.exp_dir, fps=6)

            def vis_hook(m, batch, step):
                frames = render_train_batch(m, batch, args.train_iters, visualizer)
                visualizer.save_video(frames, f"train_step_{step}", writer=logger.writer,
                                      step=step)

        if eval_hook is None and eval_specs:
            def eval_hook(m, step):
                return run_test_eval(m, eval_specs, args.exp_dir, n_iters=6,
                                     fast_eval=args.fast_eval, writer=logger.writer, step=step)

        return _train_loop(args, dev, dataset, model, eval_hook, vis_hook, logger)
    finally:
        logger.close()


def _train_loop(args, dev, dataset, model, eval_hook, vis_hook, logger):
    # the loader first: its reading processes (if the dataset asks for them)
    # start while the model is built
    data = RepeatedDataset(dataset, args.dataset_repeats) if args.dataset_repeats > 1 else dataset
    loader = PrefetchLoader(data, args.batch_size, seed=args.seed,
                            num_workers=args.num_loader_workers, prefetch=args.loader_prefetch)
    try:
        return _train_steps(args, dev, model, eval_hook, vis_hook, logger, loader)
    finally:
        loader.close()


def _train_steps(args, dev, model, eval_hook, vis_hook, logger, loader):
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
    t_start = time.time()
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
    loader.close()
    save_checkpoint(os.path.join(ckpt_dir, "model_final.pth"), model, optimizer, scheduler,
                    generator, args.num_steps)
    if args.eval_every_n_steps:
        run_eval(args.num_steps)
    print(f"training done in {time.time() - t_start:.0f}s")
    return model


def parse_fields(cls, argv=None, description=None):
    """An instance of the dataclass `cls` from the command line, as the JAX
    trainers parse theirs: one flag a scalar field; a bool flag sets the
    opposite of its default (store_true for False, store_false for True);
    a tuple field (crop_size) is not a flag."""
    p = argparse.ArgumentParser(description=description,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    for f in dataclasses.fields(cls):
        if isinstance(f.default, bool):
            p.add_argument(f"--{f.name}", action="store_false" if f.default else "store_true")
        elif isinstance(f.default, (int, float, str)):
            p.add_argument(f"--{f.name}", type=type(f.default), default=f.default)
    return cls(**vars(p.parse_args(argv)))


def parse_args(argv=None) -> TrainerArgs:
    """TrainerArgs from the command line (parse_fields)."""
    return parse_fields(TrainerArgs, argv, __doc__)


def main(argv=None):
    return train(parse_args(argv))


if __name__ == "__main__":
    main()
