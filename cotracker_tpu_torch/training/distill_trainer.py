"""Pseudo-label distillation on one GPU (port of
cotracker_tpu/training/distill_trainer.py).

    python -m cotracker_tpu_torch.training.distill_trainer --dataset_root videos/ \\
        --exp_dir runs/d --teacher_v21 v21.pth --teacher_v3_online online.pth \\
        --teacher_v3_offline offline.pth [--restore_ckpt student.pth] [--offline_model \\
        --model_window_len 16] [--device cpu]

The loop: a clip of the local videos (datasets.real_videos), SIFT or
SuperPoint queries on the host, pseudo-labels from a teacher picked at
random (training.distill), one student step with the vis_conf_head frozen;
checkpoints with auto-resume, a JSONL log of every step (and TensorBoard
when it imports) and TAP-Vid evaluation on its cadence, through
training.trainer's helpers. The clip goes to the device once a step, and
the teacher and the student share that copy. The flags are
DistillTrainerArgs' fields: a bool whose default is True is a flag that
turns it off (`--offline_model` trains the online student); crop_size is
not a flag.
"""

import json
import os
import time
from dataclasses import asdict, dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from cotracker_tpu_torch import resolve_device
from cotracker_tpu_torch.models.build import build_training_model
from cotracker_tpu_torch.training.distill import (
    DistillConfig, TeacherEnsemble, default_teacher_ensemble, distill_step,
    make_distill_optimizer, sample_distill_queries,
)
from cotracker_tpu_torch.training.train_utils import install_slurm_handlers, run_test_eval
from cotracker_tpu_torch.training.trainer import (
    Logger, _parse_eval_specs, find_auto_resume, load_checkpoint, parse_fields, save_checkpoint,
)


@dataclass
class DistillTrainerArgs:
    exp_dir: str = "./outputs/distill"
    dataset_root: str = ""  # a directory of video files
    crop_size: Tuple[int, int] = (384, 512)
    seq_len: int = 64
    sift_size: int = 384
    num_steps: int = 15000
    lr: float = 5e-5
    wdecay: float = 1e-5
    train_iters: int = 4
    grad_clip: float = 10.0
    save_every_n_steps: int = 1000
    eval_every_n_steps: int = 0
    eval_datasets: str = ""  # "name=root,..." (see trainer.TrainerArgs)
    fast_eval: bool = True
    offline_model: bool = True
    model_window_len: int = 60
    train_only_visible: bool = False
    query_method: str = "sift"  # or "superpoint"
    seed: int = 0
    # the student's start: a reference-format .pth or a checkpoint this
    # port saved (model_*.pth); empty: random weights from `seed`
    restore_ckpt: str = ""
    # the teachers' reference-format checkpoints; an empty one is left out
    teacher_v21: str = ""
    teacher_v3_online: str = ""
    teacher_v3_offline: str = ""
    teacher_tapir: str = ""
    support_grid_size: int = 5
    # the student's correlation through K4r (corr_quant_int8) or K4f and
    # the autograd wrapper, every iteration rematerialised (TrainerArgs')
    use_corr_kernels: bool = True
    corr_quant_int8: bool = True
    device: str = "cuda"


def _build_student(args: DistillTrainerArgs, dev):
    """The training model (build_training_model: K4r by default), from
    args.restore_ckpt when one is given: a reference-format .pth, or a
    checkpoint this port's trainers saved ({"model": its state_dict,
    "optimizer": ...})."""
    model = build_training_model(
        offline=args.offline_model, window_len=args.model_window_len,
        model_resolution=args.crop_size, corr_kernels=args.use_corr_kernels,
        corr_quant_int8=args.corr_quant_int8, device=dev, seed=args.seed)
    if args.restore_ckpt:
        blob = torch.load(args.restore_ckpt, map_location="cpu", weights_only=True)
        if "optimizer" in blob:
            model.load_state_dict(blob["model"])
        else:
            from cotracker_tpu_torch.models.checkpoint import load_reference_state_dict

            load_reference_state_dict(model, blob)
    return model


def distill_train(args: DistillTrainerArgs, dataset=None, model=None,
                  teacher: Optional[TeacherEnsemble] = None, eval_hook=None):
    """Distil for args.num_steps steps, resuming from the latest checkpoint
    in exp_dir/checkpoints (the data order and the queries' Generator start
    again from `seed` after a resume, as in the JAX package). dataset,
    model and teacher are injectable; by default LocalVideoDataset on
    args.dataset_root, _build_student and default_teacher_ensemble of the
    teacher flags. eval_hook(model, step) -> results runs every
    eval_every_n_steps steps (by default run_test_eval on
    args.eval_datasets; a cadence with neither raises a ValueError before
    any step, where the JAX loop skips it). On CUDA, float32 products and
    convolutions run without TF32, as in trainer.train. Returns the
    student."""
    install_slurm_handlers()
    dev = resolve_device(args.device)
    eval_specs = _parse_eval_specs(args.eval_datasets)
    if eval_hook is None and not eval_specs and args.eval_every_n_steps:
        raise ValueError("eval_every_n_steps needs --eval_datasets or an eval_hook")
    if dataset is None:
        from cotracker_tpu_torch.datasets.real_videos import LocalVideoDataset

        dataset = LocalVideoDataset(data_root=args.dataset_root, crop_size=args.crop_size,
                                    seq_len=args.seq_len)
    if teacher is None:
        teacher = default_teacher_ensemble(
            v21_checkpoint=args.teacher_v21 or None,
            v3_online_checkpoint=args.teacher_v3_online or None,
            v3_offline_checkpoint=args.teacher_v3_offline or None,
            tapir_checkpoint=args.teacher_tapir or None,
            support_grid_size=args.support_grid_size, seed=args.seed, device=dev)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if model is None:
        model = _build_student(args, dev)
    model.train()
    os.makedirs(args.exp_dir, exist_ok=True)
    with open(os.path.join(args.exp_dir, "meta.json"), "w") as f:
        json.dump(asdict(args), f, indent=2)

    cfg = DistillConfig(
        iters=args.train_iters, lr=args.lr, wdecay=args.wdecay, num_steps=args.num_steps,
        grad_clip=args.grad_clip, sift_size=args.sift_size, offline_model=args.offline_model,
        sliding_window_len=args.model_window_len, train_only_visible=args.train_only_visible,
    )
    optimizer, scheduler = make_distill_optimizer(model, cfg)
    step = 0
    ckpt_dir = os.path.join(args.exp_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    resume = find_auto_resume(ckpt_dir)
    if resume:
        step = load_checkpoint(resume, model, optimizer, scheduler, None)
        print(f"auto-resumed from {resume} at step {step}")

    logger = Logger(args.exp_dir)
    try:
        if eval_hook is None and eval_specs:
            def eval_hook(m, s):
                return run_test_eval(m, eval_specs, args.exp_dir, n_iters=6,
                                     fast_eval=args.fast_eval, writer=logger.writer, step=s)

        rng = np.random.default_rng(args.seed)
        order = rng.permutation(len(dataset))
        pos = 0
        t_start = time.time()
        while step < args.num_steps:
            if pos >= len(order):
                order = rng.permutation(len(dataset))
                pos = 0
            sample, gotit = dataset[int(order[pos])]
            pos += 1
            if not gotit:
                continue
            video_np = np.asarray(sample.video)[None]  # (1, T, 3, H, W)
            queries = sample_distill_queries(video_np, cfg.sift_size, rng,
                                             method=args.query_method)
            if not np.isfinite(queries).all() or np.abs(queries).max() > 1500:
                print("failed_sample: bad queries, skipping")
                continue
            video_dev = torch.from_numpy(video_np).to(dev)  # one upload: teacher and student
            tracks_t, vis_t = teacher.pseudo_label(video_dev, queries)
            vis_bool = np.asarray(vis_t) > cfg.teacher_vis_threshold
            aux = distill_step(
                model, optimizer, scheduler, video_dev.permute(0, 1, 3, 4, 2),
                torch.from_numpy(queries).to(dev),
                torch.from_numpy(np.asarray(tracks_t, np.float32)).to(dev),
                torch.from_numpy(vis_bool).to(dev), cfg)
            logger.push(aux, step)
            step += 1
            if args.save_every_n_steps and step % args.save_every_n_steps == 0:
                save_checkpoint(os.path.join(ckpt_dir, f"model_{step:09d}.pth"), model,
                                optimizer, scheduler, None, step)
            if eval_hook is not None and args.eval_every_n_steps and (
                    step % args.eval_every_n_steps == 0):
                res = eval_hook(model, step)
                with open(os.path.join(args.exp_dir, "eval_records.jsonl"), "a") as f:
                    f.write(json.dumps({"step": step, "results": res}, default=float) + "\n")
        save_checkpoint(os.path.join(ckpt_dir, "model_final.pth"), model, optimizer, scheduler,
                        None, step)
        print(f"distillation done in {time.time() - t_start:.0f}s")
    finally:
        logger.close()
    return model


def parse_args(argv=None) -> DistillTrainerArgs:
    """DistillTrainerArgs from the command line (trainer.parse_fields)."""
    return parse_fields(DistillTrainerArgs, argv, __doc__)


def main(argv=None):
    return distill_train(parse_args(argv))


if __name__ == "__main__":
    main()
