"""The port's training stack on its own (PyTorch only, CPU, float32): query
sampling, the autograd wrapper of the correlation kernels against autograd
through the plain featurizer, the training model's switches (remat, K4r /
K4f, the corr_fuse_mlp1 variable) against the plain model, gradients
across the online windows, the data loader, the trainer's checkpoints and
hooks, its training from a Kubric tree with the default eval and
visualisation hooks, and its command line. The comparisons with the JAX
package are in test_torch_train.py.
"""

import concurrent.futures
import dataclasses
import importlib.util
import json
import os
import pickle
import signal
import sys
import types

import numpy as np
import pytest
import torch

from cotracker_tpu_torch.models.build import build_training_model
from cotracker_tpu_torch.ops.corr import fused_corr_embs
from cotracker_tpu_torch.ops.kernels import corr_cuda
from cotracker_tpu_torch.training import train_step as TS
from cotracker_tpu_torch.training.data_loader import (
    PrefetchLoader, RepeatedDataset, Sample, collate_batch,
)
from cotracker_tpu_torch.datasets.kubric import KubricMovifDataset
from cotracker_tpu_torch.datasets.png import write_png
from cotracker_tpu_torch.training.train_utils import sig_handler, term_handler
from cotracker_tpu_torch.training.trainer import (
    TrainerArgs, find_auto_resume, main, parse_args, train,
)

torch.set_num_threads(2)


def test_queries_land_on_visible_frames():
    """As tests/test_training.py for the JAX package: every query sits on a
    visible frame of its track at that frame's position, and the last 3/4
    of the tracks use their first visible frame; the draw follows the
    generator."""
    rng = np.random.default_rng(3)
    B, T, N = 2, 10, 16
    vis = (rng.random((B, T, N)) > 0.5).astype(np.float32)
    vis[:, 3] = 1.0
    trajs = rng.standard_normal((B, T, N, 2)).astype(np.float32)
    q = TS.sample_queries_from_gt(torch.from_numpy(trajs), torch.from_numpy(vis),
                                  torch.Generator().manual_seed(0)).numpy()
    t = q[..., 0].astype(int)
    for b in range(B):
        for n in range(N):
            assert vis[b, t[b, n], n] == 1.0
            np.testing.assert_array_equal(q[b, n, 1:], trajs[b, t[b, n], n])
    first = np.argmax(vis > 0, axis=1)
    assert (t[:, N // 4:] == first[:, N // 4:]).all()
    again = TS.sample_queries_from_gt(torch.from_numpy(trajs), torch.from_numpy(vis),
                                      torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_array_equal(q, again)


@pytest.mark.parametrize("quant_int8", [False, True])
def test_trainable_corr_grads_equal_plain_autograd(quant_int8):
    """The autograd Function's gradients for every differentiable input
    (maps, support, coords, both MLP layers) equal autograd through the
    plain fused_corr_embs at the same inputs exactly: its backward is that
    computation. The forward agrees with the plain featurizer to float32
    noise (K4f) or the int8 step (K4r: 1% of the output scale)."""
    g = torch.Generator().manual_seed(5)
    B, T, N, H, W = 1, 3, 7, 12, 16
    fm = torch.nn.functional.normalize(torch.randn(B, T, H, W, 128, generator=g), dim=-1)
    sup = torch.nn.functional.normalize(torch.randn(B, N, 49, 128, generator=g), dim=-1)
    coords = torch.rand(B, T, N, 2, generator=g) * torch.tensor([W + 4.0, H + 4.0]) - 2
    w = [torch.randn(2401, 32, generator=g) * 0.02, torch.randn(32, generator=g) * 0.1,
         torch.randn(32, 16, generator=g) * 0.1, torch.randn(16, generator=g) * 0.1]
    level = (corr_cuda.build_int8_level(fm, 3) if quant_int8
             else corr_cuda.build_float_level(fm, 3, torch.float32))
    a = [t.clone().requires_grad_() for t in (fm, sup, coords, *w)]
    b = [t.clone().requires_grad_() for t in (fm, sup, coords, *w)]
    out = corr_cuda.fused_corr_embs_trainable(level, *a, chunk=4, quant_int8=quant_int8)
    ref = fused_corr_embs(*b, chunk=4, track_major=True)
    tol = 1e-2 if quant_int8 else 1e-5
    assert (out - ref).abs().max() <= tol * ref.abs().max()
    ct = torch.randn(out.shape, generator=g)
    for x, y in zip(torch.autograd.grad(out, a, ct), torch.autograd.grad(ref, b, ct)):
        assert torch.equal(x, y)


def test_fuse_mlp1_switch_in_training(monkeypatch):
    """COTRACKER_CORR_FUSE_MLP1 reaches the training model: build_training_model
    reads it once (an explicit argument overrides it), the wrapper then runs
    K4m (its plain version here) in place of K4r, and the switch raises with
    K4f, where the JAX wrapper asserts."""
    monkeypatch.setenv("COTRACKER_CORR_FUSE_MLP1", "1")
    kw = dict(window_len=8, model_resolution=(32, 32), device="cpu")
    assert build_training_model(**kw).variants.corr_fuse_mlp1
    assert not build_training_model(corr_fuse_mlp1=False, **kw).variants.corr_fuse_mlp1
    assert not build_training_model(corr_kernels=False, **kw).variants.corr_fuse_mlp1
    with pytest.raises(ValueError, match="int8"):
        build_training_model(corr_quant_int8=False, **kw)
    monkeypatch.delenv("COTRACKER_CORR_FUSE_MLP1")
    assert not build_training_model(**kw).variants.corr_fuse_mlp1

    g = torch.Generator().manual_seed(6)
    B, T, N, H, W = 1, 2, 3, 12, 16
    fm = torch.nn.functional.normalize(torch.randn(B, T, H, W, 128, generator=g), dim=-1)
    sup = torch.nn.functional.normalize(torch.randn(B, N, 49, 128, generator=g), dim=-1)
    coords = torch.rand(B, T, N, 2, generator=g) * torch.tensor([W - 1.0, H - 1.0])
    w = [torch.randn(2401, 384, generator=g) * 0.02, torch.randn(384, generator=g) * 0.1,
         torch.randn(384, 16, generator=g) * 0.1, torch.randn(16, generator=g) * 0.1]
    seen, plain = [], corr_cuda.corr_mlp1_plain
    monkeypatch.setattr(corr_cuda, "corr_mlp1_plain", lambda *a: seen.append(1) or plain(*a))
    out = corr_cuda.fused_corr_embs_trainable(corr_cuda.build_int8_level(fm, 3), fm, sup,
                                              coords, *w, fuse_mlp1=True)
    assert seen and out.shape == (B, N, T, 16) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="int8"):
        corr_cuda.fused_corr_embs_trainable(corr_cuda.build_float_level(fm, 3, torch.float32),
                                            fm, sup, coords, *w, quant_int8=False,
                                            fuse_mlp1=True)


def _batch(T=8, H=32, W=32, N=6, seed=0):
    rng = np.random.default_rng(seed)
    video = torch.from_numpy((rng.random((1, T, H, W, 3)) * 255).astype(np.float32))
    start = rng.random((N, 2)) * np.array([W - 1, H - 1])
    trajs = start + np.arange(T)[:, None, None] * rng.uniform(-1.5, 1.5, (N, 2))
    trajs = torch.from_numpy(trajs[None].astype(np.float32))
    vis = ((trajs >= 0) & (trajs <= torch.tensor([W - 1.0, H - 1.0]))).all(-1).float()
    vis[0, 0] = 1.0
    queries = TS.sample_queries_from_gt(trajs, vis, torch.Generator().manual_seed(1))
    return video, trajs, vis, torch.ones_like(vis), queries


def _grads(model, batch, cfg):
    loss, _ = TS.tracker_loss_fn(model, *batch, cfg)
    loss.backward()
    return loss.item(), {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("offline", [True, False])
def test_training_switches_keep_loss_and_grads(offline):
    """On one batch (64x96, T=8, 32 tracks, iters=2; online: window 6, two
    windows, the second past the end): remat alone changes nothing (the same
    arithmetic, recomputed); K4f with remat agrees with the plain model to
    float32 noise (loss rtol 1e-5, gradients 1e-3 of each tensor's largest);
    K4r quantizes the forward and not the backward (a straight-through
    estimator), and is held to the bounds of tests/test_training.py (loss
    rtol 1e-3, gradients rtol 2e-2 and atol max(2e-3 x each tensor's
    largest, 1e-7)), as chip_smoke holds the card. The 1e-7 floor is for the
    gradients that are zero up to float32 noise (the encoder's conv biases
    ahead of instance norm)."""
    batch = _batch(H=64, W=96, N=32)
    win = 8 if offline else 6
    cfg = TS.TrainConfig(iters=2, offline_model=offline, sliding_window_len=win)
    kw = dict(offline=offline, window_len=win, model_resolution=(64, 96), device="cpu", seed=0)
    loss0, g0 = _grads(build_training_model(corr_kernels=False, **kw), batch, cfg)
    for switches, rtol, gtol, gatol in (
        (dict(corr_kernels=False, remat_iterations=True), 1e-6, 0.0, 1e-6),
        (dict(corr_kernels=True, corr_quant_int8=False), 1e-5, 0.0, 1e-3),
        (dict(corr_kernels=True, corr_quant_int8=True), 1e-3, 2e-2, 2e-3),
    ):
        loss, g = _grads(build_training_model(**switches, **kw), batch, cfg)
        np.testing.assert_allclose(loss, loss0, rtol=rtol, err_msg=str(switches))
        for k, ref in g0.items():
            ref, out = ref.numpy(), g[k].numpy()
            atol = max(gatol * np.abs(ref).max(), 1e-7)
            np.testing.assert_allclose(out, ref, rtol=gtol, atol=atol, err_msg=f"{switches} {k}")


def test_online_gradient_crosses_windows():
    """T=12 in two windows of 8 at step 4: a loss on the second window's
    visibility reaches frames 0-3, which only the first window sees,
    through the warm-started vis logits when the tracks are queried at
    frame 4 (inside the first window's overlap), and not at all when they
    are queried at frame 9 (no warm start)."""
    video, trajs, vis, valids, queries = _batch(T=12)
    model = build_training_model(window_len=8, model_resolution=(32, 32), corr_kernels=False,
                                 device="cpu")

    def early_frames_grad(query_frame):
        q = queries.clone()
        q[..., 0] = query_frame
        v = video.clone().requires_grad_()
        *_, (coords_w, vis_w, _, _) = model.forward_windows(v, q, iters=1, is_train=True)
        assert len(vis_w) == 2 and vis_w[1].shape == (1, 1, 8, 6)
        (grad,) = torch.autograd.grad(vis_w[1].sum(), v)
        return grad[:, :4].abs().sum().item()

    assert early_frames_grad(4.0) > 0
    assert early_frames_grad(9.0) == 0


class _Clips:
    """Clips of 5 or 7 frames; the frame values carry the worker's draw."""

    def __len__(self):
        return 4

    def get(self, ix, rng):
        T = 5 if ix % 2 else 7
        v = np.full((T, 3, 4, 4), rng.random(), np.float32)
        ones = np.ones((T, 3), np.float32)
        return Sample(v, np.zeros((T, 3, 2), np.float32), ones, ones), ix != 3


def test_collate_pads_ragged_time():
    """Clips of 5 and 7 frames stack to 7: video and tracks repeat the last
    frame, visibility and valids are 0 on the padding."""
    rng = np.random.default_rng(0)
    batch = collate_batch([_Clips().get(1, rng)[0], _Clips().get(0, rng)[0]])
    assert batch["video"].shape == (2, 7, 4, 4, 3)
    assert (batch["valids"][0, 5:] == 0).all() and (batch["valids"][0, :5] == 1).all()
    assert (batch["vis_g"][0, 5:] == 0).all() and (batch["valids"][1] == 1).all()
    np.testing.assert_array_equal(batch["video"][0, 6], batch["video"][0, 4])


def test_loader_workers_draw_from_their_own_generators(tmp_path):
    """Each worker owns a generator seeded (seed, worker): with one worker
    the stream of draws is reproducible, and failed samples are skipped;
    RepeatedDataset serves index i from i % len. A worker's exception comes
    out of next(). A worker reading in a process of its own reads as its
    thread does (_loader_reads_in_processes_as_in_threads)."""
    def draws(seed):
        loader = PrefetchLoader(RepeatedDataset(_Clips(), 2), 1, seed=seed, num_workers=1,
                                prefetch=2)
        try:
            return [float(next(loader)["video"][0, 0, 0, 0, 0]) for _ in range(6)]
        finally:
            loader.close()

    first = draws(3)
    assert first == draws(3) and first != draws(4)
    w = np.random.default_rng([3, 1])
    assert first[0] == np.float32(w.random())

    class Broken(_Clips):
        def get(self, ix, rng):
            raise ValueError("unreadable clip")

    loader = PrefetchLoader(Broken(), 1, seed=0, num_workers=2)
    with pytest.raises(ValueError, match="unreadable clip"):
        next(loader)
    loader.close()
    assert not any(t.is_alive() for t in loader._threads)
    _loader_reads_in_processes_as_in_threads(tmp_path)


def _loader_reads_in_processes_as_in_threads(tmp_path):
    """The Kubric reader asks for reading processes (read_in_processes, also
    through RepeatedDataset): one spawned process a worker, holding the
    dataset and the worker's generator, gives the batch that the worker's
    thread reads, and a read that fails in the process (a PNG chunk whose
    CRC does not match) comes out of next() with its traceback; close()
    ends the threads and the process."""
    tree = tmp_path / "kubric"
    _write_kubric_tree(tree, T=4, H=32, W=48, n_tracks=48)
    second = f"seq{np.random.default_rng(0).permutation(2)[1]:03d}"  # the loader's second read
    with open(tree / second / "frames" / "001.png", "r+b") as f:
        f.seek(45)  # a byte of the IDAT chunk's data
        byte = f.read(1)[0]
        f.seek(45)
        f.write(bytes([byte ^ 255]))
    ds = KubricMovifDataset(str(tree), crop_size=(24, 32), seq_len=4, traj_per_sample=4,
                            use_augs=True)
    assert ds.read_in_processes and RepeatedDataset(ds, 2).read_in_processes
    batches = {}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # a hung read fails, in 120 s
        for processes in (True, False):
            ds.read_in_processes = processes
            loader = PrefetchLoader(ds, 1, seed=0, num_workers=1, prefetch=1)
            try:
                assert len(loader._readers) == processes
                batches[processes] = pool.submit(next, loader).result(timeout=120)
                with pytest.raises((RuntimeError, ValueError), match="CRC of its IDAT chunk"):
                    pool.submit(next, loader).result(timeout=120)
            finally:
                loader.close()
            assert not any(t.is_alive() for t in loader._threads)
            assert not any(r.proc.is_alive() for r in loader._readers)
    assert batches[True].keys() == batches[False].keys()
    for k in batches[True]:
        np.testing.assert_array_equal(batches[True][k], batches[False][k])


class _Moving:
    """One 8-frame 32x32 clip of noise with 6 tracks."""

    def __len__(self):
        return 1

    def get(self, ix, rng):
        video, trajs, vis, valids, _ = _batch()
        return Sample(video[0].permute(0, 3, 1, 2).numpy(), trajs[0].numpy(), vis[0].numpy(),
                      valids[0].numpy()), True


@pytest.fixture
def handlers():
    """train() installs the SLURM handlers (SIGUSR1 requeues, SIGTERM is
    ignored): put back the ones the test found, or the worker would go on
    ignoring SIGTERM."""
    found = {sig: signal.getsignal(sig) for sig in (signal.SIGUSR1, signal.SIGTERM)}
    yield
    for sig, handler in found.items():
        signal.signal(sig, handler)


@pytest.fixture
def no_tensorflow(monkeypatch):
    """The TensorBoard writer on tensorboard's own no-TensorFlow stub (its
    `tensorboard.compat.notf` switch): where TensorFlow is installed,
    tensorboard would otherwise import it to write the event files, ~20 s."""
    monkeypatch.setitem(sys.modules, "tensorboard.compat.notf",
                        types.ModuleType("tensorboard.compat.notf"))


def test_trainer_checkpoints_resume_and_hooks(tmp_path, monkeypatch, handlers, no_tensorflow):
    """train() on the CPU (offline model, window 8, iters=1): a checkpoint
    every 2 steps and a final one, auto-resume from the latest step
    checkpoint at its step (a removed step-4 checkpoint makes the second
    call resume at 2 and redo steps 2-3 with the same losses), the hooks on
    their cadences and the SLURM handlers installed. Its entry point: the
    command line's parsing, and training from a Kubric tree with the
    default eval and visualisation hooks. What it cannot run raises before
    a step: no data (no dataset and an empty dataset_root), an eval cadence
    with neither eval_datasets nor a hook, and a visualisation cadence
    without a hook where cv2 is missing (no writer with moviepy: the mp4
    needs it)."""
    args = TrainerArgs(exp_dir=str(tmp_path), num_steps=4, train_iters=1, save_every_n_steps=2,
                       eval_every_n_steps=2, save_vis_every_n_steps=3, num_loader_workers=1,
                       dataset_repeats=1, crop_size=(32, 32), model_window_len=8,
                       use_corr_kernels=True, device="cpu")
    calls = []
    train(args, dataset=_Moving(), eval_hook=lambda m, s: calls.append(("eval", s)) or {"s": s},
          vis_hook=lambda m, b, s: calls.append(("vis", s)))
    assert calls == [("eval", 2), ("vis", 3), ("eval", 4)]
    assert signal.getsignal(signal.SIGTERM) is term_handler
    assert signal.getsignal(signal.SIGUSR1) is sig_handler
    ckpt = tmp_path / "checkpoints"
    assert sorted(os.listdir(ckpt)) == ["model_000000002.pth", "model_000000004.pth",
                                        "model_final.pth"]
    assert find_auto_resume(str(ckpt)).endswith("model_000000004.pth")
    log = [json.loads(line) for line in open(tmp_path / "train_log.jsonl")]
    assert [r["step"] for r in log] == [0, 1, 2, 3]
    assert all(np.isfinite(r["total_loss"]) for r in log)

    os.remove(ckpt / "model_000000004.pth")
    train(args, dataset=_Moving(), eval_hook=lambda m, s: {}, vis_hook=lambda m, b, s: None)
    log2 = [json.loads(line) for line in open(tmp_path / "train_log.jsonl")][4:]
    assert [r["step"] for r in log2] == [2, 3]
    for a, b in zip(log[2:], log2):
        np.testing.assert_allclose(b["total_loss"], a["total_loss"], rtol=1e-5)

    quiet = dataclasses.replace(args, exp_dir=str(tmp_path / "none"), eval_every_n_steps=0,
                                save_vis_every_n_steps=0)
    with pytest.raises(ValueError, match="--dataset_root"):
        train(quiet)
    with pytest.raises(ValueError, match="--eval_datasets or an eval_hook"):
        train(args, dataset=_Moving(), vis_hook=lambda m, b, s: None)
    _command_line_parses_as_jaxs()
    _train_from_a_kubric_tree(tmp_path / "kubric_run")
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        train(args, dataset=_Moving(), eval_hook=lambda m, s: {})
    assert not (tmp_path / "none").exists()
    assert len(open(tmp_path / "train_log.jsonl").readlines()) == 6  # no step ran


def _write_kubric_tree(root, n_seqs=2, T=8, H=64, W=96, n_tracks=64, seed=0):
    """A Kubric MOVi-f tree of PNG frames (write_png, filters mixed by row)
    and tracks uniform in the frame, 10% occluded."""
    rng = np.random.default_rng(seed)
    for s in range(n_seqs):
        name = f"seq{s:03d}"
        os.makedirs(root / name / "frames")
        for t in range(T):
            write_png(str(root / name / "frames" / f"{t:03d}.png"),
                      (rng.random((H, W, 3)) * 255).astype(np.uint8), filters=np.arange(H) % 5)
        coords = (rng.random((n_tracks, T, 2)) * [W - 1, H - 1]).astype(np.float32)
        np.save(root / name / f"{name}.npy",
                {"coords": coords, "visibility": rng.random((n_tracks, T)) > 0.9},
                allow_pickle=True)


def _write_tapvid_pickle(path, T=8, H=64, W=64, N=5, seed=1):
    """A TAP-Vid DAVIS-format pickle with one video of noise and N tracks."""
    rng = np.random.default_rng(seed)
    data = {"clip": {"video": (rng.random((T, H, W, 3)) * 255).astype(np.uint8),
                     "points": rng.random((N, T, 2)).astype(np.float32),
                     "occluded": rng.random((N, T)) > 0.8}}
    data["clip"]["occluded"][:, 0] = False
    with open(path, "wb") as f:
        pickle.dump(data, f)


def _train_from_a_kubric_tree(tmp_path):
    """train() with no dataset reads args.dataset_root through the Kubric
    reader (augmentations on): 2 steps at 48x64, the default eval hook
    (run_test_eval on a TAP-Vid pickle: eval_records.jsonl holds the step's
    metrics) and the default visualisation hook (render_train_batch and an
    mp4 in exp_dir where cv2 imports; here TensorBoard has no moviepy)."""
    tree = tmp_path / "kubric"
    _write_kubric_tree(tree)
    pkl = tmp_path / "davis.pkl"
    _write_tapvid_pickle(pkl)
    exp = tmp_path / "exp"
    args = TrainerArgs(exp_dir=str(exp), dataset_root=str(tree), crop_size=(48, 64), seq_len=8,
                       traj_per_sample=8, num_steps=2, train_iters=1, model_window_len=8,
                       save_every_n_steps=0, eval_every_n_steps=2, save_vis_every_n_steps=2,
                       eval_datasets=f"tapvid_davis_first={pkl}", num_loader_workers=1,
                       dataset_repeats=1, device="cpu")
    model = train(args)
    assert model.training
    log = [json.loads(line) for line in open(exp / "train_log.jsonl")]
    assert [r["step"] for r in log] == [0, 1] and all(np.isfinite(r["total_loss"]) for r in log)
    records = [json.loads(line) for line in open(exp / "eval_records.jsonl")]
    assert [r["step"] for r in records] == [2]
    avg = records[0]["results"]["tapvid_davis_first"]
    assert {"average_jaccard", "average_pts_within_thresh", "occlusion_accuracy"} <= set(avg)
    assert os.path.exists(exp / "result_tapvid_davis_first.json")
    if importlib.util.find_spec("cv2") is not None:
        assert os.path.getsize(exp / "train_step_2.mp4") > 0


def _command_line_parses_as_jaxs():
    """The command line is TrainerArgs' fields as the JAX trainer parses
    them: a bool with default True is a flag that turns it off, one with
    default False a flag that turns it on; crop_size is not a flag; main()
    trains on what it parsed (an empty --dataset_root raises there)."""
    args = parse_args(["--dataset_root", "/data/kubric", "--use_augs", "--evaluate_at_start",
                       "--use_corr_kernels", "--num_steps", "7", "--lr", "0.001",
                       "--eval_datasets", "tapvid_davis_first=a.pkl", "--device", "cpu"])
    assert args == TrainerArgs(dataset_root="/data/kubric", use_augs=False,
                               evaluate_at_start=True, use_corr_kernels=False, num_steps=7,
                               lr=0.001, eval_datasets="tapvid_davis_first=a.pkl", device="cpu")
    assert parse_args([]) == TrainerArgs()
    with pytest.raises(SystemExit):
        parse_args(["--crop_size", "64"])
    with pytest.raises(ValueError, match="--dataset_root"):
        main(["--device", "cpu"])
