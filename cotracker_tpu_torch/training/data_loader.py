"""Prefetching training-data loader (port of cotracker_tpu/training/data_loader.py).

Worker threads draw samples and collate batches into a bounded queue ahead
of the training step. Two differences from the JAX package's loader, both
repairs: each worker draws its randomness from a generator of its own,
seeded from the trainer's seed (the JAX loader's threads share one
generator), and a batch of clips of different lengths is padded to the
longest with `valids` 0 instead of stacked bare.

A dataset for this loader has `__len__` and `get(index, rng)` ->
(Sample, ok): `rng` is the calling worker's numpy Generator, for the
dataset's augmentations; a sample with ok False is skipped.
"""

import queue
import threading
from typing import NamedTuple

import numpy as np


class Sample(NamedTuple):
    """One training clip: video (T, 3, H, W) in [0, 255]; trajectory
    (T, N, 2) pixels; visibility and valid (T, N) in {0, 1}."""

    video: np.ndarray
    trajectory: np.ndarray
    visibility: np.ndarray
    valid: np.ndarray


class RepeatedDataset:
    """len = repeats * len(base), each index served by base[index % len]:
    widens the shuffle epoch so augmentations draw anew on every visit."""

    def __init__(self, base, repeats: int = 4):
        self.base = base
        self.repeats = repeats

    def __len__(self):
        return len(self.base) * self.repeats

    def get(self, ix, rng):
        return self.base.get(ix % len(self.base), rng)


def _pad_time(x, T, fill=None):
    """x (t, ...) -> (T, ...): the last frame repeated, or `fill` values."""
    if x.shape[0] == T:
        return x
    tail = np.repeat(x[-1:], T - x.shape[0], axis=0) if fill is None else np.full(
        (T - x.shape[0],) + x.shape[1:], fill, x.dtype)
    return np.concatenate([x, tail], axis=0)


def collate_batch(samples):
    """Samples -> the train-step batch dict (channel-last video). Clips
    shorter than the longest are padded: the last frame repeated for video
    and trajectory, visibility and valids 0, so no loss term counts them."""
    T = max(s.video.shape[0] for s in samples)
    return {
        "video": np.stack([_pad_time(s.video, T).transpose(0, 2, 3, 1) for s in samples]),
        "trajs_g": np.stack([_pad_time(s.trajectory, T) for s in samples]),
        "vis_g": np.stack([_pad_time(s.visibility, T, 0) for s in samples]).astype(np.float32),
        "valids": np.stack([_pad_time(s.valid, T, 0) for s in samples]).astype(np.float32),
    }


class PrefetchLoader:
    """Infinite shuffled batch iterator with worker-thread prefetch.

    The shuffle order comes from one generator seeded `seed`, under a lock;
    worker w draws its samples' randomness from its own generator, seeded
    (seed, w + 1). Failed samples are skipped. A worker's exception is
    raised by the next `next()`. Call close() to stop the workers."""

    def __init__(self, dataset, batch_size: int, seed: int, num_workers: int = 4,
                 prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self._order_rng = np.random.default_rng(seed)
        self._order = self._order_rng.permutation(len(dataset))
        self._pos = 0
        self._ix_lock = threading.Lock()
        self._q = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._worker, args=(np.random.default_rng([seed, w + 1]),),
                             daemon=True)
            for w in range(max(1, num_workers))
        ]
        for t in self._threads:
            t.start()

    def _next_index(self):
        with self._ix_lock:
            if self._pos >= len(self._order):
                self._order = self._order_rng.permutation(len(self.dataset))
                self._pos = 0
            ix = int(self._order[self._pos])
            self._pos += 1
            return ix

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.25)
                return
            except queue.Full:
                continue

    def _worker(self, rng):
        try:
            while not self._stop.is_set():
                samples = []
                while len(samples) < self.batch_size:
                    s, ok = self.dataset.get(self._next_index(), rng)
                    if ok:
                        samples.append(s)
                self._put(collate_batch(samples))
        except Exception as e:  # handed to the consumer, which raises it
            self._put(e)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        """Stop the workers: drain the queue so none blocks on a full one,
        then join each (a worker inside a slow `get` gets 5 s)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        for t in self._threads:
            t.join(5.0)
