"""Prefetching training-data loader (port of cotracker_tpu/training/data_loader.py).

Worker threads draw samples and collate batches into a bounded queue ahead
of the training step. Three differences from the JAX package's loader, all
repairs: each worker draws its randomness from a generator of its own,
seeded from the trainer's seed (the JAX loader's threads share one
generator), a batch of clips of different lengths is padded to the
longest with `valids` 0 instead of stacked bare, and a dataset can be read
in worker processes (below).

A dataset for this loader has `__len__` and `get(index, rng)` ->
(Sample, ok): `rng` is the calling worker's numpy Generator, for the
dataset's augmentations; a sample with ok False is skipped. A dataset whose
reads are long runs of numpy calls on files (the Kubric reader's PNG
decoding and augmentations) sets `read_in_processes = True`: each worker
thread then hands its reads to a process of its own, which holds the
dataset and the worker's Generator. In a thread, such a read takes and
gives back the interpreter lock thousands of times a sample, and slows the
training step's launch loop, which needs the lock after every launch; the
reference trains from a DataLoader of worker processes too.
"""

import multiprocessing
import os
import pickle
import queue
import signal
import socket
import threading
import traceback
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

    @property
    def read_in_processes(self):
        return getattr(self.base, "read_in_processes", False)


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


def _contiguous(out):
    """(sample, ok) with the sample's arrays C-contiguous, so that pickle
    protocol 5 hands them over out of band (a reader's transposed video is
    not)."""
    if isinstance(out, tuple) and len(out) == 2 and isinstance(out[0], tuple):
        s = out[0]
        arrays = (np.ascontiguousarray(a) if isinstance(a, np.ndarray) else a for a in s)
        return (type(s)(*arrays) if hasattr(s, "_fields") else tuple(arrays)), out[1]
    return out


def _read_loop(conn, dataset, seed):
    """A reading process: `dataset.get(index, rng)` for each index received,
    rng its worker's Generator, until None (or the loader's end of the pipe
    closes). Sends (Sample, ok), or the failure's traceback as a string:
    the pickle without its arrays, then each array's bytes on the socket
    (`_ProcessReader.get` reads them straight into its arrays). Its torch
    ops (the augmentations' blur and resize) run on one thread: torch's
    default, a thread a core in every reader, would crowd out the training
    process's launch loop."""
    import torch

    signal.signal(signal.SIGINT, signal.SIG_IGN)  # the training process stops it
    torch.set_num_threads(1)
    sock = socket.socket(fileno=os.dup(conn.fileno()))
    rng = np.random.default_rng(seed)
    while True:
        try:
            ix = conn.recv()
        except (EOFError, OSError):  # the loader's end closed
            return
        if ix is None:
            return
        try:
            out = _contiguous(dataset.get(ix, rng))
        except Exception:  # sent to the worker thread, which raises it
            out = traceback.format_exc()
        buffers = []
        meta = pickle.dumps(out, protocol=5, buffer_callback=buffers.append)
        raws = [b.raw() for b in buffers]
        try:
            conn.send((meta, [r.nbytes for r in raws]))
            for r in raws:
                sock.sendall(r)
        except OSError:  # the loader closed while this sample was read
            return


class _ProcessReader:
    """One worker's reading process (spawned: no state of the training
    process is inherited) and its end of the pipe (a socket pair).
    A sample's arrays arrive by one socket read each, the interpreter lock
    released, into arrays allocated for them: the training process copies
    nothing of a sample while holding the lock."""

    def __init__(self, dataset, seed):
        ctx = multiprocessing.get_context("spawn")
        self.conn, child = ctx.Pipe()
        self.sock = socket.socket(fileno=os.dup(self.conn.fileno()))
        self.proc = ctx.Process(target=_read_loop, args=(child, dataset, seed), daemon=True)
        self.proc.start()
        child.close()

    def _recv_into(self, buf):
        view = memoryview(buf)
        while view.nbytes:
            n = self.sock.recv_into(view, view.nbytes, socket.MSG_WAITALL)
            if n == 0:
                raise EOFError("the reading process closed its end")
            view = view[n:]

    def get(self, ix):
        try:
            self.conn.send(ix)
            meta, sizes = self.conn.recv()
            buffers = [np.empty(n, np.uint8) for n in sizes]
            for b in buffers:
                self._recv_into(b)
        except (EOFError, OSError) as e:
            self.proc.join(1.0)
            raise RuntimeError(f"a loader process ended (exit code {self.proc.exitcode}) "
                               f"while reading sample {ix}") from e
        out = pickle.loads(meta, buffers=buffers)
        if isinstance(out, str):
            raise RuntimeError(f"a loader process failed to read sample {ix}:\n{out}")
        return out

    def close(self):
        try:
            self.conn.send(None)
        except OSError:
            pass
        self.sock.close()
        self.conn.close()
        self.proc.join(5.0)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join()


class PrefetchLoader:
    """Infinite shuffled batch iterator with worker-thread prefetch.

    The shuffle order comes from one generator seeded `seed`, under a lock;
    worker w draws its samples' randomness from its own generator, seeded
    (seed, w + 1). Failed samples are skipped. A worker's exception is
    raised by the next `next()`. Where the dataset's `read_in_processes`
    is true, each worker reads in a spawned process of its own, from the
    same generator, so the samples are those of the threads. Call close()
    to stop the workers and their processes."""

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
        processes = getattr(dataset, "read_in_processes", False)
        seeds = [[seed, w + 1] for w in range(max(1, num_workers))]
        self._readers = [_ProcessReader(dataset, sd) for sd in seeds] if processes else []
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             args=(self._readers[w].get if processes else self._reader(sd),))
            for w, sd in enumerate(seeds)
        ]
        for t in self._threads:
            t.start()

    def _reader(self, seed):
        """get(index) in the worker's thread, from the worker's generator."""
        rng = np.random.default_rng(seed)
        return lambda ix: self.dataset.get(ix, rng)

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

    def _worker(self, read):
        try:
            while not self._stop.is_set():
                samples = []
                while len(samples) < self.batch_size:
                    s, ok = read(self._next_index())
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
        then join each (a worker inside a slow `get` gets 5 s), then end
        the reading processes (5 s each, then SIGTERM)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        for t in self._threads:
            t.join(5.0)
        for r in self._readers:
            r.close()
