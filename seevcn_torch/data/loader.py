"""A background batch loader: host batch preparation on worker threads,
overlapped with the device's steps (port of seevcn_tpu/data/loader.py; the
reference has torch DataLoader worker processes).

The same worker threads, order and seed as the JAX package's: a batch's
frames are ``dataset[i]`` for the shuffled indices, stacked by key, and
handed out in order, with at most ``prefetch`` assembled batches held. A
worker's error reaches the consumer. Given a ``device``, each worker
uploads its batch as tensors: on a CUDA device through pinned memory with
non-blocking copies on the device's current stream, which the consumer's
work then follows.

Across the ranks of a data-parallel group (``rank``, ``world``) the batch
size is the global batch's: every rank shuffles with the same seed and
assembles only its block of each global batch's frames (rows [r B / W,
(r + 1) B / W)), the rows ``parallel.mesh.shard_batch`` takes.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch


def upload(batch: dict, device) -> dict:
    """A dict of numpy arrays -> tensors on ``device`` (pinned host memory
    and non-blocking copies to a CUDA device)."""
    dev = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        out[k] = t.to(dev)
    return out


class BackgroundLoader:
    """Iterate fixed-shape batches assembled on worker threads. ``dataset``
    is indexable and returns per-frame dicts of numpy arrays; batches are
    numpy, or tensors on ``device`` when one is given. ``batch_size`` is the
    global batch, which must divide by ``world``; this rank's batches hold
    its ``batch_size / world`` rows of each."""

    def __init__(self, dataset, batch_size: int,
                 keys=("points", "points_valid", "gt_boxes", "gt_mask"),
                 shuffle: bool = True, prefetch: int = 2, num_workers: int = 2,
                 seed: int = 0, drop_last: bool = True, device=None, rank: int = 0,
                 world: int = 1):
        if batch_size % world or (world > 1 and not drop_last):
            raise ValueError(f"a global batch of {batch_size} (drop_last={drop_last}) does "
                             f"not divide over {world} ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.keys = keys
        self.shuffle = shuffle
        self.prefetch = prefetch
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.device = device
        self.rank, self.world = rank, world
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        starts = list(range(0, len(order) - (self.batch_size - 1 if self.drop_last else 0),
                            self.batch_size))
        jobs = queue.Queue()
        out = {}
        done = threading.Event()
        # backpressure: a worker holding batch bi waits until bi < next +
        # prefetch; jobs are taken in order, so the worker holding the next
        # batch always fits the window and the consumer cannot starve
        cv = threading.Condition()
        state = {"next": 0, "errors": []}
        window = max(1, self.prefetch)
        n = self.batch_size // self.world
        for bi, s in enumerate(starts):
            rows = order[s:s + self.batch_size]
            jobs.put((bi, rows[self.rank * n:(self.rank + 1) * n]))

        def worker():
            while not done.is_set():
                try:
                    bi, idx = jobs.get_nowait()
                except queue.Empty:
                    return
                with cv:
                    while bi >= state["next"] + window and not done.is_set():
                        cv.wait(timeout=0.1)
                if done.is_set():
                    return
                try:
                    frames = [self.dataset[int(i)] for i in idx]
                    batch = {k: np.stack([f[k] for f in frames])
                             for k in self.keys if k in frames[0]}
                    if self.device is not None:
                        batch = upload(batch, self.device)
                except Exception as e:  # handed to the consumer
                    with cv:
                        state["errors"].append(e)
                        cv.notify_all()
                    return
                with cv:
                    out[bi] = batch
                    cv.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for bi in range(len(starts)):
                with cv:
                    while bi not in out:
                        if state["errors"]:
                            raise state["errors"][0]
                        if not any(t.is_alive() for t in threads):
                            raise RuntimeError("loader workers died")
                        cv.wait(timeout=0.1)
                    batch = out.pop(bi)
                    state["next"] = bi + 1
                    cv.notify_all()
                yield batch
        finally:
            done.set()
            with cv:
                cv.notify_all()
