r"""Host-side input pipeline: threaded batch assembly and copies to the device.

``BatchLoader`` is the JAX package's: numpy batches stacked from dataset
items that a thread pool fetches (numpy releases the interpreter lock), with
the same seeded shuffle, ``drop_last`` and uint8 quantisation.
``device_prefetch`` copies each batch into pinned host memory and from there
to the device without blocking, ``depth`` batches ahead of the consumer.
"""
import collections
import concurrent.futures as cf

import numpy as np
import torch


class BatchLoader:
    r"""Iterable over stacked numpy batches: ``{'frames': [b, t, h, w, c],
    'actions': [b, t, a], 'origin': [...]}``.

    ``uint8_frames``: quantise [0, 1]-range frames to uint8 for the copy to
    the device (a quarter of the bytes; the train step dequantises them);
    the rounding error is at most 1/510.
    """

    def __init__(self, dataset, batch_size, shuffle=False, seed=0, num_workers=4,
                 drop_last=False, uint8_frames=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.uint8_frames = uint8_frames

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        return idx

    def _stack(self, items):
        frames = np.stack([np.asarray(it["frames"]) for it in items], axis=0)
        if self.uint8_frames and frames.dtype != np.uint8:
            frames = np.clip(np.rint(frames * 255.0), 0, 255).astype(np.uint8)
        actions = np.stack([np.asarray(it["actions"]) for it in items], axis=0)
        origins = [it.get("origin", "") for it in items]
        return {"frames": frames, "actions": actions, "origin": origins}

    def __iter__(self):
        idx = self._indices()
        n = len(idx)
        batch_starts = range(0, n - self.batch_size + 1, self.batch_size) if self.drop_last \
            else range(0, n, self.batch_size)
        if self.num_workers <= 1:
            for s in batch_starts:
                items = [self.dataset[int(i)] for i in idx[s:s + self.batch_size]]
                yield self._stack(items)
            return
        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = collections.deque()
            starts = list(batch_starts)
            depth = 2  # batches in flight

            def submit(s):
                ids = [int(i) for i in idx[s:s + self.batch_size]]
                return [pool.submit(self.dataset.__getitem__, i) for i in ids]

            si = 0
            while si < len(starts) and len(pending) < depth:
                pending.append(submit(starts[si]))
                si += 1
            while pending:
                futs = pending.popleft()
                if si < len(starts):
                    pending.append(submit(starts[si]))
                    si += 1
                yield self._stack([f.result() for f in futs])


def device_prefetch(iterator, device, depth=2):
    r"""Yields the numpy batches of ``iterator`` as tensors on ``device``,
    with ``depth`` batches copied ahead of the one being consumed. On a CUDA
    device each array is copied from pinned host memory without blocking the
    host; entries that are not arrays (``origin``) are dropped."""
    device = torch.device(device)

    def put(batch):
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                t = torch.from_numpy(v)
                out[k] = t.pin_memory().to(device, non_blocking=True) \
                    if device.type == "cuda" else t.to(device)
        return out

    queue = collections.deque()
    it = iter(iterator)
    try:
        for _ in range(depth):
            queue.append(put(next(it)))
    except StopIteration:
        pass
    while queue:
        batch = queue.popleft()
        try:
            queue.append(put(next(it)))
        except StopIteration:
            pass
        yield batch
