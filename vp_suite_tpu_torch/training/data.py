r"""Host-side input pipeline: threaded batch assembly and copies to the device.

``BatchLoader`` is the JAX package's: numpy batches stacked from dataset
items that a thread pool fetches (numpy releases the interpreter lock), with
the same seeded shuffle, ``drop_last`` and uint8 quantisation.
``device_prefetch`` copies each batch into pinned host memory and from there
to the device without blocking, ``depth`` batches ahead of the consumer.
``HBMCachedLoader`` stages a whole file-backed dataset in device memory once
and serves each batch by a gather on the device.
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


def estimate_cache_bytes(dataset, uint8_frames: bool) -> int:
    r"""Device memory that :class:`HBMCachedLoader` takes for ``dataset``,
    reckoned from its first item (``set_seq_len`` makes every item alike)."""
    item = dataset[0]
    frames = np.asarray(item["frames"])
    actions = np.asarray(item["actions"])
    frame_bytes = frames.size * (1 if uint8_frames else frames.dtype.itemsize)
    return len(dataset) * (frame_bytes + actions.nbytes)


class HBMCachedLoader:
    r"""A small file-backed dataset held in the device's memory (the JAX
    package's name; here the card's HBM).

    Every item is read once, by the same thread pool as :class:`BatchLoader`;
    the frames are stacked and quantised to uint8 exactly as ``BatchLoader``'s
    ``uint8_frames`` path does it (the train step dequantises them), the
    actions are stacked, and both are copied to ``device`` once. Each batch is
    then an ``index_select`` on the device: per step the host sends only the
    ``[b]`` indices, and epochs after the first never read a file.
    """

    def __init__(self, dataset, batch_size, device, *, uint8_frames=True, drop_last=True,
                 num_workers=4):
        n = len(dataset)
        with cf.ThreadPoolExecutor(max_workers=num_workers) as pool:
            items = list(pool.map(dataset.__getitem__, range(n)))
        frames = np.stack([np.asarray(it["frames"]) for it in items], axis=0)
        if uint8_frames and frames.dtype != np.uint8:
            frames = np.clip(np.rint(frames * 255.0), 0, 255).astype(np.uint8)
        actions = np.stack([np.asarray(it["actions"]) for it in items], axis=0)
        self.device = torch.device(device)
        self._frames = torch.from_numpy(frames).to(self.device)
        self._actions = torch.from_numpy(actions).to(self.device)
        self.nbytes = frames.nbytes + actions.nbytes
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.n = n

    def __len__(self):
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def epoch_order(self, seed, shuffle=True) -> np.ndarray:
        r"""The epoch's item order: ``np.random.default_rng(seed).shuffle``
        of ``arange(n)``, as the JAX package draws it."""
        idx = np.arange(self.n)
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        return idx

    def epoch_iterator(self, seed, shuffle=True):
        r"""Yields one epoch's ``{"frames", "actions"}`` batches, gathered on
        the device in :meth:`epoch_order`."""
        idx = self.epoch_order(seed, shuffle)
        stop = self.n - self.batch_size + 1 if self.drop_last else self.n
        for s in range(0, stop, self.batch_size):
            ids = torch.from_numpy(np.ascontiguousarray(idx[s:s + self.batch_size]))
            if self.device.type == "cuda":
                ids = ids.pin_memory().to(self.device, non_blocking=True)
            yield {"frames": self._frames.index_select(0, ids),
                   "actions": self._actions.index_select(0, ids)}


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
