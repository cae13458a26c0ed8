"""Batch loader and device prefetch.

Port of ``bayer_low_light_image_enhancement_tpu/data/pipeline.py``: a
thread-pool loader (numpy decode/augment releases the GIL) that yields
shuffled, collated numpy batches, and ``prefetch_to_device``, which stages
the host-to-device copy of the next batches while the card runs the current
step: pinned host memory, copies issued on a side CUDA stream, and the
consuming stream made to wait on each batch's copy (``record_stream`` keeps
the caching allocator from reusing a batch's memory too early).
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Tuple

import numpy as np
import torch


class Loader:
    """Iterates shuffled, collated batches from a dataset with ``sample()``.

    Dataset protocol: ``__len__`` and ``sample(idx, rng) -> tuple of arrays``.
    Yields tuples of stacked numpy arrays [B, ...]. Sample ``k`` of batch
    ``bi`` in epoch ``e`` draws from ``default_rng((seed, e, 0xA5, idx,
    bi))``, as the JAX package's loader."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True, num_threads: int = 8, prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.prefetch = prefetch
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self, epoch: int):
        n = len(self.dataset)
        rng = np.random.default_rng((self.seed, epoch))
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        end = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for i in range(0, end, self.batch_size):
            yield order[i : i + self.batch_size]

    def __iter__(self) -> Iterator:
        epoch = self._epoch
        self._epoch += 1
        sample_seed = (self.seed, epoch, 0xA5)

        def load_one(idx: int, k: int):
            rng = np.random.default_rng((*sample_seed, int(idx), k))
            return self.dataset.sample(int(idx), rng)

        batch_indices = list(self._batches(epoch))
        if not batch_indices:
            return iter(())
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for bi, idxs in enumerate(batch_indices):
                        if stop.is_set():
                            return
                        samples = list(pool.map(lambda i: load_one(i, bi), idxs))
                        out_q.put(tuple(np.stack([s[j] for s in samples])
                                        for j in range(len(samples[0]))))
            finally:
                out_q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()

        def gen():
            try:
                while True:
                    item = out_q.get()
                    if item is None:
                        return
                    yield item
            finally:
                stop.set()
                while thread.is_alive():  # drain so the producer can exit
                    try:
                        out_q.get_nowait()
                    except queue.Empty:
                        thread.join(timeout=0.1)

        return gen()


def to_tensor(a: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor; uint16 travels as its int16 bits (few torch ops
    take uint16) and comes back as a uint16 view."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.uint16)
    return torch.from_numpy(a)


def _copy(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    if t.dtype == torch.uint16:
        return t.view(torch.int16).to(device, non_blocking=True).view(torch.uint16)
    return t.to(device, non_blocking=True)


def _pinned(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.uint16:
        return t.view(torch.int16).pin_memory().view(torch.uint16)
    return t.pin_memory()


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> tensor on ``device`` (uint16 moved as its int16 bits)."""
    return _copy(to_tensor(a), torch.device(device))


def prefetch_to_device(iterator: Iterable, device="cuda", size: int = 2
                       ) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Yield each numpy batch of ``iterator`` as a tuple of tensors on
    ``device``, with up to ``size`` batches in flight. On a CUDA device the
    copies run from pinned memory on a side stream; on the CPU the arrays
    are only wrapped."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield tuple(to_tensor(a) for a in batch)
        return
    copy_stream = torch.cuda.Stream(device)
    staged: "collections.deque" = collections.deque()
    it = iter(iterator)

    def stage() -> bool:
        try:
            batch = next(it)
        except StopIteration:
            return False
        host = [_pinned(to_tensor(a)) for a in batch]
        with torch.cuda.stream(copy_stream):
            dev = [_copy(h, device) for h in host]
            done = torch.cuda.Event()
            done.record(copy_stream)
        staged.append((dev, host, done))  # host buffers live until the copy is consumed
        return True

    for _ in range(max(1, size)):
        if not stage():
            break
    while staged:
        dev, _, done = staged.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for t in dev:
            t.record_stream(consumer)
        stage()
        yield tuple(dev)
