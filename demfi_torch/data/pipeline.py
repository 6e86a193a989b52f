"""Host-side input pipeline: threaded decode and augment for training,
batches copied to the device ahead of the step, and an ordered
prefetching iterator over an evaluation dataset.

Worker threads (PNG decode releases the interpreter lock in cv2 and in
zlib) fill a bounded queue of samples; batches come out in order, NHWC
numpy. ``device_prefetch`` keeps ``depth`` batches in flight to the
device from pinned host memory. ``iter_eval`` loads an EvalDataset's
samples in order on a thread, ``prefetch`` ahead of the consumer.
"""
from __future__ import annotations

import collections
import queue
import random
import threading
from typing import Iterator, Tuple

import numpy as np
import torch

from demfi_torch.data.datasets import AdobeTrainDataset, EvalDataset


class TrainLoader:
    """Shuffled, batched, prefetching loader over AdobeTrainDataset.

    One epoch is one random sample per scene (the reference's
    ``__len__`` is the number of scenes), reshuffled every epoch. The
    shuffle of epoch e is ``random.Random(seed * 1_000_003 + e)``, and
    each sample draws from a Random seeded with the next 48 bits of that
    generator: the JAX package's loader, batch for batch.
    """

    def __init__(self, dataset: AdobeTrainDataset, batch_size: int,
                 num_threads: int = 8, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 4, process_id: int = 0,
                 process_count: int = 1):
        """``batch_size`` is the global batch. With process_count > 1
        every process draws the same seeded shuffle and the per-sample
        seeds for the whole global order, then loads only its
        batch_size / process_count slice of each global batch: the
        processes' slices, put together, are the one-process stream."""
        if process_count > 1:
            if batch_size % process_count:
                raise ValueError(f"global batch {batch_size} not divisible "
                                 f"by {process_count} processes")
            if not drop_last:
                raise ValueError("multi-process loading requires drop_last")
        self.ds = dataset
        self.batch_size = batch_size
        self.num_threads = max(1, num_threads)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.process_id = process_id
        self.process_count = process_count

    def __len__(self) -> int:
        n = len(self.ds)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def epoch(self, epoch_idx: int
              ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yields (frames [B,9,ps,ps,3], t [B,1]) float32, B this
        process's share of the global batch."""
        rng = random.Random(self.seed * 1_000_003 + epoch_idx)
        order = list(range(len(self.ds)))
        rng.shuffle(order)
        if self.drop_last:
            order = order[:len(self) * self.batch_size]
        seeds = [rng.getrandbits(48) for _ in range(len(order))]
        local_bs = self.batch_size // self.process_count
        if self.process_count > 1:
            mine = [k * self.batch_size + self.process_id * local_bs + j
                    for k in range(len(self)) for j in range(local_bs)]
            order = [order[i] for i in mine]
            seeds = [seeds[i] for i in mine]

        samples: "queue.Queue" = queue.Queue(
            maxsize=self.prefetch * local_bs)
        stop = threading.Event()
        pos = iter(range(len(order)))
        lock = threading.Lock()

        def worker():
            while not stop.is_set():
                with lock:
                    i = next(pos, None)
                if i is None:
                    return
                try:
                    item = (i, self.ds.sample(order[i], random.Random(seeds[i])))
                except Exception as e:   # handed to the consumer, raised there
                    item = (i, e)
                while not stop.is_set():
                    try:
                        samples.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        pass

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_threads)]
        for t in threads:
            t.start()
        try:
            buf = {}
            emitted = 0
            total = len(order)
            while emitted < total:
                i, s = samples.get()
                if isinstance(s, Exception):
                    raise s
                buf[i] = s
                bs = min(local_bs, total - emitted)
                while bs and all(emitted + j in buf for j in range(bs)):
                    batch = [buf.pop(emitted + j) for j in range(bs)]
                    emitted += bs
                    yield (np.stack([x.frames for x in batch]),
                           np.stack([x.t_value for x in batch]))
                    bs = min(local_bs, total - emitted)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10)


def device_prefetch(iterator, device, depth: int = 2):
    """Overlap host-to-device copies with compute: each numpy batch
    (a tuple of arrays) goes to ``device`` through pinned host memory
    with ``non_blocking=True``, ``depth`` batches ahead of the one
    yielded. On the CPU the arrays are wrapped, not copied."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def put(batch):
        out = []
        for a in batch:
            t = torch.from_numpy(np.ascontiguousarray(a))
            if pin:
                t = t.pin_memory().to(device, non_blocking=True)
            out.append(t)
        return tuple(out)

    buf = collections.deque()
    for batch in iterator:
        buf.append(put(batch))
        if len(buf) > depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def iter_eval(dataset: EvalDataset, prefetch: int = 2) -> Iterator[dict]:
    """``dataset.load(i)`` for i = 0, 1, ... in order, loaded on one
    thread through a queue of ``prefetch`` samples. An exception of a
    load is raised here, at its place in the order."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        for i in range(len(dataset)):
            try:
                item = dataset.load(i)
            except Exception as e:      # handed to the consumer, raised there
                put(e)
                return
            if not put(item):
                return
        put(None)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=10)
