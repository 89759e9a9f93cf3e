"""Prefetching, host-sharded data loader and the host-to-card transfer
(port of `devias_tpu/data/loader.py`).

The host side is the JAX package's: each process loads its shard of the
global batch with a thread pool (cv2 and PIL release the GIL) and a bounded
prefetch queue, with DistributedSampler's sharding (pad by wrapping for
training, uneven contiguous shards for evaluation, ref
run_slot_finetuning.py:279-335).

The device side, `device_prefetch`, replaces `jax.device_put`: a background
thread copies each host batch into pinned memory and issues `non_blocking`
copies to the card on a side CUDA stream, then records an event; the
consumer makes the current stream wait on that event before it hands the
batch on, so the step never reads a batch still in flight. At most `size`
batches are in flight. On the CPU it is a plain copy into tensors.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch


def shard_indices(
    n: int, shard: int, num_shards: int, shuffle: bool, seed: int, epoch: int,
    pad: bool = True,
) -> np.ndarray:
    order = np.arange(n)
    if shuffle:
        order = np.random.default_rng(seed + epoch).permutation(n)
    if pad:
        total = -(-n // num_shards) * num_shards
        if total > n:
            order = np.concatenate([order, order[: total - n]])
    return order[shard::num_shards]


def _collate(samples):
    """Stack dict records; flatten repeated-augmentation samples
    (ref utils/utils.py:551-573 multiple_samples_collate)."""
    out = {}
    repeated = bool(samples[0].get("repeated", False))
    for k in samples[0]:
        if k == "repeated":
            continue
        vals = [s[k] for s in samples]
        if isinstance(vals[0], str):
            out[k] = vals
        elif repeated and k in ("videos", "labels", "scene_labels"):
            out[k] = np.concatenate([np.asarray(v) for v in vals], axis=0)
        else:
            out[k] = np.stack([np.asarray(v) for v in vals])
    return out


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 8,
        prefetch: int = 4,
        seed: int = 0,
        shard: int = 0,
        num_shards: int = 1,
        pad_shards: Optional[bool] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch
        self.seed = seed
        self.shard = shard
        self.num_shards = num_shards
        self.pad_shards = shuffle if pad_shards is None else pad_shards
        self.epoch = 0
        self._pool: Optional[ThreadPoolExecutor] = None

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        # propagate to the dataset's deterministic per-(epoch, index)
        # augmentation rng (datasets.py DataConfig.aug_seed)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        n = len(shard_indices(len(self.dataset), self.shard, self.num_shards, False, 0, 0, self.pad_shards))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def close(self):
        """Shut the worker pool down (a new iteration starts another)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def __iter__(self) -> Iterator[dict]:
        idx = shard_indices(
            len(self.dataset), self.shard, self.num_shards,
            self.shuffle, self.seed, self.epoch, self.pad_shards,
        )
        nb = len(idx) // self.batch_size if self.drop_last else -(-len(idx) // self.batch_size)
        batches = [idx[i * self.batch_size : (i + 1) * self.batch_size] for i in range(nb)]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        # one worker pool for the loader's lifetime: epoch boundaries reuse
        # it instead of respawning worker threads each __iter__
        if self._pool is None:
            self._pool = ThreadPoolExecutor(self.num_workers, thread_name_prefix="loader-worker")
        pool = self._pool

        def produce():
            # submit per-sample fetches, collate in order
            futures = [[pool.submit(self.dataset.__getitem__, int(i)) for i in b] for b in batches]
            for fb in futures:
                if stop.is_set():
                    for f in fb:
                        f.cancel()
                    continue
                try:
                    q.put(_collate([f.result() for f in fb]))
                except Exception as exc:  # propagate to consumer
                    q.put(exc)
                    break
            q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the producer can exit
            while True:
                try:
                    if q.get_nowait() is None:
                        break
                except queue.Empty:
                    break


def _to_tensors(batch: dict, device: torch.device, pin: bool) -> dict:
    """Numeric leaves as tensors on `device` (through pinned memory and
    `non_blocking` copies for a card); strings stay lists."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, np.generic)):
            t = torch.from_numpy(np.ascontiguousarray(v))
            if pin:
                t = t.pin_memory().to(device, non_blocking=True)
            else:
                t = t.clone()
            out[k] = t
        else:
            out[k] = v
    return out


def device_prefetch(iterator, device: torch.device, size: int = 2):
    """Yield the host batches of `iterator` as tensors on `device`, in
    order, with up to `size` batches copied ahead of the consumer (module
    docstring). An error of the iterator reaches the consumer after the
    batches before it."""
    device = torch.device(device)
    if device.type == "cpu":
        for batch in iterator:
            yield _to_tensors(batch, device, pin=False)
        return
    if device.type != "cuda":
        raise ValueError(f"no transfer path to {device}")
    side = torch.cuda.Stream(device=device)
    q: queue.Queue = queue.Queue(maxsize=max(size, 1))
    stop = threading.Event()
    end = object()

    def offer(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def transfer():
        try:
            with torch.cuda.device(device), torch.cuda.stream(side):
                for batch in iterator:
                    if stop.is_set():
                        return
                    moved = _to_tensors(batch, device, pin=True)
                    event = torch.cuda.Event()
                    event.record(side)
                    if not offer((moved, event)):
                        return
        except BaseException as exc:  # reaches the consumer in order
            offer(exc)
            return
        offer(end)

    thread = threading.Thread(target=transfer, daemon=True, name="device-prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            moved, event = item
            current = torch.cuda.current_stream(device)
            current.wait_event(event)
            for t in moved.values():
                if isinstance(t, torch.Tensor):
                    # the side stream allocated it: keep its memory until
                    # the consumer's work on it is done
                    t.record_stream(current)
            yield moved
    finally:
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        thread.join(timeout=5.0)
