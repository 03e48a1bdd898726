"""Host -> device feed: `DevicePrefetcher`, the counterpart of
shmgan_tpu/data/pipeline.py's, rebuilt for CUDA.

A worker thread takes each numpy batch from the wrapped iterator, copies it
into a pinned host buffer and from there, with `non_blocking=True`, into a
fresh device tensor on a side `torch.cuda.Stream`, and records an event after
the copy. The consumer makes its current stream wait on that event before it
hands the tensor out, and calls `record_stream` on it, so the caching
allocator does not give the tensor's memory back to the side stream while the
consumer's stream may still read it. The pinned buffers form a ring; the
worker waits on a buffer's last copy event before it overwrites it. So the
copy of batch n+1 overlaps the step on batch n, and no step reads a batch
whose copy has not finished.

On the CPU it is the same queue and worker, without streams: each batch is
handed out as `torch.from_numpy` of it.

An exception in the worker (the dataset's, or the copy's) is raised in the
consumer, in place of the next batch.

Under data parallelism (parallel/mesh.py) each rank feeds only its block of
every global batch to its own card (`rank_feed`), the counterpart of
`put_global_batch`: no rank loads or copies the whole batch. `local_batch`
cuts the same block out of a batch every rank made whole (the on-card
renders of the flagship trainer's phase B). On a spatial layout
(parallel/spatial.py) each rank of a model row feeds its band of rows of
that block (`local_band`), the counterpart of `shard_batch(spatial=True)`.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, List, Optional

import numpy as np
import torch

from shmgan_tpu_torch.parallel.mesh import rank, world_size


def _check_divides(batch: int, processes: int) -> None:
    if batch % processes != 0:
        raise ValueError(f"global batch {batch} not divisible by {processes} processes")


def local_batch(batch, rank_index: int, processes: int, axis: int = 1):
    """Block rank_index of `processes` contiguous blocks of `batch` along
    `axis` (the batch axis of a (V, B, H, W, 3) stack)."""
    n = batch.shape[axis]
    _check_divides(n, processes)
    size = n // processes
    index = [slice(None)] * batch.ndim
    index[axis] = slice(rank_index * size, (rank_index + 1) * size)
    return batch[tuple(index)]


def local_band(batch, index: int, count: int, axis: int = 2):
    """Band `index` of `count` equal bands of rows of `batch` along `axis`
    (the H axis of a (V, B, H, W, 3) stack); H must divide by count, as the
    JAX package's placement of H on the model axis requires."""
    h = batch.shape[axis]
    if h % count != 0:
        raise ValueError(f"image height {h} not divisible by {count} bands")
    size = h // count
    index_ = [slice(None)] * batch.ndim
    index_[axis] = slice(index * size, (index + 1) * size)
    return batch[tuple(index_)]


class _PinnedSlot:
    """A pinned host buffer and the event of its last host -> device copy."""

    def __init__(self):
        self.host: Optional[torch.Tensor] = None
        self.event: Optional[torch.cuda.Event] = None

    def fill(self, batch: np.ndarray) -> torch.Tensor:
        if self.event is not None:
            self.event.synchronize()          # its last copy has left the buffer
        src = torch.from_numpy(np.ascontiguousarray(batch))
        if self.host is None or self.host.shape != src.shape or self.host.dtype != src.dtype:
            self.host = torch.empty_like(src, pin_memory=True)
        self.host.copy_(src)
        return self.host


class DevicePrefetcher:
    """Wraps an iterator of numpy batches; yields them as tensors on `device`,
    up to `depth` batches ahead of the consumer."""

    _SENTINEL = object()

    def __init__(self, it: Iterator[np.ndarray], device="cuda", depth: int = 2):
        self._device = torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        cuda = self._device.type == "cuda"
        self._stream = torch.cuda.Stream(self._device) if cuda else None
        # the queue's batches, the one being consumed and the one being filled
        slots: List[_PinnedSlot] = [_PinnedSlot() for _ in range(max(1, depth) + 2)]

        def to_device(i: int, batch: np.ndarray):
            if not cuda:
                return torch.from_numpy(np.ascontiguousarray(batch)), None
            slot = slots[i % len(slots)]
            host = slot.fill(batch)
            with torch.cuda.stream(self._stream):
                dev = torch.empty(host.shape, dtype=host.dtype, device=self._device)
                dev.copy_(host, non_blocking=True)
                slot.event = torch.cuda.Event()
                slot.event.record(self._stream)
            return dev, slot.event

        def worker():
            try:
                for i, batch in enumerate(it):
                    self._q.put(to_device(i, np.asarray(batch)))
                    if self._stop.is_set():
                        return
            except BaseException as e:  # re-raised in the consumer
                self._err = e
            finally:
                self._q.put(self._SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self) -> torch.Tensor:
        item = self._q.get()
        if item is self._SENTINEL:
            self._q.put(item)                  # later calls stop too
            if self._err is not None:
                raise self._err
            raise StopIteration
        tensor, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            tensor.record_stream(stream)
        return tensor

    def close(self, timeout: float = 60.0) -> None:
        """Stop the worker after the batch it is on and wait for it; batches
        not consumed are dropped (the worker may be blocked on a full queue,
        so the queue is drained while waiting)."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        while self._thread.is_alive():
            if time.monotonic() > deadline:
                raise TimeoutError("DevicePrefetcher: the worker did not stop")
            try:
                self._q.get(timeout=0.05)
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)


def rank_feed(dataset, shuffle_seed: Optional[int] = None, device="cuda",
              depth: int = 2, process_index: Optional[int] = None,
              process_count: Optional[int] = None, band_index: int = 0,
              band_count: int = 1) -> DevicePrefetcher:
    """This rank's feed of one epoch: block `process_index` of
    `process_count` contiguous blocks of every global batch of `dataset`
    (`iter_epoch`, the same global order on every rank) on `device`. The
    index and count are the rank's data index and the data axis's size
    (default: the rank and the world size, the mesh of data parallelism
    alone); the M ranks of a model row take the same block, and on a
    spatial layout band `band_index` of `band_count` of its rows
    (`local_band`). The global batch must divide by the count, and the
    image height by the bands; it raises here, not in the worker."""
    index = rank() if process_index is None else process_index
    n = world_size() if process_count is None else process_count
    if n > 1:
        _check_divides(dataset.batch_size, n)
    it = dataset.iter_epoch(shuffle_seed=shuffle_seed, process_index=index, process_count=n)
    if band_count > 1:
        size = getattr(dataset, "image_size", band_count)
        if size % band_count:
            raise ValueError(f"image height {size} not divisible by {band_count} bands")
        it = (local_band(np.asarray(b), band_index, band_count) for b in it)
    return DevicePrefetcher(it, device=device, depth=depth)
