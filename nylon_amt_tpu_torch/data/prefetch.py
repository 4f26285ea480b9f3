"""Host -> device input prefetching.

Port of :mod:`nylon_amt_tpu.data.prefetch`. The reference feeds the GPU
with a synchronous ``.to(device)`` copy inside the step loop
(``training/train.py:72-76``), so the card idles during every host gather
and copy. Here the host side of the pipeline (the fancy-index gather of
:meth:`WindowDataset.batches` and the enqueued copy) runs on a background
thread, ``depth`` batches ahead of the consumer.

:func:`prefetch` is the device-neutral iterator, the JAX module's contract
unchanged: the same order, every item, an exception on the worker raised
again at the consumer, and ``close()`` stopping the worker promptly.

:class:`DeviceTransfer` is the ``transfer`` for a batch of numpy arrays.
On the card it runs on the worker thread: each array is copied into pinned
host memory (a copy from pageable memory would be synchronous whatever
``non_blocking`` says), then to the card with ``non_blocking=True`` on a
copy stream of its own, and an event is recorded behind the copies.
:meth:`DeviceTransfer.ready`, on the consumer's thread, makes the
consumer's current stream wait on that event before the step reads the
batch, and ``record_stream`` tells the caching allocator that the
consumer's stream uses the tensors, so their memory is not handed to a
later batch's copy while the step still reads them. The worker names its
device explicitly (the current device is per thread). On the CPU the
transfer is the plain ``torch.as_tensor``.

Depth 2 is enough: one batch in flight on the device, one being gathered
on the host.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Mapping, TypeVar

import numpy as np
import torch

T = TypeVar("T")

_SENTINEL = object()


class _WorkerError:
    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch(iterable: Iterable[T], transfer: Callable[[T], T] | None = None,
             depth: int = 2) -> Iterator[T]:
    """Iterate ``iterable`` through a background thread.

    ``transfer`` (e.g. :class:`DeviceTransfer`) runs on the worker thread,
    so the enqueued host -> device copy overlaps the consumer's device
    work. Worker exceptions are raised again at the consuming site;
    closing the returned generator (``close()`` or garbage collection)
    stops the worker promptly.
    """
    if depth < 1:
        raise ValueError("prefetch depth must be >= 1")
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(item) -> bool:
        """Blocking put that gives up when the consumer went away."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if stop.is_set():
                    return
                if transfer is not None:
                    item = transfer(item)
                if not _put(item):
                    return
            _put(_SENTINEL)
        except BaseException as exc:  # noqa: BLE001 (raised at the consumer)
            _put(_WorkerError(exc))

    thread = threading.Thread(target=worker, name="input-prefetch",
                              daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, _WorkerError):
                raise item.exc
            yield item
    finally:
        stop.set()
        # unblock a worker stuck on a full queue, then reap it
        while thread.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=0.05)


class DeviceTransfer:
    """``transfer`` of a host batch (a mapping of numpy arrays) to
    ``device``: call it on the worker thread, then :meth:`ready` on the
    consumer's thread before the batch is read."""

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None

    def __call__(self, batch: Mapping[str, np.ndarray]):
        if not self.cuda:
            return {k: torch.as_tensor(np.asarray(v)).to(self.device)
                    for k, v in batch.items()}
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                   .to(self.device, non_blocking=True)
                   for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(self.stream)
        return out, done

    def ready(self, item) -> dict[str, torch.Tensor]:
        """The transferred batch, safe to read on the consumer's current
        stream."""
        if not self.cuda:
            return item
        out, done = item
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(done)
        for t in out.values():
            t.record_stream(stream)
        return out


def prefetch_to_device(batches: Iterable[Mapping[str, np.ndarray]],
                       device: torch.device | str,
                       depth: int = 2) -> Iterator[dict[str, torch.Tensor]]:
    """``batches`` gathered and copied to ``device`` on a worker thread,
    ``depth`` ahead; each comes out ready to read on the consumer's current
    stream. Closing this generator stops the worker."""
    transfer = DeviceTransfer(device)
    it = prefetch(batches, transfer=transfer, depth=depth)
    try:
        for item in it:
            yield transfer.ready(item)
    finally:
        it.close()
