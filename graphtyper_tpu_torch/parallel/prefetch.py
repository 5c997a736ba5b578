"""Host/device pipeline: overlap host batch decoding with device work.

Port of graphtyper_tpu/parallel/prefetch.py. `prefetch_to_device` stages
host batches on the device `size` ahead of the consumer: a producer thread
turns each numpy pytree into tensors. On a CUDA device it copies through
pinned host memory with non_blocking copies on a side stream and records
an event there; the consumer's current stream waits on that event before
the batch is handed out, so the copy overlaps the consumer's kernels and
is complete before any of them reads it. On the CPU the arrays become
tensors with `torch.as_tensor`. `pipelined_map` is the JAX module's,
copied.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

__all__ = ["pipelined_map", "prefetch_to_device"]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def prefetch_to_device(batch_iter: Iterable, size: int = 2, device="cuda") -> Iterator:
    """Yield the batches of `batch_iter` (pytrees of numpy arrays: dicts,
    lists and tuples of them) as tensors on `device`, staged `size` ahead by
    a background thread; an error of the producer is raised to the consumer
    after the batches before it."""
    device = torch.device(device)
    q: queue.Queue = queue.Queue(maxsize=size)
    _END = object()
    err: list[BaseException] = []
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None

    def to_device(a):
        t = torch.as_tensor(np.asarray(a))
        if not cuda:
            return t.to(device)
        return t.pin_memory().to(device, non_blocking=True)

    def producer():
        try:
            for batch in batch_iter:
                if cuda:
                    with torch.cuda.stream(stream):
                        staged = _tree_map(to_device, batch)
                        ready = torch.cuda.Event()
                        ready.record(stream)
                    q.put((staged, ready))
                else:
                    q.put((_tree_map(to_device, batch), None))
        except BaseException as e:  # surfaced to the consumer
            err.append(e)
        finally:
            q.put(_END)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            t.join()
            if err:
                raise err[0]
            return
        staged, ready = item
        if ready is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(ready)
            # the side stream allocated these tensors: keep their memory from
            # being handed out again before the consumer's kernels are done
            _tree_map(lambda x: x.record_stream(consumer), staged)
        yield staged


def pipelined_map(
    decode_fn: Callable[[int], object],
    device_fn: Callable,
    n_batches: int,
    prefetch: int = 2,
) -> list:
    """Run device_fn over decode_fn(0..n_batches-1) with decode/compute
    overlap: decode_fn runs on a `prefetch`-wide thread pool while the
    results are consumed in order and handed to device_fn (whose device
    work is asynchronous on CUDA). Returns device_fn's results in order;
    a decode error is raised when its batch is reached
    (graphtyper_tpu/parallel/prefetch.py:51)."""
    from concurrent.futures import ThreadPoolExecutor

    results = []
    if n_batches <= 0:
        return results
    with ThreadPoolExecutor(max_workers=max(1, prefetch)) as pool:
        pending = {}
        next_submit = 0
        for _ in range(min(max(1, prefetch), n_batches)):
            pending[next_submit] = pool.submit(decode_fn, next_submit)
            next_submit += 1
        for i in range(n_batches):
            batch = pending.pop(i).result()  # re-raises decode errors
            if next_submit < n_batches:
                pending[next_submit] = pool.submit(decode_fn, next_submit)
                next_submit += 1
            if isinstance(batch, (tuple, list)):
                results.append(device_fn(*batch))
            else:
                results.append(device_fn(batch))
    return results
