"""Host-to-device input pipeline with background prefetch
(``frostnet_tpu/data/pipeline.py``).

A worker thread stages batches ahead of the consumer. On a CUDA device each
batch goes to pinned host memory and is copied with ``non_blocking=True`` on
the pipeline's own stream; the worker records an event after the copy, and
the consumer makes its current stream wait for that event and marks each
tensor as used by it (``record_stream``), so no batch is read before its
copy lands and no buffer is reused while the step still reads it. On the
CPU it is a plain prefetch of torch tensors.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch


def prefetch_to_device(it: Iterable, device="cuda", size: int = 2) -> Iterator:
    """Iterate ``it`` (dicts of numpy arrays), yielding dicts of tensors on
    ``device`` with up to ``size`` batches in flight."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None

    def place(batch):
        if not cuda:
            return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}, None
        with torch.cuda.stream(stream):
            out = {k: torch.as_tensor(np.asarray(v)).pin_memory().to(device, non_blocking=True)
                   for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    q: queue.Queue = queue.Queue(maxsize=size)
    end = object()
    stop = threading.Event()

    def worker():
        try:
            for batch in it:
                if stop.is_set():
                    return
                q.put(place(batch))
        except Exception as e:  # surface loader errors in the consumer
            q.put(e)
        q.put(end)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, Exception):
                raise item
            batch, done = item
            if done is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(done)
                for v in batch.values():
                    v.record_stream(current)
            yield batch
    finally:
        stop.set()
        while t.is_alive():  # let a blocked worker finish its put
            try:
                q.get_nowait()
            except queue.Empty:
                t.join(timeout=0.01)
