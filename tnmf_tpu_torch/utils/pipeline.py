"""Host-to-device input pipeline: background prefetch for streaming fits.

Port of :mod:`tnmf_tpu.utils.pipeline`.  Online and minibatch drivers
consume batches one at a time (``partial_fit``, ``fit_stream``); without a
pipeline every step first waits for the host-to-device copy of its batch.
:func:`prefetch_to_device` overlaps those copies with compute: a daemon
thread pulls batches from the source iterator and stages them on the card a
few steps ahead, so the training step finds its next batch already
resident::

    from tnmf_tpu_torch.utils.pipeline import prefetch_to_device
    for batch in prefetch_to_device(batch_source(), buffer_size=2):
        model.partial_fit(batch)          # batch is already on the card

On the card each batch is cast into a pinned host tensor and copied with
``non_blocking=True`` on a side CUDA stream, which records an event; where
the batch is consumed, the consumer's current stream waits on that event
(on the device, the host does not block) and the tensor is
``record_stream``-ed on it, so that the caching allocator does not hand its
memory to another tensor before the consumer's work on it is done.  The
model keeps a tensor on its device where it is (no host round trip).  On
the CPU it is a plain staging thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from ..serving import _torch_dtype
from .validation import require

__all__ = ['prefetch_to_device']

_END = object()


def prefetch_to_device(source: Iterable, buffer_size: int = 2, sharding=None,
                       dtype=None, device=None) -> Iterator[torch.Tensor]:
    """Iterate ``source``, yielding each batch as a tensor on ``device``
    (default: the card, ``'cuda'``) staged by a background thread up to
    ``buffer_size`` batches ahead.

    ``dtype`` casts on the way in (a ``torch.dtype`` or a NumPy-style name,
    e.g. ``'bfloat16'`` halves the transfer).  Order is preserved; an
    exception in the source is re-raised at the consumption point; the
    staging thread is a daemon, so abandoning the iterator cannot hang
    interpreter exit.  ``sharding`` (a sharded layout) is not ported."""
    require(buffer_size >= 1, f'buffer_size must be >= 1, got {buffer_size}')
    if sharding is not None:
        raise NotImplementedError(
            'sharded layouts are not ported to tnmf_tpu_torch yet '
            '(ROADMAP.md queue 1, item 14e-iv)')
    device = torch.device('cuda' if device is None else device)
    dtype = None if dtype is None else _torch_dtype(dtype)
    cuda = device.type == 'cuda'
    if cuda and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    copy_stream = torch.cuda.Stream(device) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=buffer_size)

    def stage_one(batch):
        x = batch if isinstance(batch, torch.Tensor) else torch.as_tensor(np.asarray(batch))
        if not cuda:  # a copy, as a device transfer makes one
            return x.to(device=device, dtype=dtype or x.dtype, copy=True), None
        if x.device == device:
            return x.to(dtype=dtype or x.dtype), None
        pinned = torch.empty(x.shape, dtype=dtype or x.dtype, pin_memory=True)
        pinned.copy_(x)
        with torch.cuda.stream(copy_stream):
            staged = pinned.to(device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return staged, ready

    def stage():
        try:
            if cuda:
                torch.cuda.set_device(device)
            for batch in source:
                q.put(stage_one(batch))
        except BaseException as e:  # noqa: BLE001 - re-raised at consumption
            q.put(e)
            return
        q.put(_END)

    threading.Thread(target=stage, daemon=True, name='tnmf-tpu-torch-prefetch').start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        staged, ready = item
        if ready is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(ready)
            staged.record_stream(consumer)
        yield staged
