"""Profiling and timing hooks (port of :mod:`tnmf_tpu.utils.profiling`).

* :func:`trace` — a context manager around :mod:`torch.profiler` writing a
  trace of everything run inside it, loadable in TensorBoard's profiler
  plugin or in Perfetto;
* :class:`IterationTimer` — a progress-callback wrapper that records
  per-iteration times and energies without changing fit behavior.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, List, Optional

import torch


@contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with trace('/tmp/tnmf-trace'): nmf.fit(...)``.

    Records the host's operators and, where a card is present, its kernels
    (``torch.profiler`` with CPU and CUDA activity), and writes one
    ``*.pt.trace.json`` into ``log_dir`` when the block ends.  View with
    TensorBoard's profiler plugin or Perfetto."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir))):
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()  # the block's kernels land in the trace


class IterationTimer:
    """Record per-iteration time and (optionally) energy via the
    progress-callback protocol.

    >>> timer = IterationTimer(record_energy=True)
    >>> nmf.fit(V, n_iterations=100, progress_callback=timer)
    >>> timer.times, timer.energies, timer.iterations_per_second

    Wraps (and preserves the abort semantics of) an inner callback if given.
    On a CUDA model each call first synchronises the model's device, so the
    times are the card's, not the host's enqueue of the work.  Installing
    any callback runs the fit one iteration per call; for throughput prefer
    the callback-free loop and CUDA events.
    """

    def __init__(self, inner: Optional[Callable] = None, record_energy: bool = False):
        self._inner = inner
        self._record_energy = record_energy
        self.times: List[float] = []
        self.energies: List[float] = []
        self._t0: Optional[float] = None

    def __call__(self, nmf, iteration: int) -> bool:
        device = torch.device(getattr(nmf, 'device', 'cpu'))
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
        self.times.append(now - self._t0)
        if self._record_energy:
            self.energies.append(nmf._energy_function())
        if self._inner is not None:
            return bool(self._inner(nmf, iteration))
        return True

    @property
    def iterations_per_second(self) -> float:
        if len(self.times) < 2:
            return float('nan')
        import numpy as np
        return float(1.0 / np.median(np.diff(self.times)))
