"""Profiling hooks of the PyTorch port (``tnmf_tpu_torch.utils.profiling``)
against the JAX package's, on the CPU: the cases of
``tests/test_utils_extra.py`` for ``IterationTimer`` and ``trace``, with the
timer's recorded energies held to the JAX package's in float64."""

import glob
import json
import os

import numpy as np
import torch

import tnmf_tpu
import tnmf_tpu_torch
from tnmf_tpu.utils.profiling import IterationTimer as JaxTimer
from tnmf_tpu_torch.utils.profiling import IterationTimer, trace


def _fit_with(module, timer_cls, V, inner_calls):
    def inner(nmf, it):
        inner_calls.append(it)
        return it < 3  # abort after iteration 3

    timer = timer_cls(inner=inner, record_energy=True)
    kw = dict(device='cpu', dtype=torch.float64) if module is tnmf_tpu_torch else {}
    nmf = module.TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3), seed=0, **kw)
    nmf.fit(V, n_iterations=50, progress_callback=timer)
    return timer


def test_iteration_timer_records_and_aborts():
    V = np.random.default_rng(0).random((2, 1, 12, 12))
    calls, jax_calls = [], []
    timer = _fit_with(tnmf_tpu_torch, IterationTimer, V, calls)
    want = _fit_with(tnmf_tpu, JaxTimer, V, jax_calls)
    assert calls == jax_calls == [0, 1, 2, 3]      # abort honored through the wrapper
    assert len(timer.times) == 4
    assert len(timer.energies) == 4
    assert timer.energies[-1] <= timer.energies[0]
    np.testing.assert_allclose(timer.energies, want.energies, rtol=1e-8)
    assert np.isfinite(timer.iterations_per_second)


def test_iteration_timer_single_sample_nan_rate():
    t = IterationTimer()
    assert np.isnan(t.iterations_per_second)


def test_iteration_timer_synchronises_only_a_cuda_model(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda device=None: synced.append(device))
    timer = IterationTimer()

    class Model:
        device = torch.device('cpu')
    timer(Model(), 0)
    Model.device = torch.device('cuda', 0)
    assert timer(Model(), 1) is True
    assert synced == [torch.device('cuda', 0)] and len(timer.times) == 2


def test_trace_context_writes_profile(tmp_path):
    with trace(str(tmp_path)):
        nmf = tnmf_tpu_torch.TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3), seed=0,
                                                   device='cpu')
        nmf.fit(np.random.default_rng(1).random((1, 1, 10, 10)), n_iterations=2)
    produced = glob.glob(os.path.join(str(tmp_path), '**', '*.json'), recursive=True)
    assert produced, 'profiler produced no trace files'
    with open(produced[0]) as f:
        events = json.load(f)['traceEvents']
    assert any(e.get('name', '').startswith('aten::conv') for e in events)
