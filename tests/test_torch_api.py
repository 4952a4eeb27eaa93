"""The port's kernel gate and constructor against the JAX package.

The gate: float32 problems with 1-D and 2-D shifts go to the hand-written
kernels; float64 (the reference precision) and 3-D shifts run their plain
versions, decided before any launch, as the JAX kernels' own ``supported``
gates decide.  The constructor: the JAX package's positional order, with
``device`` keyword-only."""

import inspect
import logging

import numpy as np
import pytest
import torch

import tnmf_tpu
import tnmf_tpu_torch
from tnmf_tpu_torch import engine
from tnmf_tpu_torch.ops.modes import ConvPlan

KERNELS = ('mu_ratio', 'mu_h', 'grad_w', 'mu_w', 'inhibited_mu_h')


@pytest.mark.parametrize('dtype,S,A,reason', [
    (torch.float32, (30,), (6,), None),
    (torch.float32, (12, 10), (3, 4), None),
    (torch.float64, (30,), (6,), 'float64 tensors (the kernels take float32)'),
    (torch.float64, (12, 10), (3, 4), 'float64 tensors (the kernels take float32)'),
    (torch.float32, (7, 6, 8), (2, 3, 2), '3-D shifts (K2, K3 and K4 take 1-D and 2-D)'),
    (torch.float64, (7, 6, 8), (2, 3, 2), '3-D shifts (K2, K3 and K4 take 1-D and 2-D)'),
])
def test_kernel_gate(dtype, S, A, reason):
    assert engine.plain_reason(ConvPlan.create('valid', S, A), dtype) == reason


@pytest.mark.parametrize('dtype,S,A', [
    (torch.float32, (7, 6, 8), (2, 3, 2)),
    (torch.float32, (5, 6, 4, 7), (2, 2, 3, 2)),
    (torch.float64, (12, 10), (3, 4)),
])
def test_k1_gate_takes_every_rank(dtype, S, A):
    """K1 (``mu_ratio``, ``mu_w``) is gated on the dtype alone: a 3-D or
    rank-4 float32 problem runs it; float64 runs its plain version."""
    want = None if dtype == torch.float32 else 'float64 tensors (the kernels take float32)'
    assert engine.dtype_reason(dtype) == want
    if len(S) > 2:
        assert engine.plain_reason(ConvPlan.create('valid', S, A), dtype) is not None


@pytest.fixture(name='kernels_called')
def fixture_kernels_called(monkeypatch):
    """Replaces the engine's kernel wrappers by recorders that run the
    plain versions: the names of the wrappers a fit called."""
    calls = []

    def record(name, plain):
        def fn(*args, **kwargs):
            calls.append(name)
            return plain(*args, **kwargs)
        return fn
    for name in KERNELS:
        monkeypatch.setattr(engine, name, record(name, getattr(engine, name + '_plain')))
    return calls


@pytest.mark.parametrize('inhibition', [0., 0.1])
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_fit_goes_through_the_gate(kernels_called, dtype, inhibition):
    """A 2-D fit calls the kernel wrappers in float32 only; float64 runs the
    plain versions (on CUDA too: the gate does not look at the device)."""
    V = np.random.default_rng(0).random((2, 1, 12, 10))
    nmf = tnmf_tpu_torch.TransformInvariantNMF(2, (3, 4), dtype=dtype, seed=0, device='cpu')
    nmf.fit(V, n_iterations=2, sparsity_H=0.1, inhibition_strength=inhibition)
    h_update = 'inhibited_mu_h' if inhibition else 'mu_h'
    assert kernels_called == ([h_update, 'grad_w', 'mu_w'] * 2 if dtype == 'float32'
                              else [])
    assert nmf._W.dtype == getattr(torch, dtype) and np.isfinite(nmf._energy_function())


@pytest.mark.parametrize('inhibition', [0., 0.1])
@pytest.mark.parametrize('backend,S,A', [
    ('jax_fft', (7, 6, 8), (2, 3, 2)),
    ('jax_fft', (5, 6, 4, 7), (2, 2, 3, 2)),
    ('jax_conv', (7, 6, 8), (2, 3, 2)),
], ids=['fft-3d', 'fft-rank4', 'conv-3d'])
def test_fit_of_any_rank_runs_k1_on_contiguous_tensors(monkeypatch, backend, S, A, inhibition):
    """A float32 fit with 3 or 4 shift axes calls K1 once per iteration
    (``mu_ratio`` for the fft H ratio, ``mu_w`` for W; K2, K3 and K4 run
    their plain versions under the rank gate) and hands it contiguous
    tensors, as the CUDA kernel requires: the fft pairs and plain K2's pair
    are views."""
    calls = []

    def record(name, plain):
        def fn(*args, **kwargs):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            calls.append((name, all(t.is_contiguous() for t in tensors)))
            return plain(*args, **kwargs)
        return fn
    for name in KERNELS:
        monkeypatch.setattr(engine, name, record(name, getattr(engine, name + '_plain')))
    V = np.random.default_rng(0).random((2, 1) + S)
    nmf = tnmf_tpu_torch.TransformInvariantNMF(2, A, backend=backend, seed=0, device='cpu')
    nmf.fit(V, n_iterations=2, sparsity_H=0.1, inhibition_strength=inhibition)
    h_update = [] if inhibition or backend == 'jax_conv' else [('mu_ratio', True)]
    assert nmf._strategy == backend.removeprefix('jax_')
    assert calls == (h_update + [('mu_w', True)]) * 2
    assert np.isfinite(nmf._energy_function())


def _positional(cls):
    return [p.name for p in inspect.signature(cls.__init__).parameters.values()
            if p.kind == p.POSITIONAL_OR_KEYWORD][1:]


def test_constructor_takes_the_jax_order():
    port = _positional(tnmf_tpu_torch.TransformInvariantNMF)
    jax = _positional(tnmf_tpu.TransformInvariantNMF)
    assert port == jax[:len(port)]
    assert port[:10] == ['n_atoms', 'atom_shape', 'inhibition_range', 'backend', 'logger',
                         'verbose', 'reconstruction_mode', 'dtype', 'mesh', 'seed']
    device = inspect.signature(tnmf_tpu_torch.TransformInvariantNMF).parameters['device']
    assert device.kind == device.KEYWORD_ONLY


@pytest.mark.parametrize('module', [tnmf_tpu, tnmf_tpu_torch])
def test_third_positional_is_inhibition_range(module):
    kw = dict(device='cpu') if module is tnmf_tpu_torch else {}
    nmf = module.TransformInvariantNMF(3, (20,), 5, **kw)
    assert tuple(nmf._inhibition_range) == (5,)


@pytest.mark.parametrize('value,dtype', [('float32', torch.float32), ('float64', torch.float64),
                                         (torch.float32, torch.float32),
                                         (torch.float64, torch.float64)])
def test_constructor_dtype(value, dtype):
    nmf = tnmf_tpu_torch.TransformInvariantNMF(2, (3,), dtype=value, device='cpu')
    assert nmf.dtype == dtype


@pytest.mark.parametrize('args,kwargs', [
    ((None, 'auto', None, 2), dict(shard_axis='atoms')),
    ((None, 'auto', None, 0, 'valid', 'float32', None, 0, '5-smooth'), dict(shard_axis='both')),
])
def test_unported_positional_arguments_raise(args, kwargs):
    """The later keywords whose code is not ported raise (``shard_axis``
    other than 'samples'); ``logger``, ``verbose``, ``mesh`` (a
    ``DeviceMesh``, ``tests/test_torch_distributed.py``) and
    ``fft_policy`` are ported."""
    with pytest.raises(NotImplementedError, match='ROADMAP.md queue 1, item'):
        tnmf_tpu_torch.TransformInvariantNMF(2, (3, 3), *args, device='cpu', **kwargs)
    # at their defaults they are accepted, and so are a logger and a verbosity
    tnmf_tpu_torch.TransformInvariantNMF(2, (3, 3), None, 'auto', None, 0, 'valid', 'float32',
                                         None, 0, device='cpu')
    tnmf_tpu_torch.TransformInvariantNMF(2, (3, 3), None, 'auto', logging.getLogger('t'), 3,
                                         device='cpu')


@pytest.mark.parametrize('args,kwargs', [
    ((None, 'auto', None, 0, 'valid', 'float32', None, 0), dict(fft_policy='pow2')),
    ((None, 'jax_fft', None, 0, 'valid', 'float32', None, 0, 'pow2'), {}),
], ids=['keyword', 'positional'])
def test_fft_policy_is_ported(args, kwargs):
    """The call that raised until the fft strategy was ported now runs, with
    the JAX package's plan: its FFT lengths, and a fit that matches the JAX
    model's on the same seed (float32; 'auto' picks conv here)."""
    V = np.random.default_rng(0).random((1, 1, 8, 8))
    models = [module.TransformInvariantNMF(2, (3, 3), *args, **kwargs, **extra)
              for module, extra in ((tnmf_tpu_torch, dict(device='cpu')), (tnmf_tpu, {}))]
    for m in models:
        m.fit(V, n_iterations=2)
    pm, jm = models
    assert pm._strategy == jm._strategy
    assert pm._plan.fft_shape == jm._plan.fft_shape == (32, 32)  # 5-smooth: 18
    np.testing.assert_allclose(pm.W, jm.W, rtol=1e-5)
    np.testing.assert_allclose(pm.H, jm.H, rtol=1e-5)
