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

KERNELS = ('mu_h', 'grad_w', 'mu_w', 'inhibited_mu_h')


@pytest.mark.parametrize('dtype,S,A,reason', [
    (torch.float32, (30,), (6,), None),
    (torch.float32, (12, 10), (3, 4), None),
    (torch.float64, (30,), (6,), 'float64 tensors (the kernels take float32)'),
    (torch.float64, (12, 10), (3, 4), 'float64 tensors (the kernels take float32)'),
    (torch.float32, (7, 6, 8), (2, 3, 2), '3-D shifts (the kernels take 1-D and 2-D)'),
    (torch.float64, (7, 6, 8), (2, 3, 2), '3-D shifts (the kernels take 1-D and 2-D)'),
])
def test_kernel_gate(dtype, S, A, reason):
    assert engine.plain_reason(ConvPlan.create('valid', S, A), dtype) == reason


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
    ((None, 'auto', None, 0, 'valid', 'float32', None, 0), dict(fft_policy='pow2')),
    ((None, 'auto', None, 2), dict(w_init='patches')),
    ((None, 'auto', None, 0, 'valid', 'float32', object()), {}),
])
def test_unported_positional_arguments_raise(args, kwargs):
    """``mesh`` is a real parameter that raises unless it holds the default,
    as do the later keywords whose code is not ported (``fft_policy``,
    ``w_init``); ``logger`` and ``verbose`` are ported."""
    with pytest.raises(NotImplementedError, match='ROADMAP.md queue 1, item'):
        tnmf_tpu_torch.TransformInvariantNMF(2, (3, 3), *args, device='cpu', **kwargs)
    # at their defaults they are accepted, and so are a logger and a verbosity
    tnmf_tpu_torch.TransformInvariantNMF(2, (3, 3), None, 'auto', None, 0, 'valid', 'float32',
                                         None, 0, device='cpu')
    tnmf_tpu_torch.TransformInvariantNMF(2, (3, 3), None, 'auto', logging.getLogger('t'), 3,
                                         device='cpu')
