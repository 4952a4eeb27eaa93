"""The port's minibatch fits in float64 on the CPU: the golden
``minibatch`` energies on the fft and conv strategies, Cyclic_MU against
the full batch, the ``fit`` dispatch, the argument checks and the
kernel/plain switch ``use_pallas`` (``tests/test_torch_minibatch_jax.py``
holds the fits against the JAX package).

The data and schedule are the goldens' (``tests/torch_minibatch.py``)."""

import numpy as np
import pytest
import torch

import tnmf_tpu_torch
from tnmf_tpu_torch import MiniBatchAlgorithm, engine
from tnmf_tpu_torch.ops.modes import ConvPlan

from .fixtures import load_goldens
from .torch_minibatch import ALGORITHMS, SCHEDULE, _assert_same, _fit, _model, patches_2d
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

KERNELS = ('mu_ratio', 'mu_h', 'grad_w', 'mu_w', 'inhibited_mu_h')


@pytest.mark.parametrize('algorithm', ['full_batch'] + ALGORITHMS)
@pytest.mark.parametrize('backend', ['jax_fft', 'jax_conv'])
def test_golden_minibatch_energies(backend, algorithm):
    nmf, _ = _fit(tnmf_tpu_torch, backend, algorithm)
    assert nmf._strategy == backend.removeprefix('jax_')
    np.testing.assert_allclose(nmf._energy_function(), load_goldens()['minibatch'][algorithm],
                               rtol=1e-8)
    np.testing.assert_allclose(nmf.W.sum(axis=(-1, -2)), 1.0)


def test_cyclic_equals_full_batch():
    """Cyclic_MU sums the batches' W statistics, so its epochs are
    full-batch iterations."""
    full, _ = _fit(tnmf_tpu_torch, 'jax_conv', 'full_batch')
    cyclic, _ = _fit(tnmf_tpu_torch, 'jax_conv', 'Cyclic_MU')
    _assert_same(cyclic, full)


def test_fit_dispatches_to_the_minibatch_driver():
    """``fit(algorithm=…)`` and ``fit(batch_size=…)`` run ``fit_minibatches``
    (the JAX dispatch), whose defaults are the JAX package's."""
    pm, _ = _fit(tnmf_tpu_torch, 'jax_fft', 'ASAG_MU')
    np.random.seed(42)
    nmf = _model(tnmf_tpu_torch)
    nmf.fit(patches_2d(), sparsity_H=0.1, algorithm=MiniBatchAlgorithm.ASAG_MU, **SCHEDULE)
    assert torch.equal(nmf._W, pm._W) and torch.equal(nmf._H, pm._H)
    np.random.seed(42)
    default = _model(tnmf_tpu_torch)
    default.fit(patches_2d()[:7], batch_size=3, n_epochs=2, sparsity_H=0.1)
    np.random.seed(42)
    asg = _model(tnmf_tpu_torch)
    asg.fit_minibatches(patches_2d()[:7], MiniBatchAlgorithm.ASG_MU, 3, 2, 0.2, sparsity_H=0.1)
    assert torch.equal(default._W, asg._W)


def test_minibatch_arguments_are_checked():
    nmf = tnmf_tpu_torch.TransformInvariantNMF(2, (3, 3), device='cpu')
    with pytest.raises(ValueError, match='MiniBatchAlgorithm'):
        nmf.fit_minibatches(np.ones((4, 1, 8, 8)), algorithm=5, n_epochs=1)
    with pytest.raises(ValueError, match='sparsity_H must be >= 0'):
        nmf.fit_minibatches(np.ones((4, 1, 8, 8)), sparsity_H=-1., n_epochs=1)
    with pytest.raises(KeyError):
        tnmf_tpu_torch.MiniBatchTransformInvariantNMF(2, (3, 3), algorithm='SGD', device='cpu')


@pytest.fixture(name='calls')
def fixture_calls(monkeypatch):
    """Replaces the engine's kernel wrappers and their plain versions by
    recorders that run the plain versions: the names the engine called."""
    calls = []

    def record(name, plain):
        def fn(*args, **kwargs):
            calls.append(name)
            return plain(*args, **kwargs)
        return fn
    for name in KERNELS:
        plain = getattr(engine, name + '_plain')
        monkeypatch.setattr(engine, name, record(name, plain))
        monkeypatch.setattr(engine, name + '_plain', record(name + '_plain', plain))
    return calls


@pytest.mark.parametrize('use_pallas', [None, False])
@pytest.mark.parametrize('backend', ['jax_conv', 'jax_fft'])
def test_use_pallas_selects_kernels_or_plain_versions(calls, backend, use_pallas):
    """Per batch, the H update and the W statistics and epilogue: through
    the kernel wrappers by default (which run their plain versions on CPU
    tensors), through the plain versions alone with ``use_pallas=False``,
    on every path of the model; the factors are the same."""
    V = np.random.default_rng(0).random((5, 1, 12, 10))
    out = []
    for flag in (use_pallas, False if use_pallas is None else None):
        nmf = tnmf_tpu_torch.TransformInvariantNMF(2, (3, 4), backend=backend, seed=0,
                                                   device='cpu', use_pallas=flag)
        calls.clear()
        nmf.fit_minibatches(V, algorithm=MiniBatchAlgorithm.ASG_MU, batch_size=2, n_epochs=1,
                            sparsity_H=0.1)
        nmf.partial_fit(V, inhibition_strength=0.1)
        nmf.fit_batch(V, n_iterations=1, keep_W=True, tol=0., tol_check_every=1)
        out.append((list(calls), nmf))
    (got, model), (_, other) = out
    h_update = 'mu_h' if backend == 'jax_conv' else 'mu_ratio'
    stats = ['grad_w'] if backend == 'jax_conv' else []
    want = ([h_update] + stats + ['mu_w']) * 3 + ['inhibited_mu_h'] + stats + ['mu_w'] \
        + [h_update] + stats + ['mu_w']
    if use_pallas is False:
        want = [name + '_plain' for name in want]
    assert got == want
    assert torch.equal(model._W, other._W) and torch.equal(model._H, other._H)


def test_use_pallas_true_needs_a_card():
    """``True`` forces the kernels: a CPU model has none, so it raises;
    the gate names the switch as the reason for the plain versions."""
    with pytest.raises(ValueError, match='use_pallas=True'):
        tnmf_tpu_torch.TransformInvariantNMF(2, (3, 3), device='cpu', use_pallas=True)
    with pytest.raises(ValueError, match='use_pallas must be'):
        tnmf_tpu_torch.TransformInvariantNMF(2, (3, 3), device='cpu', use_pallas='yes')
    model = tnmf_tpu_torch.TransformInvariantNMF(2, (3, 3), device='meta', use_pallas=True)
    assert model._use_pallas is True
    plan = ConvPlan.create('valid', (8, 8), (3, 3))
    assert engine.plain_reason(plan, torch.float32, use_pallas=False) == 'use_pallas=False'
    assert engine.dtype_reason(torch.float32, use_pallas=False) == 'use_pallas=False'
    assert engine.plain_reason(plan, torch.float32) is None
