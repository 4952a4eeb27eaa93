"""The port's minibatch fits against the JAX package, in float64 on the CPU:
the golden ``minibatch`` energies on the fft and conv strategies, W and H of
the five algorithms, inhibited epochs, energy traces, callbacks and logging,
the global NumPy stream after each fit, Cyclic_MU against the full batch,
``MiniBatchTransformInvariantNMF`` and the kernel/plain switch
``use_pallas``.

The data and schedule are the goldens' (``tests/test_minibatch.py``): 64
patches of 32 x 32, 10 atoms of 7 x 7, ``batch_size=5`` (a ragged final
batch of 4), 3 epochs, ``sag_lambda=0.8``."""

import logging
from functools import lru_cache

import numpy as np
import pytest
import torch

import tnmf_tpu

import tnmf_tpu_torch
from tnmf_tpu_torch import MiniBatchAlgorithm, engine
from tnmf_tpu_torch.ops.modes import ConvPlan

from .fixtures import load_goldens, patches_2d as _patches_2d

F64 = torch.float64
TOL = dict(rtol=1e-8, atol=1e-10)
ALGORITHMS = [a.name for a in MiniBatchAlgorithm]
SCHEDULE = dict(batch_size=5, n_epochs=3, sag_lambda=0.8)
KERNELS = ('mu_ratio', 'mu_h', 'grad_w', 'mu_w', 'inhibited_mu_h')


@lru_cache(maxsize=None)
def patches_2d():
    """The goldens' patches, synthesized once for the module."""
    return _patches_2d()


def _model(module, backend='jax_fft', cls='TransformInvariantNMF', **init):
    kw = dict(device='cpu', dtype=F64) if module is tnmf_tpu_torch else {}
    return getattr(module, cls)(n_atoms=10, atom_shape=(7, 7), backend=backend, **init, **kw)


def _fit(module, backend, algorithm, **fit):
    """The golden fit from ``np.random.seed(42)``; returns the model and the
    global stream's next draw after the fit."""
    np.random.seed(seed=42)
    nmf = _model(module, backend)
    if algorithm == 'full_batch':
        nmf.fit_batch(patches_2d(), sparsity_H=0.1, n_iterations=3)
    else:
        nmf.fit_minibatches(patches_2d(), sparsity_H=0.1,
                            algorithm=module.MiniBatchAlgorithm[algorithm], **SCHEDULE, **fit)
    return nmf, np.random.random()


@lru_cache(maxsize=None)
def _jax_fit(backend, algorithm, inhibited=False, record_energies=False):
    fit = dict(inhibition_strength=0.2, cross_atom_inhibition_strength=0.1) if inhibited else {}
    return _fit(tnmf_tpu, backend, algorithm, record_energies=record_energies, **fit)


def _assert_same(pm, jm):
    np.testing.assert_allclose(pm.W, jm.W, **TOL)
    np.testing.assert_allclose(pm.H, jm.H, **TOL)


@pytest.mark.parametrize('algorithm', ['full_batch'] + ALGORITHMS)
@pytest.mark.parametrize('backend', ['jax_fft', 'jax_conv'])
def test_golden_minibatch_energies(backend, algorithm):
    nmf, _ = _fit(tnmf_tpu_torch, backend, algorithm)
    assert nmf._strategy == backend.removeprefix('jax_')
    np.testing.assert_allclose(nmf._energy_function(), load_goldens()['minibatch'][algorithm],
                               rtol=1e-8)
    np.testing.assert_allclose(nmf.W.sum(axis=(-1, -2)), 1.0)


@pytest.mark.parametrize('algorithm', ALGORITHMS)
def test_algorithms_match_jax(algorithm):
    """W and H of each algorithm, and the global stream after the fit: the
    batch orders are drawn as the JAX package draws them, one permutation
    per epoch for algorithms 5-8 and none for Cyclic_MU."""
    pm, p_next = _fit(tnmf_tpu_torch, 'jax_fft', algorithm)
    jm, j_next = _jax_fit('jax_fft', algorithm)
    _assert_same(pm, jm)
    assert p_next == j_next


@pytest.mark.parametrize('backend', ['jax_fft', 'jax_conv'])
def test_inhibited_asg_matches_jax(backend):
    """ASG_MU with same- and cross-atom inhibition (K4's path per batch)."""
    pm, p_next = _fit(tnmf_tpu_torch, backend, 'ASG_MU', inhibition_strength=0.2,
                      cross_atom_inhibition_strength=0.1)
    jm, j_next = _jax_fit(backend, 'ASG_MU', inhibited=True)
    _assert_same(pm, jm)
    assert p_next == j_next


@pytest.mark.parametrize('algorithm', ['ASAG_MU', 'Cyclic_MU'])
def test_record_energies_match_jax(algorithm):
    """One energy per epoch, the JAX package's trace; the last one is the
    model's energy."""
    pm, _ = _fit(tnmf_tpu_torch, 'jax_fft', algorithm, record_energies=True)
    jm, _ = _jax_fit('jax_fft', algorithm, record_energies=True)
    assert isinstance(pm.energies_, list) and len(pm.energies_) == 3
    np.testing.assert_allclose(pm.energies_, jm.energies_, **TOL)
    assert pm.energies_[-1] == pytest.approx(pm._energy_function(), rel=1e-12)
    _assert_same(pm, jm)


def test_callback_stops_after_epoch_one_like_jax():
    """A callback that stops the fit after epoch 1: two epochs run, two
    permutations are drawn, and W and H are the JAX package's."""
    out = {}
    for module in (tnmf_tpu_torch, tnmf_tpu):
        epochs = []
        nmf, nxt = _fit(module, 'jax_fft', 'GSAG_MU',
                        progress_callback=lambda m, e, seen=epochs: seen.append(e) or e < 1)
        out[module] = (nmf, nxt, epochs)
    (pm, p_next, p_epochs), (jm, j_next, j_epochs) = out.values()
    assert p_epochs == j_epochs == [0, 1]
    _assert_same(pm, jm)
    assert p_next == j_next


def test_epoch_log_lines_match_jax(caplog):
    """INFO logging writes the JAX package's ``Epoch: %d\\tEnergy function:``
    line after each epoch, with its energies."""
    lines = {}
    for module in (tnmf_tpu_torch, tnmf_tpu):
        logger = logging.getLogger(f'minibatch-log-{module.__name__}')
        np.random.seed(42)
        nmf = _model(module, 'jax_conv', logger=logger, verbose=2)
        with caplog.at_level(logging.INFO, logger=logger.name):
            caplog.clear()
            nmf.fit_minibatches(patches_2d()[:12], algorithm=module.MiniBatchAlgorithm.ASG_MU,
                                batch_size=5, n_epochs=2, sparsity_H=0.1)
        lines[module] = [r.getMessage() for r in caplog.records]
    p, j = lines[tnmf_tpu_torch], lines[tnmf_tpu]
    assert [line.split(':')[:2] for line in p] == [line.split(':')[:2] for line in j]
    assert p[-1] == j[-1] == 'MiniBatch TNMF finished.'
    epochs = [(float(a.rsplit(' ', 1)[1]), float(b.rsplit(' ', 1)[1]))
              for a, b in zip(p, j) if a.startswith('Epoch')]
    assert len(epochs) == 2
    np.testing.assert_allclose(*zip(*epochs), rtol=1e-10)


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


def test_minibatch_model_matches_jax():
    """``MiniBatchTransformInvariantNMF`` takes the schedule in its
    constructor, ``algorithm`` by name."""
    out = []
    for module in (tnmf_tpu_torch, tnmf_tpu):
        np.random.seed(42)
        nmf = _model(module, cls='MiniBatchTransformInvariantNMF', algorithm='GSAG_MU',
                     **SCHEDULE)
        nmf.fit(patches_2d(), sparsity_H=0.1)
        out.append((nmf, np.random.random()))
    (pm, p_next), (jm, j_next) = out
    assert pm.algorithm is MiniBatchAlgorithm.GSAG_MU and pm.batch_size == 5
    _assert_same(pm, jm)
    assert p_next == j_next
    np.testing.assert_allclose(pm._energy_function(), jm._energy_function(), rtol=1e-10)


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
