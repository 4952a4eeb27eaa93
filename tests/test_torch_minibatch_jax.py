"""The port's minibatch fits against the JAX package, in float64 on the
CPU: W and H of the five algorithms, inhibited epochs, energy traces,
callbacks and logging, the global NumPy stream after each fit and
``MiniBatchTransformInvariantNMF`` (``tests/test_torch_minibatch.py`` holds
the goldens, the dispatch and ``use_pallas``).

The data and schedule are the goldens' (``tests/torch_minibatch.py``)."""

import logging

import numpy as np
import pytest

import tnmf_tpu

import tnmf_tpu_torch
from tnmf_tpu_torch import MiniBatchAlgorithm

from .torch_minibatch import (ALGORITHMS, SCHEDULE, TOL, _assert_same, _fit, _jax_fit, _model,
                              patches_2d)
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')


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
