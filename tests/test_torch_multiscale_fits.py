"""The port's multi-scale minibatch, online and streaming fits against the
JAX package, in float64 on the CPU (within 1e-8): the five
``MiniBatchAlgorithm`` schedules with per-scale sparsity and their energy
traces, masks per sample and broadcast, beta = 1, conv and fft scales
together, Cyclic_MU against the full batch, callbacks, ``partial_fit``
(averaged and memoryless), ``fit_stream``, ``w_init='patches'`` and
``h_init='correlate'``, and one scale against the port's single-scale
minibatch fit.  The full-batch fits are in
``tests/test_torch_multiscale.py``."""

import numpy as np
import pytest
import torch

from tnmf_tpu.models import multiscale as jax_ms
from tnmf_tpu.models.tnmf import MiniBatchAlgorithm as JaxAlgorithm

from tnmf_tpu_torch import MiniBatchAlgorithm, MultiScaleTNMF, TransformInvariantNMF

from .test_multiscale import _data

CPU = dict(device='cpu', dtype=torch.float64)
TOL = dict(rtol=1e-8, atol=1e-10)
ALGORITHMS = [a.name for a in MiniBatchAlgorithm]


def _pair(kw, run):
    """``run(model, algorithm_enum)`` on the JAX model and on the port's,
    same constructor arguments; returns both."""
    jm = jax_ms.MultiScaleTNMF(**kw)
    pm = MultiScaleTNMF(**kw, **CPU)
    run(jm, JaxAlgorithm)
    run(pm, MiniBatchAlgorithm)
    return jm, pm


def _same(pm, jm):
    for k in range(jm.n_scales):
        np.testing.assert_allclose(pm.W[k], np.asarray(jm.W[k]), **TOL)
        np.testing.assert_allclose(pm.H[k], np.asarray(jm.H[k]), **TOL)


@pytest.mark.parametrize('algorithm', ALGORITHMS)
def test_algorithms_match_jax(algorithm):
    V = _data(seed=6, n=5)
    kw = dict(n_atoms=(2, 1), atom_shapes=((3,), (7,)), seed=1)
    jm, pm = _pair(kw, lambda m, A: m.fit_minibatches(
        V, algorithm=A[algorithm], batch_size=2, n_epochs=3, sparsity_H=(0.05, 0.0),
        record_energies=True))
    _same(pm, jm)
    assert pm.energies_.shape == (3,)
    np.testing.assert_allclose(pm.energies_, np.asarray(jm.energies_), rtol=1e-10)
    for Wk, a in zip(pm.W, pm.atom_shapes):
        np.testing.assert_allclose(Wk.sum(axis=tuple(range(-len(a), 0))), 1.0)


@pytest.mark.parametrize('mask', ['per_sample', 'broadcast'])
@pytest.mark.parametrize('algorithm', ['ASG_MU', 'GSAG_MU'])
def test_mixed_scales_with_a_mask_match_jax(algorithm, mask):
    """A conv and an fft scale (2-D, ``'auto'``) with a mask: per sample,
    sliced with the batches, or of one sample, serving every batch."""
    V = _data(seed=2, n=4, c=1, sample=(26, 26))
    rng = np.random.default_rng(3)
    shape = V.shape if mask == 'per_sample' else (1,) + V.shape[1:]
    M = (rng.random(shape) > 0.2).astype(np.float64)
    kw = dict(n_atoms=(2, 1), atom_shapes=((3, 3), (23, 23)), seed=5)
    jm, pm = _pair(kw, lambda m, A: m.fit_minibatches(
        V, algorithm=A[algorithm], batch_size=3, n_epochs=2, mask=M, sparsity_H=0.05))
    assert pm._strategies == ('conv', 'fft')
    _same(pm, jm)


def test_kl_minibatch_matches_jax():
    V = _data(seed=7, n=4, c=1)
    kw = dict(n_atoms=(2, 2), atom_shapes=((3,), (5,)), seed=2, beta_loss=1.0)
    jm, pm = _pair(kw, lambda m, A: m.fit_minibatches(
        V, algorithm=A.ASAG_MU, batch_size=3, n_epochs=2, sag_lambda=0.5))
    _same(pm, jm)


def test_cyclic_equals_full_batch():
    """Cyclic_MU over sequential slices is full-batch MU (the H updates have
    no cross-sample term, the W statistics are summed over the batches)."""
    V = _data(seed=4, n=4)
    kw = dict(n_atoms=(2, 2), atom_shapes=((3,), (6,)), seed=3)
    mb = MultiScaleTNMF(**kw, **CPU).fit_minibatches(
        V, algorithm=MiniBatchAlgorithm.Cyclic_MU, batch_size=2, n_epochs=4)
    fb = MultiScaleTNMF(**kw, **CPU).fit(V, n_iterations=4)
    for a, b in zip(mb.W + mb.H, fb.W + fb.H):
        np.testing.assert_allclose(a, b, **TOL)


def test_one_scale_equals_the_single_scale_minibatch_fit():
    V = _data(seed=9, n=6, c=1)
    ms = MultiScaleTNMF((3,), ((4,),), seed=11, **CPU).fit_minibatches(
        V, algorithm=MiniBatchAlgorithm.ASG_MU, batch_size=2, n_epochs=3)
    single = TransformInvariantNMF(3, (4,), seed=11, **CPU)
    single.fit_minibatches(V, algorithm=MiniBatchAlgorithm.ASG_MU, batch_size=2, n_epochs=3)
    np.testing.assert_allclose(ms.W[0], single.W, **TOL)
    np.testing.assert_allclose(ms.H[0], single.H, **TOL)


def test_callback_stops_and_masked_garbage_does_not_matter():
    V = _data(seed=2, n=4)
    M = np.ones_like(V)
    M[:, :, :4] = 0.0
    garbage = V.copy()
    garbage[:, :, :4] = 50.0
    seen = []
    kw = dict(n_atoms=(2,), atom_shapes=((3,),), seed=5)
    a = MultiScaleTNMF(**kw, **CPU)
    a.fit_minibatches(V, batch_size=2, n_epochs=50, mask=M,
                      progress_callback=lambda model, epoch: seen.append(epoch) or epoch < 1)
    assert seen == [0, 1] and a.energies_ is None
    b = MultiScaleTNMF(**kw, **CPU).fit_minibatches(garbage, batch_size=2, n_epochs=2, mask=M)
    c = MultiScaleTNMF(**kw, **CPU).fit_minibatches(V, batch_size=2, n_epochs=2, mask=M)
    for x, y in zip(b.W, c.W):
        np.testing.assert_allclose(x, y, **TOL)


@pytest.mark.parametrize('sag_lambda', [0.2, 1.0])
def test_partial_fit_matches_jax(sag_lambda):
    V = _data(seed=10, n=6, c=1)
    M = (np.random.default_rng(1).random(V.shape) > 0.1).astype(np.float64)
    kw = dict(n_atoms=(2, 1), atom_shapes=((3,), (6,)), seed=8)

    def run(m, A):
        m.partial_fit(V[:3], sag_lambda=sag_lambda, sparsity_H=(0.1, 0.0))
        m.partial_fit(V[3:], sag_lambda=sag_lambda, sparsity_H=(0.1, 0.0), mask=M[3:])
        m.partial_fit(V[1:4], sag_lambda=sag_lambda)
    jm, pm = _pair(kw, run)
    _same(pm, jm)
    assert pm.n_steps_ == 3
    assert (pm._sag_stat_ is None) == (sag_lambda == 1.0)
    pm.fit(V, n_iterations=1)
    assert pm._sag_stat_ is None


def test_first_memoryless_partial_fit_is_one_fit_iteration():
    V = _data(seed=12, n=3, c=1)
    kw = dict(n_atoms=(2, 1), atom_shapes=((3,), (6,)), seed=4)
    online = MultiScaleTNMF(**kw, **CPU).partial_fit(V, sag_lambda=1.0)
    batch = MultiScaleTNMF(**kw, **CPU).fit(V, n_iterations=1)
    for a, b in zip(online.W + online.H, batch.W + batch.H):
        assert np.array_equal(a, b)


@pytest.mark.parametrize('stream', [dict(subsample_size=3, n_iterations=3),
                                    dict(subsample_size=4, max_subsamples=1, n_iterations=2)])
def test_fit_stream_matches_jax(stream):
    V = _data(seed=8, n=9, c=1)
    kw = dict(n_atoms=(2,), atom_shapes=((3,),), seed=4)
    jm, pm = _pair(kw, lambda m, A: m.fit_stream(iter(V), **stream))
    _same(pm, jm)
    assert pm.H[0].shape[0] == (3 if 'max_subsamples' not in stream else 4)
    tensors = MultiScaleTNMF(**kw, **CPU).fit_stream(iter(torch.tensor(V)), **stream)
    for a, b in zip(tensors.W + tensors.H, pm.W + pm.H):
        assert np.array_equal(a, b)


@pytest.mark.parametrize('init', [dict(w_init='patches'), dict(h_init='correlate'),
                                  dict(w_init='patches', h_init='correlate', beta_loss=1.0)])
def test_initialisations_match_jax(init):
    V = _data(seed=3, n=3, c=2, sample=(12, 12))
    kw = dict(n_atoms=(2, 2), atom_shapes=((3, 3), (5, 5)), seed=6, **init)
    jm, pm = _pair(kw, lambda m, A: m.fit(V, n_iterations=3, sparsity_H=0.1))
    _same(pm, jm)
