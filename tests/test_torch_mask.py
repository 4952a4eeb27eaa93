"""The port's masked (missing-data and weighted) fits against the JAX
package, in float64 on the CPU: binary and float masks, masks broadcast on
the sample and channel axes, at beta = 2 and beta != 2 on the conv, fft and
dot strategies; masked values that never leak into the fit; ``l2_H`` and
``ortho_W`` with inhibition under a mask; the ``record_energies``, ``tol``
and extrapolated traces; the five minibatch algorithms, ``partial_fit`` and
``fit_stream``; ``transform(batch_size)`` with a per-sample mask;
``h_init='correlate'``; and the error paths of ``_prepare_mask``."""

import numpy as np
import pytest
import torch

import tnmf_tpu

import tnmf_tpu_torch

F64 = torch.float64
TOL = dict(rtol=1e-8, atol=1e-10)
CASES = {  # strategy: (data shape, atom shape, mode)
    'conv': ((3, 2, 12, 14), (3, 4), 'valid'),
    'fft': ((3, 2, 40), (5,), 'full'),
    'dot': ((6, 2, 10), (10,), 'full'),
}


def _model(module, atom_shape, backend='auto', cls='TransformInvariantNMF', **kw):
    if module is tnmf_tpu_torch:
        kw.update(device='cpu', dtype=F64)
    return getattr(module, cls)(3, atom_shape, backend=backend, seed=3, **kw)


def _data(shape, seed=0):
    return np.random.default_rng(seed).random(shape) + 0.05


def _mask(kind, shape, seed=1):
    """A binary (missing data) or float (weights) mask, full or broadcast on
    the sample or the channel axis."""
    rng = np.random.default_rng(seed)
    if kind == 'broadcast samples':
        shape = (1,) + shape[1:]
    elif kind == 'broadcast channels':
        shape = shape[:1] + (1,) + shape[2:]
    m = (rng.random(shape) > 0.25).astype(np.float64)
    return m * rng.uniform(0.5, 2.0, shape) if kind == 'float' else m


def _pair(strategy, init=None, run=None):
    """``run(model, package)`` on a seeded model of each package; returns
    (port, jax)."""
    shape, atom, mode = CASES[strategy]
    backend = 'jax_fft' if strategy == 'fft' else 'jax_conv'
    out = []
    for module in (tnmf_tpu_torch, tnmf_tpu):
        m = _model(module, atom, backend, reconstruction_mode=mode, **(init or {}))
        run(m, module)
        out.append(m)
    assert out[0]._strategy == strategy
    return out


def _assert_same(pm, jm, energy=True):
    np.testing.assert_allclose(pm.W, jm.W, **TOL)
    np.testing.assert_allclose(pm.H, jm.H, **TOL)
    if energy:
        np.testing.assert_allclose(pm._energy_function(), jm._energy_function(), rtol=1e-8)


@pytest.mark.parametrize('b', [2.0, 1.0, 0.5])
@pytest.mark.parametrize('kind', ['binary', 'float', 'broadcast samples', 'broadcast channels'])
@pytest.mark.parametrize('strategy', list(CASES))
def test_masked_fits_match_jax(strategy, kind, b):
    """beta = 2 holds ``prepare(mask * V)`` and masks R; other betas mask
    the factor streams, which K3 and K2 (conv) or the pair and K1 take."""
    shape = CASES[strategy][0]
    V, mask = _data(shape), _mask(kind, shape)
    pm, jm = _pair(strategy, dict(beta_loss=b),
                   lambda m, _: m.fit_batch(V, n_iterations=3, sparsity_H=0.1, mask=mask))
    _assert_same(pm, jm)


@pytest.mark.parametrize('b', [2.0, 1.0, 0.0])
@pytest.mark.parametrize('strategy', ['conv', 'fft'])
def test_masked_values_never_leak(strategy, b):
    """Entries under a zero mask may hold anything (zeros too, under
    Itakura-Saito): the fit and its energy keep their bits, and the mask
    given as a tensor is the array's."""
    shape = CASES[strategy][0]
    V, mask = _data(shape), _mask('binary', shape)
    hidden = np.where(mask > 0, V, np.random.default_rng(7).choice([0., 1e6], shape))
    fits = []
    for data, m in ((V, mask), (hidden, mask), (hidden, torch.tensor(mask))):
        nmf = _model(tnmf_tpu_torch, CASES[strategy][1],
                     'jax_fft' if strategy == 'fft' else 'jax_conv',
                     reconstruction_mode=CASES[strategy][2], beta_loss=b)
        nmf.fit_batch(data, n_iterations=3, sparsity_H=0.1, mask=m)
        fits.append(nmf)
    for other in fits[1:]:
        assert torch.equal(fits[0]._W, other._W) and torch.equal(fits[0]._H, other._H)
        assert fits[0]._energy_function() == other._energy_function()


@pytest.mark.parametrize('b', [2.0, 1.0])
@pytest.mark.parametrize('strategy', ['conv', 'fft'])
def test_penalties_and_inhibition_under_a_mask(strategy, b):
    shape = CASES[strategy][0]
    V, mask = _data(shape), _mask('float', shape)
    pm, jm = _pair(strategy, dict(beta_loss=b), lambda m, _: m.fit_batch(
        V, n_iterations=3, sparsity_H=0.1, l2_H=0.3, ortho_W=0.2, inhibition_strength=0.2,
        cross_atom_inhibition_strength=0.1, mask=mask))
    _assert_same(pm, jm)


@pytest.mark.parametrize('loop', [dict(record_energies=True),
                                  dict(tol=1e-3, tol_check_every=2, record_energies=True),
                                  dict(extrapolate=True, tol=0., tol_check_every=2,
                                       record_energies=True),
                                  dict(progress_callback=lambda m, i: True,
                                       callback_interval=2, record_energies=True)],
                         ids=['energies', 'tol', 'extrapolate', 'chunks'])
@pytest.mark.parametrize('b', [1.0, 0.5])
def test_fit_loop_traces_under_beta_and_mask(b, loop):
    """The energy traces read the masked divergence of the fit's beta."""
    shape = CASES['conv'][0]
    V, mask = _data(shape), _mask('binary', shape)
    pm, jm = _pair('conv', dict(beta_loss=b), lambda m, _: m.fit_batch(
        V, n_iterations=6, sparsity_H=0.1, mask=mask, **loop))
    _assert_same(pm, jm)
    assert pm.n_iterations_ == jm.n_iterations_
    np.testing.assert_allclose(pm.energies_, np.asarray(jm.energies_), rtol=1e-8)


@pytest.mark.parametrize('algorithm', [a.name for a in tnmf_tpu_torch.MiniBatchAlgorithm])
def test_minibatch_algorithms_with_a_mask_and_kl(algorithm):
    """Each batch takes its rows of the mask (a ragged last batch too); the
    per-epoch energies are the masked KL divergence; ``ortho_W`` is formed
    from the current W at each update, never averaged."""
    shape = (7, 2, 12, 14)
    V, mask = _data(shape), _mask('float', shape)

    def run(m, module):
        m.fit_minibatches(V, algorithm=module.MiniBatchAlgorithm[algorithm], batch_size=3,
                          n_epochs=2, sag_lambda=0.7, sparsity_H=0.1, ortho_W=0.2, mask=mask,
                          record_energies=True)
    pm, jm = _pair('conv', dict(beta_loss=1.0), run)
    _assert_same(pm, jm)
    np.testing.assert_allclose(pm.energies_, jm.energies_, rtol=1e-8)


def test_broadcast_mask_serves_every_batch():
    shape = (5, 2, 40)
    V, mask = _data(shape), _mask('broadcast samples', shape)
    out = []
    for module in (tnmf_tpu_torch, tnmf_tpu):
        m = _model(module, (5,), 'jax_fft', beta_loss=0.5)
        m.fit_minibatches(V, algorithm=module.MiniBatchAlgorithm.ASAG_MU, batch_size=2,
                          n_epochs=2, sparsity_H=0.1, l2_H=0.2, mask=mask)
        out.append(m)
    _assert_same(*out)


def test_partial_fit_and_fit_stream_with_a_mask():
    shape = (4, 2, 12, 14)
    V, mask = _data(shape), _mask('binary', shape)
    batch_mask = _mask('broadcast channels', (2,) + shape[1:])
    out = []
    for module in (tnmf_tpu_torch, tnmf_tpu):
        m = _model(module, (3, 4), beta_loss=1.0)
        m.partial_fit(V[:2], mask=batch_mask, sparsity_H=0.1, l2_H=0.1, ortho_W=0.1)
        m.partial_fit(V[2:], mask=batch_mask, sag_lambda=0.5, ortho_W=0.1)
        s = _model(module, (3, 4), beta_loss=1.0)
        np.random.seed(11)
        s.fit(iter(V), subsample_size=2, batch_size=1, n_epochs=1, mask=mask[:1],
              sparsity_H=0.1)
        out.append((m, s))
    (pm, ps), (jm, js) = out
    _assert_same(pm, jm)
    _assert_same(ps, js)
    assert pm.n_steps_ == 2


def test_transform_slices_a_per_sample_mask():
    """``transform(batch_size)`` slices a mask with a row per sample along
    with the chunks and passes a broadcast one whole, as the JAX package
    does; each chunk's H is the whole call's."""
    shape = (5, 2, 12, 14)
    V, mask = _data(shape), _mask('float', shape)
    out = []
    for module in (tnmf_tpu_torch, tnmf_tpu):
        m = _model(module, (3, 4), beta_loss=1.0, h_init='correlate')
        m.fit_batch(V, n_iterations=2)
        new = _data(shape, seed=4)
        out.append((m.transform(new, n_iterations=3, batch_size=2, mask=mask,
                                sparsity_H=0.1),
                    m.transform(new, n_iterations=3, mask=mask, sparsity_H=0.1),
                    m.transform(new, n_iterations=3, batch_size=2, mask=mask[:1])))
    for got, want in zip(*out):
        np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(out[0][0], out[0][1], **TOL)


@pytest.mark.parametrize('b', [2.0, 1.0])
@pytest.mark.parametrize('strategy', ['conv', 'fft'])
def test_correlate_init_under_a_mask(strategy, b):
    """The matched filter reads ``prepare(mask * V)`` at beta = 2 and
    ``prepare(V)`` where the prepared slot holds the canonical V."""
    shape = CASES[strategy][0]
    V, mask = _data(shape), _mask('binary', shape)
    pm, jm = _pair(strategy, dict(beta_loss=b, h_init='correlate'),
                   lambda m, _: m.fit_batch(V, n_iterations=1, mask=mask))
    _assert_same(pm, jm)


def test_mask_error_paths():
    V = np.ones((2, 1, 8))
    m = _model(tnmf_tpu_torch, (3,))
    with pytest.raises(ValueError, match='nonnegative'):
        m.fit(V, n_iterations=1, mask=-np.ones((2, 1, 8)))
    with pytest.raises(ValueError, match='same rank'):
        m.fit(V, n_iterations=1, mask=np.ones((1, 8)))
    with pytest.raises(ValueError, match='does not broadcast'):
        m.fit(V, n_iterations=1, mask=np.ones((3, 1, 8)))
    with pytest.raises(ValueError, match='does not broadcast'):
        m.fit_minibatches(V, batch_size=1, n_epochs=1, mask=np.ones((2, 1, 7)))
    with pytest.raises(ValueError, match='same rank'):
        m.partial_fit(V, mask=np.ones((2, 8)))
    # Itakura-Saito needs V > 0 only where the mask is positive
    IS = _model(tnmf_tpu_torch, (3,), beta_loss='itakura-saito')
    zeros = np.where(np.arange(8) < 2, 0., 1.)[None, None].repeat(2, axis=0)
    IS.fit(zeros, n_iterations=1, mask=(zeros > 0).astype(float))
    with pytest.raises(ValueError, match='strictly positive'):
        IS.fit(zeros, n_iterations=1, mask=np.ones((1, 1, 8)))
    with pytest.raises(ValueError, match='strictly positive'):
        IS.fit(torch.tensor(zeros), n_iterations=1, mask=torch.ones(2, 1, 8))
