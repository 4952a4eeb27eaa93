"""The port's sweep loops against the JAX package's, from its inits, in
float64 on the CPU: ``tol`` against ``_sweep_impl_tol`` (the same
iterations per model, and a frozen model's state unchanged after it
froze), ``record_energies`` against ``_sweep_impl_traced``; then
``sweep_fit``'s validation with the JAX package's error texts (HALS's
rejections of the MU-only knobs and of a non-degenerate geometry too),
and the part not ported (``mesh``) raising ``NotImplementedError`` with
its ROADMAP item."""

import numpy as np
import pytest

from tnmf_tpu_torch import sweep_fit
from tnmf_tpu_torch.models.sweep import _sweep_from_init

from . import jax_sweep

F64 = dict(rtol=1e-8, atol=1e-10)


def _data(n=4, s=12):
    return np.random.default_rng(7).random((n, 1, s, s))


# (id, sweep keywords): one model converges early, the others run on
TOL_CASES = [
    ('conv', dict(strategy='conv', sparsity=[0.0, 0.8, 0.1])),
    ('fft inhibited', dict(strategy='fft', sparsity=[0.3, 0.0, 0.8],
                           inhibition=[0.0, 0.1, 0.05])),
]


@pytest.mark.parametrize('name, kw', TOL_CASES, ids=[c[0] for c in TOL_CASES])
def test_sweep_tol_matches_jax(name, kw):
    V = _data()
    W0, H0, (W, H, E, iters) = jax_sweep.run(V, jax_sweep.keys_of(13, 3), 3, (3, 3),
                                             impl='tol', n_iterations=40, tol=2e-3,
                                             check_every=4, **kw)
    res = _sweep_from_init(V, W0, H0, n_iterations=40, tol=2e-3, tol_check_every=4,
                           device='cpu', **kw)
    np.testing.assert_array_equal(res.n_iters.numpy(), iters)
    assert len(set(iters.tolist())) > 1  # the models stopped at different blocks
    np.testing.assert_allclose(res.W.numpy(), W, **F64)
    np.testing.assert_allclose(res.H.numpy(), H, **F64)
    np.testing.assert_allclose(res.energies.numpy(), E, rtol=1e-8)
    # a model that froze holds the state it had when it froze: the fixed
    # sweep run for its iterations, bit for bit
    s = int(np.argmin(iters))
    fixed = _sweep_from_init(V, W0, H0, n_iterations=int(iters[s]), device='cpu', **kw)
    assert np.array_equal(res.W[s].numpy(), fixed.W[s].numpy())
    assert np.array_equal(res.H[s].numpy(), fixed.H[s].numpy())


def test_sweep_tol_zero_runs_to_n_iterations():
    V = _data(n=2, s=10)
    kw = dict(sparsity=[0.0, 0.4], strategy='conv')
    W0, H0 = jax_sweep.inits(V, jax_sweep.keys_of(3, 2), 2, (3, 3))
    fixed = _sweep_from_init(V, W0, H0, n_iterations=12, device='cpu', **kw)
    tolled = _sweep_from_init(V, W0, H0, n_iterations=12, tol=0.0, tol_check_every=5,
                              device='cpu', **kw)
    np.testing.assert_array_equal(tolled.n_iters.numpy(), [12, 12])
    np.testing.assert_allclose(tolled.W.numpy(), fixed.W.numpy(), **F64)
    np.testing.assert_allclose(tolled.energies.numpy(), fixed.energies.numpy(), rtol=1e-12)


@pytest.mark.parametrize('strategy', ['conv', 'fft'])
def test_sweep_record_energies_matches_jax(strategy):
    V = _data(n=2, s=10)
    kw = dict(strategy=strategy, sparsity=[0.0, 0.3], inhibition=[0.1, 0.0])
    W0, H0, (W, H, traces) = jax_sweep.run(V, jax_sweep.keys_of(7, 2), 2, (3, 3),
                                           impl='traced', n_iterations=6, **kw)
    res = _sweep_from_init(V, W0, H0, n_iterations=6, record_energies=True, device='cpu', **kw)
    assert res.energy_traces.shape == (2, 6)
    np.testing.assert_allclose(res.energy_traces.numpy(), traces, rtol=1e-8)
    np.testing.assert_array_equal(res.energies.numpy(), res.energy_traces[:, -1].numpy())
    np.testing.assert_allclose(res.W.numpy(), W, **F64)
    np.testing.assert_allclose(res.H.numpy(), H, **F64)
    plain = _sweep_from_init(V, W0, H0, n_iterations=6, device='cpu', **kw)
    assert plain.energy_traces is None and plain.n_iters is None
    np.testing.assert_allclose(res.W.numpy(), plain.W.numpy(), rtol=1e-12, atol=0)


def _V():
    return _data(n=2, s=10)


# (id, sweep_fit keywords, error, JAX's text)
ERRORS = [
    ('tol and traces', dict(n_models=2, tol=1e-3, record_energies=True), ValueError,
     'mutually exclusive'),
    ('negative tol', dict(n_models=2, tol=-1.0), ValueError, 'tol must be'),
    ('check_every 0', dict(n_models=2, tol=1e-3, tol_check_every=0), ValueError,
     'tol must be'),
    ('negative data', dict(n_models=2, V=-1.0), ValueError, 'nonnegative'),
    ('zero under IS', dict(n_models=2, beta_loss=0.0, V='zero'), ValueError,
     'strictly positive'),
    ('scalar seed alone', dict(), ValueError, 'pass n_models'),
    ('seed vector and n_models', dict(n_models=2, seed=np.array([1, 2])), ValueError,
     'either n_models'),
    ('sparsity vector', dict(n_models=3, sparsity=np.array([0.1, 0.2])), ValueError,
     r'sparsity must be a scalar or a vector of one value per model \(expected shape '
     r'\(3,\), got \(2,\)\)'),
    ('unknown solver', dict(n_models=2, solver='cd'), ValueError, "solver must be 'mu' or "
     "'hals'"),
    ('mesh', dict(n_models=2, mesh=object()), NotImplementedError, r'item 14e\b'),
    ('hals group', dict(n_models=2, solver='hals', transform_type='shift+flip'), ValueError,
     'transform groups are MU-only'),
    ('hals beta', dict(n_models=2, solver='hals', beta_loss=1.0), ValueError,
     "solver='hals' requires beta_loss=2"),
    ('hals mask', dict(n_models=2, solver='hals', mask=np.ones((2, 1, 10, 10))), ValueError,
     'masked/weighted sweeps are MU-only'),
    ('hals inhibition', dict(n_models=2, solver='hals', inhibition=[0.0, 0.1]), ValueError,
     'MU-only regularizers'),
    ('hals geometry', dict(n_models=2, solver='hals'), ValueError,
     'degenerate plain-NMF geometry'),
    ('hals mesh', dict(n_models=2, solver='hals', mesh=object()), NotImplementedError,
     r'item 14e\b'),
]


@pytest.mark.parametrize('name, kw, error, text', ERRORS, ids=[e[0] for e in ERRORS])
def test_sweep_fit_errors(name, kw, error, text):
    kw = dict(kw)
    V = _V()
    if kw.get('V') == -1.0:
        V = V - 1.0
    elif kw.get('V') == 'zero':
        V[0, 0, 0, 0] = 0.0
    kw.pop('V', None)
    with pytest.raises(error, match=text):
        sweep_fit(V, 2, (3, 3), device='cpu', **{'seed': 0, **kw})
