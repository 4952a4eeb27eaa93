"""The port's HALS sweeps (``sweep_fit(solver='hals')``) against the JAX
package's, on the CPU: the port's private ``_sweep_from_init_hals`` fed the
JAX package's own inits (``jax.vmap(init_one)(keys)``, through
``tests/jax_sweep.py``) against ``_sweep_impl_hals`` (plain and traced) and
``_sweep_impl_hals_tol`` in float64 (rtol 1e-8) and against the public
``sweep_fit`` in float32 (rtol 1e-5), on plain-NMF data with grids of
``sparsity`` and ``l2`` and one and two inner sweeps; each model against
the port's single ``engine_hals.fit_loop`` from the same init; the
operators' path (K5's vmap rule, its plain version model by model here)
against ``use_pallas=False``; ``auto_inner`` against the JAX package's;
and the JAX package's rejections, message for message.

On the CPU the HALS products of a float32 fit accumulate in float64
and round once (``kernels.hals.dot``, C3), so the CPU's float32 program
is not the card's arithmetic (float32 cuBLAS); ``chip_smoke.py`` checks
the card's."""

import numpy as np
import pytest
import torch
from tnmf_tpu import engine_hals as jax_engine_hals
from tnmf_tpu import sweep_fit as jax_sweep_fit

from tnmf_tpu_torch import engine_hals, sweep_fit
from tnmf_tpu_torch.models import sweep
from tnmf_tpu_torch.models.sweep import _sweep_from_init_hals

from . import jax_sweep

F64 = dict(rtol=1e-8, atol=1e-10)
F32 = dict(rtol=1e-5, atol=1e-6)
S = 4


def _data(n=8, c=1, shape=(24,), seed=7):
    """Low-rank nonnegative plain-NMF data ``(n, c, *shape)`` (as
    ``tests/test_sweep.py::_make_V_plain`` makes it), plus a little noise."""
    rng = np.random.default_rng(seed)
    F = c * int(np.prod(shape))
    V = rng.random((n, 3)) @ rng.random((3, F)) + 0.05 * rng.random((n, F))
    return V.reshape((n, c) + tuple(shape))


# (id, data, n_atoms, sweep keywords): per-model grids of sparsity and l2
CASES = [
    ('1-D', _data(), 4, dict(sparsity=[0.0, 0.05, 0.1, 0.2], l2=[0.1, 0.0, 0.05, 0.2])),
    ('2 channels', _data(n=6, c=2, shape=(10,), seed=3), 3,
     dict(sparsity=[0.2, 0.0, 0.1, 0.0], l2=0.1)),
    ('2-D', _data(n=6, shape=(4, 5), seed=5), 3, dict(sparsity=0.05, l2=[0.0, 0.3, 0.1, 0.0])),
]
IDS = [c[0] for c in CASES]
# (impl, the port's loop keywords); the tol runs check every 3 iterations
IMPLS = [('plain', {}), ('traced', dict(record_energies=True)),
         ('tol', dict(tol=1e-4, tol_check_every=3))]


def _jax_kw(impl: str) -> dict:
    return dict(tol=1e-4, check_every=3) if impl == 'tol' else {}


def _assert_close(res, out, impl: str, tol: dict):
    W, H, E = out[:3]
    np.testing.assert_allclose(res.W.numpy(), W, **tol)
    np.testing.assert_allclose(res.H.numpy(), H, **tol)
    got = res.energy_traces if impl == 'traced' else res.energies
    np.testing.assert_allclose(got.numpy(), E, rtol=tol['rtol'])
    if impl == 'tol':
        np.testing.assert_array_equal(res.n_iters.numpy(), out[3])


@pytest.mark.parametrize('inner', [1, 2])
@pytest.mark.parametrize('impl, loop', IMPLS, ids=[i[0] for i in IMPLS])
@pytest.mark.parametrize('name, V, n_atoms, kw', CASES, ids=IDS)
def test_hals_sweep_float64_matches_jax(name, V, n_atoms, kw, impl, loop, inner):
    keys = jax_sweep.keys_of(11, S)
    W0, H0, out = jax_sweep.run_hals(V, keys, n_atoms, impl=impl, n_iterations=12,
                                     hals_inner=inner, **_jax_kw(impl), **kw)
    res = _sweep_from_init_hals(V, W0, H0, n_iterations=12, hals_inner=inner, device='cpu',
                                **loop, **kw)
    assert res.W.dtype == res.H.dtype == torch.float64
    assert res.W.shape == W0.shape and res.H.shape == H0.shape
    _assert_close(res, out, impl, F64)


def test_hals_sweep_tol_models_stop_apart():
    """A grid whose models converge at different blocks: the same
    iterations per model as the JAX package, and a frozen model's state
    that of the fixed sweep run for its iterations, bit for bit."""
    V, n_atoms = CASES[0][1], CASES[0][2]
    kw = dict(sparsity=[0.0, 0.5, 2.0, 0.1])
    W0, H0, out = jax_sweep.run_hals(V, jax_sweep.keys_of(2, S), n_atoms, impl='tol',
                                     n_iterations=30, tol=1e-3, check_every=3, **kw)
    res = _sweep_from_init_hals(V, W0, H0, n_iterations=30, tol=1e-3, tol_check_every=3,
                                device='cpu', **kw)
    _assert_close(res, out, 'tol', F64)
    iters = out[3]
    assert len(set(iters.tolist())) > 1
    s = int(np.argmin(iters))
    fixed = _sweep_from_init_hals(V, W0, H0, n_iterations=int(iters[s]), device='cpu', **kw)
    assert torch.equal(res.W[s], fixed.W[s]) and torch.equal(res.H[s], fixed.H[s])


def _off(a, b) -> float:
    """max|a - b| / max|b|, in float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize('inner', [1, 2])
@pytest.mark.parametrize('impl, loop', IMPLS, ids=[i[0] for i in IMPLS])
@pytest.mark.parametrize('name, V, n_atoms, kw', CASES, ids=IDS)
def test_hals_sweep_float32_matches_jax_sweep_fit(name, V, n_atoms, kw, impl, loop, inner):
    """Each model's W, H and energy within 1e-5 of the JAX package's
    float32 sweep (max|port - jax| / max|jax|, per model), the same
    iterations per model under ``tol``; or, where float32 rounding itself
    moves a model that far (C1, ROADMAP.md section 3: the 1-D case's last
    model at two inner sweeps, whose W both packages' float32 sweeps put
    4e-4 to 7e-4 from the float64 sweep from the same init), the port's
    model no farther than twice the JAX package's from that float64
    sweep."""
    V32 = V.astype(np.float32)
    W0, H0 = jax_sweep.inits(V32, jax_sweep.keys_of(5, S), n_atoms, V.shape[2:], mode='full')
    ref = jax_sweep_fit(V32, n_atoms, V.shape[2:], n_models=S, seed=5, n_iterations=12,
                        reconstruction_mode='full', solver='hals', hals_inner=inner, **loop,
                        **kw)
    res = _sweep_from_init_hals(V32, W0, H0, n_iterations=12, hals_inner=inner, device='cpu',
                                **loop, **kw)
    assert res.W.dtype == torch.float32
    f64 = _sweep_from_init_hals(V, W0.astype(np.float64), H0.astype(np.float64),
                                n_iterations=12, hals_inner=inner, device='cpu', **loop, **kw)
    if impl == 'tol':
        np.testing.assert_array_equal(res.n_iters.numpy(), np.asarray(ref.n_iters))
    traced = impl == 'traced'
    E, E_ref = ((res.energy_traces, ref.energy_traces) if traced
                else (res.energies, ref.energies))
    for s in range(S):
        for got, want, exact in ((res.W[s], ref.W[s], f64.W[s]), (res.H[s], ref.H[s], f64.H[s]),
                                 (E[s], E_ref[s], None)):
            off = _off(got, want)
            if off > F32['rtol']:
                assert exact is not None, (s, off)
                assert _off(got, exact) <= 2 * _off(want, exact), (s, off)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('inner', [1, 2])
def test_each_model_matches_its_single_fit(dtype, inner):
    """Each model of the sweep against ``engine_hals.fit_loop`` from the
    same init with float strengths (float64: rtol 1e-12; float32: within
    1e-5 of max|W| and max|H| per model, the batched Gram products rounding
    apart from the single ones, or, where float32 rounding moves a model
    farther (C1: here W at one inner sweep, whose rows of nearly dead
    components have a tiny curvature), no farther from the float64 fit
    than twice the single fit is), and the sweep through the operators
    (float32: K5's vmap rule) against ``use_pallas=False``, bit for bit.
    In float32 the public ``sweep_fit`` draws these inits and returns this
    sweep, bit for bit."""
    name, V, n_atoms, kw = CASES[0]
    V = torch.tensor(V, dtype=dtype)
    W0, H0 = sweep._draw([torch.Generator().manual_seed(3)], S, (n_atoms, 1, V.shape[2]),
                         (V.shape[0], n_atoms, 1), 1, dtype, torch.device('cpu'))
    fit = dict(n_iterations=6, hals_inner=inner, device='cpu', **kw)
    res = _sweep_from_init_hals(V, W0, H0, **fit)
    assert res.W.dtype == dtype
    for s in range(S):
        W, H = engine_hals.fit_loop(V, W0[s], H0[s], 6, kw['sparsity'][s], kw['l2'][s], 0.0,
                                    0.0, inner=inner, update_H=True, update_W=True)
        V2, W2, H2 = engine_hals._flatten(V, W, H)
        E = engine_hals._energy(V2, W2, H2)
        if dtype == torch.float64:
            np.testing.assert_allclose(res.W[s].numpy(), W.numpy(), rtol=1e-12, atol=1e-14)
            np.testing.assert_allclose(res.H[s].numpy(), H.numpy(), rtol=1e-12, atol=1e-14)
            np.testing.assert_allclose(res.energies[s].item(), E.item(), rtol=1e-12)
        else:
            exact = engine_hals.fit_loop(V.double(), W0[s].double(), H0[s].double(), 6,
                                         kw['sparsity'][s], kw['l2'][s], 0.0, 0.0, inner=inner,
                                         update_H=True, update_W=True)
            for got, want, w64 in ((res.W[s], W, exact[0]), (res.H[s], H, exact[1]),
                                   (res.energies[s], E, None)):
                if _off(got, want) > 1e-5:
                    assert w64 is not None and _off(got, w64) <= 2 * _off(want, w64)
    plain = _sweep_from_init_hals(V, W0, H0, use_pallas=False, **fit)
    assert torch.equal(res.W, plain.W) and torch.equal(res.H, plain.H)
    assert torch.equal(res.energies, plain.energies)
    if dtype == torch.float32:
        public = sweep_fit(V, n_atoms, tuple(V.shape[2:]), n_models=S, seed=3,
                           reconstruction_mode='full', solver='hals', **fit)
        assert torch.equal(public.W, res.W) and torch.equal(public.H, res.H)
        assert torch.equal(public.energies, res.energies)


@pytest.mark.parametrize('m, F, inner, n', [(4, 24, 'auto', 8), (16, 4096, 'auto', 16384),
                                            (256, 4096, 'auto', 16384), (16, 256, None, 1024),
                                            (64, 512, 3, 2048), (8, 100, 'auto', None),
                                            (256, 16, 'auto', 100000)])
def test_auto_inner_matches_jax(m, F, inner, n):
    assert engine_hals.auto_inner(m, F, inner, n_samples=n) == \
        jax_engine_hals.auto_inner(m, F, inner, n_samples=n)


def _error_text(fn) -> tuple:
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


# (id, sweep keywords); the data is plain NMF unless 'atoms' says otherwise
REJECTIONS = [
    ('transform group', dict(transform_type='shift+flip')),
    ('beta 1', dict(beta_loss=1.0)),
    ('mask', dict(mask='ones')),
    ('inhibition', dict(inhibition=[0.0, 0.1])),
    ('cross inhibition', dict(cross_inhibition=0.1)),
    ('ortho', dict(ortho=[0.0, 0.2])),
    ('geometry', dict(atoms=(5,))),
    ('geometry valid', dict(reconstruction_mode='valid', atoms=(20,))),
    ('group and beta', dict(transform_type='shift+flip', beta_loss=0.5)),
    ('sparsity vector', dict(sparsity=[0.1, 0.2, 0.3])),
    ('l2 vector', dict(l2=np.zeros((2, 2)))),
    ('hals_inner 0', dict(hals_inner=0)),
    ('tol and traces', dict(tol=1e-3, record_energies=True)),
    ('negative tol', dict(tol=-1.0)),
]


@pytest.mark.parametrize('name, kw', REJECTIONS, ids=[r[0] for r in REJECTIONS])
def test_hals_rejections_match_jax(name, kw):
    """What the JAX package's ``sweep_fit(solver='hals')`` rejects the
    port rejects too, with the same exception and message."""
    V = _data(n=4, shape=(8,)).astype(np.float32)
    kw = dict(kw)
    atoms = kw.pop('atoms', (8,))
    if kw.get('mask') == 'ones':
        kw['mask'] = np.ones(V.shape, np.float32)
    fit = dict(n_models=2, seed=0, n_iterations=2, solver='hals',
               reconstruction_mode=kw.pop('reconstruction_mode', 'full'), **kw)
    want = _error_text(lambda: jax_sweep_fit(V, 3, atoms, **fit))
    got = _error_text(lambda: sweep_fit(V, 3, atoms, device='cpu', **fit))
    assert got == want


def test_hals_mesh_raises_not_ported():
    with pytest.raises(NotImplementedError, match=r'item 14e\b'):
        sweep_fit(_data(n=4, shape=(8,)), 3, (8,), n_models=2, reconstruction_mode='full',
                  solver='hals', mesh=object(), device='cpu')
