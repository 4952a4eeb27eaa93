"""The port's plain-NMF HALS solver (tnmf_tpu_torch.engine_hals and
fit(solver='hals') on the degenerate geometry) against the JAX package's, in
float64 on the CPU: K5's plain version against the JAX sweeps, iterations
against the float64 Gauss-Seidel oracle, fits through every loop of the
dispatch, the energy, the dead-component rule, auto_inner, transform and the
rejections.  On the CPU the HALS products of a float32 fit accumulate in float64
and round once (``kernels.hals.dot``, C3), so the CPU's float32 program
is not the card's arithmetic (float32 cuBLAS); ``chip_smoke.py`` checks
the card's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tnmf_tpu
from tnmf_tpu import engine_hals as jeh

import tnmf_tpu_torch
from tnmf_tpu_torch import engine_hals as eh
from tnmf_tpu_torch.kernels.hals import hals_sweep, hals_sweep_plain

F64 = torch.float64
TOL = dict(rtol=1e-8, atol=1e-10)
PACKAGES = (tnmf_tpu, tnmf_tpu_torch)


def _problem(n=12, F=30, m=4, seed=0, rank=None):
    """Low-rank nonnegative data (n, 1, F) and its flat (n, F) view."""
    rng = np.random.default_rng(seed)
    V2 = rng.random((n, rank or m)) @ rng.random((rank or m, F))
    return V2.reshape(n, 1, F), V2


def _model(module, m=4, F=30, **init):
    kw = dict(device='cpu', dtype=F64) if module is tnmf_tpu_torch else {}
    return module.TransformInvariantNMF(m, (F,), reconstruction_mode='full', verbose=0,
                                        **init, **kw)


def _fit_both(V, m=4, seed=7, **fit):
    """The JAX model and the port's, seeded alike and fit alike."""
    out = []
    for module in PACKAGES:
        np.random.seed(seed)
        model = _model(module, m=m, F=V.shape[-1])
        model.fit(V, solver='hals', **fit)
        out.append(model)
    return out


def _assert_same(jm, pm, energies=False):
    assert pm._strategy == jm._strategy == 'dot'
    assert pm.n_iterations_ == jm.n_iterations_
    np.testing.assert_allclose(pm.W, jm.W, **TOL)
    np.testing.assert_allclose(pm.H, jm.H, **TOL)
    if energies:
        np.testing.assert_allclose(pm.energies_, np.asarray(jm.energies_), **TOL)


def _t(x):
    return torch.tensor(np.asarray(x), dtype=F64)


@pytest.mark.parametrize('inner', [1, 4])
def test_sweep_plain_matches_jax_sweeps(inner):
    """K5's plain version is the JAX _sweep_H applied ``inner`` times, and on
    (W^T, A^T, B^T) the JAX _sweep_W, dead rows and columns included."""
    rng = np.random.default_rng(1)
    n, m, F = 11, 9, 30
    V2 = rng.random((n, 5)) @ rng.random((5, F))
    W2, H2 = rng.random((m, F)), rng.random((n, m))
    W2[5] = 0.0     # dead dictionary row: zero curvature in the H sweep
    H2[:, 3] = 0.0  # unused component: zero curvature in the W sweep
    G, P, A, B = W2 @ W2.T, V2 @ W2.T, H2.T @ H2, H2.T @ V2
    l1, l2 = 0.03, 0.1
    Hj, Wj = jnp.asarray(H2), jnp.asarray(W2)
    for _ in range(inner):
        Hj = jeh._sweep_H(Hj, jnp.asarray(G), jnp.asarray(P), jnp.float64(l1), jnp.float64(l2))
        Wj = jeh._sweep_W(Wj, jnp.asarray(A), jnp.asarray(B), jnp.float64(l1), jnp.float64(l2))
    Hp = hals_sweep_plain(_t(H2), _t(G), _t(P), l1, l2, inner)
    Wp = hals_sweep_plain(_t(W2).T, _t(A).T, _t(B).T, l1, l2, inner).T
    np.testing.assert_allclose(Hp.numpy(), np.asarray(Hj), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(Wp.numpy(), np.asarray(Wj), rtol=1e-12, atol=1e-14)
    # the wrapper takes the plain version for CPU tensors and keeps them in place
    np.testing.assert_array_equal(hals_sweep(_t(H2), _t(G), _t(P), l1, l2, inner).numpy(),
                                  Hp.numpy())
    assert hals_sweep.launches == 0


def test_k5_off_the_cpu_never_takes_the_plain_version():
    """A tensor off the CPU goes to K5 or raises; here (meta tensors, no
    card) it raises before any build, and the engine's gate sends float64
    and ``use_pallas=False`` to the plain version."""
    from tnmf_tpu_torch.kernels import _build
    X, G = torch.empty((6, 3), device='meta'), torch.empty((3, 3), device='meta')
    with pytest.raises(ValueError, match='expected CUDA'):
        hals_sweep(X, G, X, 0.1, 0.0, 1)
    with pytest.raises(ValueError, match='do not fit'):
        hals_sweep(X, G, X[:, :2], 0.1, 0.0, 1)
    assert _build._lib is None and hals_sweep.launches == 0
    rng = np.random.default_rng(3)
    X, G = (torch.tensor(rng.random(s), dtype=torch.float32) for s in ((6, 3), (3, 3)))
    for x, g, flag in ((X, G, True), (X.double(), G.double(), True), (X, G, False)):
        np.testing.assert_array_equal(eh._sweep_H(x, g, x, 0.1, 0.0, 2, flag).numpy(),
                                      hals_sweep_plain(x, g, x, 0.1, 0.0, 2).numpy())


@pytest.mark.parametrize('inner', [1, 3])
@pytest.mark.parametrize('regs', [(0., 0., 0., 0.), (0.05, 0.2, 0.3, 0.5)],
                         ids=['plain', 'regularized'])
def test_iterations_match_numpy_oracle(inner, regs):
    """Seven iterations of the engine against the float64 oracle
    ``np_hals_iteration``, with and without l1/l2 on both factors."""
    l1, l2, l1w, l2w = regs
    V, V2 = _problem()
    rng = np.random.default_rng(2)
    W0, H0 = rng.random((4, 1, 30)), rng.random((12, 4, 1))
    W, H = eh.fit_loop(_t(V), _t(W0), _t(H0), 7, *regs, inner=inner, update_H=True,
                       update_W=True)
    W2, H2 = W0.reshape(4, -1), H0.reshape(12, 4)
    for _ in range(7):
        W2, H2 = jeh.np_hals_iteration(V2, W2, H2, l1=l1, l2=l2, l1w=l1w, l2w=l2w,
                                       inner=inner)
    np.testing.assert_allclose(W.numpy().reshape(4, -1), W2, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(H.numpy().reshape(12, 4), H2, rtol=1e-9, atol=1e-12)
    assert W.shape == W0.shape and H.shape == H0.shape and H.is_contiguous()


LOOPS = {
    'plain': dict(n_iterations=9),
    'regularized inner 2': dict(n_iterations=6, hals_inner=2, sparsity_H=0.02, l2_H=0.1,
                                sparsity_W=0.3, l2_W=0.5),
    'record_energies': dict(n_iterations=9, record_energies=True),
    'tol': dict(n_iterations=300, tol=1e-6, tol_check_every=5),
    'tol with trace': dict(n_iterations=300, tol=1e-6, tol_check_every=5,
                           record_energies=True),
    'callback': dict(n_iterations=9, progress_callback=lambda m, i: True),
    'callback abort': dict(n_iterations=50, progress_callback=lambda m, i: i < 3),
    'chunked callback with energies': dict(n_iterations=9, record_energies=True,
                                           progress_callback=lambda m, i: True,
                                           callback_interval=4),
    'per-iteration energies': dict(n_iterations=5, record_energies=True,
                                   progress_callback=lambda m, i: True),
}


@pytest.mark.parametrize('loop', list(LOOPS))
def test_fit_matches_jax(loop):
    """``fit(solver='hals')`` against the JAX model from the same seeded
    start through each loop of the dispatch: W, H, the count and the
    energies within 1e-8."""
    V, _ = _problem(seed=5)
    fit = LOOPS[loop]
    jm, pm = _fit_both(V, **fit)
    _assert_same(jm, pm, energies=fit.get('record_energies', False))
    if loop == 'tol':
        assert 0 < pm.n_iterations_ < 300 and pm.n_iterations_ % 5 == 0
    if loop == 'callback abort':
        assert pm.n_iterations_ == 4


def test_checkpoint_resume_matches_jax(tmp_path):
    """checkpoint_every under HALS: each package's resumed fit lands on the
    uninterrupted trajectory, and the two agree."""
    V, _ = _problem(seed=19)
    out = []
    for module in PACKAGES:
        path = str(tmp_path / f'{module.__name__}.npz')
        np.random.seed(3)
        full = _model(module)
        full.fit(V, n_iterations=12, solver='hals')
        np.random.seed(3)
        crashed = _model(module)
        crashed.fit(V, n_iterations=8, solver='hals', checkpoint_every=4,
                    checkpoint_path=path)
        kw = dict(device='cpu', dtype=F64) if module is tnmf_tpu_torch else {}
        resumed = module.TransformInvariantNMF.load(path, **kw)
        assert resumed.last_checkpoint_iteration_ == 8
        resumed.fit(V, n_iterations=4, solver='hals', keep_W=True, keep_H=True)
        np.testing.assert_allclose(resumed.W, full.W, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(resumed.H, full.H, rtol=1e-9, atol=1e-12)
        out.append(resumed)
    np.testing.assert_allclose(out[1].W, out[0].W, **TOL)
    np.testing.assert_allclose(out[1].H, out[0].H, **TOL)


def test_monotone_energy_and_update_flags():
    """Each component update is the exact minimizer: the energy never
    rises.  update_W=False keeps W, update_H=False keeps H, as in JAX."""
    V, _ = _problem(seed=7, rank=6)
    jm, pm = _fit_both(V, n_iterations=40, record_energies=True)
    e = pm.energies_
    assert e.shape == (40,) and np.all(np.diff(e) <= 1e-12 * e[0])
    _assert_same(jm, pm, energies=True)
    for flag in ('update_W', 'update_H'):
        models = []
        for module in PACKAGES:
            np.random.seed(3)
            m = _model(module)
            m.fit(V, n_iterations=0, solver='hals')
            W0, H0 = m.W.copy(), m.H.copy()
            m.fit(V, keep_W=True, keep_H=True, n_iterations=3, solver='hals', **{flag: False})
            frozen, moved = (m.W, m.H) if flag == 'update_W' else (m.H, m.W)
            np.testing.assert_array_equal(frozen, W0 if flag == 'update_W' else H0)
            assert not np.allclose(moved, H0 if flag == 'update_W' else W0)
            models.append(m)
        np.testing.assert_allclose(models[1].W, models[0].W, **TOL)
        np.testing.assert_allclose(models[1].H, models[0].H, **TOL)


def test_dead_component_revives_as_in_jax():
    """A zeroed atom has zero curvature: its H column is skipped (no inf or
    nan), and the atom re-enters through the W sweep, as in JAX."""
    V, _ = _problem(seed=13, rank=6)
    out = []
    for module in PACKAGES:
        np.random.seed(3)
        m = _model(module)
        m.fit(V, n_iterations=0, solver='hals')
        W = m.W.copy()
        W[2] = 0.0
        m._W = jnp.asarray(W) if module is tnmf_tpu else _t(W)
        m.fit(V, keep_W=True, keep_H=True, n_iterations=10, solver='hals')
        assert np.isfinite(m.W).all() and np.isfinite(m.H).all() and m.W[2].sum() > 0
        out.append(m)
    np.testing.assert_allclose(out[1].W, out[0].W, **TOL)
    np.testing.assert_allclose(out[1].H, out[0].H, **TOL)


def test_auto_inner_matches_jax():
    for m in (1, 4, 16, 64, 256, 1024):
        for F in (30, 256, 4096, 65536):
            for n in (None, 0, 100, 4096, 16384, 1 << 20):
                assert eh.auto_inner(m, F, n_samples=n) == jeh.auto_inner(m, F, n_samples=n)
    assert eh.auto_inner(256, 4096, n_samples=16384) == 1
    assert eh.auto_inner(4, 30, inner=2) == jeh.auto_inner(4, 30, inner=2) == 2
    assert eh.auto_inner(4, 30, inner=None) == jeh.auto_inner(4, 30, inner=None)
    for pkg in (eh, jeh):
        with pytest.raises(ValueError, match='hals_inner'):
            pkg.auto_inner(4, 30, inner=0)


def test_transform_hals_matches_jax():
    """``transform(solver='hals')``: H-only exact sweeps against the frozen
    dictionary, whole and in chunks, against the JAX package's."""
    V, _ = _problem(n=12, seed=21)
    Vn, _ = _problem(n=8, seed=22)
    jm, pm = _fit_both(V, n_iterations=20)
    Hs = []
    for model in (jm, pm):
        np.random.seed(9)
        H = model.transform(Vn, n_iterations=15, solver='hals', sparsity_H=0.01)
        np.random.seed(9)
        Hc = model.transform(Vn, n_iterations=15, solver='hals', sparsity_H=0.01,
                             batch_size=3)
        np.testing.assert_allclose(Hc, H, rtol=1e-9, atol=1e-12)
        Hs.append(H)
    np.testing.assert_allclose(Hs[1], Hs[0], **TOL)
    np.testing.assert_allclose(pm.W, jm.W, **TOL)


def test_float32_fit_on_a_nearly_rank_one_gram_is_no_farther_off_than_jax():
    """C1 (ROADMAP.md section 3): plain-NMF HALS on random nonnegative
    samples, 2048 x 512 with 64 atoms, whose W-sweep Gram ``H^T H`` is
    nearly rank one.  After 2 iterations from one seeded start the port's
    float32 fit is no farther from its float64 fit than the JAX package's
    float32 fit is from the same float64 fit (both about 1e-5 off here;
    the float64 fits agree to 1e-13)."""
    V = np.random.default_rng(0).random((2048, 1, 512))
    fits = {}
    for module in PACKAGES:
        for dtype in ('float32', 'float64'):
            kw = dict(device='cpu', dtype=getattr(torch, dtype)) if module is tnmf_tpu_torch \
                else dict(dtype=dtype)
            m = module.TransformInvariantNMF(64, (512,), reconstruction_mode='full', seed=0,
                                             **kw)
            m.fit(V.astype(dtype), n_iterations=2, solver='hals')
            fits[module, dtype] = (np.asarray(m.W, np.float64), np.asarray(m.H, np.float64))

    def off(module, i):
        got, want = fits[module, 'float32'][i], fits[tnmf_tpu_torch, 'float64'][i]
        return np.max(np.abs(got - want)) / np.max(np.abs(want))
    for i in (0, 1):  # W, then H
        np.testing.assert_allclose(fits[tnmf_tpu_torch, 'float64'][i],
                                   fits[tnmf_tpu, 'float64'][i], **TOL)
        assert off(tnmf_tpu_torch, i) <= off(tnmf_tpu, i) < 1e-3


REJECTIONS = [
    dict(solver='hals', inhibition_strength=0.1),
    dict(solver='hals', cross_atom_inhibition_strength=0.1),
    dict(solver='hals', ortho_W=0.1),
    dict(solver='hals', mask='ones'),
    dict(solver='hals', extrapolate=True),
    dict(solver='hals', revive_every=5),
    dict(solver='nope'),
    dict(sparsity_W=0.1),
    dict(l2_W=0.1),
    dict(solver='hals', sparsity_W=-1.0),
    dict(solver='hals', hals_inner=0),
    dict(solver='hals', tol=1e-3, progress_callback=lambda m, i: True),
]


@pytest.mark.parametrize('fit', REJECTIONS, ids=lambda f: ','.join(sorted(f)))
def test_rejections_match_jax(fit):
    """Each HALS rejection raises the JAX package's exception type with its
    message."""
    V, _ = _problem()
    fit = dict(fit)
    if fit.get('mask') == 'ones':
        fit['mask'] = np.ones_like(V)
    errors = []
    for module in PACKAGES:
        with pytest.raises(Exception) as info:
            _model(module).fit(V, n_iterations=2, **fit)
        errors.append(info.value)
    assert type(errors[1]) is type(errors[0]) is ValueError
    if 'progress_callback' not in fit:
        assert str(errors[1]) == str(errors[0])


@pytest.mark.parametrize('case', ['beta', 'group', 'shift geometry'])
def test_model_rejections_match_jax(case):
    V, _ = _problem()
    errors = []
    for module in PACKAGES:
        kw = dict(device='cpu', dtype=F64) if module is tnmf_tpu_torch else {}
        if case == 'beta':
            m = module.TransformInvariantNMF(4, (30,), reconstruction_mode='full',
                                             beta_loss=1.0, **kw)
        elif case == 'group':
            m = module.TransformInvariantNMF(2, (30,), reconstruction_mode='full',
                                             transform_type='shift+flip', **kw)
        else:
            m = module.TransformInvariantNMF(2, (5,), **kw)
        with pytest.raises(ValueError) as info:
            m.fit(V, n_iterations=2, solver='hals')
        errors.append(str(info.value))
    assert errors[1] == errors[0]
