"""The port's shift-invariant HALS solver (tnmf_tpu_torch.engine_hals_conv and
fit(solver='hals') under reconstruction_mode='full') against the JAX
package's, in float64 on the CPU: the phase sweep against the scalar-loop
oracle and the JAX sweep, K5's plain version on the phase rows, the layout,
fits through the loops of the dispatch, the geometry gate, the regularizers
and the update flags."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tnmf_tpu
from tnmf_tpu import engine_hals as jeh, engine_hals_conv as jehc
from tnmf_tpu.ops import oracle
from tnmf_tpu.ops.modes import ConvPlan as JConvPlan

import tnmf_tpu_torch
from tnmf_tpu_torch import engine_hals_conv as ehc
from tnmf_tpu_torch.kernels.hals import hals_sweep_plain
from tnmf_tpu_torch.ops.modes import ConvPlan

F64 = torch.float64
TOL = dict(rtol=1e-8, atol=1e-10)
PACKAGES = (tnmf_tpu, tnmf_tpu_torch)


def _t(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def _problem(n=2, c=2, sample=(13,), atom=(4,), m=3, seed=0):
    rng = np.random.default_rng(seed)
    V = rng.random((n, c) + sample)
    W = rng.random((m, c) + atom)
    plan = ConvPlan.create('full', sample, atom)
    H = rng.random((n, m) + plan.transform_shape)
    return V, W, H, plan


def _sweep(V, W, H, plan, l1, l2, inner):
    E_pad, H_pm = ehc._encode(_t(V), _t(W), _t(H), plan)
    E_pad, H_pm = ehc.h_phase_sweep(E_pad, H_pm, _t(W), ehc.gram_W(_t(W)), l1, l2, plan=plan,
                                    inner=inner)
    return E_pad, ehc._decode_h(H_pm, plan).numpy()


@pytest.mark.parametrize('geom', [((13,), (4,)), ((12,), (4,)), ((9, 8), (3, 4)),
                                  ((7, 7), (3, 3))], ids=str)
@pytest.mark.parametrize('inner', [1, 2])
def test_phase_sweep_matches_oracle(geom, inner):
    """One phase sweep against the scalar-loop exact-CD oracle
    ``np_conv_hals_h_sweep`` (T divisible by A and not), and the residual
    it carries against ``V - R``."""
    sample, atom = geom
    V, W, H, plan = _problem(sample=sample, atom=atom, seed=3)
    E_pad, got = _sweep(V, W, H, plan, 0.0, 0.0, inner)
    want = jehc.np_conv_hals_h_sweep(V, W, H, l1=0.0, l2=0.0, inner=inner)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    E = E_pad.numpy()[(Ellipsis,) + tuple(slice(0, s) for s in plan.sample_shape)]
    np.testing.assert_allclose(E, V - oracle.reconstruct(W, got, 'full'), rtol=1e-9,
                               atol=1e-11)


@pytest.mark.parametrize('geom', [((11,), (3,)), ((8, 7), (3, 2))], ids=str)
def test_regularized_phase_sweep_matches_oracle_and_jax(geom):
    """With l1 and l2 on H: against the oracle and the JAX phase sweep,
    residual and phase-major carry included."""
    sample, atom = geom
    V, W, H, plan = _problem(sample=sample, atom=atom, seed=5)
    l1, l2 = 0.05, 0.2
    E_pad, got = _sweep(V, W, H, plan, l1, l2, 1)
    np.testing.assert_allclose(got, jehc.np_conv_hals_h_sweep(V, W, H, l1=l1, l2=l2, inner=1),
                               rtol=1e-10, atol=1e-12)
    jplan = JConvPlan.create('full', sample, atom, precision='highest')
    jE, jH = jehc._encode(jnp.asarray(V), jnp.asarray(W), jnp.asarray(H), jplan)
    jE, jH = jehc.h_phase_sweep(jE, jH, jnp.asarray(W),
                                jehc.gram_W(jnp.asarray(W), jplan.lax_precision),
                                jnp.float64(l1), jnp.float64(l2), plan=jplan, inner=1)
    np.testing.assert_allclose(E_pad.numpy(), np.asarray(jE), rtol=1e-10, atol=1e-12)
    _, H_pm = ehc._encode(_t(V), _t(W), _t(got), plan)
    np.testing.assert_allclose(H_pm.numpy(), np.asarray(jH), rtol=1e-10, atol=1e-12)


def test_layout_round_trip_and_rows_sweep_match_jax():
    """The phase-major carry is the JAX package's (encode and decode), and
    K5's plain version on a phase's rows ``(n*K, M)`` is the JAX _sweep_H."""
    V, W, H, plan = _problem(n=2, c=1, sample=(10, 9), atom=(3, 2), m=4, seed=7)
    jplan = JConvPlan.create('full', plan.sample_shape, plan.atom_shape, precision='highest')
    E_pad, H_pm = ehc._encode(_t(V), _t(W), _t(H), plan)
    jE, jH = jehc._encode(jnp.asarray(V), jnp.asarray(W), jnp.asarray(H), jplan)
    np.testing.assert_allclose(E_pad.numpy(), np.asarray(jE), rtol=1e-12, atol=1e-13)
    np.testing.assert_array_equal(H_pm.numpy(), np.asarray(jH))
    np.testing.assert_array_equal(ehc._decode_h(H_pm, plan).numpy(), H)
    rows = H_pm[5].transpose(1, 2).reshape(-1, 4)
    G = ehc.gram_W(_t(W))
    P = torch.rand(rows.shape, dtype=F64, generator=torch.Generator().manual_seed(0))
    want = jeh._sweep_H(jnp.asarray(rows.numpy()), jnp.asarray(G.numpy()),
                        jnp.asarray(P.numpy()), jnp.float64(0.01), jnp.float64(0.1))
    want = jeh._sweep_H(want, jnp.asarray(G.numpy()), jnp.asarray(P.numpy()),
                        jnp.float64(0.01), jnp.float64(0.1))
    np.testing.assert_allclose(hals_sweep_plain(rows, G, P, 0.01, 0.1, 2).numpy(),
                               np.asarray(want), rtol=1e-12, atol=1e-14)


def _model(module, atom, m=3, **init):
    kw = dict(device='cpu', dtype=F64) if module is tnmf_tpu_torch else {}
    return module.TransformInvariantNMF(m, atom, reconstruction_mode='full', verbose=0,
                                        **init, **kw)


def _fit_both(V, atom, seed=7, **fit):
    out = []
    for module in PACKAGES:
        np.random.seed(seed)
        model = _model(module, atom)
        model.fit(V, solver='hals', **fit)
        out.append(model)
    return out


def _assert_same(jm, pm, energies=False):
    assert pm.n_iterations_ == jm.n_iterations_
    np.testing.assert_allclose(pm.W, jm.W, **TOL)
    np.testing.assert_allclose(pm.H, jm.H, **TOL)
    if energies:
        np.testing.assert_allclose(pm.energies_, np.asarray(jm.energies_), **TOL)


DATA = {'1d': (np.random.default_rng(1).random((2, 2, 23)), (4,)),
        '2d': (np.random.default_rng(2).random((2, 1, 11, 10)), (3, 3))}

LOOPS = {
    'plain': dict(n_iterations=4),
    'inner 2 regularized': dict(n_iterations=3, hals_inner=2, sparsity_H=0.05, l2_H=0.2),
    'record_energies': dict(n_iterations=4, record_energies=True),
    'tol': dict(n_iterations=60, tol=1e-3, tol_check_every=3),
    'tol with trace': dict(n_iterations=60, tol=1e-3, tol_check_every=3,
                           record_energies=True),
    'callback': dict(n_iterations=3, progress_callback=lambda m, i: True),
    'chunked callback with energies': dict(n_iterations=5, record_energies=True,
                                           progress_callback=lambda m, i: True,
                                           callback_interval=2),
}


@pytest.mark.parametrize('dim', list(DATA))
@pytest.mark.parametrize('loop', list(LOOPS))
def test_fit_matches_jax(loop, dim):
    """``fit(solver='hals')`` on the shift-invariant geometry against the JAX
    model from the same seeded start, through each loop: W, H, the count
    and the energies within 1e-8."""
    V, atom = DATA[dim]
    jm, pm = _fit_both(V, atom, **LOOPS[loop])
    _assert_same(jm, pm, energies=LOOPS[loop].get('record_energies', False))
    if loop.startswith('tol'):
        assert 0 < pm.n_iterations_ < 60


def test_energy_monotone_and_checkpoint_resume(tmp_path):
    """Exact H block CD and a multiplicative W step: the energy never
    rises; a checkpointed fit resumes onto the uninterrupted trajectory,
    as the JAX package's does."""
    V, atom = DATA['2d']
    jm, pm = _fit_both(V, atom, n_iterations=12, record_energies=True)
    e = pm.energies_
    assert np.all(np.diff(e) <= 1e-12 * e[0])
    _assert_same(jm, pm, energies=True)
    path = str(tmp_path / 'hals.npz')
    np.random.seed(7)
    crashed = _model(tnmf_tpu_torch, atom)
    crashed.fit(V, n_iterations=8, solver='hals', checkpoint_every=4, checkpoint_path=path)
    resumed = tnmf_tpu_torch.TransformInvariantNMF.load(path, device='cpu', dtype=F64)
    resumed.fit(V, n_iterations=4, solver='hals', keep_W=True, keep_H=True)
    np.testing.assert_allclose(resumed.W, pm.W, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(resumed.H, pm.H, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize('flag', ['update_W', 'update_H'])
def test_update_flags_and_transform_match_jax(flag):
    """A frozen factor stays as it was, the other moves as in JAX; with W
    frozen this is ``transform(solver='hals')``."""
    V, atom = DATA['1d']
    out = []
    for module in PACKAGES:
        np.random.seed(3)
        m = _model(module, atom)
        m.fit(V, n_iterations=0, solver='hals')
        W0, H0 = m.W.copy(), m.H.copy()
        m.fit(V, keep_W=True, keep_H=True, n_iterations=3, solver='hals', sparsity_H=0.02,
              **{flag: False})
        np.testing.assert_array_equal(*((m.W, W0) if flag == 'update_W' else (m.H, H0)))
        out.append(m)
    _assert_same(*out)
    if flag == 'update_W':
        Hs = []
        for m in out:
            np.random.seed(9)
            Hs.append(m.transform(V[::-1].copy(), n_iterations=3, solver='hals', l2_H=0.1))
        np.testing.assert_allclose(Hs[1], Hs[0], **TOL)


@pytest.mark.parametrize('case', ['valid mode', 'circular mode', 'sparsity_W', 'l2_W',
                                  'hals_inner=0'])
def test_geometry_gate_and_rejections_match_jax(case):
    """Only the degenerate and the 'full' geometries run HALS; the
    dictionary penalties are plain-NMF only; the JAX package's exception
    type and message each time."""
    V, atom = DATA['2d']
    errors = []
    for module in PACKAGES:
        kw = dict(device='cpu', dtype=F64) if module is tnmf_tpu_torch else {}
        mode = {'valid mode': 'valid', 'circular mode': 'circular'}.get(case, 'full')
        m = module.TransformInvariantNMF(3, atom, reconstruction_mode=mode, **kw)
        fit = {'sparsity_W': dict(sparsity_W=0.1), 'l2_W': dict(l2_W=0.1),
               'hals_inner=0': dict(hals_inner=0)}.get(case, {})
        with pytest.raises(ValueError) as info:
            m.fit(V, n_iterations=1, solver='hals', **fit)
        errors.append(str(info.value))
    assert errors[1] == errors[0]
    assert ehc.applicable(ConvPlan.create('full', (11, 10), (3, 3)))
    assert not ehc.applicable(ConvPlan.create('full', (3, 3), (3, 3)))
    assert not ehc.applicable(ConvPlan.create('valid', (11, 10), (3, 3)))
