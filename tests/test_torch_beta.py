"""The port's beta-divergence objectives against the JAX package, in float64
on the CPU: ``divergence`` and the factors for every beta (with and
without a mask), ``beta_loss`` in {0, 0.5, 1, 1.5, 2} in the four modes on
the conv and fft strategies (1-D) and on dot, 2-D conv fits plain and
inhibited, ``l2_H`` and ``ortho_W`` alone, together and with inhibition,
``reconstruction_err_``, a JAX checkpoint of a KL model loaded with
``load(beta_loss=1.0)`` and the error paths.

On CPU tensors the wrappers of K1-K4 run their plain versions: K3 with
``pos_extra`` and K2 on the factor streams are held against the kernels on
the card by ``chip_smoke.py`` phase 14."""

import numpy as np
import pytest
import torch

import tnmf_tpu
from tnmf_tpu.ops import beta as jbeta

import tnmf_tpu_torch
from tnmf_tpu_torch import engine
from tnmf_tpu_torch.ops import beta

F64 = torch.float64
TOL = dict(rtol=1e-8, atol=1e-10)
BETAS = [0.0, 0.5, 1.0, 1.5, 2.0]
MODES = ['valid', 'full', 'circular', 'reflect']


def _model(module, n_atoms, atom_shape, **kw):
    if module is tnmf_tpu_torch:
        kw.update(device='cpu', dtype=F64)
    return module.TransformInvariantNMF(n_atoms, atom_shape, seed=3, **kw)


def _data(shape, offset=0.05, seed=0):
    """Positive data (the Itakura-Saito domain), from a seeded stream."""
    return np.random.default_rng(seed).random(shape) + offset


def _both(n_atoms, atom_shape, V, init=None, n_iterations=3, **fit):
    """The same seeded fit in both packages; returns (port, jax)."""
    out = []
    for module in (tnmf_tpu_torch, tnmf_tpu):
        m = _model(module, n_atoms, atom_shape, **(init or {}))
        m.fit_batch(V, n_iterations=n_iterations, **fit)
        out.append(m)
    return out


def _assert_same(pm, jm):
    np.testing.assert_allclose(pm.W, jm.W, **TOL)
    np.testing.assert_allclose(pm.H, jm.H, **TOL)
    np.testing.assert_allclose(pm._energy_function(), jm._energy_function(), rtol=1e-8)


@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('b', BETAS + [3.0, -0.5])
def test_divergence_and_factors_match_jax(b, masked):
    """With zeros in V wherever the beta allows them (KL's ``v -> 0``
    limit), and R floored at ``EPS_R`` where it is not positive."""
    rng = np.random.default_rng(1)
    V = rng.random((2, 3, 7))
    if b > 0:
        V[0, 1, :3] = 0.
    R = rng.random((2, 3, 7))
    R[1, 0, 2] = 0.
    mask = (rng.random((2, 1, 7)) > 0.3) * rng.random((2, 1, 7)) if masked else None
    got = beta.divergence(torch.tensor(V), torch.tensor(R), b,
                          None if mask is None else torch.tensor(mask))
    want = jbeta.divergence(V, R, b, mask)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)
    assert got.dtype == F64 and got.dim() == 0
    A, B = beta.factors(torch.tensor(V), torch.tensor(R), b)
    jA, jB = jbeta.factors(V, R, b)
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), rtol=1e-13)
    np.testing.assert_allclose(B.numpy(), np.asarray(jB), rtol=1e-13)


def test_divergence_accumulates_float32_in_float32():
    V, R = torch.rand(2, 3, 5), torch.rand(2, 3, 5)
    assert beta.divergence(V, R, 1.0).dtype == torch.float32


def test_resolve_beta_loss():
    assert [beta.resolve_beta_loss(n) for n in
            ('frobenius', 'kullback-leibler', 'itakura-saito', 0.5, 2)] == [2., 1., 0., .5, 2.]
    with pytest.raises(ValueError, match='unknown beta_loss'):
        beta.resolve_beta_loss('kl')


@pytest.mark.parametrize('b', BETAS)
@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('backend', ['jax_conv', 'jax_fft'])
def test_1d_fits_match_jax(backend, mode, b):
    """Each beta in each mode, on the conv strategy (K3 and K2 on the factor
    streams, the extension pattern as ``B`` at beta = 1) and on fft (the
    factors prepared every iteration, K1's ratio)."""
    pm, jm = _both(3, (5,), _data((3, 2, 40)),
                   init=dict(backend=backend, reconstruction_mode=mode, beta_loss=b),
                   sparsity_H=0.1)
    assert pm._strategy == backend.removeprefix('jax_')
    _assert_same(pm, jm)


@pytest.mark.parametrize('b', BETAS)
def test_plain_nmf_fits_match_jax(b):
    """Plain NMF ('full', atoms as large as the samples) on the dot
    strategy: classic KL-NMF at beta = 1."""
    pm, jm = _both(3, (10,), _data((6, 2, 10)),
                   init=dict(reconstruction_mode='full', beta_loss=b), sparsity_H=0.1)
    assert pm._strategy == 'dot'
    _assert_same(pm, jm)


@pytest.mark.parametrize('inhibited', [False, True])
@pytest.mark.parametrize('b', [0.5, 1.0])
def test_2d_fits_match_jax(b, inhibited):
    """2-D conv (the flagship's rank): K3, or the stacked gradient pair and
    K4 with same- and cross-atom inhibition."""
    fit = dict(inhibition_strength=0.2, cross_atom_inhibition_strength=0.1) if inhibited else {}
    pm, jm = _both(3, (3, 4), _data((2, 2, 12, 14)), init=dict(beta_loss=b), sparsity_H=0.1,
                   **fit)
    assert pm._strategy == 'conv'
    _assert_same(pm, jm)


@pytest.mark.parametrize('regs', [dict(l2_H=0.3), dict(ortho_W=0.2),
                                  dict(l2_H=0.3, ortho_W=0.2),
                                  dict(l2_H=0.3, ortho_W=0.2, inhibition_strength=0.2,
                                       cross_atom_inhibition_strength=0.1)],
                         ids=['l2_H', 'ortho_W', 'both', 'both inhibited'])
@pytest.mark.parametrize('backend,shape,atom', [
    ('jax_conv', (2, 2, 12, 14), (3, 4)), ('jax_fft', (3, 2, 40), (5,)),
    ('jax_conv', (6, 2, 10), (10,))], ids=['conv', 'fft', 'dot'])
def test_l2_H_and_ortho_W_match_jax(backend, shape, atom, regs):
    """``l2_H`` joins K3's ``pos_extra`` on conv and the positive part
    before K1 or K4 elsewhere; ``ortho_W`` joins ``pos`` before ``mu_w``."""
    mode = 'full' if atom == (10,) else 'valid'
    pm, jm = _both(3, atom, _data(shape), init=dict(backend=backend, reconstruction_mode=mode),
                   sparsity_H=0.1, **regs)
    _assert_same(pm, jm)


def test_penalties_change_the_fit_and_zero_weights_do_not():
    """A zero weight keeps the default path's bits; a positive one moves
    the fit (``ortho_W`` spreads the atoms apart)."""
    V = _data((2, 2, 12, 14))
    fits = {}
    for name, regs in [('plain', {}), ('zero', dict(l2_H=0., ortho_W=0.)),
                       ('ortho', dict(ortho_W=0.5))]:
        m = _model(tnmf_tpu_torch, 3, (3, 4))
        m.fit_batch(V, n_iterations=5, **regs)
        fits[name] = m
    assert torch.equal(fits['plain']._W, fits['zero']._W)
    assert torch.equal(fits['plain']._H, fits['zero']._H)
    assert not np.allclose(fits['plain'].W, fits['ortho'].W)


def test_engine_steps_take_the_objective():
    """``update_H_step``, ``update_W_step`` and ``grad_W_stats`` with the
    objective's keywords, against the JAX engine's jitted steps."""
    from tnmf_tpu import engine as jengine
    from tnmf_tpu.ops.modes import ConvPlan as JConvPlan
    from tnmf_tpu_torch.ops.modes import ConvPlan
    rng = np.random.default_rng(4)
    V = rng.random((2, 2, 12, 14)) + 0.05
    W = rng.random((3, 2, 3, 4))
    H = rng.random((2, 3, 14, 17))
    plan = ConvPlan.create('valid', (12, 14), (3, 4), '5-smooth')
    jplan = JConvPlan.create('valid', (12, 14), (3, 4))
    Vp = engine.prepare_data(torch.tensor(V), plan=plan)
    jVp = jengine.prepare_data(V, plan=jplan, strategy='conv')
    t = torch.tensor
    got_H = engine.update_H_step(Vp, t(W), t(H), 0.1, plan=plan, beta=0.5, l2_H=0.2)
    want_H = jengine.update_H_step(jVp, W, H, 0.1, 0., 0., (), None, 0.2, plan=jplan,
                                   strategy='conv', beta=0.5)
    np.testing.assert_allclose(got_H.numpy(), np.asarray(want_H), **TOL)
    got_W = engine.update_W_step(Vp, t(W), t(H), plan=plan, beta=0.5, ortho_W=0.2)
    want_W = jengine.update_W_step(jVp, W, H, None, 0.2, plan=jplan, strategy='conv', beta=0.5)
    np.testing.assert_allclose(got_W.numpy(), np.asarray(want_W), **TOL)
    for got, want in zip(engine.grad_W_stats(Vp, t(W), t(H), plan=plan, beta=1.0),
                         jengine.grad_W_stats(jVp, W, H, plan=jplan, strategy='conv', beta=1.0)):
        np.testing.assert_allclose(got.numpy(), np.broadcast_to(want, W.shape), **TOL)


@pytest.mark.parametrize('name', ['kullback-leibler', 'itakura-saito'])
def test_reconstruction_error_is_the_divergence(name):
    pm, jm = _both(3, (5,), _data((3, 2, 40)), init=dict(beta_loss=name))
    np.testing.assert_allclose(pm.reconstruction_err_, jm.reconstruction_err_, rtol=1e-8)
    np.testing.assert_allclose(pm.reconstruction_err_ ** 2 / 2, pm._energy_function(),
                               rtol=1e-12)


def test_jax_kl_checkpoint_loads_with_its_beta_loss(tmp_path):
    """Neither package stores ``beta_loss``: a KL model fitted by the JAX
    package loads into the port with ``load(beta_loss=1.0)``, and its
    ``transform`` of new data reaches the JAX model's."""
    V = _data((3, 2, 12, 14))
    jm = _model(tnmf_tpu, 3, (3, 4), beta_loss=1.0)
    jm.fit_batch(V, n_iterations=4, sparsity_H=0.1)
    path = str(tmp_path / 'kl.npz')
    jm.save(path)
    pm = tnmf_tpu_torch.TransformInvariantNMF.load(path, device='cpu', beta_loss=1.0)
    assert pm._beta == 1.0 and pm.dtype == F64
    jm = tnmf_tpu.TransformInvariantNMF.load(path, beta_loss=1.0)
    new = _data((2, 2, 12, 14), seed=9)
    np.random.seed(5)  # both loaded models draw H from the global stream
    want = jm.transform(new, n_iterations=4, sparsity_H=0.1)
    np.random.seed(5)
    got = pm.transform(new, n_iterations=4, sparsity_H=0.1)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(pm._energy_function(), jm._energy_function(), rtol=1e-8)


def test_error_paths():
    with pytest.raises(ValueError, match='strictly positive'):
        _model(tnmf_tpu_torch, 2, (3,), beta_loss='itakura-saito').fit(
            np.zeros((1, 1, 8)), n_iterations=1)
    with pytest.raises(ValueError, match='strictly positive'):
        _model(tnmf_tpu_torch, 2, (3,), beta_loss=-1.0).fit_minibatches(
            np.zeros((2, 1, 8)), batch_size=1, n_epochs=1)
    with pytest.raises(ValueError, match='beta_loss != 2'):
        tnmf_tpu_torch.TransformInvariantNMF(2, (3,), device='cuda', use_pallas=True,
                                             beta_loss=1.0)
    with pytest.raises(ValueError, match='unknown beta_loss'):
        tnmf_tpu_torch.TransformInvariantNMF(2, (3,), device='cpu', beta_loss='kl')
    m = _model(tnmf_tpu_torch, 2, (3,))
    for bad in (dict(l2_H=-0.1), dict(ortho_W=float('nan'))):
        with pytest.raises(ValueError, match='must be >= 0'):
            m.fit(np.ones((1, 1, 8)), n_iterations=1, **bad)
        with pytest.raises(ValueError, match='must be >= 0'):
            m.partial_fit(np.ones((1, 1, 8)), **bad)
