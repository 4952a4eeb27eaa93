"""The PyTorch port's plain-NMF matmul strategy (tnmf_tpu_torch.ops.dot)
against the JAX package's (tnmf_tpu.ops.dot) in float64 on the CPU, plain-NMF
fits against the JAX model, and the full-float32 guard of the fft and dot
products against a caller's matmul precision."""

import numpy as np
import pytest
import torch

from tnmf_tpu.ops import dot as jdot
from tnmf_tpu.ops.modes import ConvPlan as JConvPlan

import tnmf_tpu
import tnmf_tpu_torch
from tnmf_tpu_torch import engine
from tnmf_tpu_torch.ops import dot, precision
from tnmf_tpu_torch.ops.modes import ConvPlan

F64 = torch.float64
TOL = dict(rtol=1e-8, atol=1e-10)


def _t(x):
    return torch.tensor(np.array(x), dtype=F64)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize('S', [(16,), (6, 5), (3, 4, 2)], ids=str)
def test_operators_match_jax(S):
    rng = np.random.default_rng(len(S))
    plan, jplan = ConvPlan.create('full', S, S), JConvPlan.create('full', S, S)
    assert plan.transform_shape == (1,) * len(S)
    N, C, M = 7, 2, 3
    V, W = rng.random((N, C) + S), rng.random((M, C) + S)
    H = rng.random((N, M) + plan.transform_shape)
    assert dot.FACTORS_IN_PREPARED
    np.testing.assert_array_equal(dot.prepare_data(_t(V), plan).numpy(), V)
    R, jR = dot.reconstruct(_t(W), _t(H), plan), jdot.reconstruct(W, H, jplan)
    assert R.dtype == F64 and _rel(R, jR) <= 1e-12
    R = np.asarray(jR)
    assert _rel(dot.corr_H(_t(V), _t(W), plan), jdot.corr_H(V, W, jplan)) <= 1e-12
    assert _rel(dot.corr_W(_t(V), _t(H), plan), jdot.corr_W(V, H, jplan)) <= 1e-12
    for name, other in (('grad_H_pair', W), ('grad_W_pair', H),
                        ('grad_H_pair_prepared', W), ('grad_W_pair_prepared', H)):
        got = getattr(dot, name)(_t(V), _t(R), _t(other), plan)
        want = getattr(jdot, name)(V, R, other, jplan)
        for g, w in zip(got, want):
            assert _rel(g, w) <= 1e-12


def _fit(module, V, n_atoms, **fit):
    kw = dict(device='cpu', dtype=F64) if module is tnmf_tpu_torch else {}
    np.random.seed(3)
    m = module.TransformInvariantNMF(n_atoms, V.shape[2:], reconstruction_mode='full', **kw)
    m.fit(V, **fit)
    return m


@pytest.mark.parametrize('fit', [dict(n_iterations=8, sparsity_H=0.05),
                                 dict(n_iterations=30, tol=1e-4, tol_check_every=5,
                                      record_energies=True)], ids=['plain', 'tol'])
def test_plain_nmf_fit_matches_jax(fit):
    """Atoms as large as the samples in 'full' mode: both packages resolve
    the problem to the matmul strategy and agree in float64."""
    V = np.random.default_rng(11).random((20, 1, 24))
    pm, jm = _fit(tnmf_tpu_torch, V, 4, **fit), _fit(tnmf_tpu, V, 4, **fit)
    assert pm._strategy == jm._strategy == 'dot'
    np.testing.assert_allclose(pm.W, jm.W, **TOL)
    np.testing.assert_allclose(pm.H, jm.H, **TOL)
    np.testing.assert_allclose(pm._energy_function(), jm._energy_function(), **TOL)
    assert pm.n_iterations_ == jm.n_iterations_
    if 'record_energies' in fit:
        np.testing.assert_allclose(pm.energies_, jm.energies_, **TOL)


def test_plain_nmf_correlate_init_matches_jax():
    V = np.random.default_rng(12).random((9, 2, 5, 4))
    out = []
    for module in (tnmf_tpu, tnmf_tpu_torch):
        kw = dict(device='cpu', dtype=F64) if module is tnmf_tpu_torch else {}
        m = module.TransformInvariantNMF(3, (5, 4), reconstruction_mode='full', seed=1,
                                         h_init='correlate', **kw)
        m.fit(V, n_iterations=0)
        out.append(m)
    assert out[1]._strategy == 'dot'
    np.testing.assert_allclose(out[1].H, out[0].H, **TOL)


@pytest.mark.parametrize('strategy', ['dot', 'fft'])
def test_products_ignore_the_callers_matmul_precision(strategy):
    """The engine's fft and dot products compute in full float32 whatever
    ``torch.set_float32_matmul_precision`` says (on the CPU, 'high' and
    'medium' may otherwise take reduced-precision paths); the caller's
    setting comes back afterwards."""
    rng = np.random.default_rng(5)
    S, A = ((64,), (64,)) if strategy == 'dot' else ((40, 36), (5, 5))
    plan = ConvPlan.create('full' if strategy == 'dot' else 'valid', S, A)
    V = torch.tensor(rng.random((16, 3) + S), dtype=torch.float32)
    W = torch.tensor(rng.random((8, 3) + A), dtype=torch.float32)
    H = torch.tensor(rng.random((16, 8) + plan.transform_shape), dtype=torch.float32)
    Vp = engine.prepare_data(V, plan=plan, strategy=strategy)

    def run():
        R = engine.reconstruct(W, H, plan=plan, strategy=strategy)
        H1 = engine.update_H_step(Vp, W, H, 0.1, plan=plan, strategy=strategy)
        W1 = engine.update_W_step(Vp, W, H, plan=plan, strategy=strategy)
        H0 = engine.correlate_init_H(Vp, V, W, plan=plan, strategy=strategy)
        return R, H1, W1, H0, engine.energy(V, W, H, plan=plan, strategy=strategy)
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision('highest')
        want = run()
        for precision in ('high', 'medium'):
            torch.set_float32_matmul_precision(precision)
            got = run()
            assert torch.get_float32_matmul_precision() == precision
            for g, w in zip(got, want):
                assert torch.equal(g, w)
    finally:
        torch.set_float32_matmul_precision(saved)


def test_full_fp32_matmul_restores_on_error():
    """The matmul pin at a full-float32 level (None here; every level on
    the CPU) gives the caller's setting back when its block raises."""
    torch.set_float32_matmul_precision('high')
    try:
        with pytest.raises(RuntimeError):
            with precision.matmul_pin(None, 'cpu'):
                assert torch.get_float32_matmul_precision() == 'highest'
                with precision.matmul_pin('default', 'cpu'):
                    assert torch.get_float32_matmul_precision() == 'highest'
                assert torch.get_float32_matmul_precision() == 'highest'
                raise RuntimeError
        assert torch.get_float32_matmul_precision() == 'high'
    finally:
        torch.set_float32_matmul_precision('highest')


def _loop_problem(strategy, rng):
    S, A = ((64,), (64,)) if strategy == 'dot' else ((20, 18), (5, 5))
    plan = ConvPlan.create('full' if strategy == 'dot' else 'valid', S, A)
    V, W, H = (torch.tensor(rng.random(shape), dtype=torch.float32)
               for shape in ((4, 2) + S, (3, 2) + A, (4, 3) + plan.transform_shape))
    return plan, engine.prepare_data(V, plan=plan, strategy=strategy), V, W, H


@pytest.mark.parametrize('strategy', ['dot', 'fft', 'conv'])
def test_a_fit_loop_pins_the_precision_once(monkeypatch, strategy):
    """A fit loop of several iterations sets full float32 once and gives
    the caller's setting back once, not around every product; conv, which
    runs no matrix product, leaves the setting alone."""
    plan, Vp, V, W, H = _loop_problem(strategy, np.random.default_rng(6))
    sets = []
    setter = torch.set_float32_matmul_precision
    monkeypatch.setattr(torch, 'set_float32_matmul_precision',
                        lambda p: (sets.append(p), setter(p)))
    setter('high')
    try:
        engine.fit_loop(Vp, W, H, 4, 0.1, plan=plan, strategy=strategy)
        engine.fit_loop_energies(Vp, V, W, H, 0.1, n_iterations=3, plan=plan,
                                 strategy=strategy)
        assert sets == ([] if strategy == 'conv' else ['highest', 'high'] * 2)
        assert torch.get_float32_matmul_precision() == 'high'
    finally:
        setter('highest')


def test_plain_nmf_checkpoints_round_trip_with_jax(tmp_path):
    """A plain-NMF model saved with H by either package loads in the other
    on the matmul strategy, with the same reconstruction."""
    V = np.random.default_rng(13).random((6, 2, 9))
    for saver, loader in ((tnmf_tpu_torch, tnmf_tpu), (tnmf_tpu, tnmf_tpu_torch)):
        m = _fit(saver, V, 3, n_iterations=3)
        path = str(tmp_path / f'{saver.__name__}.npz')
        m.save(path, include_H=True, completed_iterations=3)
        kw = dict(device='cpu') if loader is tnmf_tpu_torch else {}
        back = loader.TransformInvariantNMF.load(path, **kw)
        assert back._strategy == 'dot' and back.last_checkpoint_iteration_ == 3
        np.testing.assert_allclose(back.R, m.R, **TOL)
