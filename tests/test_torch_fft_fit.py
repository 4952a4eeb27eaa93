"""Fits on the port's fft strategy against the JAX model, in float64 on the
CPU: the golden 2-D energies through every fft backend name, the golden 1-D
pulse train, an inhibited fit with same- and cross-atom terms, ``'auto'``
above the direct-conv threshold, ``fft_policy``, a rank-4 fit, the encoder
(``transform``, ``correlate_init_H``) and a JAX checkpoint of an fft model."""

from functools import lru_cache

import numpy as np
import pytest
import torch

import tnmf_tpu
from tnmf_tpu import engine as jengine
from tnmf_tpu.ops.modes import ConvPlan as JConvPlan

import tnmf_tpu_torch
from tnmf_tpu_torch import engine
from tnmf_tpu_torch.ops.modes import ConvPlan

from .fixtures import image_2d, load_goldens, signal_1d

F64 = torch.float64
TOL = dict(rtol=1e-8, atol=1e-10)
FFT_BACKENDS = ['numpy_fft', 'numpy_caching_fft', 'pytorch_fft', 'jax_fft']


def _model(module, *args, **kw):
    if module is tnmf_tpu_torch:
        kw['device'] = 'cpu'
        if len(args) < 8:  # dtype is the eighth positional
            kw['dtype'] = F64
    return module.TransformInvariantNMF(*args, **kw)


def _assert_close(pm, jm, energy=True):
    np.testing.assert_allclose(pm.W, jm.W, **TOL)
    np.testing.assert_allclose(pm.H, jm.H, **TOL)
    if energy:
        np.testing.assert_allclose(pm._energy_function(), jm._energy_function(), rtol=1e-10)


@lru_cache(maxsize=None)
def _image():
    return image_2d()


def _golden_fit(module, backend, mode):
    np.random.seed(seed=42)
    nmf = _model(module, n_atoms=10, atom_shape=(7, 7), backend=backend,
                 reconstruction_mode=mode)
    nmf.fit(_image(), sparsity_H=0.1, n_iterations=10)
    return nmf


@lru_cache(maxsize=None)
def _jax_golden(mode):
    return _golden_fit(tnmf_tpu, 'jax_fft', mode)


@pytest.mark.parametrize('mode', ['valid', 'full', 'circular'])
@pytest.mark.parametrize('backend', FFT_BACKENDS[1:])
def test_golden_2d_through_every_fft_backend(backend, mode):
    """tests/test_2d_backends.py's fit on the port's fft strategy: the
    golden energy, and W, H, R and R_partial of the JAX model on fft."""
    nmf = _golden_fit(tnmf_tpu_torch, backend, mode)
    assert nmf._strategy == 'fft'
    assert np.isclose(nmf._energy_function(), load_goldens()['2d'][mode])
    ref = _jax_golden(mode)
    _assert_close(nmf, ref)
    np.testing.assert_allclose(nmf.R, ref.R, **TOL)
    np.testing.assert_allclose(nmf.R_partial(0), ref.R_partial(0), **TOL)
    np.testing.assert_allclose(nmf.W.sum(axis=(-1, -2)), 1.0)


@pytest.mark.parametrize('mode', ['valid', 'full', 'circular', 'reflect'])
def test_golden_1d_pulse_train_on_fft(mode):
    out = []
    for module in (tnmf_tpu_torch, tnmf_tpu):
        np.random.seed(seed=42)
        nmf = _model(module, n_atoms=3, atom_shape=(20,), backend='numpy_fft',
                     reconstruction_mode=mode)
        nmf.fit(signal_1d(), n_iterations=10, inhibition_strength=0.1)
        out.append(nmf)
    assert out[0]._strategy == 'fft'
    assert np.isclose(out[0]._energy_function(), load_goldens()['1d'][mode])
    _assert_close(*out)


@pytest.mark.parametrize('fit', [
    dict(inhibition_strength=0.2, cross_atom_inhibition_strength=0.1, sparsity_H=0.05),
    dict(cross_atom_inhibition_strength=0.3, record_energies=True, tol=1e-6,
         tol_check_every=2),
], ids=['same+cross', 'cross-tol'])
def test_inhibited_fit_on_fft_matches_jax(fit):
    V = np.random.default_rng(3).random((2, 2, 17, 14))
    out = []
    for module in (tnmf_tpu_torch, tnmf_tpu):
        nmf = _model(module, 3, (4, 3), (2, 1), 'jax_fft', reconstruction_mode='reflect', seed=4)
        nmf.fit(V, n_iterations=6, **fit)
        out.append(nmf)
    _assert_close(*out)
    if 'record_energies' in fit:
        np.testing.assert_allclose(out[0].energies_, out[1].energies_, **TOL)


def test_auto_above_the_threshold_picks_fft_like_jax():
    """31 x 31 atoms on 40 x 40 samples pass ``max(512, prod(sample)/64)``."""
    V = np.random.default_rng(4).random((1, 1, 40, 40))
    out = []
    for module in (tnmf_tpu_torch, tnmf_tpu):
        nmf = _model(module, 2, (31, 31), seed=5)
        nmf.fit(V, n_iterations=3, sparsity_H=0.1)
        out.append(nmf)
    assert out[0]._strategy == out[1]._strategy == 'fft'
    _assert_close(*out)
    plan = ConvPlan.create('valid', (40, 40), (31, 31))
    assert engine.choose_strategy(plan) == jengine.choose_strategy(
        JConvPlan.create('valid', (40, 40), (31, 31)), 2, 1) == 'fft'


@pytest.mark.parametrize('positional', [False, True], ids=['keyword', 'positional'])
def test_fft_policy_runs_and_matches_jax(positional):
    """``fft_policy='pow2'`` (keyword, or the JAX package's eleventh
    positional) reaches the plan: the fit matches the JAX model's."""
    V = np.random.default_rng(5).random((2, 1, 19, 21))
    out = []
    for module in (tnmf_tpu_torch, tnmf_tpu):
        args = (2, (3, 3), None, 'jax_fft', None, 0, 'valid', 'float64', None, 6)
        nmf = (_model(module, *args, 'pow2') if positional
               else _model(module, *args, fft_policy='pow2'))
        nmf.fit(V, n_iterations=3, sparsity_H=0.1)
        out.append(nmf)
    assert out[0]._plan.fft_shape == out[1]._plan.fft_shape == (64, 64)  # 5-smooth: 40, 45
    _assert_close(*out)


@pytest.mark.parametrize('fit', [dict(), dict(inhibition_strength=0.1,
                                             cross_atom_inhibition_strength=0.1)],
                         ids=['plain', 'inhibited'])
def test_rank4_fit_matches_jax(fit):
    """A 4-D fit ('auto' routes rank > 3 to fft; the rank gate keeps K4 on
    its plain version, whose inhibition runs one 1-D pass per axis)."""
    V = np.random.default_rng(0).random((2, 1, 5, 6, 4, 7))
    out = []
    for module in (tnmf_tpu_torch, tnmf_tpu):
        np.random.seed(0)
        nmf = _model(module, n_atoms=2, atom_shape=(2, 2, 3, 2))
        nmf.fit(V, n_iterations=3, record_energies=True, **fit)
        out.append(nmf)
    assert out[0]._strategy == 'fft'
    assert engine.plain_reason(out[0]._plan, torch.float32) is not None
    _assert_close(*out)
    np.testing.assert_allclose(out[0].energies_, out[1].energies_, **TOL)
    np.testing.assert_allclose(out[0].W.sum(axis=(-4, -3, -2, -1)), 1.0, rtol=1e-12)


@pytest.mark.parametrize('h_init', ['random', 'correlate'])
def test_transform_on_fft_matches_jax(h_init):
    W = np.random.default_rng(6).random((3, 2, 5, 4))
    V = np.random.default_rng(7).random((3, 2, 16, 15))
    out = []
    for module in (tnmf_tpu_torch, tnmf_tpu):
        m = _model(module, 3, (5, 4), None, 'numpy_fft', reconstruction_mode='circular',
                   seed=8, h_init=h_init).set_dictionary(W)
        out.append((m, m.transform(V, n_iterations=4, sparsity_H=0.1)))
    (pm, pH), (jm, jH) = out
    np.testing.assert_allclose(pH, jH, **TOL)
    np.testing.assert_array_equal(pm.W, np.asarray(jm._W))  # frozen
    np.testing.assert_allclose(pm.inverse_transform(pH), jm.inverse_transform(jH), **TOL)


@pytest.mark.parametrize('mode', ['valid', 'reflect'])
def test_correlate_init_H_on_fft_matches_jax(mode):
    rng = np.random.default_rng(9)
    S, A = (14, 13), (4, 5)
    plan, jplan = ConvPlan.create(mode, S, A), JConvPlan.create(mode, S, A)
    V, W = rng.random((2, 3) + S), rng.random((4, 3) + A)
    Vp = engine.prepare_data(torch.tensor(V), plan=plan, strategy='fft')
    got = engine.correlate_init_H(Vp, torch.tensor(V), torch.tensor(W), plan=plan,
                                  strategy='fft')
    want = jengine.correlate_init_H(jengine.prepare_data(V, plan=jplan, strategy='fft'), V, W,
                                    plan=jplan, strategy='fft', n_atoms=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_jax_fft_checkpoint_continues_in_port(tmp_path):
    """A JAX model that 'auto' sends to fft, saved with H, loads in the port
    on the same strategy and resumes as the JAX package does."""
    V = np.random.default_rng(10).random((2, 1, 30, 30))
    jm = _model(tnmf_tpu, 2, (25, 25), seed=11)
    jm.fit(V, n_iterations=2, sparsity_H=0.1)
    assert jm._strategy == 'fft'
    path = str(tmp_path / 'fft.npz')
    jm.save(path, include_H=True, completed_iterations=2)
    pm = tnmf_tpu_torch.TransformInvariantNMF.load(path, device='cpu')
    assert pm._strategy == 'fft' and pm.last_checkpoint_iteration_ == 2
    np.testing.assert_allclose(pm.R, jm.R, **TOL)
    jl = tnmf_tpu.TransformInvariantNMF.load(path)
    for m in (pm, jl):
        m.fit(V, n_iterations=2, keep_W=True, keep_H=True, sparsity_H=0.1)
    _assert_close(pm, jl)
