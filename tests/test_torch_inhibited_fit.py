"""Inhibited fits of the PyTorch port against the JAX package, in float64 on
the CPU: the fit loop step for step with same-atom and cross-atom
inhibition, the seeded '1d' (pulse train) and 'sparsity_inhibition' golden
fits, a JAX checkpoint with its own inhibition range continued in the port,
the copy of the signal generators, and the rank gate that sends 3-D
problems to the plain operators."""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tnmf_tpu
from tnmf_tpu import engine as jengine
from tnmf_tpu.ops.inhibition import inhibition_kernels as jax_kernels
from tnmf_tpu.ops.modes import ConvPlan as JConvPlan
from tnmf_tpu.utils import signals as jsignals

import tnmf_tpu_torch
from tnmf_tpu_torch import engine
from tnmf_tpu_torch.ops.inhibition import inhibition_kernels
from tnmf_tpu_torch.ops.modes import ConvPlan
from tnmf_tpu_torch.utils import signals

from .fixtures import image_2d, load_goldens, signal_1d

F64 = torch.float64
TOL = dict(rtol=1e-8, atol=1e-10)
COMBOS = [(True, False), (False, True), (True, True)]
#: the 2-D golden fixture, built once (synthesizing the image takes seconds)
_image_2d = lru_cache(maxsize=None)(image_2d)


def _problem(mode, S, A, ranges, seed=0):
    rng = np.random.default_rng(seed)
    N, C, M = 2, 2, 3
    jplan, plan = JConvPlan.create(mode, S, A), ConvPlan.create(mode, S, A)
    V = rng.random((N, C) + S)
    W = rng.random((M, C) + A)
    W /= W.sum(axis=tuple(range(2, W.ndim)), keepdims=True)
    H = rng.random((N, M) + plan.transform_shape)
    return jplan, plan, V, W, H, inhibition_kernels(ranges)


@pytest.mark.parametrize('mode', ['valid', 'reflect'])
@pytest.mark.parametrize('S,A,ranges', [((30,), (6,), (5,)), ((12, 10), (3, 4), (2, 3))],
                         ids=['1d', '2d'])
@pytest.mark.parametrize('use_same,use_cross', COMBOS)
def test_inhibited_fit_loop_matches_jax_step_for_step(mode, S, A, ranges, use_same,
                                                      use_cross):
    jplan, plan, V, W, H, ks = _problem(mode, S, A, ranges)
    Vpj = jengine.prepare_data(jnp.asarray(V), plan=jplan, strategy='conv')
    Vp = engine.prepare_data(torch.tensor(V), plan=plan)
    jks = tuple(jnp.asarray(k) for k in ks)
    tks = tuple(torch.tensor(k) for k in ks)
    flags = dict(use_inhibition=use_same, use_cross=use_cross)
    Wt, Ht = torch.tensor(W), torch.tensor(H)
    for k in range(1, 4):
        Wj, Hj = jengine.fit_loop(Vpj, jnp.asarray(W), jnp.asarray(H), k, 0.1, 0.3, 0.2,
                                  jks, plan=jplan, strategy='conv', **flags)
        Wt, Ht = engine.update_step(Vp, Wt, Ht, 0.1, 0.3, 0.2, tks, plan=plan, **flags)
        np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), **TOL)
        np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), **TOL)
    Wl, Hl = engine.fit_loop(Vp, torch.tensor(W), torch.tensor(H), 3, 0.1, 0.3, 0.2, tks,
                             plan=plan, **flags)
    np.testing.assert_array_equal(Wl.numpy(), Wt.numpy())
    np.testing.assert_array_equal(Hl.numpy(), Ht.numpy())


# ------------------------------------------------------------------ goldens

def _fit(module, fixture, n_atoms, atom_shape, backend=None, **params):
    """The golden tests' fit: seed, build the model, then the fixture (which
    may draw from the global stream) and the seeded initialization."""
    np.random.seed(seed=42)
    kw = dict(device='cpu', dtype=F64) if module is tnmf_tpu_torch else dict(backend=backend)
    mode = params.pop('reconstruction_mode', 'valid')
    nmf = module.TransformInvariantNMF(n_atoms=n_atoms, atom_shape=atom_shape,
                                       reconstruction_mode=mode, **kw)
    nmf.fit(fixture(), n_iterations=10, **params)
    return nmf


@lru_cache(maxsize=None)
def _jax_1d(mode):
    return _fit(tnmf_tpu, signal_1d, 3, (20,), 'jax_conv', reconstruction_mode=mode,
                inhibition_strength=0.1)


@pytest.mark.parametrize('mode', ['valid', 'full', 'circular', 'reflect'])
def test_golden_1d_pulse_train(mode):
    """tests/test_1d.py's fit in the port: the golden energy, and W, H and
    R of the JAX model."""
    nmf = _fit(tnmf_tpu_torch, signal_1d, 3, (20,), reconstruction_mode=mode,
               inhibition_strength=0.1)
    assert np.isclose(nmf._energy_function(), load_goldens()['1d'][mode])
    ref = _jax_1d(mode)
    np.testing.assert_allclose(nmf.W, ref.W, **TOL)
    np.testing.assert_allclose(nmf.H, ref.H, **TOL)
    np.testing.assert_allclose(nmf.R, ref.R, **TOL)
    np.testing.assert_allclose(nmf.W.sum(axis=-1), 1.0)


# tests/test_sparsity_inhibition.py's settings and golden keys
SETTINGS = [
    dict(),
    dict(sparsity_H=0.1),
    dict(sparsity_H=1.0),
    dict(inhibition_strength=0.1),
    dict(inhibition_strength=1.0),
    dict(cross_atom_inhibition_strength=0.5),
    dict(sparsity_H=0.5, inhibition_strength=0.5, cross_atom_inhibition_strength=0.5),
]


def _key(params):
    return ','.join(f'{k}={v}' for k, v in sorted(params.items())) or 'plain'


@pytest.mark.parametrize('params', SETTINGS, ids=_key)
def test_golden_sparsity_inhibition(params):
    golden = load_goldens()['sparsity_inhibition'][_key(params)]
    nmf = _fit(tnmf_tpu_torch, _image_2d, 5, (5, 5), **params)
    H = nmf.H
    assert np.isclose(nmf._energy_function(), golden['energy'])
    assert np.isclose(np.abs(H).sum(), golden['l1'], rtol=1e-5)
    assert int((H > 1e-4).sum()) == golden['l0']
    ref = _fit(tnmf_tpu, _image_2d, 5, (5, 5), 'jax_conv', **params)
    np.testing.assert_allclose(nmf.W, ref.W, **TOL)
    np.testing.assert_allclose(H, ref.H, **TOL)


# ------------------------------------------------------------- checkpoints

def test_jax_checkpoint_with_inhibition_range_continues_in_port(tmp_path):
    """A JAX model with a non-default inhibition range, saved to .npz,
    continues its inhibited fit in the port as in the JAX package."""
    rng = np.random.default_rng(6)
    V1, V2 = rng.random((2, 2, 16, 13)), rng.random((3, 2, 16, 13))
    params = dict(sparsity_H=0.05, inhibition_strength=0.2,
                  cross_atom_inhibition_strength=0.1)
    np.random.seed(1)
    jm = tnmf_tpu.TransformInvariantNMF(n_atoms=3, atom_shape=(4, 3), inhibition_range=(1, 5),
                                        reconstruction_mode='reflect')
    jm.fit(V1, n_iterations=3, **params)
    path = str(tmp_path / 'model.npz')
    jm.save(path)

    pm = tnmf_tpu_torch.TransformInvariantNMF.load(path, device='cpu')
    assert pm._inhibition_range == (1, 5)
    jl = tnmf_tpu.TransformInvariantNMF.load(path)
    np.random.seed(2)
    jl.fit(V2, n_iterations=3, keep_W=True, **params)
    np.random.seed(2)
    pm.fit(V2, n_iterations=3, keep_W=True, **params)
    np.testing.assert_allclose(pm.W, jl.W, **TOL)
    np.testing.assert_allclose(pm.H, jl.H, **TOL)
    np.testing.assert_allclose(pm._energy_function(), jl._energy_function(), rtol=1e-10)


def test_constructor_inhibition_range_matches_jax():
    for value in (None, 2, (3, 1)):
        pm = tnmf_tpu_torch.TransformInvariantNMF(2, (4, 3), inhibition_range=value,
                                                  device='cpu')
        jm = tnmf_tpu.TransformInvariantNMF(2, (4, 3), inhibition_range=value)
        assert pm._inhibition_range == jm._inhibition_range
        for a, b in zip(pm._inhibition_kernels_1D, jm._inhibition_kernels_1D):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('name', ['inhibition_strength', 'cross_atom_inhibition_strength'])
def test_negative_strength_raises_like_jax(name):
    V = np.ones((1, 1, 8, 8))
    msgs = []
    for nmf in (tnmf_tpu_torch.TransformInvariantNMF(2, (3, 3), device='cpu'),
                tnmf_tpu.TransformInvariantNMF(2, (3, 3))):
        with pytest.raises(ValueError) as err:
            nmf.fit(V, n_iterations=1, **{name: -0.1})
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] == f'{name} must be >= 0, got -0.1'


def test_cross_inhibition_one_atom_model_raises():
    """The JAX model turns W and H into NaN here (ROADMAP queue 3); the port
    refuses before it initializes anything."""
    V = np.random.default_rng(0).random((2, 1, 12, 12))
    np.random.seed(0)
    jm = tnmf_tpu.TransformInvariantNMF(1, (3, 3))
    jm.fit(V, n_iterations=2, cross_atom_inhibition_strength=0.5)
    assert np.isnan(jm.H).all() and np.isnan(jm.W).all()
    pm = tnmf_tpu_torch.TransformInvariantNMF(1, (3, 3), device='cpu')
    with pytest.raises(ValueError, match='at least 2 atoms'):
        pm.fit(V, n_iterations=2, cross_atom_inhibition_strength=0.5)
    assert pm._W is None
    pm.fit(V, n_iterations=2, inhibition_strength=0.5)  # same-atom alone is fine
    assert np.isfinite(pm.H).all()


# ----------------------------------------------------------------- signals

def test_signals_copy_matches_jax_package():
    for seed in (0, 42):
        for kw in (dict(pulse_length=20, n_pulses=5),
                   dict(symbols=['n-', '^v', '__'], pulse_length=9, n_pulses=11)):
            np.random.seed(seed)
            got = signals.generate_pulse_train(**kw)
            np.random.seed(seed)
            want = jsignals.generate_pulse_train(**kw)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        np.random.seed(seed)
        got = signals.generate_block_image(symbol_size=6, n_symbols=4)
        np.random.seed(seed)
        want = jsignals.generate_block_image(symbol_size=6, n_symbols=4)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for shape in signals.PULSE_SHAPES:
        np.testing.assert_array_equal(signals.generate_pulse(shape, 13),
                                      jsignals.generate_pulse(shape, 13))


# --------------------------------------------------------------- rank gate

@pytest.fixture(name='launched')
def fixture_launched(monkeypatch):
    """Replaces the engine's kernel wrappers by recorders that run the
    plain versions: the names of the wrappers a step called."""
    calls = []

    def record(name, plain):
        def fn(*args, **kwargs):
            calls.append(name)
            return plain(*args, **kwargs)
        return fn
    for name in ('mu_h', 'grad_w', 'mu_w', 'inhibited_mu_h'):
        monkeypatch.setattr(engine, name, record(name, getattr(engine, name + '_plain')))
    return calls


@pytest.mark.parametrize('inhibited', [False, True])
def test_rank_gate_3d_runs_plain_operators(launched, inhibited):
    """A 3-D problem reaches no wrapper of K2, K3 or K4, and its fit
    matches the JAX package's; in float32 it reaches K1's W epilogue
    (``mu_w`` takes any rank); 1-D and 2-D problems go through every
    wrapper."""
    S, A, ranges = (7, 6, 8), (2, 3, 2), (1, 2, 1)
    jplan, plan, V, W, H, ks = _problem('valid', S, A, ranges, seed=3)
    reason = engine.plain_reason(plan, torch.float32)
    assert reason == '3-D shifts (K2, K3 and K4 take 1-D and 2-D)'
    assert engine.dtype_reason(torch.float32) is None
    flags = dict(use_inhibition=inhibited, use_cross=inhibited)
    Vp = engine.prepare_data(torch.tensor(V), plan=plan)
    Wt, Ht = engine.fit_loop(Vp, torch.tensor(W), torch.tensor(H), 2, 0.1, 0.3, 0.2,
                             tuple(torch.tensor(k) for k in ks), plan=plan, **flags)
    assert launched == []
    Vpj = jengine.prepare_data(jnp.asarray(V), plan=jplan, strategy='conv')
    Wj, Hj = jengine.fit_loop(Vpj, jnp.asarray(W), jnp.asarray(H), 2, 0.1, 0.3, 0.2,
                              tuple(jnp.asarray(k) for k in jax_kernels(ranges)),
                              plan=jplan, strategy='conv', **flags)
    np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), **TOL)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), **TOL)
    f32 = [torch.tensor(x, dtype=torch.float32) for x in (V, W, H)]
    engine.update_step(engine.prepare_data(f32[0], plan=plan), f32[1], f32[2], 0.1, 0.3, 0.2,
                       tuple(torch.tensor(k, dtype=torch.float32) for k in ks), plan=plan,
                       **flags)
    assert launched == ['mu_w']
    launched.clear()

    for S, A, ranges in (((30,), (6,), (5,)), ((12, 10), (3, 4), (2, 3))):
        _, plan, V, W, H, ks = _problem('valid', S, A, ranges)
        assert engine.plain_reason(plan, torch.float32) is None
        f32 = [torch.tensor(x, dtype=torch.float32) for x in (V, W, H)]
        engine.update_step(engine.prepare_data(f32[0], plan=plan), f32[1], f32[2], 0.1, 0.3,
                           0.2, tuple(torch.tensor(k, dtype=torch.float32) for k in ks),
                           plan=plan, **flags)
    h_update = 'inhibited_mu_h' if inhibited else 'mu_h'
    assert launched == [h_update, 'grad_w', 'mu_w'] * 2
