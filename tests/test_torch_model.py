"""The PyTorch port's model and engine against the JAX package, in float64 on
the CPU: the seeded golden 2-D fits (the fixture of test_2d_backends.py),
the fit loop step for step, and a JAX checkpoint continued in the port."""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tnmf_tpu
from tnmf_tpu import engine as jengine
from tnmf_tpu.ops.inhibition import inhibition_kernels
from tnmf_tpu.ops.modes import ConvPlan as JConvPlan

import tnmf_tpu_torch
from tnmf_tpu_torch import engine
from tnmf_tpu_torch.ops.modes import ConvPlan
from tnmf_tpu_torch.utils.data_loading import synthetic_face

from .fixtures import image_2d, load_goldens

MODES = ['valid', 'full', 'circular']
F64 = torch.float64
TOL = dict(rtol=1e-8, atol=1e-10)


@lru_cache(maxsize=None)
def _fit_jax(mode):
    np.random.seed(seed=42)
    nmf = tnmf_tpu.TransformInvariantNMF(
        n_atoms=10, atom_shape=(7, 7), backend='jax_conv', reconstruction_mode=mode)
    nmf.fit(image_2d(), sparsity_H=0.1, n_iterations=10)
    return nmf


@pytest.mark.parametrize('mode', MODES)
def test_golden_fit_matches_jax(mode):
    np.random.seed(seed=42)
    nmf = tnmf_tpu_torch.TransformInvariantNMF(
        n_atoms=10, atom_shape=(7, 7), reconstruction_mode=mode, device='cpu', dtype=F64)
    nmf.fit(image_2d(), sparsity_H=0.1, n_iterations=10)
    assert np.isclose(nmf._energy_function(), load_goldens()['2d'][mode])
    ref = _fit_jax(mode)
    np.testing.assert_allclose(nmf.W, ref.W, **TOL)
    np.testing.assert_allclose(nmf.H, ref.H, **TOL)
    np.testing.assert_allclose(nmf.R, ref.R, **TOL)
    np.testing.assert_allclose(nmf.R_partial(0), ref.R_partial(0), **TOL)
    np.testing.assert_allclose(nmf.W.sum(axis=(-1, -2)), 1.0)
    np.testing.assert_array_equal(nmf.V, image_2d())


def test_synthetic_face_copy_matches_jax_package():
    from tnmf_tpu.utils.data_loading import synthetic_face as jax_face
    np.testing.assert_array_equal(synthetic_face(gray=False)[::10, ::10],
                                  jax_face(gray=False)[::10, ::10])


def _small_problem(mode, seed=0):
    rng = np.random.default_rng(seed)
    S, A, N, C, M = (12, 10), (3, 4), 2, 2, 3
    jplan, plan = JConvPlan.create(mode, S, A), ConvPlan.create(mode, S, A)
    V = rng.random((N, C) + S)
    W = rng.random((M, C) + A)
    W /= W.sum(axis=(-2, -1), keepdims=True)
    H = rng.random((N, M) + plan.transform_shape)
    return jplan, plan, V, W, H


@pytest.mark.parametrize('mode', ['valid', 'reflect'])
@pytest.mark.parametrize('update_H,update_W', [(True, True), (True, False), (False, True)])
def test_fit_loop_matches_jax_step_for_step(mode, update_H, update_W):
    jplan, plan, V, W, H = _small_problem(mode)
    Vpj = jengine.prepare_data(jnp.asarray(V), plan=jplan, strategy='conv')
    Vp = engine.prepare_data(torch.tensor(V), plan=plan)
    kernels = tuple(jnp.asarray(k) for k in inhibition_kernels((2, 3)))
    Wt, Ht = torch.tensor(W), torch.tensor(H)
    for k in range(1, 4):
        Wj, Hj = jengine.fit_loop(Vpj, jnp.asarray(W), jnp.asarray(H), k, 0.1, 0., 0.,
                                  kernels, plan=jplan, strategy='conv',
                                  update_H=update_H, update_W=update_W)
        Wt, Ht = engine.update_step(Vp, Wt, Ht, 0.1, plan=plan,
                                    update_H=update_H, update_W=update_W)
        np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), **TOL)
        np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), **TOL)
        Wl, Hl = engine.fit_loop(Vp, torch.tensor(W), torch.tensor(H), k, 0.1, plan=plan,
                                 update_H=update_H, update_W=update_W)
        np.testing.assert_array_equal(Wl.numpy(), Wt.numpy())
        np.testing.assert_array_equal(Hl.numpy(), Ht.numpy())
    e_jax = jengine.energy(jnp.asarray(V), Wj, Hj, plan=jplan, strategy='conv')
    e = engine.energy(torch.tensor(V), Wt, Ht, plan=plan)
    np.testing.assert_allclose(float(e), float(e_jax), rtol=1e-12)


def test_normalize_W_keeps_zero_atoms():
    W = torch.tensor(np.random.default_rng(0).random((3, 2, 4, 4)))
    W[1] = 0
    got = engine._normalize_W(W, 2)
    want = jengine._normalize_W(jnp.asarray(W.numpy()), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15)
    assert torch.all(got[1] == 0)


@pytest.mark.parametrize('include_H', [False, True])
def test_jax_checkpoint_continues_in_port(tmp_path, include_H):
    """A dictionary fit by the JAX package, saved to .npz, loaded by the port
    and continued with keep_W=True matches the JAX model's continuation."""
    rng = np.random.default_rng(5)
    V1, V2 = rng.random((2, 2, 14, 12)), rng.random((3, 2, 14, 12))
    np.random.seed(1)
    jm = tnmf_tpu.TransformInvariantNMF(n_atoms=3, atom_shape=(4, 3),
                                        reconstruction_mode='circular')
    jm.fit(V1, n_iterations=4, sparsity_H=0.05)
    path = str(tmp_path / 'model.npz')
    jm.save(path, include_H=include_H)

    pm = tnmf_tpu_torch.TransformInvariantNMF.load(path, device='cpu')
    assert pm.dtype == F64 and pm.n_atoms == 3 and pm.atom_shape == (4, 3)
    np.testing.assert_array_equal(pm.W, jm.W)
    if include_H:
        np.testing.assert_allclose(pm.R, jm.R, **TOL)

    jl = tnmf_tpu.TransformInvariantNMF.load(path)
    np.random.seed(2)
    jl.fit(V2, n_iterations=3, keep_W=True, sparsity_H=0.05)
    np.random.seed(2)
    pm.fit(V2, n_iterations=3, keep_W=True, sparsity_H=0.05)
    np.testing.assert_allclose(pm.W, jl.W, **TOL)
    np.testing.assert_allclose(pm.H, jl.H, **TOL)
    np.testing.assert_allclose(pm._energy_function(), jl._energy_function(), rtol=1e-10)


def test_from_numpy():
    W, H = np.ones((2, 1, 3)), np.zeros((4, 2, 5))
    Wt, Ht = tnmf_tpu_torch.from_numpy(W, H, device='cpu', dtype=torch.float32)
    assert Wt.dtype == Ht.dtype == torch.float32 and Ht.shape == (4, 2, 5)
    Wt, Ht = tnmf_tpu_torch.from_numpy(W, device='cpu', dtype=F64)
    assert Ht is None and Wt.dtype == F64


def test_seeded_private_rng_matches_jax():
    """seed= draws from a private default_rng in the JAX package's order."""
    V = np.random.default_rng(9).random((2, 1, 10, 9))
    jm = tnmf_tpu.TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3), seed=11)
    jm.fit(V, n_iterations=2)
    pm = tnmf_tpu_torch.TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3), seed=11,
                                              device='cpu', dtype=F64)
    pm.fit(V, n_iterations=2)
    np.testing.assert_allclose(pm.W, jm.W, **TOL)
    np.testing.assert_allclose(pm.H, jm.H, **TOL)
