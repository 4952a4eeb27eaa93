"""The plain versions of the PyTorch port's kernels (K1 mu_ratio, K2 grad_w,
K3 mu_h) against the JAX package's Pallas kernels, run in interpret mode on
the CPU as tests/test_pallas_{mu,gw,phased}.py run them, and against the
engine's XLA path.  CPU tensors take the plain versions; the CUDA kernels
themselves are held against these plain versions on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tnmf_tpu import engine as jengine
from tnmf_tpu.experimental import pallas_gw, pallas_mu, pallas_phased
from tnmf_tpu.ops import conv as jconv
from tnmf_tpu.ops import phased
from tnmf_tpu.ops.modes import ConvPlan as JConvPlan

from tnmf_tpu_torch.kernels import _build
from tnmf_tpu_torch.kernels import gw, mu, mu_h
from tnmf_tpu_torch.ops import conv
from tnmf_tpu_torch.ops.modes import ConvPlan

MODES = ['valid', 'full', 'circular', 'reflect']


def _t(x, dtype=torch.float64):
    return torch.tensor(np.array(x), dtype=dtype)


# --------------------------------------------------------------------- K1

@pytest.mark.parametrize('shape', [(7,), (3, 5, 11), (2, 4, 30, 31)])
def test_mu_ratio_matches_pallas(shape):
    rng = np.random.default_rng(0)
    a, n, p = (rng.random(shape) for _ in range(3))
    want = pallas_mu.mu_ratio(jnp.asarray(a), jnp.asarray(n), jnp.asarray(p), 0.1,
                              interpret=True)
    got = mu.mu_ratio(_t(a), _t(n), _t(p), 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-14)


def test_mu_ratio_float32_matches_pallas():
    rng = np.random.default_rng(4)
    a, n, p = (rng.random((3, 5, 11)).astype(np.float32) for _ in range(3))
    want = pallas_mu.mu_ratio(jnp.asarray(a), jnp.asarray(n), jnp.asarray(p), 1e-9,
                              interpret=True)
    got = mu.mu_ratio(*(_t(x, torch.float32) for x in (a, n, p)), 1e-9)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# --------------------------------------------------------------------- K2

def _gw_problem(mode, S, A, N, C, M, seed=0):
    rng = np.random.default_rng(seed)
    jplan = JConvPlan.create(mode, S, A)
    V = rng.random((N, C) + S)
    W = rng.random((M, C) + A)
    H = rng.random((N, M) + jplan.transform_shape)
    Vp = jconv.prepare_data(jnp.asarray(V, jnp.float32), jplan)
    R = jconv.reconstruct(jnp.asarray(W, jnp.float32), jnp.asarray(H, jnp.float32), jplan)
    X2 = np.asarray(jnp.concatenate([Vp, jconv.extend_data(R, jplan)], axis=1))
    return jplan, ConvPlan.create(mode, S, A), X2, H.astype(np.float32)


@pytest.mark.parametrize('mode', MODES)
def test_grad_w_matches_pallas_all_modes(mode):
    jplan, plan, X2, H = _gw_problem(mode, (20, 17), (5, 4), N=3, C=2, M=4)
    neg0, pos0 = pallas_gw.grad_w_gemm(jnp.asarray(X2), jnp.asarray(H), plan=jplan,
                                       interpret=True)
    neg1, pos1 = gw.grad_w(_t(X2), _t(H), plan)
    np.testing.assert_allclose(neg1.numpy(), np.asarray(neg0), rtol=2e-5)
    np.testing.assert_allclose(pos1.numpy(), np.asarray(pos0), rtol=2e-5)


@pytest.mark.parametrize('S,A,N,C,M', [
    ((11, 9), (3, 2), 1, 1, 1),      # minimal everything
    ((40, 30), (8, 5), 5, 2, 10),    # even atom extents, M not a multiple of 4
])
def test_grad_w_matches_pallas_geometries(S, A, N, C, M):
    jplan, plan, X2, H = _gw_problem('valid', S, A, N=N, C=C, M=M, seed=1)
    neg0, pos0 = pallas_gw.grad_w_gemm(jnp.asarray(X2), jnp.asarray(H), plan=jplan,
                                       interpret=True)
    neg1, pos1 = gw.grad_w(_t(X2), _t(H), plan)
    np.testing.assert_allclose(neg1.numpy(), np.asarray(neg0), rtol=2e-5)
    np.testing.assert_allclose(pos1.numpy(), np.asarray(pos0), rtol=2e-5)


@pytest.mark.parametrize('mode', MODES)
def test_grad_w_1d_matches_conv(mode):
    """1-D shifts (the Pallas kernel is 2-D only): against the conv strategy's
    grad_W_pair, the statistics the JAX engine uses there."""
    rng = np.random.default_rng(2)
    S, A, N, C, M = (40,), (7,), 3, 3, 5
    jplan, plan = JConvPlan.create(mode, S, A), ConvPlan.create(mode, S, A)
    V, W = rng.random((N, C) + S), rng.random((M, C) + A)
    H = rng.random((N, M) + plan.transform_shape)
    Vp = jconv.prepare_data(V, jplan)
    R = jconv.reconstruct(W, H, jplan)
    want = jconv.grad_W_pair(Vp, R, H, jplan)
    X2 = np.concatenate([np.asarray(Vp), np.asarray(jconv.extend_data(R, jplan))], axis=1)
    got = gw.grad_w(_t(X2), _t(H), plan)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10)


# --------------------------------------------------------------------- K3

@pytest.mark.parametrize('with_extra', [False, True])
def test_mu_h_matches_pallas_phased(with_extra):
    """Against the TPU kernel in its phase-blocked layout, converted with
    phased.encode_h / decode_h."""
    rng = np.random.default_rng(0)
    S, A, N, C, M = (40, 44), (9, 9), 2, 2, 3
    jplan, plan = JConvPlan.create('valid', S, A), ConvPlan.create('valid', S, A)
    V, W = rng.random((N, C) + S), rng.random((M, C) + A)
    Hc = rng.random((N, M) + plan.transform_shape)
    pe = rng.random(Hc.shape) if with_extra else None
    Rj = jconv.reconstruct(W, Hc, jplan)
    want = pallas_phased.mu_h(
        phased.prepare_data(jnp.asarray(V), jplan), Rj, jnp.asarray(W),
        phased.encode_h(jnp.asarray(Hc), jplan), jplan, 1e-9,
        None if pe is None else phased.encode_h(jnp.asarray(pe), jplan), interpret=True)
    want = np.asarray(phased.decode_h(want, jplan, M))
    Vp = conv.prepare_data(_t(V), plan)
    Rx = conv.extend_data(_t(Rj), plan)
    got = mu_h.mu_h(Vp, Rx, _t(W), _t(Hc), 1e-9, None if pe is None else _t(pe))
    assert got.shape == Hc.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=1e-7)


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('S,A', [((23, 19), (5, 4)), ((30,), (6,))])
def test_mu_h_matches_engine_mu_H(mode, S, A):
    """Against the JAX engine's H update on the conv strategy."""
    rng = np.random.default_rng(3)
    N, C, M, sparsity = 2, 3, 4, 0.1
    jplan, plan = JConvPlan.create(mode, S, A), ConvPlan.create(mode, S, A)
    V, W = rng.random((N, C) + S), rng.random((M, C) + A)
    H = rng.random((N, M) + plan.transform_shape)
    Vpj = jconv.prepare_data(V, jplan)
    want = jengine._mu_H(jconv, Vpj, jnp.asarray(W), jnp.asarray(H), sparsity, 0., 0.,
                         None, plan=jplan, use_inhibition=False, use_cross=False)
    Rx = conv.extend_data(conv.reconstruct(_t(W), _t(H), plan), plan)
    got = mu_h.mu_h(_t(Vpj), Rx, _t(W), _t(H), 1e-9 + sparsity)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5, atol=1e-7)


# --------------------------------------------------------------- geometry

def test_grad_w_geometry_flagship():
    """64 x 1 x 256 x 256, 16 atoms 9x9: near-equal chunks that cover the
    transform grid, all 2,592 outputs in one 256-thread tile group, and a
    chunk that fits the shared-memory budget."""
    g = gw._geometry(N=64, M=16, C2=2, Tx=264, Ty=264, Ax=9, Ay=9, n_sm=132)
    assert (g['tile_rows'], g['tile_cols']) == (8, 53)
    assert g['grid_y'] == 1 and g['grid_x'] == 4 * 132
    assert g['smem_bytes'] <= gw._SMEM_BUDGET
    # many atoms and channels shrink the chunk rows instead of failing
    g = gw._geometry(N=4, M=64, C2=6, Tx=100, Ty=100, Ax=9, Ay=9, n_sm=132)
    assert g['tile_rows'] < 8 and g['smem_bytes'] <= gw._SMEM_BUDGET
    assert g['grid_y'] == -(-(16 * 6 * 9 * 3) // 256)


def test_mu_h_geometry():
    g = mu_h._geometry(C=1, Ax=9, Ay=9)
    assert g['pitch'] % 32 == 16 and g['pitch'] >= 64 + 8
    assert g['smem_bytes'] == 4 * (2 * 24 * g['pitch'] + 81 * 8)
    with pytest.raises(ValueError, match='shared memory'):
        mu_h._geometry(C=16, Ax=31, Ay=31)
    assert _build.MAX_SMEM_BYTES == 227 * 1024
