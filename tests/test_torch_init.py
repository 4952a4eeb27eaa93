"""The port's initializations against the JAX package, on the CPU:
``w_init='patches'`` (the JAX package's bits from a NumPy array, the same
windows from a tensor), ``nndsvda_init`` against the JAX function and
against sklearn's ``nndsvda``, seeded fits from both schemes in float64,
the guard rails, and ``init='device'`` on a CPU generator: the same seed
gives the same bits, another seed other bits, each fit a fresh draw;
``keep_W``; H in (0, 1], W sum-normalised; the mean of H's draw within 4
standard errors of 1/2.

``init='device'`` draws from a ``torch.Generator``, whose stream is not
``jax.random``'s: it is held to the distribution, not to the JAX bits.
``chip_smoke.py`` phase 15 draws on the card at the flagship."""

import numpy as np
import pytest
import torch

import tnmf_tpu
from tnmf_tpu.utils import initialization as jinit

import tnmf_tpu_torch
from tnmf_tpu_torch.utils.initialization import nndsvda_init, patches_init

F64 = torch.float64
TOL = dict(rtol=1e-8, atol=1e-10)


def _V(shape=(6, 2, 20, 20), seed=0):
    return np.random.default_rng(seed).random(shape)


def _model(module, n_atoms, atom_shape, **kw):
    if module is tnmf_tpu_torch:
        kw.setdefault('device', 'cpu')
        kw.setdefault('dtype', F64)
    return module.TransformInvariantNMF(n_atoms, atom_shape, **kw)


# ---------------------------------------------------------------- patches

@pytest.mark.parametrize('dtype', [np.float64, np.float32])
@pytest.mark.parametrize('shape,atom', [((6, 2, 20, 20), (5, 5)), ((5, 1, 40), (7,))])
def test_patches_init_has_the_jax_bits(shape, atom, dtype):
    """A NumPy array: the JAX function's windows and floor, bit for bit,
    and the same RNG state after; a tensor: the same windows, cut from the
    tensor and returned as one."""
    V = _V(shape).astype(dtype)
    rngs = [np.random.default_rng(3) for _ in range(3)]
    W = patches_init(V, 4, atom, rngs[0])
    want = jinit.patches_init(V, 4, atom, rngs[1])
    assert W.dtype == want.dtype == dtype
    np.testing.assert_array_equal(W, want)
    Wt = patches_init(torch.tensor(V), 4, atom, rngs[2])
    assert isinstance(Wt, torch.Tensor) and Wt.dtype == torch.tensor(V).dtype
    np.testing.assert_allclose(Wt.numpy(), want, rtol=1e-6 if dtype == np.float32 else 1e-14)
    assert rngs[0].random() == rngs[1].random() == rngs[2].random()


@pytest.mark.parametrize('data', ['array', 'tensor'])
@pytest.mark.parametrize('ttype', ['shift', 'shift+rot90'])
def test_patches_fits_match_jax(ttype, data):
    """Seeded ``w_init='patches'`` fits (a transform group too); from an
    array the starting dictionary has the JAX package's bits."""
    V = _V((4, 1, 12, 12), seed=1)
    out = []
    for module in (tnmf_tpu_torch, tnmf_tpu):
        m = _model(module, 3, (4, 4), seed=2, w_init='patches', transform_type=ttype)
        m.fit(torch.tensor(V) if module is tnmf_tpu_torch and data == 'tensor' else V,
              n_iterations=0, update_W=False)
        W0 = m.W
        m.fit(V, n_iterations=3, keep_W=True, sparsity_H=0.1)
        out.append((W0, m))
    (pW0, pm), (jW0, jm) = out
    if data == 'array':
        np.testing.assert_array_equal(pW0, jW0)
    np.testing.assert_allclose(pW0, jW0, rtol=1e-14)
    np.testing.assert_allclose(pm.W, jm.W, **TOL)
    np.testing.assert_allclose(pm.H, jm.H, **TOL)


# ----------------------------------------------------------------- nndsvd

def test_nndsvda_init_matches_jax_and_sklearn():
    """The JAX function's factors; against sklearn's randomized sketch, the
    well-determined leading triplet and a reconstruction no worse."""
    from sklearn.decomposition._nmf import _initialize_nmf
    X = np.abs(np.random.default_rng(5).standard_normal((24, 40))) + 0.01
    A, B = nndsvda_init(X, 6)
    jA, jB = jinit.nndsvda_init(X, 6)
    np.testing.assert_array_equal(A, jA)
    np.testing.assert_array_equal(B, jB)
    W_sk, H_sk = _initialize_nmf(X, 6, init='nndsvda', random_state=0)
    np.testing.assert_allclose(A[:, 0], W_sk[:, 0], rtol=1e-6)
    np.testing.assert_allclose(B[0], H_sk[0], rtol=1e-6)
    assert (A > 0).all() and (B > 0).all()
    assert np.linalg.norm(X - A @ B) <= 1.02 * np.linalg.norm(X - W_sk @ H_sk)


@pytest.mark.parametrize('data', ['array', 'tensor'])
def test_nndsvd_fits_match_jax(data):
    """Plain NMF on dot from the SVD start: W sum-normalised, H carrying the
    scales, the product the SVD's, then the same trajectory as JAX."""
    rng = np.random.default_rng(2)
    V = (rng.random((16, 3)) @ rng.random((3, 24)))[:, np.newaxis, :]
    out = []
    for module in (tnmf_tpu_torch, tnmf_tpu):
        m = _model(module, 3, (24,), seed=1, reconstruction_mode='full', w_init='nndsvd')
        m.fit(torch.tensor(V) if module is tnmf_tpu_torch and data == 'tensor' else V,
              n_iterations=0, update_W=False)
        A, B = nndsvda_init(V.reshape(16, 24), 3)
        np.testing.assert_allclose(m.H.reshape(16, 3) @ m.W.reshape(3, 24), A @ B, rtol=1e-12)
        m.fit(V, n_iterations=4, keep_W=True, keep_H=True)
        out.append(m)
    assert out[0]._strategy == 'dot'
    np.testing.assert_allclose(out[0].W, out[1].W, **TOL)
    np.testing.assert_allclose(out[0].H, out[1].H, **TOL)


def test_guard_rails():
    """The JAX constructor's and fit's refusals, with its messages."""
    port = tnmf_tpu_torch.TransformInvariantNMF
    with pytest.raises(ValueError, match='w_init must be'):
        port(2, (3,), w_init='svd')
    with pytest.raises(ValueError, match="init must be 'host' or 'device'"):
        port(2, (3,), init='gpu')
    with pytest.raises(ValueError, match="requires init='host'"):
        port(2, (3,), w_init='patches', init='device')
    with pytest.raises(ValueError, match='transform groups'):
        port(2, (3, 3), w_init='nndsvd', transform_type='shift+flip')
    with pytest.raises(ValueError, match="h_init='correlate'"):
        port(2, (3,), w_init='nndsvd', h_init='correlate')
    m = port(2, (3,), w_init='nndsvd', device='cpu')
    with pytest.raises(ValueError, match='plain-NMF geometry'):
        m.fit(_V((4, 1, 10)), n_iterations=1)
    m = port(20, (8,), w_init='nndsvd', reconstruction_mode='full', device='cpu')
    with pytest.raises(ValueError, match='n_atoms'):
        m.fit(_V((4, 1, 8)), n_iterations=1)
    m = port(2, (12,), w_init='patches', device='cpu')
    with pytest.raises(ValueError, match='fit inside'):
        m.fit(_V((4, 1, 10)), n_iterations=1)
    # keep_W wins over w_init
    m = port(2, (4, 4), seed=1, w_init='patches', device='cpu')
    V = _V((4, 1, 12, 12))
    m.fit(V, n_iterations=2)
    W0 = m.W.copy()
    m.fit(V, n_iterations=0, keep_W=True)
    np.testing.assert_array_equal(m.W, W0)


# ------------------------------------------------------------ init='device'

def _drawn(seed, shape=(5, 2, 16, 16), **kw):
    m = _model(tnmf_tpu_torch, 3, (4, 4), seed=seed, init='device', **kw)
    m.fit(_V(shape), n_iterations=0, update_W=False)
    return m


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_device_draw_is_seeded_and_advances(dtype):
    a, b, c = _drawn(5, dtype=dtype), _drawn(5, dtype=dtype), _drawn(6, dtype=dtype)
    assert a._H.dtype == a._W.dtype == dtype
    assert torch.equal(a._W, b._W) and torch.equal(a._H, b._H)
    assert not torch.equal(a._W, c._W) and not torch.equal(a._H, c._H)
    # each fit draws afresh from the model's one generator
    H0, W0 = a._H.clone(), a._W.clone()
    a.fit(_V((5, 2, 16, 16)), n_iterations=0, update_W=False)
    assert not torch.equal(a._H, H0) and not torch.equal(a._W, W0)
    b.fit(_V((5, 2, 16, 16)), n_iterations=0, update_W=False)
    assert torch.equal(a._H, b._H)
    # no seed: the generator starts from 0
    assert torch.equal(_drawn(None)._H, _drawn(0)._H)


def test_device_draw_distribution_and_normalisation():
    """H in (0, 1] with mean 1/2 within 4 standard errors (1/sqrt(12 n)),
    W sum-normalised per atom and channel; a group draws H's ``M*G`` maps."""
    m = _drawn(7, shape=(8, 2, 30, 30), transform_type='shift+rot90+flip')
    H = m._H
    assert H.shape == (8, 24, 33, 33)
    assert float(H.min()) > 0 and float(H.max()) <= 1
    assert abs(float(H.mean()) - 0.5) < 4 / np.sqrt(12 * H.numel())
    np.testing.assert_allclose(m._W.sum(dim=(-2, -1)).numpy(), 1., rtol=1e-13)
    assert float(m._W.min()) > 0


def test_device_draw_keeps_W_and_H_and_fits():
    m = _drawn(3)
    W0 = m._W.clone()
    V = _V((5, 2, 16, 16))
    m.fit(V, n_iterations=0, keep_W=True, update_W=False)
    assert torch.equal(m._W, W0)
    H0 = m._H.clone()
    m.fit(V, n_iterations=0, keep_W=True, keep_H=True, update_W=False)
    assert torch.equal(m._H, H0)
    m.fit(V, n_iterations=0, update_W=False)
    assert not torch.equal(m._W, W0)
    # a fit from the device draw lowers the energy as the host draw's does
    e0 = m._energy_function()
    m.fit(V, n_iterations=10, keep_W=True, keep_H=True)
    assert m._energy_function() < 0.5 * e0


def test_device_draw_leaves_the_host_stream_and_correlate_draws_no_H():
    """``init='device'`` consumes nothing of the NumPy stream; with
    ``h_init='correlate'`` H is the matched filter, the host init's with
    the same dictionary."""
    V = _V((5, 2, 16, 16))
    np.random.seed(0)
    want = np.random.random()
    np.random.seed(0)
    _drawn(None)
    assert np.random.random() == want
    dev = _model(tnmf_tpu_torch, 3, (4, 4), seed=4, init='device', h_init='correlate')
    dev.fit(V, n_iterations=0, update_W=False)
    host = _model(tnmf_tpu_torch, 3, (4, 4), h_init='correlate')
    host._W = dev._W.clone()
    host.fit(V, n_iterations=0, keep_W=True, update_W=False)
    assert torch.equal(dev._H, host._H)
