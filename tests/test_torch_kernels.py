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


@pytest.mark.parametrize('dtype,rtol', [(torch.float64, 1e-12), (torch.float32, 1e-6)])
@pytest.mark.parametrize('M,C,A', [(4, 1, (9, 9)), (5, 3, (4, 6)), (3, 1, (20,)), (6, 3, (33,))])
def test_mu_w_plain_matches_jax_epilogue(M, C, A, dtype, rtol):
    """K1's W epilogue: the ratio ``W * neg / (pos + EPS)``, then the JAX
    package's ``_normalize_W``; an all-zero atom stays zero."""
    rng = np.random.default_rng(M)
    W, neg, pos = (rng.random((M, C) + A) for _ in range(3))
    W[1] = 0.
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    W, neg, pos = (x.astype(np_dtype) for x in (W, neg, pos))
    want = jengine._normalize_W(jnp.asarray(W) * jnp.asarray(neg)
                                / (jnp.asarray(pos) + jengine.EPS), len(A))
    got = mu.mu_w(*(_t(x, dtype) for x in (W, neg, pos)), jengine.EPS, len(A))
    assert got.dtype == dtype
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=0)
    assert not got[1].any()
    sums = got.sum(dim=tuple(range(2, 2 + len(A))))
    np.testing.assert_allclose(sums[[0] + list(range(2, M))].numpy(), 1., rtol=10 * rtol)


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
    neg1, pos1 = gw.grad_w(_t(X2), _t(H))
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
    neg1, pos1 = gw.grad_w(_t(X2), _t(H))
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
    got = gw.grad_w(_t(X2), _t(H))
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
    """64 x 1 x 256 x 256, 16 atoms 9x9: one row tile of 16 atoms, the
    2 x 81 (channel, offset) columns flattened and padded to 168 (21 column
    tiles), 3 tiles per warp on 7 warps, chunks of 4 rows x 88 columns that
    cover the 264 x 264 transform grid exactly, two blocks per SM."""
    g = gw._geometry(N=64, M=16, C2=2, Tx=264, Ty=264, Ax=9, Ay=9, n_sm=132)
    assert (g['n_mt'], g['m_rows'], g['n_ct'], g['col_pad']) == (1, 16, 21, 6)
    assert (g['nt'], g['n_items'], g['ksplit'], g['grid_y']) == (3, 7, 1, 1)
    assert (g['tile_rows'], g['tile_cols'], g['blocks_per_sm'], g['planes']) == (4, 88, 2, 3)
    assert g['n_chunks'] == 64 * 66 * 3 and g['grid_x'] == 2 * 132
    # pitches that keep the fragment loads off each other's banks
    assert g['hp'] % 8 == 4 and g['xp'] >= 88 + 8
    assert gw._b_conflicts(g['xp'], 4 + 8, 9, 9, 2, 21) == 0
    assert 2 * (g['smem_bytes'] + 1024) <= 233472
    # many atoms and channels: more row tiles and y blocks, still in budget
    g = gw._geometry(N=4, M=64, C2=6, Tx=100, Ty=100, Ax=9, Ay=9, n_sm=132)
    assert g['n_mt'] == 4 and g['smem_bytes'] <= gw._SMEM_BUDGET
    assert g['grid_y'] == -(-g['n_items'] // 8)


@pytest.mark.parametrize('M', [3, 16, 17, 64])
@pytest.mark.parametrize('C2', [2, 6])
def test_grad_w_geometry_tiles(M, C2):
    """Row tiles of 16 atoms and column tiles of 8 (channel, offset) columns
    with their padding, every tile owned by one work item, shared memory in
    budget, an X2 pitch with no more bank conflicts than any other."""
    g = gw._geometry(N=8, M=M, C2=C2, Tx=60, Ty=70, Ax=7, Ay=7, n_sm=132)
    assert g['n_mt'] == -(-M // 16)
    # a block stages the atoms of its items' row tiles: all of them when it holds every item
    assert min(M, 16) <= g['m_rows'] <= M and (g['grid_y'] > 1 or g['m_rows'] == M)
    assert g['n_ct'] == -(-(C2 * 49) // 8) and g['col_pad'] == 8 * g['n_ct'] - C2 * 49
    xr = g['tile_rows'] + 6
    first = -(-g['xw'] // 4) * 4
    best = min(gw._b_conflicts(p, xr, 7, 7, C2, g['n_ct']) for p in range(first, first + 32, 4))
    assert g['xp'] % 4 == 0
    assert gw._b_conflicts(g['xp'], xr, 7, 7, C2, g['n_ct']) == best
    assert g['n_items'] == g['n_mt'] * -(-g['n_ct'] // g['nt'])
    assert g['nt'] in gw._TILES_PER_WARP
    assert g['ipb'] * g['ksplit'] <= 8 and g['ipb'] * g['grid_y'] >= g['n_items']
    assert g['tile_cols'] % 8 == 0 and g['tile_rows'] in (1, 2, 4)
    assert g['smem_bytes'] <= _build.MAX_SMEM_BYTES
    # three planes: the raw chunk and its big and small TF32 halves
    assert g['planes'] == 3 and g['smem_bytes'] == 4 * 3 * (
        g['tile_rows'] * g['m_rows'] * g['hp'] + C2 * (g['tile_rows'] + 6) * g['xp'])


def test_grad_w_geometry_1d_and_limits():
    # the 1-D pulse train: one row, 20 offsets -> 24 per channel
    g = gw._geometry(N=1, M=3, C2=2, Tx=1, Ty=81, Ax=1, Ay=20, n_sm=132, vec=False)
    assert (g['tile_rows'], g['tile_cols'], g['n_ct'], g['col_pad']) == (1, 88, 5, 0)
    assert g['xw'] == 88 + 19 and g['vec'] == 1
    # a ragged ty: near-equal chunks of whole MMA steps
    g = gw._geometry(N=3, M=5, C2=4, Tx=26, Ty=92, Ax=4, Ay=6, n_sm=132)
    assert g['tile_cols'] == 48 and g['n_chunks'] == 3 * 7 * 2
    # a chunk that cannot fit over both channels runs as one launch per channel
    g = gw._geometry(N=1, M=5, C2=2, Tx=100, Ty=100, Ax=200, Ay=200, n_sm=132)
    assert g['groups'] == ((0, 1, 0, 200, 0, 200), (1, 1, 0, 200, 0, 200))
    assert g['smem_bytes'] <= _build.MAX_SMEM_BYTES


def test_grad_w_geometry_many_atoms():
    """With more work items than warps each block stages only the atoms of
    its own row tiles, so shared memory stops growing with M."""
    g = gw._geometry(N=1, M=5000, C2=2, Tx=100, Ty=100, Ax=9, Ay=9, n_sm=132)
    assert g['grid_y'] > 1 and g['m_rows'] <= 16 * (8 + 1)
    assert g == {**gw._geometry(N=1, M=4000, C2=2, Tx=100, Ty=100, Ax=9, Ay=9, n_sm=132),
                 'n_mt': g['n_mt'], 'n_items': g['n_items'], 'grid_y': g['grid_y'],
                 'grid_x': g['grid_x']}


def _first_design_fits(M, C2, Tx, Ty, Ax, Ay):
    """Whether the first CUDA design of K2 (a 4-atom x 4-offset register tile
    per thread over chunks of at most 64 ty columns) could stage a chunk."""
    tc = -(-Ty // -(-Ty // 64))
    floats = min(-(-M // 4) * 4 * tr * tc + C2 * (tr + Ax - 1) * (tc + 4 * -(-Ay // 4) - 1)
                 for tr in {-(-Tx // -(-Tx // r)) for r in (8, 4, 2, 1)})
    return 4 * floats <= _build.MAX_SMEM_BYTES


@pytest.mark.parametrize('M,C2,Tx,Ty,Ay', [
    (1, 2, 200, 200, 100), (16, 6, 200, 200, 57), (3, 2, 8, 8, 9), (17, 6, 40, 9, 5),
    (5, 2, 3, 3, 4), (16, 2, 1, 4, 61), (300, 32, 200, 12, 20), (7000, 2, 200, 8, 1)])
def test_grad_w_geometry_takes_first_design_shapes(M, C2, Tx, Ty, Ay):
    """Every shape the first design could stage still runs: at the widest
    atom it took, the split layout or, failing that, the compact one (one
    plane split as it loads, the tightest pitches, ty < 8 as a narrow chunk)
    fits."""
    Ax = max(a for a in range(1, 400) if _first_design_fits(M, C2, Tx, Ty, a, Ay))
    for vec in (False, True):
        if vec and (Ty % 4 or (Ty + Ay - 1) % 4):
            continue
        g = gw._geometry(N=2, M=M, C2=C2, Tx=Tx, Ty=Ty, Ax=Ax, Ay=Ay, n_sm=132, vec=vec)
        assert g['smem_bytes'] <= _build.MAX_SMEM_BYTES
        assert g['smem_bytes'] == 4 * g['planes'] * (
            g['tile_rows'] * g['m_rows'] * g['hp'] + C2 * (g['tile_rows'] + Ax - 1) * g['xp'])
        assert g['hw'] == (Ty if g['planes'] == 1 and Ty < 8 and g['hp'] == g['hw']
                           else g['tile_cols'])


def test_mu_h_geometry():
    """The FP32 route keeps the first port's geometry (one segment of all
    the taps) where it fits; taps that do not fit a block stream through
    it in segments of whole channels."""
    g = mu_h._fma_geometry(C=1, Ax=9, Ay=9)
    assert g['pitch'] % 32 == 16 and g['pitch'] >= 64 + 8
    assert g['smem_bytes'] == 4 * (2 * 24 * g['pitch'] + 81 * 8)
    assert (g['seg_c'], g['seg_ax'], g['seg_ay'], g['n_segments']) == (1, 9, 9, 1)
    g = mu_h._fma_geometry(C=16, Ax=31, Ay=31)
    assert (g['seg_c'], g['seg_ax'], g['seg_ay'], g['n_segments']) == (3, 31, 31, 6)
    assert g['smem_bytes'] == 4 * (2 * 3 * 46 * g['pitch'] + 3 * 961 * 8)
    assert g['smem_bytes'] <= _build.MAX_SMEM_BYTES
    assert _build.MAX_SMEM_BYTES == 227 * 1024


def test_mu_h_geometry_flagship():
    """64 x 1 x 256 x 256, 16 atoms 9x9: the tensor-core route, one row tile
    of 16 atoms, 81 taps padded to 88 (11 k steps), chunks of 8 rows x 88
    columns that cover the 264 x 264 positions exactly, 3 work items per
    chunk row (4, 4 and 3 column tiles), two blocks per SM."""
    g = mu_h._geometry(N=64, M=16, C=1, Tx=264, Ty=264, Ax=9, Ay=9, n_sm=132)
    assert g['route'] == 'mma'
    assert (g['n_mt'], g['ks']) == (1, 11)  # 81 taps padded to 88
    assert (g['tile_rows'], g['tile_cols'], g['n_groups']) == (8, 88, 3)
    assert (g['xr'], g['xw'], g['vec']) == (16, 96, 4)
    assert g['n_chunks'] == 64 * 33 * 3 and g['grid_x'] == 2 * 132
    assert g['blocks_per_sm'] == 2 and 2 * (g['smem_bytes'] + 1024) <= 233472
    # a pitch that keeps the sliding-window B loads off each other's banks
    assert mu_h._b_conflicts(g['xp'], 16, 1, 9, 9, 11) == 0


@pytest.mark.parametrize('where,dims,route,k_pad', [
    ('flagship', (64, 16, 1, 264, 264, 9, 9), 'mma', 88),
    ('golden 2-D fixture', (2, 10, 3, 70, 96, 7, 7), 'mma', 152),
    ('17 atoms: two row tiles', (2, 17, 1, 32, 29, 9, 9), 'mma', 88),
    ('1-D pulse train as one row', (1, 3, 1, 1, 81, 1, 20), 'mma', 24),
    ('C=3 25x25: split W too large', (1, 5, 3, 36, 46, 25, 25), 'fma', None),
    ('100 atoms C=3 15x15', (1, 100, 3, 30, 30, 15, 15), 'fma', None),
])
def test_mu_h_geometry_routes(where, dims, route, k_pad):
    """The route is chosen from the shapes: the tensor-core route when its
    three window planes and split dictionary fit a block, else the first
    port's FP32 kernel with its geometry as it was."""
    N, M, C, Tx, Ty, Ax, Ay = dims
    g = mu_h._geometry(N, M, C, Tx, Ty, Ax, Ay, n_sm=132)
    assert g['route'] == route, where
    if route == 'mma':
        assert 8 * g['ks'] == k_pad == 8 * -(-(C * Ax * Ay) // 8)
        assert g['n_mt'] == -(-M // 16)
    else:
        assert g == dict(route='fma', **mu_h._fma_geometry(C, Ax, Ay))
    # forcing the FP32 route (chip_smoke.py's comparison) takes the same geometry
    assert (mu_h._geometry(N, M, C, Tx, Ty, Ax, Ay, 132, True, ('fma',))
            == dict(route='fma', **mu_h._fma_geometry(C, Ax, Ay)))


def test_mu_h_geometry_neither_route_raises():
    """A shape whose taps neither the tensor-core route nor one FP32
    segment holds no longer raises: it streams through the FP32 route."""
    g = mu_h._geometry(N=1, M=5, C=16, Tx=100, Ty=100, Ax=31, Ay=31, n_sm=132)
    assert g == dict(route='fma', **mu_h._fma_geometry(16, 31, 31))
    assert g['n_segments'] > 1


@pytest.mark.parametrize('M', [3, 16, 17, 64])
@pytest.mark.parametrize('C,A,T', [(1, (9, 9), (40, 37)), (3, (7, 7), (70, 96)),
                                   (2, (4, 6), (32, 93)), (1, (1, 20), (1, 81)),
                                   (3, (1, 7), (1, 295))])
@pytest.mark.parametrize('vec', [False, True])
def test_mu_h_geometry_mma_tiles(M, C, A, T, vec):
    """The tensor-core route's chunk, pitch and shared memory: within a
    block, the layout mu_h.cu computes (A fragments big and small, the tap
    offsets, raw, big and small planes of the Vp and Rx windows), a pitch
    with no more bank conflicts than any other, whole column tiles."""
    (Ax, Ay), (Tx, Ty) = A, T
    g = mu_h._geometry(2, M, C, Tx, Ty, Ax, Ay, n_sm=132, vec=vec)
    assert g['route'] == 'mma'
    ks, n_mt = g['ks'], g['n_mt']
    assert g['smem_bytes'] <= _build.MAX_SMEM_BYTES
    assert g['smem_bytes'] == 4 * (2 * n_mt * ks * 128 + 8 * ks
                                   + 3 * 2 * C * g['xr'] * g['xp'])
    assert g['tile_cols'] % 8 == 0 and g['tile_rows'] <= min(8, Tx)
    assert g['xr'] == g['tile_rows'] + Ax - 1
    assert g['xw'] >= g['tile_cols'] + Ay - 1 and g['xp'] >= g['xw'] and g['xp'] % 4 == 0
    assert g['xw'] % g['vec'] == 0 and g['vec'] == (4 if vec else 1)
    assert g['n_groups'] * 4 >= g['tile_cols'] // 8 > (g['n_groups'] - 1) * 4
    first = -(-g['xw'] // 4) * 4
    best = min(mu_h._b_conflicts(p, g['xr'], C, Ax, Ay, ks) for p in range(first, first + 32, 4))
    assert mu_h._b_conflicts(g['xp'], g['xr'], C, Ax, Ay, ks) == best
    assert g['grid_x'] == min(g['n_chunks'], g['blocks_per_sm'] * 132)


@pytest.mark.parametrize('M,C,Tx,Ty,Ay', [
    (1, 1, 200, 200, 100), (16, 3, 200, 200, 57), (3, 1, 8, 8, 9), (17, 3, 40, 9, 5),
    (5, 1, 3, 3, 4), (16, 1, 1, 4, 61), (300, 8, 200, 12, 20), (7000, 1, 200, 8, 1),
    (64, 8, 100, 100, 9), (100, 3, 50, 50, 15)])
def test_mu_h_geometry_takes_first_design_shapes(M, C, Tx, Ty, Ay):
    """Every shape the first port's kernel took still runs: at the widest
    atom it took, one of the two routes holds the problem within a block."""
    Ax = max(a for a in range(1, 400) if 4 * (
        2 * C * (16 + a - 1) * (64 + Ay - 1 + (16 - (64 + Ay - 1)) % 32) + C * a * Ay * 8)
        <= _build.MAX_SMEM_BYTES)
    for ax in (1, Ax // 2, Ax):
        for vec in (False, True):
            g = mu_h._geometry(2, M, C, Tx, Ty, ax, Ay, n_sm=132, vec=vec)
            assert g['smem_bytes'] <= _build.MAX_SMEM_BYTES
            if g['route'] == 'fma':
                assert g == dict(route='fma', **mu_h._fma_geometry(C, ax, Ay))
