"""Every 1-D and 2-D shape the direct-conv path can send to the port's
kernels has a launch geometry: K3 ``mu_h`` (the tensor-core route, else the
FP32 route streamed over its taps in segments), K2 ``grad_w`` (one launch,
else groups of channels or offsets) and K4 ``inhibited_mu_h``.  The
geometries are pure Python, so they are checked here for an H100's 132 SMs
without a card; the kernels themselves run on the card in chip_smoke.py.

Also the comparator of the streamed FP32 route: its sums taken segment by
segment and tap by tap, in the kernel's order, against ``mu_h_plain`` in
float64."""

import numpy as np
import pytest
import torch

from tnmf_tpu_torch.kernels import _build, gw, inhibit, mu_h
from tnmf_tpu_torch.ops.inhibition import inhibition_kernels
from tnmf_tpu_torch.ops.modes import ConvPlan

N_SM = 132
# (atom, sample): 2-D atoms up to 31 x 31 on 256 x 256 samples and 1-D
# atoms up to 1024 on 4096 samples, all on the conv path of the JAX rule
ATOMS = [((9, 9), (256, 256)), ((15, 15), (256, 256)), ((31, 31), (256, 256)),
         ((4, 31), (256, 256)), ((20,), (4096,)), ((301,), (4096,)), ((1024,), (4096,))]


def _as_2d(A, S):
    """``(Tx, Ty), (Ax, Ay)`` of a 'valid' problem; 1-D is one row."""
    T = ConvPlan.create('valid', S, A).transform_shape
    return ((1,) + T, (1,) + A) if len(A) == 1 else (T, A)


@pytest.mark.parametrize('M', [1, 16, 100])
@pytest.mark.parametrize('C', [1, 3, 16, 32, 64])
@pytest.mark.parametrize('A,S', ATOMS)
def test_every_shape_has_a_geometry(A, S, C, M):
    """K3, K2 and K4 (taps at ``2 A - 1``, the default inhibition range)
    return a launch geometry within a block's shared memory; K3's segments
    and K2's groups cover every tap and offset once."""
    (Tx, Ty), (Ax, Ay) = _as_2d(A, S)
    g = mu_h._geometry(4, M, C, Tx, Ty, Ax, Ay, N_SM)
    assert g['route'] in ('mma', 'fma')
    assert g['smem_bytes'] <= _build.MAX_SMEM_BYTES
    if g['route'] == 'fma':
        sc, sa, sb = g['seg_c'], g['seg_ax'], g['seg_ay']
        assert g['n_segments'] == -(-C // sc) * -(-Ax // sa) * -(-Ay // sb)
        # whole channels, else whole rows of one channel, else part of one row
        assert sc == C or (sa, sb) == (Ax, Ay)
        assert sa == Ax or (sc, sb) == (1, Ay)
        assert sb == Ay or (sc, sa) == (1, 1)
        assert g['smem_bytes'] == 4 * (2 * sc * (16 + sa - 1) * g['pitch'] + sc * sa * sb * 8)

    g = gw._geometry(4, M, 2 * C, Tx, Ty, Ax, Ay, N_SM)
    covered = np.zeros((2 * C, Ax, Ay), dtype=int)
    for c0, nc, a0, na, b0, nb in g['groups']:
        covered[c0:c0 + nc, a0:a0 + na, b0:b0 + nb] += 1
        launch = gw._group_chunk(4, M, Tx, Ty, (c0, nc, a0, na, b0, nb), N_SM, True)
        assert launch['smem_bytes'] <= _build.MAX_SMEM_BYTES
    assert (covered == 1).all()

    taps = tuple(2 * a - 1 for a in (Ax, Ay))
    g = inhibit._geometry(M, taps[0], taps[1], len(A) == 2, Tx, Ty, cross=True)
    assert g['smem_bytes'] <= _build.MAX_SMEM_BYTES


def test_fits_today_is_one_launch():
    """Shapes that fit a block keep their one launch: K3's FP32 route one
    segment of all the taps (the first port's kernel) and K2 one group over
    all of X2 (the flagship's three-plane layout)."""
    g = mu_h._geometry(64, 16, 1, 264, 264, 9, 9, N_SM, True, ('fma',))
    assert (g['seg_c'], g['seg_ax'], g['seg_ay'], g['n_segments']) == (1, 9, 9, 1)
    g = gw._geometry(64, 16, 2, 264, 264, 9, 9, N_SM)
    assert g['groups'] == ((0, 2, 0, 9, 0, 9),) and g['planes'] == 3


@pytest.mark.parametrize('dims,groups', [
    # 32 channels of 31 x 31 atoms on 256 x 256: two groups of the 64 stacked channels
    ((4, 16, 64, 286, 286, 31, 31), [(0, 32, 0, 31, 0, 31), (32, 32, 0, 31, 0, 31)]),
    # 300 x 300 atoms: one channel does not fit, so rows of it
    ((1, 3, 2, 11, 11, 300, 300), [(c, 1, a, 150, 0, 300) for c in (0, 1) for a in (0, 150)]),
    # 70,000-tap 1-D atoms: one row does not fit, so stretches of it
    ((1, 3, 2, 1, 101, 1, 70000), [(c, 1, 0, 1, b, 35000) for c in (0, 1) for b in (0, 35000)]),
])
def test_grad_w_groups(dims, groups):
    assert list(gw._geometry(*dims, N_SM)['groups']) == groups


@pytest.mark.parametrize('segment', [(3, 31, 31), (16, 31, 31), (1, 7, 31), (1, 1, 8)])
def test_streamed_reference_matches_plain(segment):
    """The streamed FP32 route's comparator, at 16 channels of 31 x 31
    atoms (six segments of three channels on an H100), agrees with
    ``mu_h_plain`` in float64 for any segmentation."""
    if segment == (3, 31, 31):
        g = mu_h._fma_geometry(16, 31, 31)
        assert (g['seg_c'], g['seg_ax'], g['seg_ay']) == segment
    rng = np.random.default_rng(5)
    N, M, C, T, A = 1, 3, 16, (3, 4), (31, 31)
    E = tuple(t + a - 1 for t, a in zip(T, A))
    Vp, Rx = (torch.tensor(rng.random((N, C) + E)) for _ in range(2))
    W, H, extra = (torch.tensor(rng.random(s)) for s in ((M, C) + A, (N, M) + T, (N, M) + T))
    want = mu_h.mu_h_plain(Vp, Rx, W, H, 0.1, extra)
    got = mu_h.mu_h_segments_plain(Vp, Rx, W, H, 0.1, segment, extra)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)


def test_streamed_reference_1d():
    rng = np.random.default_rng(6)
    Vp, Rx = (torch.tensor(rng.random((2, 3, 40))) for _ in range(2))
    W, H = torch.tensor(rng.random((4, 3, 20))), torch.tensor(rng.random((2, 4, 21)))
    want = mu_h.mu_h_plain(Vp, Rx, W, H, 0.1)
    got = mu_h.mu_h_segments_plain(Vp, Rx, W, H, 0.1, (1, 1, 7))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)


# ------------------------------------------------------- K4, wide stencils

def _k4(shape, ranges, cross, aligned=True):
    """K4's launch geometry for H of ``shape`` with the default kernels of
    ``ranges`` (``2 r + 1`` taps per axis)."""
    return inhibit.launch_geometry(shape, tuple(2 * r + 1 for r in ranges), cross, aligned)


@pytest.mark.parametrize('aligned', [False, True])
@pytest.mark.parametrize('cross', [False, True])
@pytest.mark.parametrize('shape,taps', [
    # 2-D: no tile holds the halo from 239 taps a side on (the row route's
    # limit was 237); the flagship's 264 x 264 plane and a 300 x 300 one
    ((64, 16, 264, 264), 239), ((64, 16, 264, 264), 241), ((1, 4, 300, 300), 241),
    ((1, 4, 300, 300), 301), ((1, 4, 300, 300), 401), ((2, 3, 20, 24), 401),
    # 1-D: no row holds more than 29,049 taps
    ((1, 2, 60000), 29051), ((1, 2, 60000), 40001), ((1, 2, 60000), 60001),
    ((16, 8, 4159), 60001),
])
def test_inhibited_mu_h_wide_stencils_stream(shape, taps, cross, aligned):
    """Stencils wider than a block holds in one piece get a streamed
    geometry: segments that cover every tap, one H buffer copied by 4
    bytes, all y taps in each segment of a 2-D tile, within a block's
    shared memory."""
    g = inhibit.launch_geometry(shape, (taps,) * (len(shape) - 2), cross, aligned)
    assert g['smem_bytes'] <= _build.MAX_SMEM_BYTES
    assert (g['h_bufs'], g['h_vec'], g['compiled']) == (1, False, 0)
    assert g['n_segments'] == -(-g['tx'] // g['seg_x']) * -(-g['ty'] // g['seg_y']) > 1
    assert 1 <= g['seg_x'] <= g['tx'] and 1 <= g['seg_y'] <= g['ty']
    assert g['two_d'] == (len(shape) == 4)  # 2-D tiles keep the stencil separable
    if g['two_d']:
        assert g['seg_y'] == g['ty']
        assert g['smem_bytes'] == 4 * (2 * g['tile_x'] * g['npp']
                                       + (g['tile_x'] + g['seg_x'] - 1) * g['hp']
                                       + (g['tile_y'] + g['ty'] - 1) * g['xtp']
                                       + 8 * inhibit._THREADS * cross + g['tx'] + g['ty'])
    else:
        assert g['tile_x'] == 1 and g['smem_bytes'] == 4 * (
            2 * g['tile_y'] + g['seg_x'] * g['hp'] + g['seg_x'] + g['seg_y'])
    assert g['hp'] % 2 == 1 and g['hp'] >= g['tile_y'] + g['seg_y'] - 1


@pytest.mark.parametrize('cross', [False, True])
@pytest.mark.parametrize('shape,ranges,tile', [
    # the inhibited flagship (17 x 17 taps, compiled)
    ((64, 16, 264, 264), (8, 8), (16, 88, True, 2, 108)),
    # chip_smoke.py's K4 cases: (tile_x, tile_y, 2-D tiles, H buffers, H pitch)
    ((3, 5, 37, 29), (6, 2), (8, 32, True, 2, 49)),
    ((1, 3, 300, 40), (4, 3), (24, 40, True, 2, 52)),
    ((3, 4, 40), (5,), (1, 40, False, 2, 51)),
    ((16, 8, 4159), (63,), (1, 208, False, 2, 335)),
    ((1, 3, 200, 200), (82, 82), None),
    ((1, 2, 12, 4500), (1, 2000), (1, 180, False, 2, 4180)),
    ((1, 2, 20000), (9700,), (1, 244, False, 1, 19644)),
    ((70000, 3, 64), (4,), (1, 64, False, 2, 76)),
    # the widest stencils one piece holds
    ((1, 4, 264, 264), (118, 118), (1, 4, False, 1, 241)),
    ((1, 2, 60000), (14524,), (1, 4, False, 1, 29052)),
])
def test_inhibited_mu_h_stencils_that_fit_keep_their_tile(shape, ranges, cross, tile):
    """A stencil that one piece holds runs in one segment on the tile it
    had before the streamed route (the compiled taps where it had them)."""
    g = _k4(shape, ranges, cross)
    assert g['n_segments'] == 1 and (g['seg_x'], g['seg_y']) == (g['tx'], g['ty'])
    if tile is None:  # 165 x 165 taps: the tile depends on the cross-atom sums
        tile = (8, 104, True, 1, 269) if cross else (16, 104, True, 1, 269)
    assert (g['tile_x'], g['tile_y'], g['two_d'], g['h_bufs'], g['hp']) == tile
    if shape[2:] == (264, 264) and ranges == (8, 8):
        assert g['compiled'] == 17


COMBOS = [(True, False), (False, True), (True, True)]


@pytest.mark.parametrize('use_same,use_cross', COMBOS)
@pytest.mark.parametrize('dims,ranges,segment', [
    # 2-D tiles: segments of x taps (the geometry's, then others)
    ((2, 3, 20, 24), (120, 120), None),
    ((2, 3, 20, 24), (150, 200), (True, 7, 401)),
    ((1, 4, 13, 17), (9, 4), (True, 1, 9)),
    # rows: whole x rows, or one x row and a stretch of y taps
    ((2, 3, 9, 30), (3, 20), (False, 2, 41)),
    ((2, 3, 9, 30), (3, 20), (False, 1, 6)),
    # 1-D: stretches of the taps (the geometry's, then others)
    ((2, 3, 70), (14600,), None),
    ((2, 3, 70), (40,), (False, 1, 9)),
])
def test_streamed_k4_reference_matches_plain(dims, ranges, segment, use_same, use_cross):
    """The streamed K4 route's comparator, its sums segment by segment in
    the kernel's order, agrees with ``inhibited_mu_h_plain`` in float64."""
    ks = [torch.tensor(k) for k in inhibition_kernels(ranges)]
    if segment is None:
        g = inhibit.launch_geometry(dims, tuple(k.numel() for k in ks), use_cross)
        assert g['n_segments'] > 1
        segment = (g['two_d'], g['seg_x'], g['seg_y'])
    rng = np.random.default_rng(7)
    H, neg, pos = (torch.tensor(rng.random(dims)) for _ in range(3))
    args = (H, neg, pos, ks, 0.3, 0.2, 0.1)
    kw = dict(use_same=use_same, use_cross=use_cross)
    want = inhibit.inhibited_mu_h_plain(*args, **kw)
    got = inhibit.inhibited_mu_h_segments_plain(*args, segment, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)
