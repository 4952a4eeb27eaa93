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
