"""The PyTorch port's lateral inhibition (tnmf_tpu_torch.ops.inhibition) and
the plain version of K4 (kernels.inhibit.inhibited_mu_h_plain) against the
JAX package in float64 on the CPU: the kernels and ranges, the separable
zero-padded convolution on both sides of the JAX package's banded-matrix
threshold, the positive term, and the Pallas kernel run in interpret mode
as tests/test_pallas_mu.py runs it.  The CUDA kernel itself is held against
the plain version on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tnmf_tpu.experimental import pallas_mu
from tnmf_tpu.ops import inhibition as jinh

from tnmf_tpu_torch.kernels import _build, inhibit
from tnmf_tpu_torch.ops import inhibition as inh

F64 = torch.float64


def _t(x):
    return torch.tensor(np.array(x), dtype=F64)


@pytest.mark.parametrize('ranges', [(0,), (5,), (2, 3), (8, 8), (63,), (1, 8, 2)])
def test_inhibition_kernels_match_jax(ranges):
    got, want = inh.inhibition_kernels(ranges), jinh.inhibition_kernels(ranges)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        np.testing.assert_array_equal(g, w)
    assert inh.inhibition_kernels((0,))[0].tolist() == [1.0]


@pytest.mark.parametrize('value,atom', [(None, (9, 9)), (None, (20,)), (3, (5, 4)),
                                        ((6, 2), (7, 7)), ([1, 2, 3], (2, 3, 4))])
def test_resolve_inhibition_range_matches_jax(value, atom):
    assert inh.resolve_inhibition_range(value, atom) == \
        jinh.resolve_inhibition_range(value, atom)


def test_resolve_inhibition_range_rank_mismatch():
    for mod in (inh, jinh):
        with pytest.raises(ValueError, match='one entry per atom axis'):
            mod.resolve_inhibition_range((1, 2), (3,))


# below / above the JAX package's _BAND_MIN_ELEMS = 2**14 elements, so the
# comparator is its single-channel conv path and its banded-matrix path
@pytest.mark.parametrize('shape,ranges,axes,banded', [
    ((3, 4, 40), (5,), (-1,), False),
    ((8, 4, 700), (8,), (-1,), True),
    ((2, 3, 12, 14), (2, 3), (-2, -1), False),
    ((4, 4, 40, 40), (2, 3), (-2, -1), True),
    ((2, 2, 5, 6, 7), (1, 2, 3), (-3, -2, -1), False),
    ((2, 2, 5, 300, 6), (1, 8, 2), (-3, -2, -1), True),
], ids=['1d-small', '1d-banded', '2d-small', '2d-banded', '3d-small', '3d-banded'])
def test_convolve_multi_1d_matches_jax(shape, ranges, axes, banded):
    from scipy.ndimage import convolve1d
    assert (np.prod(shape) >= jinh._BAND_MIN_ELEMS) == banded
    rng = np.random.default_rng(0)
    H = rng.random(shape)
    ks = inh.inhibition_kernels(ranges)
    got = inh.convolve_multi_1d(_t(H), ks, axes)
    assert got.dtype == F64 and got.shape == H.shape
    want = jinh.convolve_multi_1d(jnp.asarray(H), tuple(jnp.asarray(k) for k in ks), axes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    # zero-padded at the boundary: scipy's constant mode, the reference
    ref = H
    for ax, k in zip(axes, ks):
        ref = convolve1d(ref, k, axis=ax, mode='constant', cval=0.0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)


def test_convolve_multi_1d_inner_axis():
    """An axis list that leaves a trailing axis out still folds only the
    leading axes into the batch."""
    H = np.random.default_rng(1).random((2, 3, 9, 8))
    ks = inh.inhibition_kernels((3,))
    got = inh.convolve_multi_1d(_t(H), ks, (2,))
    want = jinh.convolve_multi_1d(jnp.asarray(H), (jnp.asarray(ks[0]),), (2,))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


COMBOS = [(True, False), (False, True), (True, True)]


@pytest.mark.parametrize('dims,ranges', [((2, 4, 20, 24), (3, 2)), ((3, 4, 40), (5,)),
                                         ((2, 5, 130, 140), (8, 8))])
@pytest.mark.parametrize('use_same,use_cross', COMBOS)
def test_inhibition_positive_term_matches_jax(dims, ranges, use_same, use_cross):
    rng = np.random.default_rng(2)
    H = rng.random(dims)
    ks = inh.inhibition_kernels(ranges)
    got = inh.inhibition_positive_term(_t(H), ks, len(ranges), 0.3, 0.2, dims[1],
                                       use_same, use_cross)
    want = jinh.inhibition_positive_term(jnp.asarray(H), tuple(jnp.asarray(k) for k in ks),
                                         len(ranges), jnp.float64(0.3), jnp.float64(0.2),
                                         dims[1], use_same, use_cross)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-14)


def test_range_zero_same_atom_term_is_zero():
    """Range 0 is the one-tap kernel [1.]: g equals H, so the same-atom term
    vanishes exactly."""
    H = _t(np.random.default_rng(3).random((2, 3, 11, 7)))
    term = inh.inhibition_positive_term(H, inh.inhibition_kernels((0, 0)), 2, 0.7, 0., 3,
                                        True, False)
    assert torch.count_nonzero(term) == 0


# the dims/ranges of tests/test_pallas_mu.py::test_inhibited_mu_h
PALLAS_CASES = [
    ((2, 4, 20, 24), (3, 2)),
    ((3, 5, 17, 13), (6, 6)),
    ((1, 3, 300, 40), (4, 3)),
    ((3, 4, 40), (5,)),
]


@pytest.mark.parametrize('dims,ranges', PALLAS_CASES)
@pytest.mark.parametrize('use_same,use_cross', COMBOS)
def test_inhibited_mu_h_plain_matches_pallas(dims, ranges, use_same, use_cross):
    rng = np.random.default_rng(1)
    H, neg, pos = (rng.random(dims) for _ in range(3))
    ks = inh.inhibition_kernels(ranges)
    want = pallas_mu.inhibited_mu_h(jnp.asarray(H), jnp.asarray(neg), jnp.asarray(pos),
                                    tuple(jnp.asarray(k) for k in ks), 0.3, 0.2, 1e-9 + 0.1,
                                    use_same=use_same, use_cross=use_cross, interpret=True)
    before = inhibit.inhibited_mu_h.launches
    got = inhibit.inhibited_mu_h(_t(H), _t(neg), _t(pos), ks, 0.3, 0.2, 1e-9 + 0.1,
                                 use_same=use_same, use_cross=use_cross)
    assert inhibit.inhibited_mu_h.launches == before  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)


def test_cross_inhibition_with_one_atom():
    """One atom has no other atom to inhibit.  The JAX package's default
    route divides by n_atoms - 1 = 0 and returns NaN; its Pallas kernel
    divides by max(M - 1, 1) and drops the term.  The port raises."""
    rng = np.random.default_rng(4)
    H = rng.random((2, 1, 10, 12))
    ks = inh.inhibition_kernels((2, 3))
    jks = tuple(jnp.asarray(k) for k in ks)
    term = jinh.inhibition_positive_term(jnp.asarray(H), jks, 2, jnp.float64(0.),
                                         jnp.float64(0.5), 1, False, True)
    assert np.isnan(np.asarray(term)).all()
    out = pallas_mu.inhibited_mu_h(jnp.asarray(H), jnp.asarray(H), jnp.asarray(H), jks, 0.,
                                   0.5, 0.1, use_same=False, use_cross=True, interpret=True)
    np.testing.assert_allclose(np.asarray(out), H * H / (H + 0.1), rtol=1e-12)
    with pytest.raises(ValueError, match='at least 2 atoms'):
        inh.inhibition_positive_term(_t(H), ks, 2, 0., 0.5, 1, False, True)
    with pytest.raises(ValueError, match='at least 2 atoms'):
        inhibit.inhibited_mu_h(_t(H), _t(H), _t(H), ks, 0., 0.5, 0.1,
                               use_same=False, use_cross=True)
    # same-atom inhibition alone is fine with one atom
    got = inhibit.inhibited_mu_h(_t(H), _t(H), _t(H), ks, 0.3, 0.5, 0.1, use_cross=False)
    assert torch.isfinite(got).all()


def test_inhibited_mu_h_geometry():
    # the inhibited flagship: 264 x 264 planes, 17 x 17 taps -> 16 x 88
    # tiles (272 x 264 covered, against 288 x 288 with the first design's 32 x 32), an
    # odd pitch for the staged H tile, two H buffers, four blocks per SM;
    # the cross-atom term adds each thread's eight sums
    hr, hw = 16 + 16, 88 + 16
    for cross, sums in ((False, 0), (True, 8 * 256)):
        g = inhibit._geometry(M=16, tx=17, ty=17, two_d=True, X=264, Y=264, cross=cross)
        assert (g['tile_x'], g['tile_y'], g['hp'], g['npp']) == (16, 88, 105, 92)
        assert (g['two_d'], g['h_bufs']) == (True, 2)
        assert g['smem_bytes'] == 4 * (2 * 16 * 92 + 2 * hr * 105 + hw * g['xtp'] + sums + 34)
        assert g['blocks_per_sm'] == 4 and 4 * (g['smem_bytes'] + 1024) <= 233472
    assert -(-264 // 16) * 16 * -(-264 // 88) * 88 < 288 * 288
    # the transposed x-pass pitch with the fewest conflicts
    assert inhibit._xst_conflicts(g['xtp'], 16, 88, hw, 17, 17) == min(
        inhibit._xst_conflicts(p, 16, 88, hw, 17, 17) for p in range(16, 48))
    # 16-byte copies of the H tile (Y % 4 == 0, ry % 4 == 0): rows of
    # 4 mod 8 floats for aligned float4 reads
    g = inhibit._geometry(M=16, tx=17, ty=17, two_d=True, X=264, Y=264, h_vec=True)
    assert (g['tile_x'], g['tile_y'], g['hp']) == (16, 88, 108)
    assert g['blocks_per_sm'] == 4
    # the long 1-D shape: 8 atoms, 127 taps
    g = inhibit._geometry(M=8, tx=1, ty=127, two_d=False, X=1, Y=4159)
    assert g['tile_x'] == 1 and g['tile_y'] % 4 == 0 and g['tile_y'] <= 256
    assert g['hp'] % 2 == 1 and g['hp'] >= g['tile_y'] + 126
    assert g['smem_bytes'] <= inhibit._SMEM_BUDGET
    # wide 2-D taps (range 82): one H buffer, the next atom's tile copied
    # after this one's epilogue
    g = inhibit._geometry(M=16, tx=165, ty=165, two_d=True, X=300, Y=300, cross=True)
    assert (g['two_d'], g['h_bufs']) == (True, 1) and g['smem_bytes'] <= _build.MAX_SMEM_BYTES
    # few x taps and very many y taps: no 8-row tile fits, so the stencil runs
    # on tiles of one row, each output the y pass of its tx staged rows
    g = inhibit._geometry(M=16, tx=3, ty=4001, two_d=True, X=40, Y=5000)
    assert (g['two_d'], g['tile_x']) == (False, 1) and g['smem_bytes'] <= _build.MAX_SMEM_BYTES
    # a stencil no tile holds in one piece streams its x taps through 2-D
    # tiles in segments, one H buffer
    g = inhibit._geometry(M=4, tx=401, ty=401, two_d=True, X=500, Y=500)
    assert (g['two_d'], g['h_bufs'], g['seg_y']) == (True, 1, 401)
    assert g['n_segments'] == -(-401 // g['seg_x']) > 1
    assert g['smem_bytes'] <= _build.MAX_SMEM_BYTES


@pytest.mark.parametrize('ranges', [(0, 1), (4, 3), (6, 2), (8, 8), (9, 3)])
@pytest.mark.parametrize('use_cross', [False, True])
def test_inhibited_mu_h_compiled_taps(ranges, use_cross):
    """A 2-D stencil of at most 17 taps a side runs with the next compiled
    tap count (9 or 17), both axes' taps centred in zeros; a wider one takes
    the runtime loop.  The padded taps give the same field (the plain
    version on both, float64)."""
    ks = [torch.tensor(k) for k in inh.inhibition_kernels(ranges)]
    n = max(k.numel() for k in ks)
    c = inhibit._compiled_taps(*(k.numel() for k in ks))
    assert c == (9 if n <= 9 else 17 if n <= 17 else 0)
    if not c:
        return
    padded = [inhibit._pad_taps(k, c) for k in ks]
    assert [k.numel() for k in padded] == [c, c]
    rng = np.random.default_rng(3)
    H, neg, pos = (_t(rng.random((2, 3, 21, 18))) for _ in range(3))
    args = (0.3, 0.2, 0.1)
    want = inhibit.inhibited_mu_h_plain(H, neg, pos, ks, *args, use_cross=use_cross)
    got = inhibit.inhibited_mu_h_plain(H, neg, pos, padded, *args, use_cross=use_cross)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=0)


def _first_design_fits(M, tx, ty, two_d):
    """Whether the first CUDA design of K4 (every atom's field in shared
    memory, tiles of 32 columns or 1-D rows of 32 to 256) had a tile that
    fits."""
    tiles = [(t, 32) for t in (32, 16, 8, 4, 2, 1)] if two_d else [(1, t) for t in (256, 128, 64, 32)]
    return any(4 * (M * a * b + (a + tx - 1) * (b + ty - 1) + (a + tx - 1) * b * two_d + tx + ty)
               <= _build.MAX_SMEM_BYTES for a, b in tiles)


@pytest.mark.parametrize('M,tx,X,Y', [(16, 1, 1, 60000), (2, 1, 1, 300), (16, 165, 300, 300),
                                      (16, 3, 40, 30000), (1, 1, 40, 30000), (2, 211, 250, 400),
                                      (200, 9, 300, 300), (16, 17, 264, 264)])
@pytest.mark.parametrize('cross', [False, True])
def test_inhibited_mu_h_geometry_takes_first_design_shapes(M, tx, X, Y, cross):
    """Every shape the first design could hold still runs: at the most y
    taps it took (and at tx x tx), a 2-D tile with two H buffers, with one,
    or tiles of one row fit."""
    two_d = X > 1
    ty = max(t for t in range(1, 60001, 2) if _first_design_fits(M, tx, t, two_d))
    for t in {ty, tx}:
        if not _first_design_fits(M, tx, t, two_d):
            continue
        for h_vec in (False, True):
            g = inhibit._geometry(M=M, tx=tx, ty=t, two_d=two_d, X=X, Y=Y, h_vec=h_vec,
                                  cross=cross and M > 1)
            assert g['smem_bytes'] <= _build.MAX_SMEM_BYTES and g['h_bufs'] in (1, 2)
            assert g['two_d'] or g['tile_x'] == 1


@pytest.mark.parametrize('M', [1, 3, 16, 200, 4000])
def test_inhibited_mu_h_geometry_independent_of_atoms(M):
    """The atoms stream through one tile, so the tile and its shared memory
    are those of any other atom count (a field buffer per atom would grow
    with M)."""
    want = inhibit._geometry(M=16, tx=17, ty=17, two_d=True, X=264, Y=264)
    assert inhibit._geometry(M=M, tx=17, ty=17, two_d=True, X=264, Y=264) == want


@pytest.mark.parametrize('dims,taps', [((37, 29), (13, 5)), ((300, 40), (9, 7)),
                                       ((76, 102), (9, 9)), ((1, 40), (1, 11)),
                                       ((1, 4159), (1, 127))])
def test_inhibited_mu_h_geometry_tiles(dims, taps):
    """Tiles the kernel can walk: 2-D tiles of whole x-pass segments (8 rows)
    and y-pass segments (8 columns), 1-D tiles of whole quads; one y-pass
    item per thread; pitches for float4 neg/pos rows and an odd H row;
    four blocks per SM."""
    (X, Y), (tx, ty) = dims, taps
    two_d = X > 1
    g = inhibit._geometry(M=5, tx=tx, ty=ty, two_d=two_d, X=X, Y=Y)
    seg_y = 8 if two_d else 1
    assert g['tile_x'] % (8 if two_d else 1) == 0 and g['tile_y'] % (8 if two_d else 4) == 0
    assert g['tile_x'] * g['tile_y'] // seg_y <= inhibit._THREADS
    assert g['hp'] % 2 == 1 and g['hp'] >= g['tile_y'] + ty - 1
    assert g['npp'] % 8 == 4 if two_d else g['npp'] == g['tile_y']
    assert g['blocks_per_sm'] >= 4
