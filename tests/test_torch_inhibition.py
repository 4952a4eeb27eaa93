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
    # the inhibited flagship: M = 16, 17 x 17 taps -> 32 x 32 tiles, two
    # blocks per SM
    g = inhibit._geometry(M=16, tx=17, ty=17, two_d=True)
    assert (g['tile_x'], g['tile_y']) == (32, 32)
    assert g['smem_bytes'] == 4 * (16 * 32 * 32 + 48 * 48 + 48 * 32 + 34)
    assert g['smem_bytes'] <= _build.MAX_SMEM_BYTES // 2
    # the long 1-D shape: 8 atoms, 127 taps
    g = inhibit._geometry(M=8, tx=1, ty=127, two_d=False)
    assert (g['tile_x'], g['tile_y']) == (1, 256)
    assert g['smem_bytes'] == 4 * (8 * 256 + 382 + 1 + 127)
    # many atoms split the tile along x
    g = inhibit._geometry(M=200, tx=17, ty=17, two_d=True)
    assert g['tile_x'] < 32 and g['smem_bytes'] <= _build.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match='shared memory'):
        inhibit._geometry(M=4000, tx=17, ty=17, two_d=True)
