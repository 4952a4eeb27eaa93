"""K4's summed route (the cross-atom term under a mesh over the atoms), its
plain version on the CPU: the atoms' sum given from outside as an ``(N, 1,
*T)`` plane with the global map count.  Given the whole block's own sum it
is today's plain version; two halves of the atoms, each given the sum of
both halves, put together the whole update within 1e-12, and the JAX
package's plain inhibition term agrees.  The operators: the new
``tnmf::inhibited_mu_h_summed`` beside ``tnmf::inhibited_mu_h``, whose
schema (which serving artifacts name) does not change."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnmf_tpu.ops import inhibition as jax_inhibition
from tnmf_tpu_torch.kernels import inhibit, ops
from tnmf_tpu_torch.ops.inhibition import inhibition_kernels

#: (H shape, inhibition range): 1-D and 2-D, ragged
CASES = [((2, 6, 11, 9), (2, 3)), ((3, 4, 40), (5,)), ((1, 8, 17, 17), (8, 8))]
ARGS = (0.3, 0.2, 1e-9 + 0.1)


def _problem(shape, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.random(shape)) for _ in range(3))


@pytest.mark.parametrize('use_same', [False, True])
@pytest.mark.parametrize('shape,ranges', CASES)
def test_the_blocks_own_sum_is_todays_plain_version(shape, ranges, use_same):
    H, neg, pos = _problem(shape)
    ks = inhibition_kernels(ranges)
    want = inhibit.inhibited_mu_h_plain(H, neg, pos, ks, *ARGS, use_same=use_same,
                                        use_cross=True)
    got = inhibit.inhibited_mu_h_summed_plain(H, neg, pos, ks, *ARGS, H.sum(1, keepdim=True),
                                              H.shape[1], use_same=use_same)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-15)
    # the wrapper takes the plain version on CPU tensors
    wrapped = inhibit.inhibited_mu_h_summed(H, neg, pos, ks, *ARGS, H.sum(1, keepdim=True),
                                            H.shape[1], use_same=use_same)
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize('use_same', [False, True])
@pytest.mark.parametrize('shape,ranges', CASES)
def test_two_halves_of_the_atoms_give_the_whole_update(shape, ranges, use_same):
    H, neg, pos = _problem(shape, seed=1)
    ks = inhibition_kernels(ranges)
    M = H.shape[1]
    halves = [slice(0, M // 2), slice(M // 2, M)]
    h_sum = sum(H[:, h].sum(1, keepdim=True) for h in halves)  # the all-reduce of two ranks
    parts = [ops.inhibited_mu_h_summed(H[:, h], neg[:, h], pos[:, h], ks, *ARGS, h_sum, M,
                                       use_same=use_same) for h in halves]
    whole = inhibit.inhibited_mu_h_plain(H, neg, pos, ks, *ARGS, use_same=use_same,
                                         use_cross=True)
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(), whole.numpy(), rtol=1e-12,
                               atol=1e-15)


@pytest.mark.parametrize('shape,ranges', CASES[:2])
def test_the_halves_match_the_jax_inhibition_term(shape, ranges):
    """The JAX package's plain term (``inhibition_positive_term``) on the
    whole block, in float64, against the halves' updates."""
    H, neg, pos = _problem(shape, seed=2)
    ks = inhibition_kernels(ranges)
    M = H.shape[1]
    inh, cross, reg = ARGS
    term = jax_inhibition.inhibition_positive_term(
        jnp.asarray(H.numpy()), tuple(jnp.asarray(k) for k in ks), H.dim() - 2, inh, cross, M,
        True, True)
    want = H.numpy() * neg.numpy() / (pos.numpy() + np.asarray(term) + reg)
    h_sum = H.sum(1, keepdim=True)
    parts = [inhibit.inhibited_mu_h_summed_plain(H[:, h], neg[:, h], pos[:, h], ks, *ARGS,
                                                 h_sum, M)
             for h in (slice(0, M // 2), slice(M // 2, M))]
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(), want, rtol=1e-12, atol=1e-15)


def test_the_operators_schemas():
    assert str(torch.ops.tnmf.inhibited_mu_h.default._schema) == (
        'tnmf::inhibited_mu_h(Tensor H, Tensor neg, Tensor pos, Tensor[] kernels, '
        'float inhibition, float cross_inhibition, float reg, bool use_same, '
        'bool use_cross) -> Tensor')
    assert str(torch.ops.tnmf.inhibited_mu_h_summed.default._schema) == (
        'tnmf::inhibited_mu_h_summed(Tensor H, Tensor neg, Tensor pos, Tensor[] kernels, '
        'float inhibition, float cross_inhibition, float reg, Tensor h_sum, int n_total, '
        'bool use_same) -> Tensor')


def test_the_summed_route_counts_its_own_launches():
    assert inhibit.inhibited_mu_h_summed.launches == 0  # no card here: never launched
    assert hasattr(inhibit.inhibited_mu_h, 'model_launches')
    assert not hasattr(inhibit.inhibited_mu_h_summed, 'model_launches')


def test_one_map_in_all_is_refused():
    H, neg, pos = _problem((1, 1, 9))
    with pytest.raises(ValueError, match='at least 2 atoms'):
        inhibit.inhibited_mu_h_summed_plain(H, neg, pos, inhibition_kernels((2,)), *ARGS,
                                            H.sum(1, keepdim=True), 1)
