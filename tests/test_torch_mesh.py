"""The port's data parallelism over the samples, MU fits: a world of two
processes (gloo on the CPU, ``tests/torch_mesh.py``) fits each case with
``TransformInvariantNMF(mesh=make_mesh(devices='cpu'))`` in float64, and
the JAX package's mesh-free fit of the whole batch is the reference: W
(every rank's replica the same bits), the ranks' rows of H put together,
the energy, the energy traces and the stop iteration within rtol 1e-9.
The cases: conv and fft, a mask, beta = 1 on conv and fft, lateral
inhibition with the cross-atom term, the flip group, ``ortho_W`` with
``l2_H``, ``h_init='correlate'``, ``record_energies``, ``tol``, the
extrapolated loop and ``transform`` (each rank's rows).  The JAX
package's own tests pin its sharded fits to its single-device fits
(``tests/test_sharding.py``)."""

import numpy as np
import pytest

import tnmf_tpu

from .torch_mesh import MU_CASES, TRANSFORM, World, data, dictionary, fit_kwargs

TOL = dict(rtol=1e-9, atol=1e-12)


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """The two workers, started once for the module; their results are
    read by the first test that needs them."""
    return World('mu', tmp_path_factory.mktemp('mesh_mu'))


def _jax(model_kw: dict, fit_kw: dict):
    m = tnmf_tpu.TransformInvariantNMF(4, (3, 3), seed=0, dtype='float64', **model_kw)
    m.fit(data(), **fit_kwargs(fit_kw))
    return m


@pytest.mark.parametrize('name', sorted(MU_CASES))
def test_mu_fit_on_two_ranks_matches_jax(world, name):
    jm = _jax(*MU_CASES[name])
    got = world.result()
    assert got[f'{name}/W_ranks_equal']
    assert int(got[f'{name}/n_iter']) == jm.n_iterations_
    np.testing.assert_allclose(got[f'{name}/W'], jm.W, **TOL)
    np.testing.assert_allclose(got[f'{name}/H'], jm.H, **TOL)
    np.testing.assert_allclose(got[f'{name}/energy'], jm._energy_function(), rtol=1e-9)
    if jm.energies_ is not None:
        np.testing.assert_allclose(got[f'{name}/energies'], np.asarray(jm.energies_),
                                   rtol=1e-9)


def test_transform_on_two_ranks_matches_jax(world):
    """Each rank encodes its rows against the frozen dictionary and
    ``transform`` returns them; put together they are the JAX encoding."""
    jm = tnmf_tpu.TransformInvariantNMF(4, (3, 3), seed=0, dtype='float64')
    jm.set_dictionary(dictionary())
    H = np.asarray(jm.transform(data(), **TRANSFORM))
    got = world.result()
    np.testing.assert_allclose(got['transform/H'], H, **TOL)
    np.testing.assert_allclose(got['transform/energy'], jm._energy_function(), rtol=1e-9)
