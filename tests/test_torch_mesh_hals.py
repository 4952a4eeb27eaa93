"""The port's data parallelism over the samples, HALS fits
(``fit(solver='hals')``): a world of two processes (gloo on the CPU,
``tests/torch_mesh.py``) against the JAX package's mesh-free fit of the
whole batch in float64, within rtol 1e-9: plain NMF, whose Grams ``H^T H``
and ``H^T V`` are summed over the ranks and whose ``hals_inner='auto'``
count is the whole batch's (2 for its 2000 samples where a rank's 1000
would give 1), the shift-invariant solver in ``'full'`` mode (its W step's
statistics summed), and a ``tol`` fit stopping where JAX stops.  The JAX
package pins its own sharded HALS to the single-device fit
(``tests/test_hals.py``)."""

import numpy as np
import pytest

import tnmf_tpu
from tnmf_tpu_torch.engine_hals import auto_inner

from .torch_mesh import HALS_CASES, WORLD, World, data

TOL = dict(rtol=1e-9, atol=1e-12)


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    return World('hals', tmp_path_factory.mktemp('mesh_hals'))


def test_auto_inner_differs_between_the_batch_and_a_rank():
    """The plain case is sized so that the rank's count would give another
    inner count than the whole batch's."""
    shape, model_kw, _ = HALS_CASES['plain']
    F = int(np.prod(shape[1:]))
    n_atoms = model_kw['n_atoms']
    assert auto_inner(n_atoms, F, 'auto', n_samples=shape[0]) == 2
    assert auto_inner(n_atoms, F, 'auto', n_samples=shape[0] // WORLD) == 1


@pytest.mark.parametrize('name', sorted(HALS_CASES))
def test_hals_fit_on_two_ranks_matches_jax(world, name):
    shape, model_kw, fit_kw = HALS_CASES[name]
    jm = tnmf_tpu.TransformInvariantNMF(seed=0, dtype='float64', **model_kw)
    jm.fit(data(shape, seed=3), **fit_kw)
    got = world.result()
    assert got[f'{name}/W_ranks_equal']
    assert int(got[f'{name}/n_iter']) == jm.n_iterations_
    np.testing.assert_allclose(got[f'{name}/W'], jm.W, **TOL)
    np.testing.assert_allclose(got[f'{name}/H'], jm.H, **TOL)
    np.testing.assert_allclose(got[f'{name}/energy'], jm._energy_function(), rtol=1e-9)
    if jm.energies_ is not None:
        np.testing.assert_allclose(got[f'{name}/energies'], np.asarray(jm.energies_),
                                   rtol=1e-9)
