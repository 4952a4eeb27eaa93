"""The port's 2-D mesh of samples by atoms (``shard_axis='samples+atoms'``).

A world of four processes (gloo on the CPU, ``tests/torch_mesh.py``) on
``make_mesh_2d_atoms(2, 2)``: rank ``r`` holds data row ``r // 2``'s four
samples of eight and atom column ``r % 2``'s four atoms of eight (3 x 3).
Each case is held against the JAX package's mesh-free fit of the same
seeded inputs in float64 within rtol 1e-9, W and H put together from the
ranks' shares (and the two ranks of an atom column holding the same bits
of W): conv, fft, cross-atom inhibition, the D4 group with the cross-atom
term (the JAX package's ``tests/test_transforms.py`` checks its 2-D atom
mesh on D4) and ``transform``.  ``init='device'`` is held to the port's
own world of one (torch's generators are not ``jax.random``), and ``R``
raises where the ranks hold only their rows."""

import numpy as np
import pytest
import torch.distributed as dist

import tnmf_tpu
from tnmf_tpu_torch import TransformInvariantNMF, parallel
from tnmf_tpu_torch.parallel import distributed

from .torch_mesh import (ATOM_2D_CASES, ATOM_MODEL, DEVICE_INIT, TOL, TRANSFORM, World,
                         assert_fit, atom_case, data, dictionary)


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """The four workers, started once for the module."""
    return World('atoms_2d', tmp_path_factory.mktemp('mesh_2d'), mesh='2x2')


@pytest.mark.parametrize('name', ATOM_2D_CASES)
def test_samples_atoms_fit_on_four_ranks_matches_jax(world, name):
    V, model_kw, fit_kw = atom_case(name)
    jm = tnmf_tpu.TransformInvariantNMF(seed=0, dtype='float64', **model_kw)
    jm.fit(V, **fit_kw)
    assert_fit(world.result(), name, jm)


def test_transform_on_four_ranks_matches_jax(world):
    """Each rank encodes its data row's samples against its atom column's
    atoms of the frozen dictionary."""
    jm = tnmf_tpu.TransformInvariantNMF(seed=0, dtype='float64', **ATOM_MODEL)
    jm.set_dictionary(dictionary(ATOM_MODEL['n_atoms']))
    H = np.asarray(jm.transform(data(), **TRANSFORM))
    got = world.result()
    assert got['transform/W_ranks_equal']
    np.testing.assert_allclose(got['transform/H'], H, **TOL)
    np.testing.assert_allclose(got['transform/energy'], jm._energy_function(), rtol=1e-9)


def test_device_init_on_four_ranks_equals_a_world_of_one(world, monkeypatch):
    """Every rank draws its rows of H whole, one at a time, and keeps its
    atoms' maps; put together they are the world of one's draw, and the fit
    (with the cross-atom term) is the world of one's."""
    for name in ('WORLD_SIZE', 'RANK', 'MASTER_ADDR', 'MASTER_PORT', 'LOCAL_RANK'):
        monkeypatch.delenv(name, raising=False)
    distributed.initialize(num_processes=1)
    try:
        model_kw, fit_kw = DEVICE_INIT
        m = TransformInvariantNMF(seed=0, device='cpu', dtype='float64',
                                  mesh=parallel.make_mesh_2d_atoms(1, 1, devices='cpu'),
                                  shard_axis='samples+atoms', **ATOM_MODEL, **model_kw)
        m.fit(data(), **fit_kw)
        got = world.result()
        assert got['device_init/W_ranks_equal']
        np.testing.assert_allclose(got['device_init/W'], m.W, rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(got['device_init/H'], m.H, rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(got['device_init/energy'], m._energy_function(),
                                   rtol=1e-10)
    finally:
        dist.destroy_process_group()


def test_r_raises_where_the_ranks_hold_their_rows(world):
    message = str(world.result()['error:R'])
    assert message.startswith('RuntimeError: R is not host-addressable'), message
