"""The port's model parallelism over the atoms (``shard_axis='atoms'``).

A world of two processes (gloo on the CPU, ``tests/torch_mesh.py``) fits
each case on ``make_mesh_atoms(devices='cpu')`` in float64, 8 atoms of
3 x 3, 4 a rank, and the JAX package's mesh-free fit of the same seeded
inputs is the reference: W (the ranks' atoms put together), H (the ranks'
maps put together), the energy, the energy traces and the stop iteration
within rtol 1e-9.  The cases: conv, fft, dot (atoms as large as the
samples), a mask, beta = 1, same-atom and cross-atom inhibition, the D4
group with cross-atom inhibition, ``ortho_W`` with ``l2_H``,
``h_init='correlate'``, ``record_energies``, ``tol``, the extrapolated
loop and ``transform``; ``R``, whole on every rank, and what a world of
two refuses.  The JAX package's own tests pin its atom-sharded fits to its
single-device fits (``tests/test_sharding.py``, ``tests/test_transforms.py``).

In this process, a world of one (a ``HashStore``): the meshes, the
placements and the shares, every error message (the JAX package's text
where it has one), the cross-atom term on the summed route, and
``atom_group=None`` issuing no collective.  Then the example
``model_parallel_fit`` on the CPU against the JAX package's single-device
fit of the same arguments (float32, rtol 1e-3)."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import tnmf_tpu
import tnmf_tpu.parallel as jax_parallel
from tnmf_tpu_torch import TransformInvariantNMF, engine, parallel
from tnmf_tpu_torch.parallel import distributed, sharding

from .torch_mesh import (ATOM_CASES, ATOM_MODEL, TOL, TRANSFORM, World, assert_fit, atom_case,
                         data, dictionary)

CPU = dict(device='cpu', dtype='float64')


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """The two workers, started once for the module."""
    return World('atoms', tmp_path_factory.mktemp('mesh_atoms'), mesh='atoms')


@pytest.fixture
def world_of_one(monkeypatch):
    """A process group of this process alone."""
    for name in ('WORLD_SIZE', 'RANK', 'MASTER_ADDR', 'MASTER_PORT', 'LOCAL_RANK'):
        monkeypatch.delenv(name, raising=False)
    distributed.initialize(num_processes=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _jax(name: str):
    V, model_kw, fit_kw = atom_case(name)
    m = tnmf_tpu.TransformInvariantNMF(seed=0, dtype='float64', **model_kw)
    m.fit(V, **fit_kw)
    return m


# ------------------------------------------------------------- two ranks

@pytest.mark.parametrize('name', sorted(ATOM_CASES))
def test_atom_sharded_fit_on_two_ranks_matches_jax(world, name):
    assert_fit(world.result(), name, _jax(name))


def test_transform_on_two_ranks_matches_jax(world):
    """Each rank encodes the batch against its atoms of the frozen
    dictionary; the ranks' maps put together are the JAX encoding."""
    jm = tnmf_tpu.TransformInvariantNMF(seed=0, dtype='float64', **ATOM_MODEL)
    jm.set_dictionary(dictionary(ATOM_MODEL['n_atoms']))
    H = np.asarray(jm.transform(data(), **TRANSFORM))
    got = world.result()
    np.testing.assert_allclose(got['transform/H'], H, **TOL)
    np.testing.assert_allclose(got['transform/W'], jm.W, **TOL)
    np.testing.assert_allclose(got['transform/energy'], jm._energy_function(), rtol=1e-9)


def test_r_is_whole_on_every_rank(world):
    np.testing.assert_allclose(world.result()['R_atoms'], _jax('extrapolate').R, **TOL)


@pytest.mark.parametrize('call,expected', [
    ('W', 'RuntimeError: W is not host-addressable under a process-spanning mesh over the '
          "atoms; access the per-process shards (this rank's atoms: model._local_W()"),
    ('H', 'RuntimeError: H is not host-addressable'),
    ('R_partial', 'RuntimeError: R_partial is not host-addressable'),
    ('export_serving', 'RuntimeError: export_serving is not host-addressable under a '
                       'process-spanning mesh over the atoms'),
    ('inverse_transform_H', 'RuntimeError: inverse_transform(H) is not host-addressable'),
    ('fit_minibatches', 'NotImplementedError: fit_minibatches under a mesh of 2 processes'),
    ('fit_stream', 'NotImplementedError: fit_stream under a mesh of 2 processes'),
    ('partial_fit', 'NotImplementedError: partial_fit under a mesh of 2 processes'),
    ('transform_batch_size', 'NotImplementedError: transform(batch_size=...) under a mesh'),
    ('save', 'NotImplementedError: save under a mesh of 2 processes'),
    ('checkpoint_every', 'NotImplementedError: checkpoint_every under a mesh'),
    ('hals', "ValueError: solver='hals' supports shard_axis='samples' meshes"),
    ('R', 'no error'),
])
def test_what_a_world_of_two_refuses_on_the_atom_axis(world, call, expected):
    message = str(world.result()[f'error:{call}'])
    assert message.startswith(expected), message
    item = {'fit_minibatches': '14e-iv', 'fit_stream': '14e-iv', 'partial_fit': '14e-iv',
            'transform_batch_size': '14e-iv', 'save': '14e-v',
            'checkpoint_every': '14e-v'}.get(call)
    if item is not None:
        assert message.endswith(f'item {item}'), message


# ------------------------------------------------------------- one rank

def test_make_mesh_atoms_is_one_axis_over_the_default_group(world_of_one):
    mesh = parallel.make_mesh_atoms(devices='cpu')
    assert mesh.ndim == 1 and mesh.size() == 1 and mesh.get_local_rank() == 0
    assert mesh.mesh_dim_names == (parallel.ATOM_AXIS,) == ('atoms',)
    assert mesh.device_type == 'cpu' and mesh.get_group() is dist.group.WORLD
    assert parallel.make_mesh_atoms().device_type == 'cuda'  # the card's by default
    with pytest.raises(ValueError, match='spans every process'):
        parallel.make_mesh_atoms(n_devices=2, devices='cpu')


def test_make_mesh_2d_atoms_is_data_by_atoms(world_of_one):
    mesh = parallel.make_mesh_2d_atoms(1, 1, devices='cpu')
    assert mesh.mesh_dim_names == ('data', 'atoms') and tuple(mesh.shape) == (1, 1)
    with pytest.raises(ValueError, match=r'^mesh 2x2 needs 4 processes, have 1$'):
        parallel.make_mesh_2d_atoms(2, 2, devices='cpu')


@pytest.mark.parametrize('make', [parallel.make_mesh_atoms,
                                  lambda: parallel.make_mesh_2d_atoms(1, 1)])
def test_the_atom_meshes_need_a_process_group(make):
    with pytest.raises(RuntimeError, match='needs a process group'):
        make()


def test_placements_of_the_atom_axes():
    def names(placements):
        return [f'{type(p).__name__}({getattr(p, "dim", "")})' for p in placements]
    assert names(parallel.h_sharding(None, 4, 'atoms')) == ['Shard(1)']
    assert names(parallel.w_sharding(None, 4, 'atoms')) == ['Shard(0)']
    assert names(parallel.h_sharding(None, 4, 'samples+atoms')) == ['Shard(0)', 'Shard(1)']
    assert names(parallel.w_sharding(None, 4, 'samples+atoms')) == ['Replicate()', 'Shard(0)']


class _Mesh:
    """What ``local_atoms``, ``data_rows`` and ``shard_model_state`` ask of
    a mesh: its axis names and extents, and this rank's place."""

    def __init__(self, names, shape, ranks):
        self.mesh_dim_names, self.shape, self._ranks = names, shape, ranks
        self.ndim = len(shape)

    def get_local_rank(self, name=None):
        return self._ranks[self.mesh_dim_names.index(name or self.mesh_dim_names[0])]


def test_shard_model_state_keeps_the_ranks_atoms_and_maps():
    V, W = np.arange(4 * 5).reshape(4, 1, 5), np.arange(6 * 3).reshape(6, 1, 3)
    H = np.arange(4 * 12 * 3).reshape(4, 12, 3)  # two maps an atom (m-major)
    v, w, h = parallel.shard_model_state(_Mesh(('atoms',), (3,), (1,)), V, W, H, 'atoms')
    assert v is V or np.array_equal(v, V)
    np.testing.assert_array_equal(w, W[2:4])
    np.testing.assert_array_equal(h, H[:, 4:8])
    mesh = _Mesh(('data', 'atoms'), (2, 3), (1, 2))
    v, w, h = parallel.shard_model_state(mesh, V, W, H, 'samples+atoms')
    np.testing.assert_array_equal(v, V[2:])
    np.testing.assert_array_equal(w, W[4:])
    np.testing.assert_array_equal(h, H[2:, 8:])


def _jax_error(axis, mesh, V, W, H):
    with pytest.raises(ValueError) as jax:
        jax_parallel.shard_model_state(mesh, V, W, H, axis=axis)
    return str(jax.value)


def test_divisibility_messages_of_the_jax_package():
    V, H = np.ones((6, 1, 4)), np.ones((6, 5, 2))
    W = np.ones((5, 1, 3))
    with pytest.raises(ValueError) as port:
        sharding.local_atoms(_Mesh(('atoms',), (3,), (0,)), 5)
    assert str(port.value) == _jax_error('atoms', jax_parallel.make_mesh_atoms(3), V, W, H)
    assert 'pad the dictionary or resize the mesh' in str(port.value)
    with pytest.raises(ValueError) as port:
        sharding.data_rows(_Mesh(('data', 'atoms'), (4, 1), (0, 0)), 6)
    assert str(port.value) == _jax_error('samples+atoms', jax_parallel.make_mesh_2d_atoms(4, 1),
                                         V, W, H)


def test_samples_atoms_needs_the_2d_mesh_with_the_jax_text(world_of_one):
    text = _jax_error('samples+atoms', jax_parallel.make_mesh(1), np.ones((2, 1, 4)),
                      np.ones((2, 1, 3)), np.ones((2, 2, 2)))
    with pytest.raises(ValueError) as port:
        TransformInvariantNMF(2, (3, 3), mesh=parallel.make_mesh_atoms(devices='cpu'),
                              shard_axis='samples+atoms', **CPU)
    assert str(port.value) == text


def test_the_mesh_must_carry_the_shard_axis(world_of_one):
    from torch.distributed.device_mesh import init_device_mesh
    other = init_device_mesh('cpu', (1, 1), mesh_dim_names=('data', 'space'))
    with pytest.raises(ValueError, match="needs a 2-D mesh from make_mesh_2d_atoms"):
        TransformInvariantNMF(2, (3, 3), mesh=other, shard_axis='samples+atoms', **CPU)
    with pytest.raises(ValueError, match="axis='atoms' needs a 1-D mesh from make_mesh_atoms"):
        TransformInvariantNMF(2, (3, 3), mesh=parallel.make_mesh(devices='cpu'),
                              shard_axis='atoms', **CPU)
    with pytest.raises(ValueError, match="axis='samples' needs a 1-D mesh from make_mesh"):
        TransformInvariantNMF(2, (3, 3), mesh=parallel.make_mesh_atoms(devices='cpu'), **CPU)
    with pytest.raises(ValueError, match="axis='samples' needs a 1-D mesh from make_mesh"):
        TransformInvariantNMF(2, (3, 3), mesh=parallel.make_mesh_2d_atoms(1, 1, devices='cpu'),
                              **CPU)


def test_hals_under_an_atom_axis_raises_the_jax_value_error(world_of_one):
    V = data((8, 1, 36))
    kw = dict(n_atoms=2, atom_shape=(36,), reconstruction_mode='full')
    jm = tnmf_tpu.TransformInvariantNMF(**kw, mesh=jax_parallel.make_mesh_atoms(1),
                                        shard_axis='atoms', dtype='float64')
    with pytest.raises(ValueError) as jax:
        jm.fit(V, n_iterations=1, solver='hals')
    for axis, mesh in (('atoms', parallel.make_mesh_atoms(devices='cpu')),
                       ('samples+atoms', parallel.make_mesh_2d_atoms(1, 1, devices='cpu'))):
        pm = TransformInvariantNMF(**kw, mesh=mesh, shard_axis=axis, **CPU)
        with pytest.raises(ValueError) as port:
            pm.fit(V, n_iterations=1, solver='hals')
        assert str(port.value) == str(jax.value)


def test_a_batch_that_spans_processes_waits_for_14e_iv(world_of_one):
    mesh = parallel.make_mesh_atoms(devices='cpu')
    m = TransformInvariantNMF(2, (3, 3), mesh=mesh, shard_axis='atoms', init='device', **CPU)
    V = distributed.SampleShards(torch.as_tensor(data()), mesh)
    with pytest.raises(NotImplementedError, match=r'ROADMAP.md queue 1, item 14e-iv$'):
        m.fit(V, n_iterations=1)


def test_cross_atom_inhibition_takes_the_summed_route(world_of_one, monkeypatch):
    """On an atom axis the cross-atom term runs K4's summed route (here its
    plain version) and same-atom inhibition alone K4's own; a world of one
    then equals the mesh-free fit."""
    calls = dict(summed=0, own=0)

    def counting(key, fn):
        def call(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return call
    monkeypatch.setattr(engine, 'inhibited_mu_h_summed_plain',
                        counting('summed', engine.inhibited_mu_h_summed_plain))
    monkeypatch.setattr(engine, 'inhibited_mu_h_plain',
                        counting('own', engine.inhibited_mu_h_plain))
    mesh = parallel.make_mesh_atoms(devices='cpu')
    V, model_kw, fit_kw = atom_case('inhibition')
    fits = []
    for kw in (dict(mesh=mesh, shard_axis='atoms'), {}):
        m = TransformInvariantNMF(seed=0, **model_kw, **kw, **CPU)
        m.fit(V, **fit_kw)
        fits.append(m)
    assert calls == dict(summed=fit_kw['n_iterations'], own=fit_kw['n_iterations'])
    np.testing.assert_allclose(fits[0].W, fits[1].W, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(fits[0].H, fits[1].H, rtol=1e-12, atol=1e-15)
    m = TransformInvariantNMF(seed=0, **model_kw, mesh=mesh, shard_axis='atoms', **CPU)
    m.fit(V, n_iterations=2, inhibition_strength=0.1)
    assert calls['summed'] == fit_kw['n_iterations']


def test_no_atom_group_issues_no_collective(monkeypatch):
    """Without a mesh the engine issues no collective and copies no
    tensor: with every collective patched to raise, the mesh-free fits of
    the atom cases that sum over the atoms (the cross-atom term, the D4
    group, ``ortho_W``, the matched filter) still match the JAX package."""
    def refuse(*args, **kwargs):
        raise AssertionError('a collective was issued')
    for name in ('all_reduce', 'all_gather', 'all_gather_object', 'broadcast'):
        monkeypatch.setattr(dist, name, refuse)
    x = torch.ones(3)
    assert engine.atom_sum(x) is x
    for name in ('inhibition', 'd4', 'ortho_W', 'correlate'):
        V, model_kw, fit_kw = atom_case(name)
        pm = TransformInvariantNMF(seed=0, **model_kw, **CPU)
        pm.fit(V, **fit_kw)
        jm = _jax(name)
        np.testing.assert_allclose(pm.W, jm.W, **TOL)
        np.testing.assert_allclose(pm.H, jm.H, **TOL)


# ------------------------------------------------------------- the example

def test_model_parallel_fit_matches_the_jax_single_device_fit():
    """The port's example (two workers on the CPU, float32, its smoke
    size) against what the JAX example fits as its reference: the
    single-device fit of the same arguments at 8 atoms.  The mesh fit's
    and the example's own mesh-free fit's energies and the gathered W
    within rtol 1e-3."""
    from tnmf_tpu_torch.examples import model_parallel_fit
    result = model_parallel_fit.run(smoke=True, device='cpu')
    V = np.random.default_rng(0).random((6, 1, 32, 32)).astype(np.float32)
    np.random.seed(42)
    jm = tnmf_tpu.TransformInvariantNMF(n_atoms=8, atom_shape=(5, 5))
    jm.fit(V, n_iterations=5, sparsity_H=0.1, inhibition_strength=0.1)
    energy = jm._energy_function()
    assert result['devices'] == (2, 'cpu')
    np.testing.assert_allclose(result['energy_mesh'], energy, rtol=1e-3)
    np.testing.assert_allclose(result['energy_single'], energy, rtol=1e-3)
    np.testing.assert_allclose(result['W'], jm.W, rtol=1e-3, atol=1e-6)
    lines = model_parallel_fit.lines(result)
    assert lines[0] == 'devices: 2 x cpu' and len(lines) == 6
    assert lines[1].startswith('sharded W layout: rank 0 of 2 holds atoms 0:4 of 8')
