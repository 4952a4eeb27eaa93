"""The port's process-spanning fits and meshes (``tnmf_tpu_torch.parallel``).

A world of two processes (gloo on the CPU, ``tests/torch_mesh.py``):
``init='device'`` draws each rank's rows of H alone, and the fit equals the
port's fit in a world of one; ``fit_distributed`` on each rank's block
equals the same batch given whole, bit for bit, and so does a mask
distributed like V; every rank's W is the same bits; what a world above one
refuses raises, naming its sub-item of ROADMAP.md item 14e.

In this process, a world of one (a ``HashStore``, destroyed after each
test): ``make_mesh`` and ``shard_model_state``, the divisibility message
(the JAX package's text), the mesh checks, a world of one equal to the
mesh-free fit bit for bit, every ``NotImplementedError`` and the sub-item
it names, and ``process_group=None`` issuing no collective."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import tnmf_tpu
import tnmf_tpu.parallel as jax_parallel
from tnmf_tpu_torch import TransformInvariantNMF, engine, parallel
from tnmf_tpu_torch.models.multiscale import MultiScaleTNMF
from tnmf_tpu_torch.models.sweep import sweep_fit
from tnmf_tpu_torch.parallel import distributed, sharding

from .torch_mesh import World, data, mask

CPU = dict(device='cpu', dtype='float64')


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    return World('distributed', tmp_path_factory.mktemp('mesh_distributed'))


@pytest.fixture
def world_of_one(monkeypatch):
    """A process group of this process alone, and its mesh on the CPU."""
    for name in ('WORLD_SIZE', 'RANK', 'MASTER_ADDR', 'MASTER_PORT', 'LOCAL_RANK'):
        monkeypatch.delenv(name, raising=False)
    distributed.initialize(num_processes=1)
    try:
        yield parallel.make_mesh(devices='cpu')
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- two ranks

def test_device_init_on_two_ranks_equals_a_world_of_one(world, world_of_one):
    m = TransformInvariantNMF(4, (3, 3), seed=0, init='device', mesh=world_of_one, **CPU)
    m.fit(data(), n_iterations=5, sparsity_H=0.1)
    got = world.result()
    for name in ('device_whole', 'device_blocks'):
        np.testing.assert_allclose(got[f'{name}/W'], m.W, rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(got[f'{name}/H'], m.H, rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(got[f'{name}/energy'], m._energy_function(), rtol=1e-10)


@pytest.mark.parametrize('whole,blocks', [('device_whole', 'device_blocks'),
                                          ('mask_whole', 'mask_blocks')])
def test_fit_distributed_equals_the_batch_given_whole(world, whole, blocks):
    got = world.result()
    for part in ('W', 'H', 'energy'):
        np.testing.assert_array_equal(got[f'{blocks}/{part}'], got[f'{whole}/{part}'])
    assert got[f'{whole}/W_ranks_equal'] and got[f'{blocks}/W_ranks_equal']
    assert got['replicas_equal']


@pytest.mark.parametrize('call,expected', [
    ('H', 'RuntimeError: H is not host-addressable'),
    ('V', 'RuntimeError: V is not host-addressable'),
    ('R', 'RuntimeError: R is not host-addressable'),
    ('reconstruction_err_', 'RuntimeError: reconstruction_err_ is not host-addressable'),
    ('fit_minibatches', 'NotImplementedError: fit_minibatches under a mesh of 2 processes'
                        ' is not ported to tnmf_tpu_torch yet; see ROADMAP.md queue 1, '
                        'item 14e-iv'),
    ('fit_stream', 'NotImplementedError: fit_stream under a mesh of 2 processes'),
    ('partial_fit', 'NotImplementedError: partial_fit under a mesh of 2 processes'),
    ('transform_batch_size', 'NotImplementedError: transform(batch_size=...) under a mesh'),
    ('save', 'NotImplementedError: save under a mesh of 2 processes is not ported to '
             'tnmf_tpu_torch yet; see ROADMAP.md queue 1, item 14e-v'),
    ('checkpoint_every', 'NotImplementedError: checkpoint_every under a mesh'),
    ('revive_every', 'ValueError: revive_every re-draws atoms host-side'),
    ('host_init', "ValueError: a process-spanning global array requires mesh=... and "
                  "init='device'"),
    ('unequal_blocks', 'ValueError: distribute_samples: every process must pass a block '
                       'of the same shape'),
])
def test_what_a_world_of_two_refuses(world, call, expected):
    message = str(world.result()[f'error:{call}'])
    assert message.startswith(expected), message
    item = {'fit_minibatches': '14e-iv', 'fit_stream': '14e-iv', 'partial_fit': '14e-iv',
            'transform_batch_size': '14e-iv', 'save': '14e-v',
            'checkpoint_every': '14e-v'}.get(call)
    if item is not None:
        assert message.endswith(f'item {item}'), message


# ------------------------------------------------------------- one rank

def test_make_mesh_is_one_axis_over_the_default_group(world_of_one):
    mesh = world_of_one
    assert mesh.ndim == 1 and mesh.size() == 1 and mesh.get_local_rank() == 0
    assert mesh.mesh_dim_names == (parallel.DATA_AXIS,) == ('data',)
    assert mesh.device_type == 'cpu'
    assert mesh.get_group() is dist.group.WORLD
    assert parallel.make_mesh().device_type == 'cuda'  # the card's by default
    with pytest.raises(ValueError, match='spans every process'):
        parallel.make_mesh(n_devices=2, devices='cpu')
    assert distributed.global_mesh(devices='cpu').get_group() is mesh.get_group()


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match='initialize'):
        parallel.make_mesh(devices='cpu')


def test_shard_model_state_keeps_the_ranks_rows_and_w_whole(world_of_one):
    V, W, H = np.ones((6, 1, 5)), np.ones((2, 1, 3)), np.ones((6, 2, 3))
    v, w, h = parallel.shard_model_state(world_of_one, V, W, H)
    assert v.shape == V.shape and h.shape == H.shape and w is W
    assert [type(p).__name__ for p in parallel.data_sharding(world_of_one, 3)] == ['Shard']
    assert [type(p).__name__ for p in parallel.w_sharding(world_of_one, 3)] == ['Replicate']


class _Mesh:
    """The two questions ``local_rows`` asks of a mesh."""

    def __init__(self, size, rank):
        self._size, self._rank = size, rank

    def size(self):
        return self._size

    def get_local_rank(self):
        return self._rank


def test_rows_and_the_divisibility_message_of_the_jax_package():
    assert sharding.local_rows(_Mesh(4, 2), 8) == slice(4, 6)
    with pytest.raises(ValueError) as port:
        sharding.local_rows(_Mesh(3, 0), 8)
    V = np.ones((8, 1, 4))
    with pytest.raises(ValueError) as jax:
        jax_parallel.shard_model_state(jax_parallel.make_mesh(3), V, np.ones((2, 1, 3)),
                                       np.ones((8, 2, 2)))
    assert str(port.value) == str(jax.value)


def test_a_world_of_one_is_the_mesh_free_fit(world_of_one):
    """Bit for bit: the all-reduce of one rank is the identity."""
    fits = []
    for mesh in (None, world_of_one):
        m = TransformInvariantNMF(4, (3, 3), seed=0, mesh=mesh, **CPU)
        m.fit(data(), n_iterations=4, sparsity_H=0.1, record_energies=True)
        fits.append(m)
    a, b = fits
    np.testing.assert_array_equal(b.W, a.W)
    np.testing.assert_array_equal(b.H, a.H)
    np.testing.assert_array_equal(b.energies_, a.energies_)
    # a process-spanning batch of one block is the whole batch
    c = TransformInvariantNMF(4, (3, 3), seed=0, init='device', mesh=world_of_one, **CPU)
    distributed.fit_distributed(c, data(), n_iterations=2, mask=None)
    assert c.H.shape == a.H.shape and np.isfinite(c._energy_function())


def test_mesh_checks(world_of_one):
    with pytest.raises(TypeError, match='DeviceMesh'):
        TransformInvariantNMF(2, (3, 3), mesh=object(), **CPU)
    with pytest.raises(ValueError, match="computes on 'cpu' devices and the model on 'cuda'"):
        TransformInvariantNMF(2, (3, 3), mesh=world_of_one, device='cuda')
    m = TransformInvariantNMF(2, (3, 3), mesh=world_of_one, **CPU)
    with pytest.raises(ValueError, match='full data shape'):
        m.fit(data(), n_iterations=1, mask=mask()[:1])
    with pytest.raises(ValueError, match='fit_distributed needs a model constructed with mesh'):
        distributed.fit_distributed(TransformInvariantNMF(2, (3, 3), **CPU), data())
    assert m.get_params()['mesh'] is world_of_one


@pytest.mark.parametrize('call,item', [
    (lambda: TransformInvariantNMF(2, (3, 3), shard_axis='atoms', **CPU), '14e-ii'),
    (lambda: TransformInvariantNMF(2, (3, 3), shard_axis='samples+atoms', **CPU), '14e-ii'),
    (lambda: TransformInvariantNMF(2, (3, 3), shard_axis='spatial', **CPU), '14e-iii'),
    (lambda: TransformInvariantNMF(2, (3, 3), shard_axis='both', **CPU), '14e-iii'),
    (lambda: parallel.make_mesh_atoms(), '14e-ii'),
    (lambda: parallel.make_mesh_2d_atoms(1, 1), '14e-ii'),
    (lambda: parallel.make_mesh_2d(1, 1), '14e-iii'),
    (lambda: parallel.spatial_sharding(None, 4), '14e-iii'),
    (lambda: parallel.h_sharding(None, 4, 'atoms'), '14e-ii'),
    (lambda: parallel.w_sharding(None, 4, 'samples+atoms'), '14e-ii'),
    (lambda: parallel.make_mesh_models(), '14e-iv'),
    (lambda: sweep_fit(data(), 2, (3, 3), n_models=2, mesh=object(), device='cpu'), '14e-iv'),
    (lambda: MultiScaleTNMF((2,), ((3, 3),), mesh=object(), device='cpu'), '14e-iv'),
    (lambda: TransformInvariantNMF(2, (3, 3), **CPU).save_sharded('x'), '14e-v'),
    (lambda: TransformInvariantNMF(2, (3, 3), **CPU).wait_for_checkpoints(), '14e-v'),
    (lambda: TransformInvariantNMF.load_sharded('x'), '14e-v'),
    (lambda: MultiScaleTNMF((2,), ((3, 3),), device='cpu').save_sharded('x'), '14e-v'),
])
def test_unported_parts_name_their_sub_item(call, item):
    if item == '14e-ii':
        # ported since (tests/test_torch_mesh_atoms.py): the constructor and
        # the placements take the atom axes, and the meshes ask for a
        # process group as make_mesh does
        try:
            call()
        except RuntimeError as e:
            assert 'needs a process group' in str(e)
        return
    with pytest.raises(NotImplementedError, match=rf'ROADMAP.md queue 1, item {item}$'):
        call()


def test_unknown_shard_axis_raises_the_jax_value_error():
    with pytest.raises(ValueError) as port:
        TransformInvariantNMF(2, (3, 3), shard_axis='rows', **CPU)
    with pytest.raises(ValueError) as jax:
        jax_parallel.h_sharding(jax_parallel.make_mesh(1), 4, 'rows')
    assert str(port.value) == str(jax.value)


def test_no_process_group_issues_no_collective(monkeypatch):
    """Without a mesh the engine issues no collective and copies no
    tensor: with every collective patched to raise, the mesh-free fits
    (MU on conv and fft, the matched filter, both HALS solvers) still
    match the JAX package."""
    def refuse(*args, **kwargs):
        raise AssertionError('a collective was issued')
    for name in ('all_reduce', 'all_gather', 'all_gather_object', 'broadcast'):
        monkeypatch.setattr(dist, name, refuse)
    x = torch.ones(3)
    assert engine.all_reduce_sum(x)[0] is x
    cases = [
        (dict(n_atoms=4, atom_shape=(3, 3), h_init='correlate'), data(),
         dict(n_iterations=3, sparsity_H=0.1, record_energies=True)),
        (dict(n_atoms=4, atom_shape=(3, 3), backend='jax_fft'), data(),
         dict(n_iterations=3, tol=1e-6, tol_check_every=1)),
        (dict(n_atoms=2, atom_shape=(36,), reconstruction_mode='full'), data((16, 1, 36)),
         dict(n_iterations=3, solver='hals', record_energies=True)),
        (dict(n_atoms=3, atom_shape=(3, 3), reconstruction_mode='full'), data((4, 1, 9, 9)),
         dict(n_iterations=2, solver='hals', sparsity_H=0.1)),
    ]
    for model_kw, V, fit_kw in cases:
        pm = TransformInvariantNMF(seed=0, **model_kw, **CPU)
        pm.fit(V, **fit_kw)
        jm = tnmf_tpu.TransformInvariantNMF(seed=0, dtype='float64', **model_kw)
        jm.fit(V, **fit_kw)
        np.testing.assert_allclose(pm.W, jm.W, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(pm.H, jm.H, rtol=1e-9, atol=1e-12)
