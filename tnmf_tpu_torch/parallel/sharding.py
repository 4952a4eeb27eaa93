"""Meshes over the samples and over the atoms on ``torch.distributed``
(port of :mod:`tnmf_tpu.parallel.sharding`, its ``'samples'``,
``'atoms'`` and ``'samples+atoms'`` axes).

``'samples'`` (data parallelism): every rank of a process group holds its
own contiguous rows of V and H and a replica of the dictionary W.  The H
update has no cross-sample term, so each rank runs it on its rows alone;
every sum over the samples (the W statistics, the energy, HALS's ``H^T H``
and ``H^T V``) is a partial sum per rank that one ``all_reduce`` completes.

``'atoms'`` (model parallelism): every rank holds its contiguous block of
atoms of W, H's maps of those atoms (m-major: an atom's maps under a
transform group stay on its rank) and all of V.  Both MU gradients are
atom-local; every sum over the atoms (the reconstruction, the cross-atom
inhibition field, ``ortho_W``'s atom sum) is one ``all_reduce`` over the
atom group.  ``'samples+atoms'`` combines the two on a 2-D mesh
``('data', 'atoms')``: a rank holds its data row's samples and its atom
column's atoms, sums over samples run over the data group and sums over
atoms over the atom group.  The engine takes the groups as its
``process_group`` and ``atom_group`` keywords (:mod:`tnmf_tpu_torch.engine`).

A 1-D mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` named
``('data',)`` or ``('atoms',)`` over every rank of the default process
group, built on that group (no new group is made); the 2-D mesh comes from
``init_device_mesh``, which makes the row and column groups.  In torch
every mesh spans processes: one process drives one device, so a world of
one is the single-card mesh and :mod:`tnmf_tpu_torch.parallel.distributed`
starts the process group.

The JAX package's other shard axes ('spatial', 'both') and its model-axis
mesh are not ported yet: their functions raise ``NotImplementedError``
naming the sub-item of ROADMAP.md item 14e that ports them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

DATA_AXIS = 'data'
SPATIAL_AXIS = 'space'
ATOM_AXIS = 'atoms'
MODEL_AXIS = 'models'

#: the JAX package's shard axes, and the sub-item of item 14e that ports
#: each one not ported yet
SHARD_AXES = ('samples', 'spatial', 'both', 'atoms', 'samples+atoms')
AXIS_ITEMS = {'spatial': '14e-iii', 'both': '14e-iii'}
#: the shard axes that split the atoms
ATOM_AXES = ('atoms', 'samples+atoms')
ITEM = 'ROADMAP.md queue 1, item {}'


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error of a part of the JAX package's meshes not ported yet."""
    return NotImplementedError(f'{what} is not ported to tnmf_tpu_torch yet; see '
                               + ITEM.format(item))


def check_axis(axis: str) -> None:
    """``ValueError`` for a name that is no shard axis (the JAX text),
    ``NotImplementedError`` for the axes not ported yet."""
    if axis == 'samples' or axis in ATOM_AXES:
        return
    if axis in AXIS_ITEMS:
        raise not_ported(f'shard_axis={axis!r}', AXIS_ITEMS[axis])
    raise ValueError(
        f"shard axis must be 'samples', 'spatial', 'both', 'atoms' or "
        f"'samples+atoms', got {axis!r}")


def _world(what: str, n_devices: Optional[int]) -> int:
    """The default process group's size, ``n_devices`` where given checked
    against it."""
    dist = torch.distributed
    if not dist.is_initialized():
        raise RuntimeError(
            f'{what} needs a process group: call '
            'tnmf_tpu_torch.parallel.distributed.initialize() (or '
            'torch.distributed.init_process_group) on every rank first')
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(
            f'n_devices={n_devices}: a mesh spans every process of the default '
            f'process group ({world}); start the group with that many processes')
    return world


def _device_type(devices) -> str:
    return torch.device('cuda' if devices is None else devices).type


def _mesh_1d(what: str, name: str, n_devices: Optional[int], devices):
    from torch.distributed.device_mesh import DeviceMesh
    _world(what, n_devices)
    return DeviceMesh.from_group(torch.distributed.group.WORLD, _device_type(devices),
                                 mesh_dim_names=(name,))


def make_mesh(n_devices: Optional[int] = None, devices=None):
    """1-D data-parallel mesh ``('data',)`` over every rank of the default
    process group (:func:`tnmf_tpu_torch.parallel.distributed.initialize`
    starts it).  ``devices`` is the device type the ranks compute on: the
    card (``'cuda'``, the default) or ``'cpu'``; ``n_devices``, where
    given, must be the world size (a mesh spans every process)."""
    return _mesh_1d('make_mesh', DATA_AXIS, n_devices, devices)


def make_mesh_atoms(n_devices: Optional[int] = None, devices=None):
    """1-D model-parallel mesh ``('atoms',)`` over every rank of the
    default process group, built as :func:`make_mesh` builds its mesh and
    with its errors: each rank holds a block of the dictionary's atoms."""
    return _mesh_1d('make_mesh_atoms', ATOM_AXIS, n_devices, devices)


def make_mesh_2d_atoms(n_data: int, n_atoms: int, devices=None):
    """2-D mesh ``('data', 'atoms')`` of shape ``(n_data, n_atoms)`` over
    every rank of the default process group: samples split over
    ``'data'``, the dictionary over ``'atoms'``.  The atom axis is
    innermost, as in the JAX package (the reconstruction's all-reduce over
    the atoms then runs between neighbouring ranks): rank ``r`` is data row
    ``r // n_atoms`` and atom column ``r % n_atoms``.  ``ValueError``
    unless ``n_data * n_atoms`` is the world size."""
    from torch.distributed.device_mesh import init_device_mesh
    world = _world('make_mesh_2d_atoms', None)
    need = int(n_data) * int(n_atoms)
    if need != world:
        raise ValueError(f'mesh {n_data}x{n_atoms} needs {need} processes, have {world}')
    return init_device_mesh(_device_type(devices), (int(n_data), int(n_atoms)),
                            mesh_dim_names=(DATA_AXIS, ATOM_AXIS))


def make_mesh_2d(n_data: int, n_space: int, devices=None):
    raise not_ported('make_mesh_2d (samples x space)', '14e-iii')


def make_mesh_models(n_devices: Optional[int] = None, devices=None):
    raise not_ported("make_mesh_models (a sweep's 'models' mesh)", '14e-iv')


def data_sharding(mesh, ndim: int) -> tuple:
    """Axis 0 (samples) split over the mesh, the rest whole: the DTensor
    placements ``(Shard(0),)``."""
    from torch.distributed.tensor import Shard
    return (Shard(0),)


def replicated(mesh) -> tuple:
    """A whole copy on every rank (the dictionary W): ``(Replicate(),)``."""
    from torch.distributed.tensor import Replicate
    return (Replicate(),)


def spatial_sharding(mesh, ndim: int):
    raise not_ported('spatial_sharding', '14e-iii')


def h_sharding(mesh, ndim: int, axis: str = 'samples') -> tuple:
    """The placements H takes under :func:`shard_model_state` for ``axis``:
    its rows, its maps (``(Shard(1),)`` under ``'atoms'``) or both."""
    from torch.distributed.tensor import Shard
    check_axis(axis)
    if axis == 'atoms':
        return (Shard(1),)
    if axis == 'samples+atoms':
        return (Shard(0), Shard(1))
    return data_sharding(mesh, ndim)


def w_sharding(mesh, ndim: int, axis: str = 'samples') -> tuple:
    """The placements W takes under :func:`shard_model_state` for ``axis``:
    split along its atom axis under ``'atoms'`` and ``'samples+atoms'``
    (replicated over the data axis), replicated under ``'samples'``."""
    from torch.distributed.tensor import Replicate, Shard
    check_axis(axis)
    if axis == 'atoms':
        return (Shard(0),)
    if axis == 'samples+atoms':
        return (Replicate(), Shard(0))
    return replicated(mesh)


def local_rows(mesh, n_samples: int) -> slice:
    """This rank's contiguous rows of ``n_samples``: the ``rank``-th of
    ``world`` equal blocks.  ``ValueError`` (the JAX text) unless the world
    divides the count."""
    n_dev = mesh.size()
    if n_samples % n_dev != 0:
        raise ValueError(
            f'n_samples ({n_samples}) must be divisible by the mesh size ({n_dev}); '
            f'pad the batch or use a smaller mesh')
    n_local = n_samples // n_dev
    rank = mesh.get_local_rank()
    return slice(rank * n_local, (rank + 1) * n_local)


def axis_size(mesh, name: str) -> int:
    """The extent of the mesh axis ``name`` (1 where the mesh has none)."""
    names = tuple(mesh.mesh_dim_names or ())
    return mesh.shape[names.index(name)] if name in names else 1


def data_rows(mesh, n_samples: int) -> slice:
    """This rank's contiguous rows of ``n_samples`` on the data axis of a
    2-D mesh from :func:`make_mesh_2d_atoms`.  ``ValueError`` (the JAX
    text) unless the data axis divides the count."""
    n_data = axis_size(mesh, DATA_AXIS)
    if n_samples % n_data:
        raise ValueError(
            f'n_samples ({n_samples}) must be divisible by the data '
            f'mesh axis ({n_data})')
    n_local = n_samples // n_data
    rank = mesh.get_local_rank(DATA_AXIS)
    return slice(rank * n_local, (rank + 1) * n_local)


def local_atoms(mesh, n_atoms: int) -> slice:
    """This rank's contiguous block of ``n_atoms`` on the mesh's atom axis.
    ``ValueError`` (the JAX text) unless the atom axis divides the count."""
    n_shards = axis_size(mesh, ATOM_AXIS)
    if n_atoms % n_shards:
        raise ValueError(
            f'n_atoms ({n_atoms}) must be divisible by the atom mesh '
            f'axis ({n_shards}); pad the dictionary or resize the mesh')
    n_local = n_atoms // n_shards
    rank = mesh.get_local_rank(ATOM_AXIS)
    return slice(rank * n_local, (rank + 1) * n_local)


def check_mesh(mesh, axis: str) -> None:
    """``ValueError`` unless ``mesh`` carries ``axis``: ``'samples'`` a 1-D
    ``('data',)`` mesh (:func:`make_mesh`), ``'atoms'`` a 1-D ``('atoms',)``
    one (:func:`make_mesh_atoms`), ``'samples+atoms'`` the 2-D ``('data',
    'atoms')`` one (:func:`make_mesh_2d_atoms`; the JAX text)."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis == 'samples+atoms':
        if names != (DATA_AXIS, ATOM_AXIS):
            raise ValueError("axis='samples+atoms' needs a 2-D mesh from make_mesh_2d_atoms")
    elif axis == 'atoms':
        if names != (ATOM_AXIS,):
            raise ValueError(f"axis='atoms' needs a 1-D mesh from make_mesh_atoms, got the "
                             f'mesh axes {names}')
    elif mesh.ndim != 1 or names == (ATOM_AXIS,):
        raise ValueError(f"axis='samples' needs a 1-D mesh from make_mesh, got the mesh "
                         f'axes {names}; pass the shard_axis the mesh was built for')


def shard_model_state(mesh, V, W, H, axis: str = 'samples') -> Tuple:
    """This rank's share of the model state (views of tensors, slices of
    arrays), with the JAX package's errors: under ``'samples'`` its rows
    of V and H and W whole; under ``'atoms'`` V whole, its block of W's
    atoms and H's maps of them; under ``'samples+atoms'`` its data row's
    rows of V and H and its atom column's atoms of W and maps of H."""
    check_axis(axis)
    if axis == 'samples':
        rows = local_rows(mesh, V.shape[0])
        return V[rows], W, H[rows]
    check_mesh(mesh, axis)
    rows = data_rows(mesh, V.shape[0]) if axis == 'samples+atoms' else slice(None)
    atoms = local_atoms(mesh, W.shape[0])
    per_atom = H.shape[1] // W.shape[0]  # an atom's maps (m-major)
    maps = slice(atoms.start * per_atom, atoms.stop * per_atom)
    return V[rows], W[atoms], H[rows][:, maps]
