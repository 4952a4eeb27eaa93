"""Data parallelism over the samples on ``torch.distributed`` (port of
:mod:`tnmf_tpu.parallel.sharding`, its ``'samples'`` axis).

Every rank of a process group holds its own contiguous rows of V and H and
a replica of the dictionary W.  The H update has no cross-sample term, so
each rank runs it on its rows alone; every sum over the samples (the W
statistics, the energy, HALS's ``H^T H`` and ``H^T V``) is a partial sum
per rank that one ``all_reduce`` completes.  The engine takes the mesh's
process group as its ``group`` keyword (:mod:`tnmf_tpu_torch.engine`).

A mesh here is a 1-D :class:`torch.distributed.device_mesh.DeviceMesh`
named ``('data',)`` over every rank of the default process group, built on
that group (no new group is made).  In torch every mesh spans processes:
one process drives one device, so a world of one is the single-card mesh
and :mod:`tnmf_tpu_torch.parallel.distributed` starts the process group.

The JAX package's other shard axes ('atoms', 'samples+atoms', 'spatial',
'both') and its model-axis mesh are not ported yet: their functions raise
``NotImplementedError`` naming the sub-item of ROADMAP.md item 14e that
ports them.
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
AXIS_ITEMS = {'atoms': '14e-ii', 'samples+atoms': '14e-ii', 'spatial': '14e-iii',
              'both': '14e-iii'}
ITEM = 'ROADMAP.md queue 1, item {}'


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error of a part of the JAX package's meshes not ported yet."""
    return NotImplementedError(f'{what} is not ported to tnmf_tpu_torch yet; see '
                               + ITEM.format(item))


def check_axis(axis: str) -> None:
    """``ValueError`` for a name that is no shard axis (the JAX text),
    ``NotImplementedError`` for the axes not ported yet."""
    if axis == 'samples':
        return
    if axis in AXIS_ITEMS:
        raise not_ported(f'shard_axis={axis!r}', AXIS_ITEMS[axis])
    raise ValueError(
        f"shard axis must be 'samples', 'spatial', 'both', 'atoms' or "
        f"'samples+atoms', got {axis!r}")


def make_mesh(n_devices: Optional[int] = None, devices=None):
    """1-D data-parallel mesh ``('data',)`` over every rank of the default
    process group (:func:`tnmf_tpu_torch.parallel.distributed.initialize`
    starts it).  ``devices`` is the device type the ranks compute on: the
    card (``'cuda'``, the default) or ``'cpu'``; ``n_devices``, where
    given, must be the world size (a mesh spans every process)."""
    dist = torch.distributed
    if not dist.is_initialized():
        raise RuntimeError(
            'make_mesh needs a process group: call '
            'tnmf_tpu_torch.parallel.distributed.initialize() (or '
            'torch.distributed.init_process_group) on every rank first')
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(
            f'n_devices={n_devices}: a mesh spans every process of the default '
            f'process group ({world}); start the group with that many processes')
    from torch.distributed.device_mesh import DeviceMesh
    device_type = torch.device('cuda' if devices is None else devices).type
    return DeviceMesh.from_group(dist.group.WORLD, device_type, mesh_dim_names=(DATA_AXIS,))


def make_mesh_atoms(n_devices: Optional[int] = None, devices=None):
    raise not_ported('make_mesh_atoms (a mesh over the atoms)', '14e-ii')


def make_mesh_2d_atoms(n_data: int, n_atoms: int, devices=None):
    raise not_ported('make_mesh_2d_atoms (samples x atoms)', '14e-ii')


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
    """The placements H takes under :func:`shard_model_state` for ``axis``."""
    check_axis(axis)
    return data_sharding(mesh, ndim)


def w_sharding(mesh, ndim: int, axis: str = 'samples') -> tuple:
    """The placements W takes under :func:`shard_model_state` for ``axis``:
    replicated."""
    check_axis(axis)
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


def shard_model_state(mesh, V, W, H, axis: str = 'samples') -> Tuple:
    """This rank's share of the model state: its rows of V and H (views of
    tensors, slices of arrays), W whole.  Only ``axis='samples'`` is
    ported."""
    check_axis(axis)
    rows = local_rows(mesh, V.shape[0])
    return V[rows], W, H[rows]
