"""Meshes on ``torch.distributed`` (port of :mod:`tnmf_tpu.parallel`): the
sample and atom axes (:mod:`.sharding`) and fits whose samples span
processes (:mod:`.distributed`).  Imports torch only."""

from . import distributed
from .sharding import (ATOM_AXIS, DATA_AXIS, MODEL_AXIS, SPATIAL_AXIS, data_sharding,
                       h_sharding, local_atoms, make_mesh, make_mesh_2d, make_mesh_2d_atoms,
                       make_mesh_atoms, make_mesh_models, replicated, shard_model_state,
                       spatial_sharding, w_sharding)

__all__ = ['ATOM_AXIS', 'DATA_AXIS', 'MODEL_AXIS', 'SPATIAL_AXIS',
           'data_sharding', 'distributed', 'h_sharding', 'local_atoms', 'make_mesh',
           'make_mesh_2d', 'make_mesh_2d_atoms', 'make_mesh_atoms',
           'make_mesh_models', 'replicated', 'shard_model_state',
           'spatial_sharding', 'w_sharding']
