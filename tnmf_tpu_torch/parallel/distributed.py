"""Data parallelism across processes (port of
:mod:`tnmf_tpu.parallel.distributed`).

In torch one process drives one device, so every mesh spans processes:

1. every process calls :func:`initialize` (a thin wrapper over
   ``torch.distributed.init_process_group``);
2. builds the same :func:`global_mesh` over every rank;
3. either passes the whole batch to ``fit`` (each rank keeps its rows), or
   wraps its *local* block of samples with :func:`distribute_samples`, so
   that no process ever holds the whole batch;
4. fits as usual with ``TransformInvariantNMF(mesh=global_mesh(),
   init='device')``: each rank updates its own rows of H, and the sample
   sums of the W statistics are one ``all_reduce`` per iteration.

Under process-spanning input (:func:`distribute_samples`) the JAX
package's rules hold: ``init='device'``, no shuffling, and the mask
distributed like V.  The ``V``/``H``/``R`` properties raise under a world
above one (no property hides a collective); ``W`` is replicated and reads
everywhere.

Backends: ``nccl`` where every process has a card of its own, ``gloo`` on
the CPU.  Two processes that share one card must ask for ``gloo`` (NCCL
takes one card per rank); nothing switches the backend or the device
silently.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import numpy as np
import torch

from .sharding import make_mesh


def _local_world(num_processes: Optional[int], process_id: Optional[int]) -> tuple:
    """``(local_rank, local_world)`` of this process on its host: the
    launcher's ``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` (``torchrun``), else the
    process's rank in a world on one host."""
    rank = int(os.environ.get('LOCAL_RANK', process_id or 0))
    world = int(os.environ.get('LOCAL_WORLD_SIZE', num_processes or 1))
    return rank, world


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               timeout: Optional[float] = None) -> None:
    """Connect this process to the others (``init_process_group``).

    ``coordinator_address`` is ``'host:port'`` (TCP) or an ``init_method``
    URL (``'tcp://…'``, ``'file://…'``, ``'env://'``).  With nothing
    passed, ``torchrun``'s environment (``MASTER_ADDR``, ``RANK``,
    ``WORLD_SIZE``) is read; with ``num_processes=1`` and no address the
    process starts a world of one on its own.  ``backend`` defaults to
    ``'nccl'`` where every process of the host has a card of its own
    (each then computes on the card of its local rank) and to ``'gloo'``
    without a card; processes that share a card raise unless they pass
    ``backend='gloo'``.  ``timeout`` (seconds) bounds each collective."""
    dist = torch.distributed
    kw = {} if timeout is None else dict(timeout=timedelta(seconds=float(timeout)))
    alone = num_processes in (None, 1) and 'WORLD_SIZE' not in os.environ
    if coordinator_address is None and alone:
        kw.update(store=dist.HashStore(), rank=0, world_size=1)
        num_processes, process_id = 1, 0
    else:
        if coordinator_address is None:
            url = 'env://'
        elif '://' in coordinator_address:
            url = coordinator_address
        else:
            url = 'tcp://' + coordinator_address
        kw.update(init_method=url)
        if num_processes is not None:
            kw.update(world_size=int(num_processes))
        if process_id is not None:
            kw.update(rank=int(process_id))
    if torch.cuda.is_available():
        local_rank, local_world = _local_world(num_processes, process_id)
        own_card = local_world <= torch.cuda.device_count()
        if backend is None:
            if not own_card:
                raise ValueError(
                    f'{local_world} processes on this host share its '
                    f'{torch.cuda.device_count()} card(s), and NCCL takes one card per '
                    "process: pass backend='gloo' to share them")
            backend = 'nccl'
        if own_card:
            torch.cuda.set_device(local_rank)
    elif backend is None:
        backend = 'gloo'
    dist.init_process_group(backend, **kw)


def global_mesh(devices=None):
    """1-D data-parallel mesh over every process
    (:func:`~tnmf_tpu_torch.parallel.sharding.make_mesh`; ``devices``: the
    device type, the card by default)."""
    return make_mesh(devices=devices)


class SampleShards:
    """A batch of samples spread over the processes of a mesh, as this
    process holds it: its own block ``local`` of ``n_local`` samples, the
    ``rank``-th of the batch's ``world`` equal blocks (the JAX package's
    process-spanning global array).  ``shape`` is the whole batch's."""

    def __init__(self, local: torch.Tensor, mesh):
        self.local = local
        self.mesh = mesh
        self.shape = (local.shape[0] * mesh.size(),) + tuple(local.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype


def distribute_samples(mesh, V_local) -> SampleShards:
    """The batch whose blocks the processes of ``mesh`` hold: every
    process passes its own ``(n_local, channels, *sample_shape)`` block (an
    array or a tensor; equal shapes everywhere, checked with one
    ``all_gather`` of the shapes), in rank order.  The block goes to this
    process's device of the mesh's type (no copy of the whole batch
    anywhere)."""
    if isinstance(V_local, torch.Tensor):
        local = V_local.detach()
    else:
        local = torch.as_tensor(np.asarray(V_local))
    if mesh.device_type == 'cuda':
        local = local.to(torch.device('cuda', torch.cuda.current_device()))
    else:
        local = local.to(mesh.device_type)
    shapes = [None] * mesh.size()
    torch.distributed.all_gather_object(shapes, tuple(local.shape), group=mesh.get_group())
    if len(set(shapes)) != 1:
        raise ValueError(
            f'distribute_samples: every process must pass a block of the same shape '
            f'(equal n_local), got {shapes} by rank')
    return SampleShards(local, mesh)


def fit_distributed(model, V_local, **fit_kwargs):
    """Convenience driver: distribute ``V_local`` over the model's mesh and
    fit.  The model must have been constructed with ``mesh=global_mesh()``
    and ``init='device'``."""
    if model._mesh is None:
        raise ValueError('fit_distributed needs a model constructed with mesh=global_mesh()')
    V = distribute_samples(model._mesh, V_local)
    model.fit(V, **fit_kwargs)
    return model
