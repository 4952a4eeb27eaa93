"""Data-parallel conv-NMF over a mesh of processes.

Port of ``examples/data_parallel_fit.py``.  Splits a stack of image
samples over the ranks of a process group (``torch.distributed``): each
rank keeps its rows of V and H and a replica of the dictionary, and the
sample sums of the W statistics are one ``all_reduce`` per iteration
(:mod:`tnmf_tpu_torch.parallel`).  Prints the layout and checks that the
result matches the fit of the same batch without a mesh.

Run alone (``python -m tnmf_tpu_torch.examples.data_parallel_fit``) it
starts a world of one: NCCL on the card, gloo on the CPU.  Under
``torchrun --nproc-per-node N`` each process computes on its own card and
the batch is split ``N`` ways.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import TransformInvariantNMF
from ..parallel import distributed, make_mesh
from . import smoke_from_env

#: the layout line and the mesh fit's distance from the mesh-free one (0
#: in a world of one, where the all-reduce is the identity; the JAX
#: package's sharded program rounds otherwise)
NOT_COMPARED = ('layout', 'max_w_diff')


def run(smoke: bool = False, device='cuda', use_pallas=None, dtype=torch.float32) -> dict:
    n_iterations = 5 if smoke else 20
    dist = torch.distributed
    started = not dist.is_initialized()
    if started:
        distributed.initialize(num_processes=1)
    try:
        mesh = make_mesh(devices=torch.device(device).type)
        n_dev = mesh.size()
        model = dict(device=device, use_pallas=use_pallas, dtype=dtype)

        rng = np.random.default_rng(0)
        n_samples = 4 * n_dev
        V = rng.random((n_samples, 1, 32, 32)).astype(np.float32)

        np.random.seed(42)
        nmf = TransformInvariantNMF(n_atoms=8, atom_shape=(5, 5), mesh=mesh, verbose=2, **model)
        nmf.fit(V, n_iterations=n_iterations, sparsity_H=0.1)
        rank, n_local = mesh.get_local_rank(), nmf._H.shape[0]
        layout = (f'rank {rank} of {n_dev} holds H rows {rank * n_local}:{(rank + 1) * n_local} '
                  f'of {n_samples}, {tuple(nmf._H.shape)} on {nmf._H.device}')
        energy = nmf._energy_function()

        np.random.seed(42)
        ref = TransformInvariantNMF(n_atoms=8, atom_shape=(5, 5), **model)
        ref.fit(V, n_iterations=n_iterations, sparsity_H=0.1)
        return dict(devices=(n_dev, mesh.device_type), layout=layout, energy_mesh=energy,
                    energy_single=ref._energy_function(),
                    max_w_diff=float(np.abs(nmf.W - ref.W).max()))
    finally:
        if started:
            dist.destroy_process_group()


def lines(result: dict) -> list:
    n_dev, platform = result['devices']
    return [f'devices: {n_dev} x {platform}',
            f'sharded H layout: {result["layout"]}',
            f'final energy (mesh={n_dev}): {result["energy_mesh"]:.4f}',
            f'final energy (single device): {result["energy_single"]:.4f}',
            f'max |W_mesh - W_single| = {result["max_w_diff"]}']


def plot(result: dict) -> None:
    """The JAX example draws nothing."""


def main() -> None:
    print('\n'.join(lines(run(smoke=smoke_from_env()))))


if __name__ == '__main__':
    main()
