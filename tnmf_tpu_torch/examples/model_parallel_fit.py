"""Atom (model/tensor) parallel conv-NMF: sharding the dictionary itself.

Port of ``examples/model_parallel_fit.py``.  For dictionaries too large for
one device (thousands of atoms; both W and the ``n_atoms``-proportional
activation tensor H grow with the atom count), ``shard_axis='atoms'``
splits W along its atom axis and H along its atom axis over the ranks of
a mesh (:func:`tnmf_tpu_torch.parallel.make_mesh_atoms`).  Both MU
gradients are atom-local, so the only collective is the reconstruction's
sum over the atoms: one ``all_reduce`` per gradient pass.

This launcher spawns two worker processes that join one process group
through a ``file://`` store; each fits its four atoms of eight, and rank 0
gathers the ranks' blocks of W and fits the same problem without a mesh.
The workers compute on the CPU when asked (``device='cpu'``), and otherwise
share the card over gloo (NCCL takes one card per process).  On a machine
with a card per process, run the worker under ``torchrun`` instead.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from . import smoke_from_env

#: the layout lines (which rank holds which atoms, on which device) and
#: the mesh fit's distance from the mesh-free one (the sums over the atoms
#: run in another order)
NOT_COMPARED = ('layouts', 'max_w_diff')
WORLD = 2
#: seconds each worker may take, its start included
WORKER_TIMEOUT = 300
_MARK = 'model_parallel_fit worker result: '


def worker(init_method: str, rank: int, device='cpu', use_pallas=None, dtype=torch.float32,
           n_iterations: int = 20) -> dict:
    """One rank's part: join the group, fit this rank's atoms on
    ``make_mesh_atoms()``, and return what it reports; rank 0 also gathers
    every rank's block of W and fits the problem without a mesh."""
    from .. import TransformInvariantNMF
    from ..parallel import distributed, make_mesh_atoms
    distributed.initialize(init_method, num_processes=WORLD, process_id=rank, backend='gloo',
                           timeout=60)
    try:
        mesh = make_mesh_atoms(devices=torch.device(device).type)
        n_dev = mesh.size()
        model = dict(device=device, use_pallas=use_pallas, dtype=dtype)

        rng = np.random.default_rng(0)
        n_atoms = 4 * n_dev  # 4 atoms per rank
        V = rng.random((6, 1, 32, 32)).astype(np.float32)
        fit = dict(n_iterations=n_iterations, sparsity_H=0.1, inhibition_strength=0.1)

        np.random.seed(42)
        nmf = TransformInvariantNMF(n_atoms=n_atoms, atom_shape=(5, 5), mesh=mesh,
                                    shard_axis='atoms', verbose=2, **model)
        nmf.fit(V, **fit)
        W_local = nmf._local_W()
        first = rank * W_local.shape[0]
        layout = (f'rank {rank} of {n_dev} holds atoms {first}:{first + W_local.shape[0]} of '
                  f'{n_atoms}: W {tuple(nmf._W.shape)}, H {tuple(nmf._H.shape)} on '
                  f'{nmf._W.device}')
        energy = nmf._energy_function()  # the whole model's, the same on every rank
        blocks = [None] * n_dev
        torch.distributed.all_gather_object(blocks, W_local, group=mesh.get_group())
        out = dict(rank=rank, devices=[n_dev, mesh.device_type], layout=layout,
                   energy_mesh=energy)
        if rank == 0:
            W_mesh = np.concatenate(blocks)
            np.random.seed(42)
            ref = TransformInvariantNMF(n_atoms=n_atoms, atom_shape=(5, 5), **model)
            ref.fit(V, **fit)
            out.update(energy_single=ref._energy_function(),
                       max_w_diff=float(np.abs(W_mesh - ref.W).max()), W=W_mesh.tolist())
        return out
    finally:
        torch.distributed.destroy_process_group()


def run(smoke: bool = False, device='cuda', use_pallas=None, dtype=torch.float32) -> dict:
    """Launch the two workers (``python -m tnmf_tpu_torch.examples.model_parallel_fit
    --worker …``, each within ``WORKER_TIMEOUT`` seconds) and collect what
    they report: 5 iterations with ``smoke``, else 20."""
    n_iterations = 5 if smoke else 20
    package = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = [package, os.environ.get('PYTHONPATH', '')]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in path if p))
    pallas = 'none' if use_pallas is None else str(bool(use_pallas))
    with tempfile.TemporaryDirectory() as tmp:
        store = 'file://' + os.path.join(tmp, 'store')
        procs = [subprocess.Popen(
            [sys.executable, '-m', 'tnmf_tpu_torch.examples.model_parallel_fit', '--worker',
             store, str(rank), str(device), pallas, str(dtype).removeprefix('torch.'),
             str(n_iterations)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for rank in range(WORLD)]
        outputs = []
        try:
            for p in procs:
                outputs.append(p.communicate(timeout=WORKER_TIMEOUT))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    codes = [p.returncode for p in procs]
    if codes != [0] * WORLD:
        raise RuntimeError(f'model_parallel_fit workers exited {codes}:\n' + '\n'.join(
            f'--- rank {r}\n{out}\n{err}' for r, (out, err) in enumerate(outputs)))
    workers = [json.loads(next(line[len(_MARK):] for line in out.splitlines()
                               if line.startswith(_MARK))) for out, _ in outputs]
    first = workers[0]
    return dict(devices=tuple(first['devices']), layouts=[w['layout'] for w in workers],
                energy_mesh=first['energy_mesh'], energy_single=first['energy_single'],
                max_w_diff=first['max_w_diff'], W=np.asarray(first['W']))


def lines(result: dict) -> list:
    n_dev, platform = result['devices']
    return ([f'devices: {n_dev} x {platform}']
            + [f'sharded W layout: {layout}' for layout in result['layouts']]
            + [f'final energy (atom-sharded, mesh={n_dev}): {result["energy_mesh"]:.4f}',
               f'final energy (single device):           {result["energy_single"]:.4f}',
               f'max |W_mesh - W_single| = {result["max_w_diff"]}'])


def plot(result: dict) -> None:
    """The JAX example draws nothing."""


def main() -> None:
    print('\n'.join(lines(run(smoke=smoke_from_env()))))


if __name__ == '__main__':
    if len(sys.argv) == 8 and sys.argv[1] == '--worker':
        _, _, store, rank, device, pallas, dtype, n_iterations = sys.argv
        result = worker(store, int(rank), device,
                        None if pallas == 'none' else pallas == 'True', getattr(torch, dtype),
                        int(n_iterations))
        print(_MARK + json.dumps(result), flush=True)
    else:
        main()
