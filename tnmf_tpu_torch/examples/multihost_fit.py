"""A fit whose samples span processes, runnable on one machine.

Port of ``examples/multihost_fit.py``: this launcher spawns two worker
processes; every worker joins the process group
(:func:`tnmf_tpu_torch.parallel.distributed.initialize`, through a
``file://`` store), builds the same mesh over both, contributes its *local*
half of the sample batch (:func:`~tnmf_tpu_torch.parallel.distributed.fit_distributed`,
``init='device'``) and fits: the W-statistic all-reduce spans both
processes, as it would span hosts.

The workers compute on the CPU when asked (``device='cpu'``), and otherwise
share the card over gloo (NCCL takes one card per process).  On a machine
with a card per process, run the worker under ``torchrun`` instead, with
``initialize()`` reading its environment and ``backend`` left to default
to NCCL.
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

#: the workers' lines about the layout (the JAX example counts devices of
#: its processes' virtual meshes, two processes here)
NOT_COMPARED = ('layout',)
WORLD = 2
#: seconds each worker may take, its start included
WORKER_TIMEOUT = 300
_MARK = 'multihost_fit worker result: '


def worker(init_method: str, rank: int, device='cpu', use_pallas=None,
           dtype=torch.float32) -> dict:
    """One rank's part: join the group, fit this rank's half of the batch,
    and return what it reports."""
    from .. import TransformInvariantNMF
    from ..parallel import distributed
    distributed.initialize(init_method, num_processes=WORLD, process_id=rank, backend='gloo',
                           timeout=60)
    try:
        mesh = distributed.global_mesh(devices=torch.device(device).type)
        layout = (f'{torch.distributed.get_world_size()} processes, mesh '
                  f'{dict(zip(mesh.mesh_dim_names, mesh.shape))} on {device}')
        # every rank generates the same global batch and keeps its own slice
        # (in production each host would load its own shard from storage)
        rng = np.random.default_rng(0)
        V_global = rng.random((16, 2, 24, 24)).astype(np.float32)
        V_local = V_global[rank * 8:(rank + 1) * 8]

        nmf = TransformInvariantNMF(n_atoms=4, atom_shape=(5, 5), mesh=mesh, init='device',
                                    seed=0, device=device, use_pallas=use_pallas, dtype=dtype)
        distributed.fit_distributed(nmf, V_local, n_iterations=30, sparsity_H=0.1)
        energy = nmf._energy_function()  # the whole batch's, the same on every rank
        return dict(rank=rank, layout=layout, energy=energy,
                    norms=nmf.W.sum(axis=(-2, -1)).round(4).tolist())
    finally:
        torch.distributed.destroy_process_group()


def run(smoke: bool = False, device='cuda', use_pallas=None, dtype=torch.float32) -> dict:
    """Launch the two workers (``python -m tnmf_tpu_torch.examples.multihost_fit
    --worker …``, each within ``WORKER_TIMEOUT`` seconds) and collect what
    they report.  ``smoke`` changes nothing: the JAX example has one size."""
    del smoke
    package = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = [package, os.environ.get('PYTHONPATH', '')]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in path if p))
    pallas = 'none' if use_pallas is None else str(bool(use_pallas))
    with tempfile.TemporaryDirectory() as tmp:
        store = 'file://' + os.path.join(tmp, 'store')
        procs = [subprocess.Popen(
            [sys.executable, '-m', 'tnmf_tpu_torch.examples.multihost_fit', '--worker', store,
             str(rank), str(device), pallas, str(dtype).removeprefix('torch.')],
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
        raise RuntimeError(f'multihost_fit workers exited {codes}:\n' + '\n'.join(
            f'--- rank {r}\n{out}\n{err}' for r, (out, err) in enumerate(outputs)))
    workers = [json.loads(next(line[len(_MARK):] for line in out.splitlines()
                               if line.startswith(_MARK))) for out, _ in outputs]
    return dict(workers=workers)


def lines(result: dict) -> list:
    out = []
    for w in result['workers']:
        out.append(f'[rank {w["rank"]}] {w["layout"]}')
        out.append(f'[rank {w["rank"]}] final energy {w["energy"]:.4f}, '
                   f'atom norms {w["norms"]}')
    out.append('multi-host fit finished on both ranks.')
    return out


def plot(result: dict) -> None:
    """The JAX example draws nothing."""


def main() -> None:
    print('\n'.join(lines(run(smoke=smoke_from_env()))))


if __name__ == '__main__':
    if len(sys.argv) == 7 and sys.argv[1] == '--worker':
        _, _, store, rank, device, pallas, dtype = sys.argv
        result = worker(store, int(rank), device,
                        None if pallas == 'none' else pallas == 'True', getattr(torch, dtype))
        print(_MARK + json.dumps(result), flush=True)
    else:
        main()
