"""Hyperparameter sweeps as one vmapped fit (``tnmf_tpu_torch.sweep_fit``).

Port of ``examples/hyperparameter_sweep.py``.  Dictionary learning is init-
and regularization-sensitive, so real use means many restarts and strength
grids.  With the reference library that is a Python loop of sequential
``fit`` calls; here the model axis is a ``torch.func.vmap`` batch
dimension: S inits, S fit loops and S objectives run together, each kernel
launched once per iteration for all the models.

The script fits a seed x sparsity grid on synthetic patches, reports the
per-model objectives and the winner, grids a dictionary-diversity (ortho)
strength, and stops each model on its own ``tol``.  The JAX example's last
step, the same sweep on a device mesh, waits for the port's 'models'
mesh (ROADMAP.md queue 1, item 14e-iv).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import sweep_fit
from . import smoke_from_env, synchronize

#: the sweep's wall time and the device it ran on
NOT_COMPARED = ('seconds', 'platform')


def run(smoke: bool = False, device='cuda', use_pallas=None, dtype=torch.float32) -> dict:
    """``dtype`` is accepted for the examples' common signature: a sweep
    fits float64 data in float32, as the JAX package's does."""
    n_iterations = 8 if smoke else 100
    sweep = dict(device=device, use_pallas=use_pallas is not False)

    rng = np.random.default_rng(3)
    V = rng.random((8, 1, 24, 24)).astype(np.float32) ** 2

    # a 2 x 4 grid: 2 restarts x 4 sparsity strengths, flattened to vectors
    sparsities = np.array([0.0, 0.05, 0.2, 0.8], np.float32)
    n_restarts = 2
    sp = np.tile(sparsities, n_restarts)
    seeds = np.repeat(np.arange(n_restarts, dtype=np.uint32), len(sparsities))
    n_models = len(sp)

    synchronize(device)
    t0 = time.perf_counter()
    res = sweep_fit(V, 5, (5, 5), seed=seeds, n_iterations=n_iterations,
                    sparsity=sp, record_energies=True, **sweep)
    synchronize(device)
    seconds = time.perf_counter() - t0
    tr = res.energy_traces.cpu().numpy()
    H = res.H.cpu().numpy()
    l1 = np.sum(np.abs(H), axis=tuple(range(1, H.ndim)))
    energies = res.energies.cpu().numpy()

    # any regularizer grids the same way: here a dictionary-diversity
    # (ortho) grid — higher strengths push atoms apart (lower cross-atom
    # overlap), at some reconstruction cost
    orthos = np.array([0.0, 0.5, 2.0, 8.0], np.float32)
    # identical per-model seeds: every lane starts from the same init, so
    # the grid isolates the strength's effect
    res_o = sweep_fit(V, 5, (5, 5), seed=np.zeros(len(orthos), np.uint32),
                      n_iterations=n_iterations, ortho=orthos, **sweep)
    Wo = res_o.W.cpu().numpy().reshape(len(orthos), 5, -1)
    gram = np.einsum('smk,snk->smn', Wo, Wo)
    overlap = gram.sum(axis=(1, 2)) - np.trace(gram, axis1=1, axis2=2)

    # per-model early stopping: converged models freeze, the sweep stops
    # when all are done (or at n_iterations)
    res_tol = sweep_fit(V, 5, (5, 5), seed=seeds, n_iterations=n_iterations,
                        sparsity=sp, tol=1e-3, tol_check_every=5, **sweep)
    return dict(
        n_models=n_models, n_iterations=n_iterations, seconds=seconds,
        platform=torch.device(device).type,
        trace=(float(tr[0, 0]), float(tr[0, -1]), tr.shape[1]),
        models=[(int(seeds[s]), float(sp[s]), float(energies[s]), float(l1[s]))
                for s in range(n_models)],
        best=(res.best, int(seeds[res.best]), float(sp[res.best])),
        ortho=[(float(o), float(res_o.energies[s]), float(overlap[s]))
               for s, o in enumerate(orthos)],
        stop_iterations=res_tol.n_iters.cpu().numpy().tolist())


def lines(result: dict) -> list:
    out = [f'{result["n_models"]} models x {result["n_iterations"]} iterations in '
           f'{result["seconds"]:.2f} s (one vmapped fit, {result["platform"]})']
    first, last, n = result['trace']
    out.append(f'convergence: model 0 objective {first:.2f} -> {last:.2f} '
               f'over {n} iterations (traces recorded per model)')
    out.append(f'{"seed":>4} {"sparsity":>9} {"energy":>12} {"|H|_1":>12}')
    out += [f'{seed:>4} {sp:>9.2f} {e:>12.4f} {l1:>12.1f}'
            for seed, sp, e, l1 in result['models']]
    best, seed, sp = result['best']
    out.append(f'best model: #{best} (seed {seed}, sparsity {sp:.2f})')
    out.append(f'{"ortho":>6} {"energy":>12} {"atom overlap":>13}')
    out += [f'{o:>6.1f} {e:>12.4f} {ov:>13.4f}' for o, e, ov in result['ortho']]
    out.append(f'tol=1e-3 per-model stop iterations: {result["stop_iterations"]}')
    return out


def plot(result: dict) -> None:
    """The JAX example draws nothing."""


def main() -> None:
    result = run(smoke=smoke_from_env())
    print('\n'.join(lines(result)))
    plot(result)


if __name__ == '__main__':
    main()
