"""Shift-invariant conv-NMF: racing MU, extrapolated MU and exact CD.

Port of ``examples/shift_invariant_solvers.py``.  Under
``reconstruction_mode='full'`` (atoms strictly inside the sample — the
classic conv-NMF / sparse-coding formulation) two solvers cover the full
shift-invariant geometry:

* ``solver='mu'`` (default): Lee–Seung multiplicative updates — the
  reference's algorithm — optionally accelerated with ``extrapolate=True``
  (multiplicative momentum with safeguard restarts);
* ``solver='hals'``: exact phase-blocked coordinate descent
  (:mod:`tnmf_tpu_torch.engine_hals_conv`) — activations spaced one atom
  apart have disjoint footprints, so each of the ``prod(atom_shape)``
  phases is an exact shared-Gram HALS block; W steps stay multiplicative
  and the iteration is monotone by construction.

This script plants sparse pulse activations, fits the same seeded problem
with all three solvers under ``record_energies=True``, and plots the energy
trajectories (iteration- and wall-clock-indexed).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import TransformInvariantNMF
from ..utils.drawing import pyplot
from . import smoke_from_env, synchronize

N_SAMPLES, SAMPLE_LEN, ATOM_LEN, N_ATOMS = 8, 120, 8, 6
#: each fit's wall time
NOT_COMPARED = ('seconds',)
SOLVERS = (('MU', {}), ('MU+extrapolate', dict(extrapolate=True)),
           ('exact CD (hals)', dict(solver='hals')))


def make_data(seed=0):
    """Sparse planted pulses: a ground-truth dictionary of random atoms
    placed at ~5%-dense shift positions, plus a little noise."""
    rng = np.random.default_rng(seed)
    W = rng.random((N_ATOMS, 1, ATOM_LEN))
    T = SAMPLE_LEN - ATOM_LEN + 1
    H = np.where(rng.random((N_SAMPLES, N_ATOMS, T)) > 0.95,
                 rng.random((N_SAMPLES, N_ATOMS, T)), 0.0)
    V = np.zeros((N_SAMPLES, 1, SAMPLE_LEN))
    for t in range(T):
        V[:, :, t:t + ATOM_LEN] += np.einsum('nm,mca->nca', H[:, :, t], W)
    return (V + 0.01 * rng.random(V.shape)).astype(np.float32)


def run(smoke: bool = False, device='cuda', use_pallas=None, dtype=torch.float32) -> dict:
    n_iterations = 15 if smoke else 120
    V = make_data()
    energies, seconds = {}, {}
    for label, kw in SOLVERS:
        np.random.seed(42)
        nmf = TransformInvariantNMF(n_atoms=N_ATOMS, atom_shape=(ATOM_LEN,),
                                    reconstruction_mode='full', device=device,
                                    use_pallas=use_pallas, dtype=dtype)
        synchronize(device)
        t0 = time.perf_counter()
        nmf.fit(V, n_iterations=n_iterations, record_energies=True, **kw)
        synchronize(device)
        seconds[label] = time.perf_counter() - t0
        energies[label] = np.asarray(nmf.energies_, np.float64)

    # the exact solver is monotone by construction
    es_cd = energies['exact CD (hals)']
    assert np.all(np.diff(es_cd) <= 1e-4 * es_cd[0]), 'CD must be monotone'
    return dict(energy={label: (float(e[0]), float(e[-1])) for label, e in energies.items()},
                seconds=seconds, plot=dict(energies=energies))


def lines(result: dict) -> list:
    return [f'{label:16s} E: {first:10.3f} -> {last:8.3f}  ({result["seconds"][label]:.2f} s)'
            for label, (first, last) in result['energy'].items()]


def plot(result: dict) -> None:
    plt = pyplot()
    if plt is None:
        return
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4), sharey=True)
    for label, es in result['plot']['energies'].items():
        ax1.semilogy(es, label=label)
        ax2.semilogy(np.linspace(0, result['seconds'][label], len(es)), es, label=label)
    ax1.set_xlabel('iteration')
    ax2.set_xlabel('seconds (whole fit)')
    ax1.set_ylabel('energy')
    ax1.legend()
    fig.suptitle('Shift-invariant solvers: per-iteration vs wall-clock')
    fig.tight_layout()
    plt.show()


def main() -> None:
    result = run(smoke=smoke_from_env())
    print('\n'.join(lines(result)))
    plot(result)


if __name__ == '__main__':
    main()
