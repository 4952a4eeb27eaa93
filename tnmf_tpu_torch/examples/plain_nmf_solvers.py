"""Classic (plain) NMF: racing the MU and HALS solvers.

Port of ``examples/plain_nmf_solvers.py``.  With
``reconstruction_mode='full'`` and ``atom_shape == sample_shape`` the shift
axis degenerates and the model IS standard NMF (``V ~ H @ W``): the engine
lowers every update to matrix products (the ``dot`` strategy).  In that
geometry two solvers are available:

* ``solver='mu'`` (default): Lee–Seung multiplicative updates — the
  reference's algorithm — optionally accelerated with ``extrapolate=True``;
* ``solver='hals'``: exact block coordinate descent (fast HALS — the
  algorithm behind sklearn's ``NMF(solver='cd')``), which typically needs
  far fewer iterations and cannot strand zeroed atoms.

This script fits the same seeded low-rank data with MU, extrapolated MU
and HALS, compares the energy trajectories, and then uses the fitted HALS
dictionary to encode held-out data (``transform(solver='hals')``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import TransformInvariantNMF
from ..utils.drawing import pyplot
from . import smoke_from_env

N_SAMPLES, N_FEATURES, N_COMPONENTS = 128, 192, 8
NOT_COMPARED = ()

#: the ground-truth generative dictionary, shared by train and held-out
#: draws so the learned atoms can actually explain the held-out samples
_W_TRUE = np.random.default_rng(7).random((N_COMPONENTS, N_FEATURES))


def make_data(seed=0):
    """Nonnegative rank-``N_COMPONENTS`` data (n_samples, 1, n_features)
    drawn from the shared ground-truth dictionary."""
    rng = np.random.default_rng(seed)
    X = rng.random((N_SAMPLES, N_COMPONENTS)) @ _W_TRUE
    return X.reshape(N_SAMPLES, 1, N_FEATURES).astype(np.float32)


def run(smoke: bool = False, device='cuda', use_pallas=None, dtype=torch.float32) -> dict:
    n_iterations = 20 if smoke else 150

    def make_model():
        return TransformInvariantNMF(n_atoms=N_COMPONENTS, atom_shape=(N_FEATURES,),
                                     reconstruction_mode='full', device=device,
                                     use_pallas=use_pallas, dtype=dtype)

    V = make_data()
    runs = {}
    for label, kwargs in [('MU', {}), ('HALS', dict(solver='hals'))]:
        np.random.seed(42)  # identical starting factors for every solver
        nmf = make_model()
        nmf.fit(V, n_iterations=n_iterations, record_energies=True, **kwargs)
        runs[label] = np.asarray(nmf.energies_, np.float64)

    # race all three to the same tolerance (adaptive loops — extrapolated
    # MU records no trace, so it joins the tol race only)
    race = {}
    for label, kwargs in [('MU', {}),
                          ('extrapolated MU', dict(extrapolate=True)),
                          ('HALS', dict(solver='hals'))]:
        np.random.seed(42)
        nmf = make_model()
        nmf.fit(V, n_iterations=20 * n_iterations, tol=1e-6, tol_check_every=5, **kwargs)
        race[label] = (nmf.n_iterations_, nmf._energy_function())

    # encode held-out data against the frozen HALS dictionary (exact
    # H-only coordinate sweeps — the serving path)
    V_new = make_data(seed=1)
    H_new = nmf.transform(V_new, n_iterations=50, solver='hals')
    R = H_new.reshape(len(V_new), -1) @ nmf.W.reshape(N_COMPONENTS, -1)
    rel = np.linalg.norm(V_new.reshape(len(V_new), -1) - R) / np.linalg.norm(V_new)
    return dict(n_iterations=n_iterations,
                energy_after={label: float(e[-1]) for label, e in runs.items()},
                tol_race=race, heldout_error=float(rel), plot=dict(runs=runs))


def lines(result: dict) -> list:
    out = [f'{label:16s} energy after {result["n_iterations"]} iterations: {e:.6f}'
           for label, e in result['energy_after'].items()]
    out += [f'{label:16s} tol=1e-6 reached after {n:5d} iterations (energy {e:.6f})'
            for label, (n, e) in result['tol_race'].items()]
    out.append(f'held-out encoding relative error: {result["heldout_error"]:.4f}')
    return out


def plot(result: dict) -> None:
    plt = pyplot()
    if plt is None:
        return
    plt.figure(figsize=(6, 4))
    for label, e in result['plot']['runs'].items():
        plt.semilogy(e, label=label)
    plt.xlabel('iteration')
    plt.ylabel('energy')
    plt.title('Plain NMF: solver comparison from the same start')
    plt.legend()
    plt.tight_layout()
    plt.show()


def main() -> None:
    result = run(smoke=smoke_from_env())
    print('\n'.join(lines(result)))
    plot(result)


if __name__ == '__main__':
    main()
