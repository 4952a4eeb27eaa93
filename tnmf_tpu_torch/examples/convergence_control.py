"""Early stopping: the progress-callback protocol vs ``tol``.

Port of ``examples/convergence_control.py`` (the reference's
convergence_control example): the ``(model, iteration) -> bool`` callback
inspects the reconstruction energy every iteration and aborts the fit once
it drops below a threshold.

A second fit shows the alternative: ``fit(tol=...)`` checks convergence
every ``tol_check_every`` iterations inside the fit, reading the device
once per block where the callback protocol reads it every iteration; a
third accelerates it with ``extrapolate=True``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import TransformInvariantNMF
from ..utils.drawing import pyplot
from ..utils.signals import generate_pulse_train
from . import smoke_from_env

NOT_COMPARED = ()


def run(smoke: bool = False, device='cuda', use_pallas=None, dtype=torch.float32) -> dict:
    # stop once the energy has dropped to this fraction of its starting value
    threshold = 0.05 if smoke else 0.001
    model = dict(device=device, use_pallas=use_pallas, dtype=dtype)
    np.random.seed(42)
    signal, W_true = generate_pulse_train(pulse_length=20, n_pulses=5)
    V = signal[np.newaxis]

    energies, iterations = [], []

    def progress_callback(nmf: TransformInvariantNMF, iteration: int) -> bool:
        e = nmf._energy_function()
        energies.append(e)
        iterations.append(iteration)
        return e > energies[0] * threshold

    nmf = TransformInvariantNMF(n_atoms=len(W_true), atom_shape=(20,), **model)
    nmf.fit(V, n_iterations=1000, progress_callback=progress_callback)

    # the same idea with one device read per block: sklearn-style tol,
    # checked every tol_check_every iterations
    np.random.seed(42)
    nmf_tol = TransformInvariantNMF(n_atoms=len(W_true), atom_shape=(20,), **model)
    nmf_tol.fit(V, n_iterations=1000, tol=1e-4, tol_check_every=10)

    # accelerate the same adaptive fit: extrapolated MU (multiplicative
    # momentum with safeguard restarts) typically reaches the tolerance in
    # substantially fewer iterations, often at a lower energy
    np.random.seed(42)
    nmf_xtr = TransformInvariantNMF(n_atoms=len(W_true), atom_shape=(20,), **model)
    nmf_xtr.fit(V, n_iterations=1000, tol=1e-4, tol_check_every=10, extrapolate=True)
    return dict(iterations=iterations, energies=energies, stopped_after=len(energies),
                tol=(nmf_tol.n_iterations_, nmf_tol._energy_function()),
                extrapolated=(nmf_xtr.n_iterations_, nmf_xtr._energy_function()),
                plot=dict(threshold=energies[0] * threshold))


def lines(result: dict) -> list:
    out = [f'iteration {i:4d}  energy {e:.6f}'
           for i, e in zip(result['iterations'], result['energies'])]
    out.append(f'stopped after {result["stopped_after"]} iterations at energy '
               f'{result["energies"][-1]:.6f}')
    n, e = result['tol']
    out.append(f'tol=1e-4 fit stopped after {n} iterations at energy {e:.6f}')
    n, e = result['extrapolated']
    out.append(f'extrapolated tol fit stopped after {n} iterations at energy {e:.6f}')
    return out


def plot(result: dict) -> None:
    plt = pyplot()
    if plt is None:
        return
    plt.figure(figsize=(6, 4))
    plt.semilogy(result['energies'])
    plt.axhline(result['plot']['threshold'], color='r', ls='--', label='threshold')
    plt.xlabel('iteration')
    plt.ylabel('energy')
    plt.legend()
    plt.tight_layout()
    plt.show()


def main() -> None:
    result = run(smoke=smoke_from_env())
    print('\n'.join(lines(result)))
    plot(result)


if __name__ == '__main__':
    main()
