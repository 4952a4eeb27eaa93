"""Convergence / CPU-time comparison of the five minibatch MU algorithms.

Port of ``examples/minibatch_algorithms.py`` (the reference's
minibatch_algorithms example).  The reference used an ECG recording
(scipy.misc.electrocardiogram, no longer downloadable offline); here the
sample set is a stack of synthetic multi-channel pulse trains with the same
structure: many short 1-D samples sharing a common dictionary.
"""

from __future__ import annotations

from time import process_time

import numpy as np
import torch

from .. import MiniBatchAlgorithm, TransformInvariantNMF
from ..utils.drawing import pyplot
from ..utils.signals import generate_pulse_train
from . import smoke_from_env

ENERGY_THRESHOLD = 50.0
#: the process time each run took
NOT_COMPARED = ('cpu_time',)


def make_samples(n_samples: int = 30) -> np.ndarray:
    np.random.seed(42)
    return np.stack([
        generate_pulse_train(pulse_length=20, n_pulses=3)[0] for _ in range(n_samples)])


def _run_one(V: np.ndarray, algorithm, max_epochs: int, model: dict) -> dict:
    energies, times = [], []

    def cb(nmf, epoch) -> bool:
        energies.append(nmf._energy_function())
        times.append(process_time())
        return energies[-1] > ENERGY_THRESHOLD

    np.random.seed(7)
    nmf = TransformInvariantNMF(n_atoms=5, atom_shape=(20,), **model)
    t0 = process_time()
    if algorithm is None:
        nmf.fit(V, n_iterations=max_epochs, progress_callback=cb)
    else:
        nmf.fit(V, algorithm=algorithm, batch_size=5, n_epochs=max_epochs,
                sag_lambda=0.8, progress_callback=cb)
    times = [t - t0 for t in times]
    return dict(epochs=len(energies), final_energy=energies[-1], cpu_time=times[-1],
                plot=dict(energies=energies, times=times))


def run(smoke: bool = False, device='cuda', use_pallas=None, dtype=torch.float32) -> dict:
    max_epochs = 5 if smoke else 40
    model = dict(device=device, use_pallas=use_pallas, dtype=dtype)
    V = make_samples()
    runs = {'full batch': _run_one(V, None, max_epochs, model)}
    for algorithm in MiniBatchAlgorithm:
        runs[algorithm.name] = _run_one(V, algorithm, max_epochs, model)
    return dict(runs=runs)


def lines(result: dict) -> list:
    return [f'{name:12s} epochs={r["epochs"]:3d} final_energy={r["final_energy"]:10.3f} '
            f'cpu_time={r["cpu_time"]:6.2f}s' for name, r in result['runs'].items()]


def plot(result: dict) -> None:
    plt = pyplot()
    if plt is None:
        return
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    for name, r in result['runs'].items():
        axes[0].semilogy(r['plot']['energies'], label=name)
        axes[1].semilogy(r['plot']['times'], r['plot']['energies'], label=name)
    axes[0].set_xlabel('epoch')
    axes[1].set_xlabel('process time [s]')
    for ax in axes:
        ax.set_ylabel('energy')
        ax.legend(fontsize=8)
    fig.tight_layout()
    plt.show()


def main() -> None:
    result = run(smoke=smoke_from_env())
    print('\n'.join(lines(result)))
    plot(result)


if __name__ == '__main__':
    main()
