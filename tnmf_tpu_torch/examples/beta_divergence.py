"""Beta-divergence objectives: Euclidean vs KL vs Itakura-Saito fits.

Port of ``examples/beta_divergence.py``.  A nonnegative "spectrogram-like"
pulse train is decomposed under three objectives (``beta_loss=`` on the
model) and the learned reconstructions are compared:

* ``beta_loss=2`` (Frobenius) weights absolute errors — large-magnitude
  regions dominate the fit;
* ``beta_loss=1`` (generalized Kullback-Leibler) weights errors relative
  to sqrt-magnitude — the classic choice for count-like data;
* ``beta_loss=0`` (Itakura-Saito) is scale-invariant — low-energy structure
  matters as much as peaks, the standard objective for audio spectrograms.

Each fit records its divergence trace (``record_energies=True``) and
reports the final value of *all three* divergences for comparison.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import TransformInvariantNMF
from ..ops.beta import divergence
from ..utils.drawing import pyplot
from ..utils.signals import generate_pulse_train
from . import smoke_from_env

LOSSES = [('frobenius', 2.0), ('kullback-leibler', 1.0), ('itakura-saito', 0.0)]
NOT_COMPARED = ()


def run(smoke: bool = False, device='cuda', use_pallas=None, dtype=torch.float32) -> dict:
    n_iterations = 25 if smoke else 200
    rng = np.random.default_rng(42)
    np.random.seed(42)  # generate_pulse_train draws from the global stream
    V = np.stack([generate_pulse_train(n_pulses=5)[0] for _ in range(8)])
    # Itakura-Saito requires strictly positive data; add a noise floor that
    # also makes the fit more realistic for spectrogram-like inputs.
    V = V.astype(np.float64) + 0.01 * (1 + rng.random(V.shape))

    fits, R0 = {}, {}
    for name, _ in LOSSES:
        nmf = TransformInvariantNMF(
            n_atoms=3, atom_shape=(20,), beta_loss=name, seed=7,
            reconstruction_mode='valid', device=device, use_pallas=use_pallas, dtype=dtype)
        nmf.fit(V, n_iterations=n_iterations, record_energies=True)
        R = nmf.R
        energies = np.asarray(nmf.energies_, np.float64)
        # every objective's own trace must be monotone non-increasing
        # (float32 fit: allow roundoff wiggle)
        assert np.all(np.diff(energies) <= 1e-5 * max(1.0, energies[0]))
        fits[name] = dict(trace=(float(energies[0]), float(energies[-1])),
                          divergences={n: float(divergence(torch.from_numpy(V),
                                                         torch.as_tensor(R, dtype=torch.float64), b))
                                       for n, b in LOSSES})
        R0[name] = R[0]
    return dict(fits=fits, plot=dict(V0=V[0], R0=R0))


def lines(result: dict) -> list:
    return [f'{name:17s} trace {fit["trace"][0]:10.3f} -> {fit["trace"][1]:10.3f} | '
            'final divergences: '
            + '  '.join(f'{n}={v:.3f}' for n, v in fit['divergences'].items())
            for name, fit in result['fits'].items()]


def plot(result: dict) -> None:
    plt = pyplot()
    if plt is None:
        return
    data = result['plot']
    fig, axes = plt.subplots(len(LOSSES) + 1, 1, figsize=(9, 8), sharex=True)
    axes[0].plot(data['V0'].T)
    axes[0].set_ylabel('data')
    for ax, (name, _) in zip(axes[1:], LOSSES):
        ax.plot(data['R0'][name].T)
        ax.set_ylabel(name)
    axes[-1].set_xlabel('sample position')
    fig.suptitle('Reconstructions under the beta-divergence family')
    fig.tight_layout()
    plt.show()


def main() -> None:
    result = run(smoke=smoke_from_env())
    print('\n'.join(lines(result)))
    plot(result)


if __name__ == '__main__':
    main()
