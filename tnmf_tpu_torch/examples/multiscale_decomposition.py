"""Multi-scale dictionaries: atoms of different sizes in one model.

Port of ``examples/multiscale_decomposition.py``.  The reference library
fixes a single ``atom_shape`` per model — data whose structure lives at
several scales (sharp spikes riding on broad waves) forces a compromise
atom size.  :class:`tnmf_tpu_torch.MultiScaleTNMF` learns a *tuple* of atom
banks with independent shapes jointly, each with its own activation
tensor, optimized by exact block multiplicative updates against the shared
total reconstruction.

This example plants narrow spikes and broad Gaussian bumps in 1-D signals
and decomposes them with a (3-tap, 15-tap) dictionary pair: each planted
pulse is recovered in the bank of its native scale, and the per-scale
reconstructions separate the signal into its spike and wave components.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import MultiScaleTNMF
from ..utils.drawing import pyplot
from . import smoke_from_env

NOT_COMPARED = ()
SCALES = ('narrow', 'broad')


def run(smoke: bool = False, device='cuda', use_pallas=None, dtype=torch.float32) -> dict:
    n_iterations = 200 if smoke else 600
    rng = np.random.default_rng(0)
    narrow = np.array([0.2, 1.0, 0.2])
    broad = np.exp(-0.5 * ((np.arange(15) - 7) / 3.0) ** 2)
    V = np.zeros((6, 1, 80))
    for i in range(6):
        for at in rng.integers(0, 77, size=4):
            V[i, 0, at:at + 3] += narrow
        for at in rng.integers(0, 65, size=2):
            V[i, 0, at:at + 15] += broad

    model = MultiScaleTNMF(n_atoms=(1, 1), atom_shapes=((3,), (15,)), seed=1, dtype=dtype,
                           device=device, use_pallas=use_pallas)
    # more sparsity pressure on the narrow bank: scale separation in conv
    # models is regularization-driven (narrow atoms could tile the bumps)
    model.fit(V, n_iterations=n_iterations, sparsity_H=(0.3, 0.05), record_energies=True)
    W, H = model.W, model.H
    return dict(energy=(float(model.energies_[-1]), float(model.energies_[0])),
                scales=[(tuple(W[k].shape), tuple(H[k].shape)) for k in range(len(SCALES))],
                plot=dict(V0=V[0, 0], parts=[model.R_scale(k)[0, 0] for k in range(2)],
                          atoms=[W[k][0, 0] for k in range(2)], truth=[narrow, broad]))


def lines(result: dict) -> list:
    last, first = result['energy']
    out = [f'final energy: {last:.4f} (from {first:.4f})']
    out += [f'scale {k} ({name}): atoms {w}, activations {h}'
            for k, (name, (w, h)) in enumerate(zip(SCALES, result['scales']))]
    return out


def plot(result: dict) -> None:
    plt = pyplot()
    if plt is None:
        return
    d = result['plot']
    fig, axes = plt.subplots(3, 1, figsize=(10, 6), sharex=True)
    axes[0].plot(d['V0'], 'k', lw=1)
    axes[0].set_title('signal (spikes + waves)')
    for ax, part, name in zip(axes[1:], d['parts'], ('narrow-scale part', 'broad-scale part')):
        ax.plot(part, lw=1)
        ax.set_title(name)
    fig.tight_layout()

    fig2, ax2 = plt.subplots(1, 2, figsize=(8, 2.5))
    for ax, atom, truth, name in zip(ax2, d['atoms'], d['truth'],
                                     ('3-tap atom', '15-tap atom')):
        ax.plot(atom, label='learned')
        ax.plot(truth / truth.sum(), '--', label='planted (normalized)')
        ax.set_title(name)
        ax.legend(fontsize=7)
    fig2.tight_layout()
    plt.show()


def main() -> None:
    result = run(smoke=smoke_from_env())
    print('\n'.join(lines(result)))
    plot(result)


if __name__ == '__main__':
    main()
