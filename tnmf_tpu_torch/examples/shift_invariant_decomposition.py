"""Shift-invariant decomposition of a 2-D block image with lateral inhibition.

Port of ``examples/shift_invariant_decomposition.py`` (the reference
example of the same name): learns a patch dictionary of a synthetic block
image in 'circular' reconstruction mode with same-atom inhibition, scores
the learned atoms against the ground-truth patches, then plots both and the
reconstruction.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import TransformInvariantNMF
from ..utils.atoms import match_dictionaries
from ..utils.drawing import pyplot
from ..utils.signals import generate_block_image
from . import smoke_from_env

NOT_COMPARED = ()


def run(smoke: bool = False, device='cuda', use_pallas=None, dtype=torch.float32) -> dict:
    n_iterations = 10 if smoke else 100
    np.random.seed(42)

    # synthesize a 5x5-patch image from three grayscale symbols
    image, W_true = generate_block_image(symbols=['+', 'x', 's'], symbol_size=10, n_symbols=5)
    V = image[np.newaxis]

    nmf = TransformInvariantNMF(
        n_atoms=len(W_true),
        atom_shape=W_true.shape[-2:],
        reconstruction_mode='circular',
        verbose=2, device=device, use_pallas=use_pallas, dtype=dtype,
    )
    nmf.fit(V, n_iterations=n_iterations, inhibition_strength=0.01)

    # quantitative ground-truth recovery: shift-invariant optimal matching
    # of the learned atoms onto the generating dictionary (the reference's
    # examples can only eyeball the atom plots)
    W = nmf.W
    rec = match_dictionaries(W, W_true)
    return dict(energy=nmf._energy_function(), score=rec['score'],
                assignment=rec['assignment'].tolist(),
                plot=dict(W_true=W_true, W=W, V=V, R=nmf.R))


def lines(result: dict) -> list:
    return [f'final energy: {result["energy"]:.4f}',
            f'dictionary recovery score: {result["score"]:.3f} '
            f'(assignment {result["assignment"]})']


def plot(result: dict) -> None:
    plt = pyplot()
    if plt is None:
        return
    d = result['plot']
    W_true, W, V, R = d['W_true'], d['W'], d['V'], d['R']
    n = len(W)
    fig, axes = plt.subplots(2, n, figsize=(2 * n, 4))
    for i in range(n):
        axes[0, i].imshow(W_true[i, 0], cmap='gray')
        axes[0, i].set_title(f'true atom {i}')
        axes[1, i].imshow(W[i, 0], cmap='gray')
        axes[1, i].set_title(f'learned atom {i}')
        for ax in axes[:, i]:
            ax.axis('off')
    fig.tight_layout()

    fig, axes = plt.subplots(1, 2, figsize=(8, 4))
    axes[0].imshow(np.moveaxis(V[0], 0, -1) if V.shape[1] == 3 else V[0, 0], cmap='gray')
    axes[0].set_title('input')
    axes[1].imshow(np.moveaxis(R[0], 0, -1) if V.shape[1] == 3 else R[0, 0], cmap='gray')
    axes[1].set_title('reconstruction')
    for ax in axes:
        ax.axis('off')
    fig.tight_layout()
    plt.show()


def main() -> None:
    result = run(smoke=smoke_from_env())
    print('\n'.join(lines(result)))
    plot(result)


if __name__ == '__main__':
    main()
