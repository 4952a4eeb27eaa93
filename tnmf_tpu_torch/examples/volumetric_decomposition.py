"""3-D (volumetric) shift-invariant decomposition.

Port of ``examples/volumetric_decomposition.py``.  Demonstrates that the
model is rank-agnostic: a stack of synthetic volumes containing randomly
placed 3-D blobs is factorized into volumetric atoms.  (The reference's
coordinate-space backend capped out at 3-D and its tests only exercised
1-D/2-D.)  On the card, 3-D problems run the plain versions of the
convolution kernels (the kernels cover one and two shift axes) and K1's W
epilogue, which takes any rank.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import TransformInvariantNMF
from . import smoke_from_env

NOT_COMPARED = ()


def make_volumes(n_samples=3, size=16, n_blobs=4, blob=5):
    """Volumes containing randomly placed copies of two blob shapes."""
    g = np.arange(blob) - (blob - 1) / 2
    zz, yy, xx = np.meshgrid(g, g, g, indexing='ij')
    r2 = zz ** 2 + yy ** 2 + xx ** 2
    sphere = np.maximum(0, 1 - r2 / ((blob / 2) ** 2))
    cross = ((np.abs(zz) < 1) & (np.abs(yy) < 1)) | \
            ((np.abs(yy) < 1) & (np.abs(xx) < 1))
    atoms = np.stack([sphere, cross.astype(float)])

    V = np.zeros((n_samples, 1, size, size, size))
    rng = np.random.default_rng(0)
    for n in range(n_samples):
        for _ in range(n_blobs):
            a = rng.integers(len(atoms))
            pos = rng.integers(0, size - blob, size=3)
            sl = (n, 0) + tuple(slice(p, p + blob) for p in pos)
            V[sl] += atoms[a]
    return V, atoms


def run(smoke: bool = False, device='cuda', use_pallas=None, dtype=torch.float32) -> dict:
    n_iterations = 10 if smoke else 200
    np.random.seed(42)
    V, true_atoms = make_volumes()

    nmf = TransformInvariantNMF(n_atoms=2, atom_shape=(5, 5, 5), verbose=2, device=device,
                                use_pallas=use_pallas, dtype=dtype)
    nmf.fit(V, n_iterations=n_iterations, sparsity_H=0.05, record_energies=True)

    # crude recovery check: correlate learned atoms with ground truth
    W = nmf.W
    matches = []
    for i in range(2):
        learned = W[i, 0]
        matches.append(max(
            float(np.sum(learned / np.linalg.norm(learned) * t / np.linalg.norm(t)))
            for t in true_atoms))
    return dict(energy=(float(nmf.energies_[0]), float(nmf.energies_[-1]),
                        len(nmf.energies_)),
                atom_shapes=tuple(W.shape), matches=matches)


def lines(result: dict) -> list:
    first, last, n = result['energy']
    out = [f'energy: {first:.3f} -> {last:.3f} over {n} iterations',
           f'learned atom shapes: {result["atom_shapes"]}']
    out += [f'atom {i}: best cosine match to a true blob = {m:.3f}'
            for i, m in enumerate(result['matches'])]
    return out


def plot(result: dict) -> None:
    """The JAX example draws nothing."""


def main() -> None:
    result = run(smoke=smoke_from_env())
    print('\n'.join(lines(result)))
    plot(result)


if __name__ == '__main__':
    main()
