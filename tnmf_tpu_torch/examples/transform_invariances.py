"""Transform invariances beyond shift: flip- and rotation-tied dictionaries.

Port of ``examples/transform_invariances.py``.  The reference library
supports shift invariance only; ``transform_type=`` ties each canonical
atom across a finite set of mirror flips and/or quarter-turn rotations,
with one shift-activation map per (atom, transform) pair — see
:mod:`tnmf_tpu_torch.ops.transforms`.

The demonstration plants ONE asymmetric L-shaped patch into 2-D samples in
all 8 of its dihedral (D4) orientations and compares:

* a shift-only model with a single atom — it can explain one orientation
  and mis-fits the other seven;
* a shift-only model with 8 atoms — it works, but has to learn 8 separate
  copies of the same shape (8x the dictionary, no parameter sharing);
* a ``shift+rot90+flip`` model with a single atom — one canonical patch,
  tied across its 8 transformed copies, matches the 8-atom fit with 1/8th
  of the dictionary.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import TransformInvariantNMF
from ..ops import transforms as tr
from ..utils.drawing import pyplot
from . import smoke_from_env

# enough sparsity pressure that a degenerate single-pixel atom (which can
# re-draw anything through a dense H) is more expensive than learning the
# actual patch shape — that is what makes the comparison meaningful
SPARSITY = 0.2
NOT_COMPARED = ()
RUNS = (('shift, 1 atom', 1, 'shift'), ('shift, 8 atoms', 8, 'shift'),
        ('shift+rot90+flip, 1 atom', 1, 'shift+rot90+flip'))


def make_data(n_samples=16, size=32, seed=0):
    """Samples containing an asymmetric L-shaped patch in all 8 dihedral
    orientations at random positions."""
    rng = np.random.default_rng(seed)
    patch = np.zeros((5, 5))
    patch[:, 0] = 1.0   # vertical bar
    patch[-1, :3] = 0.6  # short foot: breaks every mirror/rotation symmetry
    patch[0, 1] = 0.3
    V = np.zeros((n_samples, 1, size, size))
    for i in range(n_samples):
        p = np.rot90(patch, k=i % 4)
        if (i // 4) % 2:
            p = np.flip(p, axis=-1)
        for _ in range(3):
            y, x = rng.integers(0, size - 5, size=2)
            V[i, 0, y:y + 5, x:x + 5] += p
    return V


def run(smoke: bool = False, device='cuda', use_pallas=None, dtype=torch.float32) -> dict:
    n_iterations = 150 if smoke else 500
    V = make_data()
    runs, tied = {}, None
    for label, n_atoms, transform_type in RUNS:
        model = TransformInvariantNMF(
            n_atoms=n_atoms, atom_shape=(5, 5), transform_type=transform_type,
            seed=7, reconstruction_mode='valid', device=device, use_pallas=use_pallas,
            dtype=dtype)
        model.fit(V, n_iterations=n_iterations, sparsity_H=SPARSITY)
        runs[label] = (model._energy_function(), model.W.size,
                       model.n_atoms * model.n_transforms)
        tied = model
    return dict(runs=runs, plot=dict(W=tied.W[0, 0], H0=tied.H[0, 0]))


def lines(result: dict) -> list:
    return [f'{label:28s} energy {e:10.3f}   dictionary parameters {n_params:4d}   '
            f'H maps {n_maps}' for label, (e, n_params, n_maps) in result['runs'].items()]


def plot(result: dict) -> None:
    plt = pyplot()
    if plt is None:
        return
    W, H0 = result['plot']['W'], result['plot']['H0']
    fig, axes = plt.subplots(2, 8, figsize=(14, 4))
    group = tr.make_group('shift+rot90+flip', (5, 5))
    for g, (elem, ax) in enumerate(zip(group.elements, axes[0])):
        copy = tr.apply(torch.as_tensor(W)[None, None], elem, 2, 2)[0, 0].numpy()
        ax.imshow(copy, cmap='viridis')
        ax.set_title(f'T{g}(atom)', fontsize=8)
        ax.axis('off')
    for g, ax in enumerate(axes[1]):
        ax.imshow(H0[g], cmap='magma')
        ax.set_title(f'H[0, 0, {g}]', fontsize=8)
        ax.axis('off')
    fig.suptitle('One canonical atom, tied across the 8 dihedral transforms')
    fig.tight_layout()
    plt.show()


def main() -> None:
    result = run(smoke=smoke_from_env())
    print('\n'.join(lines(result)))
    plot(result)


if __name__ == '__main__':
    main()
