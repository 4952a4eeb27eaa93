"""Dictionary health: finding and reviving dead atoms.

Port of ``_atom_mass``, ``find_dead_atoms`` and ``revive_dead_atoms`` of
:mod:`tnmf_tpu.utils.atoms` (copied, not imported: importing the JAX
package loads JAX).  Multiplicative updates have an absorbing state: once an
atom's activation map collapses to about 0 neither it nor the atom grows
back.  Revival re-draws the dead atoms and their activation maps from the
model's RNG, in the JAX package's order, so seeded fits of both packages
revive the same atoms with the same values::

    nmf.fit(V, n_iterations=200, sparsity_H=2.0)
    while revive_dead_atoms(nmf).size:
        nmf.fit(V, n_iterations=200, sparsity_H=2.0, keep_W=True, keep_H=True)

An atom is dead when its activation mass is below ``rel_threshold`` times
the mean atom mass, so the test is free of the scale of V and of the sample
count.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ['find_dead_atoms', 'revive_dead_atoms']


def _atom_mass(model) -> np.ndarray:
    """Total activation mass per atom, summed over samples and shifts (on
    the host, in H's dtype)."""
    H = model._H.cpu().numpy()
    return H.sum(axis=(0,) + tuple(range(2, H.ndim)))


def find_dead_atoms(model, rel_threshold: float = 1e-4) -> np.ndarray:
    """Indices of the atoms whose activation mass is below
    ``rel_threshold`` times the mean atom mass of the last fit."""
    if model._H is None:
        raise RuntimeError('find_dead_atoms requires a fitted model')
    mass = _atom_mass(model)
    return np.flatnonzero(mass < rel_threshold * max(mass.mean(), 1e-30))


def revive_dead_atoms(model, rel_threshold: float = 1e-4,
                      rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Re-draw the dead atoms' dictionary entries (``1 - U[0, 1)``,
    sum-normalised, the init distribution) and their activation maps
    (``1 - U[0, 1)``) from ``rng`` (default: the model's own), atom by
    atom; returns the revived indices.  Living atoms and their activations
    are untouched; refit with ``keep_W=True, keep_H=True`` to continue."""
    dead = find_dead_atoms(model, rel_threshold)
    if dead.size == 0:
        return dead
    draw = rng if rng is not None else model._rng
    W = model._W.cpu().numpy().copy()
    H = model._H.cpu().numpy().copy()
    atom_axes = tuple(range(-len(model.atom_shape), 0))
    for m in dead:
        Wm = 1 - draw.random(W.shape[1:])
        W[m] = Wm / Wm.sum(axis=atom_axes, keepdims=True)
        H[:, m:m + 1] = 1 - draw.random((H.shape[0], 1) + H.shape[2:])
    model._W = model._tensor(W)
    model._H = model._tensor(H)
    return dead
