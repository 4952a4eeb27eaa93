"""Dictionary health and comparison: dead atoms, and atom matching.

Port of :mod:`tnmf_tpu.utils.atoms` (copied, not imported: importing the
JAX package loads JAX).  Multiplicative updates have an absorbing state: once an
atom's activation map collapses to about 0 neither it nor the atom grows
back.  Revival re-draws the dead atoms and their activation maps from the
model's RNG, in the JAX package's order, so seeded fits of both packages
revive the same atoms with the same values::

    nmf.fit(V, n_iterations=200, sparsity_H=2.0)
    while revive_dead_atoms(nmf).size:
        nmf.fit(V, n_iterations=200, sparsity_H=2.0, keep_W=True, keep_H=True)

An atom is dead when its activation mass is below ``rel_threshold`` times
the mean atom mass, so the test is free of the scale of V and of the sample
count.  Under a transform group an atom's mass sums its G maps, and
revival re-draws all of them.

:func:`atom_similarity` and :func:`match_dictionaries` score two
dictionaries up to the gauge freedoms of transform-invariant NMF (atom
order, scale, shifts and the transforms of ``transform_type``), on the host
with SciPy, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.transforms import make_group

__all__ = ['find_dead_atoms', 'revive_dead_atoms', 'atom_similarity',
           'match_dictionaries']


def _atom_mass(model) -> np.ndarray:
    """Total activation mass per canonical atom, summed over samples,
    shifts and (under a transform group) the atom's G maps (on the host,
    in H's dtype)."""
    H = model._H.cpu().numpy()
    g = model.n_transforms
    mass = H.sum(axis=(0,) + tuple(range(2, H.ndim)))  # (n_atoms * g,)
    return mass.reshape(model.n_atoms, g).sum(axis=1)


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
    (``1 - U[0, 1)``, all G maps of an atom under a transform group) from
    ``rng`` (default: the model's own), atom by atom; returns the revived
    indices.  Living atoms and their activations
    are untouched; refit with ``keep_W=True, keep_H=True`` to continue."""
    dead = find_dead_atoms(model, rel_threshold)
    if dead.size == 0:
        return dead
    draw = rng if rng is not None else model._rng
    W = model._W.cpu().numpy().copy()
    H = model._H.cpu().numpy().copy()
    atom_axes = tuple(range(-len(model.atom_shape), 0))
    g = model.n_transforms
    for m in dead:
        Wm = 1 - draw.random(W.shape[1:])
        W[m] = Wm / Wm.sum(axis=atom_axes, keepdims=True)
        H[:, m * g:(m + 1) * g] = 1 - draw.random((H.shape[0], g) + H.shape[2:])
    model._W = model._tensor(W)
    model._H = model._tensor(H)
    return dead


# ---------------------------------------------------------------------------
# dictionary comparison and recovery scoring
# ---------------------------------------------------------------------------

def _transform_variants(w: np.ndarray, transform_type) -> list:
    """Every transformed copy of one atom ``w (C, *A)`` under the group of
    ``transform_type`` (NumPy mirror of :func:`tnmf_tpu_torch.ops.transforms.apply`)."""
    group = make_group(transform_type, w.shape[1:])
    if group is None:
        return [w]
    out = []
    for k, flips in group.elements:
        x = w
        if k % 4:
            x = np.rot90(x, k, axes=(w.ndim - 2, w.ndim - 1))
        if flips:
            x = np.flip(x, axis=tuple(1 + a for a in flips))
        out.append(np.ascontiguousarray(x))
    return out


def atom_similarity(a, b, transform_type='shift') -> float:
    """Transform-invariant similarity of two atoms (``(C, *A)`` arrays or
    tensors, shapes may differ) in ``[0, 1]``: the maximum over all
    relative shifts (and the transforms of ``transform_type``) of the
    normalised cross-correlation ``<a, T(b)> / (||a|| ||b||)``, summed over
    the channels; 1 exactly when ``b`` is a scaled, shifted (and
    transformed) copy of ``a``."""
    from scipy.signal import correlate

    a = _host(a)
    na = np.linalg.norm(a)
    best = 0.0
    for bt in _transform_variants(_host(b), transform_type):
        nb = np.linalg.norm(bt)
        if na == 0 or nb == 0:
            continue
        c = sum(correlate(a[ch], bt[ch], mode='full') for ch in range(a.shape[0]))
        best = max(best, float(np.max(c)) / (na * nb))
    return min(best, 1.0)


def match_dictionaries(W_a, W_b, transform_type='shift') -> dict:
    """The best one-to-one matching of two dictionaries (Hungarian
    algorithm on the pairwise :func:`atom_similarity`), invariant to atom
    order, scale, shifts and the transforms of ``transform_type``.

    Returns ``assignment`` (for each atom of ``W_a`` the matched index into
    ``W_b``, -1 where ``W_b`` has fewer atoms), ``scores`` (per matched
    pair), ``score`` (their mean) and ``similarity`` (the matrix)."""
    from scipy.optimize import linear_sum_assignment

    W_a = [_host(w) for w in W_a]
    W_b = [_host(w) for w in W_b]
    S = np.zeros((len(W_a), len(W_b)))
    for i, wa in enumerate(W_a):
        for j, wb in enumerate(W_b):
            S[i, j] = atom_similarity(wa, wb, transform_type)
    rows, cols = linear_sum_assignment(-S)
    assignment = np.full(len(W_a), -1, dtype=int)
    assignment[rows] = cols
    scores = S[rows, cols]
    return {'assignment': assignment, 'scores': scores,
            'score': float(scores.mean()) if scores.size else 0.0,
            'similarity': S}


def _host(w) -> np.ndarray:
    """An atom as a float64 NumPy array (a tensor is copied to the host:
    atoms are small)."""
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    return np.asarray(w, np.float64)
