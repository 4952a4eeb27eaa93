"""Data-dependent dictionary initializations (``w_init=`` on the model).

Port of :mod:`tnmf_tpu.utils.initialization` (copied, not imported: the
port imports nothing of the JAX package):

* ``'patches'``: each atom is an atom-shaped window cut from the data at a
  random (sample, position), plus a floor of 1 % of the mean window level
  (zero is absorbing under MU).  The (sample, position) sequence comes from
  the host RNG in the JAX package's order, so a NumPy array gives the JAX
  package's bits; a tensor is cut where it lives, the windows stacked on
  its device, with no host copy of the data (one scalar, the mean, is read
  back).
* ``'nndsvd'``: sklearn's ``NMF(init='nndsvda')`` scheme (Boutsidis &
  Gallopoulos 2008, zeros filled with the data mean) for W and H, on the
  host in NumPy float64 with an exact SVD, as the JAX package computes it.
  Plain-NMF geometry only.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _randint(rng, n: int) -> int:
    """Uniform integer in [0, n) from either RNG API (the global
    ``np.random`` module or a ``Generator``)."""
    return int(rng.random() * n) if n > 1 else 0


def patches_init(V, n_atoms: int, atom_shape: Tuple[int, ...], rng):
    """Atom-shaped windows cut from random (sample, position) locations of
    ``V`` (an array, or a tensor on any device), plus a floor of 1 % of
    their mean; returned as ``V`` is (an array, or a tensor on its device)."""
    sample_shape = tuple(V.shape[2:])
    if any(a > s for a, s in zip(atom_shape, sample_shape)):
        raise ValueError(
            f"w_init='patches' needs atom_shape {tuple(atom_shape)} to fit "
            f'inside the samples {sample_shape}')
    windows = []
    for _ in range(n_atoms):
        i = _randint(rng, V.shape[0])
        sl = tuple(slice(st, st + a) for st, a in
                   ((_randint(rng, s - a + 1), a) for s, a in zip(sample_shape, atom_shape)))
        windows.append((i, slice(None)) + sl)
    if isinstance(V, torch.Tensor):
        W = torch.stack([V[w] for w in windows])
        floor = max(float(W.mean()), torch.finfo(W.dtype).tiny) * 0.01
        return W + floor
    W = np.empty((n_atoms, V.shape[1]) + tuple(atom_shape), dtype=np.asarray(V).dtype)
    for m, w in enumerate(windows):
        W[m] = V[w]
    floor = max(float(W.mean()), np.finfo(W.dtype).tiny) * 0.01
    return W + floor


def nndsvda_init(X: np.ndarray, k: int, eps: float = 1e-6) -> Tuple[np.ndarray, np.ndarray]:
    """NNDSVD with zero-filling by the data mean (the 'a' variant).

    ``X: (n, f)`` nonnegative; returns ``(A, B)`` with ``A: (n, k)``,
    ``B: (k, f)`` and ``X ~ A @ B``: sklearn's ``_initialize_nmf(X, k,
    init='nndsvda')`` recipe with an exact SVD (``np.linalg.svd``) where
    sklearn sketches, so the two agree on the leading triplet.  Entries
    below ``eps`` become the data mean, as in sklearn."""
    n, f = X.shape
    if k > min(n, f):
        raise ValueError(
            f"w_init='nndsvd' needs n_atoms <= min(n_samples, n_features) "
            f'= {min(n, f)}, got {k}')
    U, S, Vt = np.linalg.svd(X, full_matrices=False)
    A = np.zeros((n, k), dtype=X.dtype)
    B = np.zeros((k, f), dtype=X.dtype)
    A[:, 0] = np.sqrt(S[0]) * np.abs(U[:, 0])
    B[0] = np.sqrt(S[0]) * np.abs(Vt[0])
    for j in range(1, k):
        x, y = U[:, j], Vt[j]
        xp, xn = np.maximum(x, 0), np.maximum(-x, 0)
        yp, yn = np.maximum(y, 0), np.maximum(-y, 0)
        xp_norm, yp_norm = np.linalg.norm(xp), np.linalg.norm(yp)
        xn_norm, yn_norm = np.linalg.norm(xn), np.linalg.norm(yn)
        mp, mn = xp_norm * yp_norm, xn_norm * yn_norm
        if mp > mn:
            u, v, sigma = xp / (xp_norm or 1), yp / (yp_norm or 1), mp
        else:
            u, v, sigma = xn / (xn_norm or 1), yn / (yn_norm or 1), mn
        lbd = np.sqrt(S[j] * sigma)
        A[:, j] = lbd * u
        B[j] = lbd * v
    avg = X.mean()
    A[A < eps] = avg
    B[B < eps] = avg
    return A, B
