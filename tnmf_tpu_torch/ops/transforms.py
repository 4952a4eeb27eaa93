"""Transform groups beyond shifts: flip- and rotation-invariant dictionaries.

Port of :mod:`tnmf_tpu.ops.transforms` (copied, not imported: importing the
JAX package loads JAX).  A dictionary atom is matched under mirror flips
and/or quarter-turn rotations as well as shifts, with one activation map
per (atom, transform) pair::

    R[n] = sum_{m, g}  H[n, m, g] * conv( T_g(W[m]) )

Only the canonical ``W`` is learned.  Every ``T_g`` permutes the atom grid,
so the W gradient of the tied reconstruction pulls back exactly as
``sum_g T_g^{-1}(dE/dW_exp[m, g])`` and keeps its nonnegative
``(neg, pos)`` split: the MU step on the canonical ``W`` stays valid.

The group wraps a base strategy ('conv', 'fft' or 'dot'): the engine's
``strategy`` becomes the tuple ``(base, TransformGroup)`` and
:class:`GroupOps` runs the base operators on the expanded dictionary
``W_exp (M*G, C, *A)``, laid out m-major (``W_exp[m*G + g] = T_g(W[m])``, so
H's ``M*G`` maps reshape to ``(n_samples, n_atoms, n_transforms, *shift)``),
and ties the W statistics back to ``(M, C, *A)``.  The kernels K1-K4 are not
changed by a group: K3, K4 and K2 take the ``M*G`` maps as they take any
atom count, ``mu_w`` the canonical W.
"""

from __future__ import annotations

import dataclasses
from itertools import chain, combinations
from typing import Optional, Tuple

import torch

# One group element: (k, flip_axes): rotate by k quarter turns in the plane
# of the LAST TWO shift axes, then flip along each listed shift axis (axis
# indices are 0-based within the shift dimensions).
Element = Tuple[int, Tuple[int, ...]]

TRANSFORM_TYPES = ('shift', 'shift+flip', 'shift+rot90', 'shift+rot90+flip')


@dataclasses.dataclass(frozen=True)
class TransformGroup:
    """A finite set of orthogonal atom-grid transforms (hashable, so the
    ``(strategy, group)`` tuple can key caches)."""
    name: str
    ndim: int
    elements: Tuple[Element, ...]

    @property
    def size(self) -> int:
        return len(self.elements)


def _rot_axes(first_axis: int, ndim: int) -> Tuple[int, int]:
    """The rotation plane: the last two shift axes of a tensor whose shift
    dimensions start at ``first_axis``."""
    return (first_axis + ndim - 2, first_axis + ndim - 1)


def apply(x: torch.Tensor, elem: Element, first_axis: int, ndim: int) -> torch.Tensor:
    """Apply one group element to the shift axes of ``x`` (rotate, then flip)."""
    k, flips = elem
    if k % 4:
        x = torch.rot90(x, k, dims=_rot_axes(first_axis, ndim))
    if flips:
        x = torch.flip(x, dims=tuple(first_axis + a for a in flips))
    return x


def apply_inverse(x: torch.Tensor, elem: Element, first_axis: int, ndim: int) -> torch.Tensor:
    """Apply the inverse element (un-flip, then rotate back); the transforms
    are permutations, so this is also the adjoint ``T^T``."""
    k, flips = elem
    if flips:
        x = torch.flip(x, dims=tuple(first_axis + a for a in flips))
    if k % 4:
        x = torch.rot90(x, -k, dims=_rot_axes(first_axis, ndim))
    return x


def make_group(transform_type, atom_shape: Tuple[int, ...]) -> Optional[TransformGroup]:
    """The :class:`TransformGroup` of a transform-type string, ``None`` for
    ``'shift'`` (the reference's model).  A :class:`TransformGroup` passes
    through unchanged (any finite set of grid permutations gives a valid
    tied MU step; closure is not required)."""
    if isinstance(transform_type, TransformGroup):
        return transform_type
    ndim = len(atom_shape)
    if transform_type == 'shift':
        return None
    if transform_type not in TRANSFORM_TYPES:
        raise ValueError(
            f'unknown transform type {transform_type!r}; '
            f'choose one of {TRANSFORM_TYPES} or pass a TransformGroup')
    if 'rot90' in transform_type:
        if ndim < 2:
            raise ValueError(
                f'{transform_type!r} needs >= 2 shift dimensions '
                f'(atoms of shape {atom_shape} cannot be quarter-turned)')
        if atom_shape[-1] != atom_shape[-2]:
            raise ValueError(
                f'{transform_type!r} requires square atoms in the rotation '
                f'plane (the last two atom axes), got {atom_shape}')
    if transform_type == 'shift+flip':
        # the full mirror group: one element per subset of flipped axes
        # (2^ndim elements, identity first)
        subsets = chain.from_iterable(combinations(range(ndim), r) for r in range(ndim + 1))
        elements = tuple((0, s) for s in subsets)
    elif transform_type == 'shift+rot90':
        elements = tuple((k, ()) for k in range(4))   # the C4 rotations
    else:  # 'shift+rot90+flip', the dihedral group D4 (8 elements): only the
        # last axis is flipped, flipping both is a half turn
        elements = tuple((k, f) for f in ((), (ndim - 1,)) for k in range(4))
    return TransformGroup(name=transform_type, ndim=ndim, elements=elements)


def expand_w(W: torch.Tensor, group: TransformGroup) -> torch.Tensor:
    """Canonical dictionary -> tied copies, ``(M, C, *A) -> (M*G, C, *A)``
    with ``W_exp[m*G + g] = T_g(W[m])`` (m-major, H's layout); contiguous."""
    copies = [apply(W, e, 2, group.ndim) for e in group.elements]
    We = torch.stack(copies, dim=1)  # (M, G, C, *A)
    return We.reshape((W.shape[0] * group.size,) + tuple(W.shape[1:]))


def tie_back(G_exp: torch.Tensor, group: TransformGroup) -> torch.Tensor:
    """Pull an expanded-dictionary gradient back onto the canonical atoms,
    ``(M*G, C, *A) -> (M, C, *A)``: ``sum_g T_g^{-1}(G_exp[m, g])``, summed
    in the element order (the JAX function's)."""
    g = group.size
    Gm = G_exp.reshape((G_exp.shape[0] // g, g) + tuple(G_exp.shape[1:]))
    out = apply_inverse(Gm[:, 0], group.elements[0], 2, group.ndim)
    for i in range(1, g):
        out = out + apply_inverse(Gm[:, i], group.elements[i], 2, group.ndim)
    return out.contiguous()


def split_strategy(strategy) -> Tuple[str, Optional[TransformGroup]]:
    """``(base strategy, group or None)`` of an engine ``strategy``: a
    string, or the tuple ``(base, TransformGroup)``."""
    if isinstance(strategy, tuple):
        return strategy
    return strategy, None


class GroupOps:
    """The engine's operator contract (``prepare_data`` / ``reconstruct`` /
    ``grad_H_pair`` / ``grad_W_pair`` and the prepared-stream primitives)
    on top of a base strategy module: the dictionary is expanded before
    every call that reads it, and the W statistics are tied back.  The
    primitives keep the base module's signature (conv's plan is optional)."""

    def __init__(self, base, group: TransformGroup):
        self.base = base
        self.group = group
        self.FACTORS_IN_PREPARED = bool(getattr(base, 'FACTORS_IN_PREPARED', False))

    def _tie(self, pair):
        return tie_back(pair[0], self.group), tie_back(pair[1], self.group)

    def prepare_data(self, V, plan):
        return self.base.prepare_data(V, plan)

    def reconstruct(self, W, H, plan):
        return self.base.reconstruct(expand_w(W, self.group), H, plan)

    def grad_H_pair(self, Vp, R, W, plan):
        return self.base.grad_H_pair(Vp, R, expand_w(W, self.group), plan)

    def grad_W_pair(self, Vp, R, H, plan):
        return self._tie(self.base.grad_W_pair(Vp, R, H, plan))

    def corr_H(self, Xp, W, *plan):
        return self.base.corr_H(Xp, expand_w(W, self.group), *plan)

    def corr_W(self, Xp, H, *plan):
        return tie_back(self.base.corr_W(Xp, H, *plan), self.group)

    def grad_H_pair_prepared(self, Ap, Bp, W, *plan):
        return self.base.grad_H_pair_prepared(Ap, Bp, expand_w(W, self.group), *plan)

    def grad_W_pair_prepared(self, Ap, Bp, H, *plan):
        return self._tie(self.base.grad_W_pair_prepared(Ap, Bp, H, *plan))
