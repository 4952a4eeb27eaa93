"""Lateral-inhibition regularizer support, in PyTorch.

Port of :mod:`tnmf_tpu.ops.inhibition` (copied, not imported: importing the
JAX package loads JAX).  The inhibition gradient is a separable multi-1-D
convolution of the activation tensor H with small symmetric kernels
``1 - (i/(r+1))**2`` along each shift axis, zero-padded at the boundary in
every reconstruction mode (the reference is
``scipy.ndimage.convolve1d(mode='constant')``).

Each 1-D pass is one depthwise ``F.conv{1,2,3}d`` over the shift axes with
a one-axis kernel, TF32 off.  The JAX module's banded-matrix lowering
(``_band_matrix``, ``_band_convolve_blocked``, the fused einsum) is not
ported: it exists to run the convolution on the TPU matrix unit.  On CUDA
the whole inhibited H update is the hand-written kernel K4
(:mod:`tnmf_tpu_torch.kernels.inhibit`); the functions here are its plain
version and the CPU path.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .precision import convolution_pin

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def inhibition_kernels(inhibition_range: Tuple[int, ...],
                       dtype=np.float64) -> Tuple[np.ndarray, ...]:
    """Per-axis 1-D kernels ``1 - (i/(r+1))**2`` for i in [-r, r].

    A range of 0 yields the single-tap kernel [1.], matching the reference.
    """
    return tuple(
        (1.0 - (np.arange(-r, r + 1, dtype=dtype) / (r + 1)) ** 2)
        for r in inhibition_range
    )


def resolve_inhibition_range(
    inhibition_range: Optional[Union[int, Tuple[int, ...]]],
    atom_shape: Tuple[int, ...],
) -> Tuple[int, ...]:
    """Default: minimal range covering the atom size (reference
    ``TransformInvariantNMF.py:154-160``)."""
    if inhibition_range is None:
        return tuple(a - 1 for a in atom_shape)
    if isinstance(inhibition_range, int):
        return (inhibition_range,) * len(atom_shape)
    rng = tuple(int(r) for r in inhibition_range)
    if len(rng) != len(atom_shape):
        raise ValueError('inhibition_range must have one entry per atom axis')
    return rng


def cross_scale(cross_inhibition, n_atoms: int):
    """The cross-atom weight ``cross / (n_atoms - 1)`` (a tensor of
    strengths, a sweep's, divides in its own dtype).  With one atom there
    is no other atom to inhibit: the JAX package's default route divides by
    zero there (NaN activations) and its Pallas kernel silently drops the
    term, so the port refuses the case."""
    if n_atoms < 2:
        raise ValueError(
            'cross_atom_inhibition_strength > 0 needs at least 2 atoms '
            f'(it scales by 1/(n_atoms - 1)), got n_atoms={n_atoms}')
    if isinstance(cross_inhibition, torch.Tensor):
        return cross_inhibition / (n_atoms - 1)
    return float(cross_inhibition) / (n_atoms - 1)


def convolve_multi_1d(arr: torch.Tensor, kernels: Sequence, axes: Sequence[int]) -> torch.Tensor:
    """Sequential zero-padded 1-D correlations of ``arr`` along ``axes``
    (the kernels are symmetric, so convolution equals correlation).

    The shift axes from the first of ``axes`` to the last dimension (at most
    three) ride a depthwise convolution; all leading axes fold into its
    batch.  More shift axes (rank-4 fits, which take the fft strategy) run
    one 1-D convolution per axis, that axis moved last.  Ranks 1-3 keep the
    depthwise route: it is the plain version of K4 that the 1-D and 2-D
    goldens and the card's comparisons were taken on, and the per-axis
    route sums in another order (its speed on those ranks is not
    measured)."""
    assert len(kernels) == len(axes)
    axes = [a % arr.ndim for a in axes]
    lead = min(axes)
    spatial = tuple(arr.shape[lead:])
    nd = len(spatial)
    out = arr if nd not in _CONV else arr.reshape((-1, 1) + spatial)
    # float32 at every level: the JAX package runs this stencil without
    # its precision
    with convolution_pin(None, arr.device, arr.dtype):
        for axis, kernel in zip(axes, kernels):
            k = torch.as_tensor(kernel, dtype=arr.dtype, device=arr.device)
            r = (k.shape[0] - 1) // 2
            if nd not in _CONV:
                x = out.movedim(axis, -1)
                y = F.conv1d(x.reshape(-1, 1, x.shape[-1]), k.reshape(1, 1, -1), padding=r)
                out = y.reshape(x.shape).movedim(-1, axis)
                continue
            shape = [1] * nd
            shape[axis - lead] = k.shape[0]
            pad = [0] * nd
            pad[axis - lead] = r
            out = _CONV[nd](out, k.reshape([1, 1] + shape), padding=tuple(pad))
    return out.reshape(arr.shape)


def inhibition_positive_term(
    H: torch.Tensor,
    kernels: Sequence,
    n_shift_axes: int,
    inhibition: float,
    cross_inhibition: float,
    n_atoms: int,
    with_same_atom: bool,
    with_cross_atom: bool,
    h_sum: Optional[torch.Tensor] = None,
    n_total: Optional[int] = None,
) -> torch.Tensor:
    """Additional positive-gradient term for the H update.

    Mirrors ``TransformInvariantNMF.py:252-269``: the same-atom term subtracts
    H itself (an atom must not suppress its own activation), the cross-atom
    term broadcasts the atom-summed inhibition minus the own-atom
    contribution, scaled by 1/(n_atoms-1).

    Given ``h_sum``, the atoms' sum ``sum_m H[:, m]`` as an ``(N, 1, *T)``
    plane (under a mesh over the atoms: the sum of every rank's maps, of
    which H holds a block), and ``n_total``, the global map count, the
    cross field is the stencil of ``h_sum`` minus the own-atom field,
    scaled by ``1/(n_total - 1)`` (the stencil is linear, so that is the
    sum of the fields).
    """
    axes = tuple(range(-n_shift_axes, 0))
    g = convolve_multi_1d(H, kernels, axes)
    term = torch.zeros_like(H)
    if with_same_atom:
        term = term + inhibition * (g - H)
    if with_cross_atom:
        if h_sum is None:
            cross, n_maps = g.sum(dim=1, keepdim=True) - g, n_atoms
        else:
            cross, n_maps = convolve_multi_1d(h_sum, kernels, axes) - g, n_total
        term = term + cross_scale(cross_inhibition, n_maps) * cross
    return term
