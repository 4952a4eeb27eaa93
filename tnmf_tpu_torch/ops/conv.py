"""Direct-convolution strategy for the conv-NMF operators, in PyTorch.

Port of :mod:`tnmf_tpu.ops.conv`.  Each operator is one
``F.conv{1,2,3}d`` call (a cross-correlation) on mode-extended tensors, so
every convolution runs with zero padding:

* reconstruct: ``R[n,c,x] = sum_{m,a} Hp[n,m,x+a] * W[m,c,A-1-a]``;
  input ``Hp (N, M, *)``, weight ``flip(W)^T (C, M, *A)``.
* corr_H:      ``G[n,m,t] = sum_{c,a} Xp[n,c,t+a] * W[m,c,a]``;
  input ``Xp (N, C, *)``, weight ``W (M, C, *A)``.
* corr_W:      ``G[m,c,a] = sum_{n,t} Xp[n,c,a+t] * H[n,m,t]``;
  input ``Xp^T (C, N, *)``, weight ``H^T (M, N, *T)``, output transposed.

The space-to-depth output blocking of the JAX module is not ported: it only
fills the TPU matrix unit's 128 lanes.

On the GPU these convolutions go to cuDNN at the plan's precision
(:func:`~tnmf_tpu_torch.ops.precision.convolution_pin`): TF32 at 'default'
and 'high', full float32 otherwise, as the JAX module passes
``plan.lax_precision`` to each convolution
(``torch.backends.cudnn.allow_tf32`` defaults to True, so the pin sets it
either way).  The prepared-stream primitives take the plan as an optional
last argument, as the fft and dot modules' do; without one (the kernels'
plain versions) they compute in full float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .modes import ConvPlan
from .precision import convolution_pin

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _level(plan: Optional[ConvPlan]) -> Optional[str]:
    """The precision of ``plan``; None (full float32) without one."""
    return None if plan is None else plan.precision


def _conv(x: torch.Tensor, w: torch.Tensor, level: Optional[str] = None) -> torch.Tensor:
    """Zero-padding, stride-1 cross-correlation at the precision ``level``."""
    try:
        conv = _CONV[x.dim() - 2]
    except KeyError:
        raise NotImplementedError(
            'direct-conv strategy supports up to 3 shift dimensions; the fft '
            "strategy takes any number (backend='jax_fft', or 'auto')") from None
    with convolution_pin(level, x.device, x.dtype):
        return conv(x, w)


def _pad_index(size: int, left: int, right: int, mode: str,
               device) -> torch.Tensor:
    """Source indices of ``numpy.pad(..., mode)`` along one axis, for any
    pad width ('wrap' is torch's 'circular'; torch's own circular/reflect
    padding rejects pads as wide as the axis)."""
    i = torch.arange(-left, size + right, device=device)
    if mode == 'wrap':
        return i % size
    if mode != 'reflect':
        raise ValueError(mode)
    if size == 1:
        return torch.zeros_like(i)
    period = 2 * (size - 1)
    i = i % period
    return torch.where(i >= size, period - i, i)


def _pad_spatial(x: torch.Tensor, left, right, mode: str) -> torch.Tensor:
    if mode == 'zero':
        pad = []
        for lo, hi in reversed(list(zip(left, right))):
            pad += [lo, hi]
        return F.pad(x, pad)
    for ax, (lo, hi) in enumerate(zip(left, right)):
        if lo or hi:
            idx = _pad_index(x.shape[2 + ax], lo, hi, mode, x.device)
            x = x.index_select(2 + ax, idx)
    return x


def extend_data(X: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """Mode extension of a data-space tensor to ``T + A - 1`` per axis, so
    the convolutions below all run with padding 0."""
    am1 = tuple(a - 1 for a in plan.atom_shape)
    zero = (0,) * plan.ndim
    if plan.mode == 'valid':
        return _pad_spatial(X, am1, am1, 'zero')
    if plan.mode == 'full':
        return X
    if plan.mode == 'circular':
        return _pad_spatial(X, zero, am1, 'wrap')
    if plan.mode == 'reflect':
        return _pad_spatial(X, zero, am1, 'reflect')
    raise ValueError(plan.mode)


def _extend_H(H: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """Left-extend H to length ``S + A - 1`` per axis."""
    am1 = tuple(a - 1 for a in plan.atom_shape)
    zero = (0,) * plan.ndim
    if plan.mode == 'valid':
        return H
    if plan.mode == 'full':
        return _pad_spatial(H, am1, am1, 'zero')
    if plan.mode == 'circular':
        return _pad_spatial(H, am1, zero, 'wrap')
    if plan.mode == 'reflect':
        return _pad_spatial(H, am1, zero, 'reflect')
    raise ValueError(plan.mode)


def prepare_data(V: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """The extended data tensor; loop-invariant per fit."""
    return extend_data(V, plan)


#: the extension replicates or zero-fills entries, so it commutes with the
#: beta-divergence factors (elementwise, 0 -> 0): they are formed on
#: prepared tensors (the JAX engine's ``beta_prepares_data``)
FACTORS_IN_PREPARED = True


def reconstruct(W: torch.Tensor, H: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """``R[n,c,*S] = sum_m (H[n,m] * W[m,c])``, the model reconstruction."""
    Hp = _extend_H(H, plan)
    Wk = torch.flip(W.transpose(0, 1), dims=plan.shift_axes)
    return _conv(Hp, Wk, plan.precision)


def corr_H(Xp: torch.Tensor, W: torch.Tensor,
           plan: Optional[ConvPlan] = None) -> torch.Tensor:
    """``G[n,m,t] = sum_{c,a} Xp[n,c,t+a] * W[m,c,a]`` (no flip) for a
    mode-extended data-space tensor ``Xp`` of any batch extent."""
    return _conv(Xp, W, _level(plan))


def corr_W(Xp: torch.Tensor, H: torch.Tensor,
           plan: Optional[ConvPlan] = None) -> torch.Tensor:
    """``G[m,c,a] = sum_{n,t} Xp[n,c,a+t] * H[n,m,t]`` for a mode-extended
    ``Xp`` of any channel extent (channels ride the conv's batch role)."""
    return _conv(Xp.transpose(0, 1), H.transpose(0, 1), _level(plan)).transpose(0, 1)


def grad_H_pair_prepared(Ap: torch.Tensor, Bp: torch.Tensor, W: torch.Tensor,
                         plan: Optional[ConvPlan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(neg, pos) H-gradient correlations of two prepared streams, as one
    convolution with the streams stacked along the batch axis."""
    G2 = corr_H(torch.cat([Ap, Bp], dim=0), W, plan)
    n = Ap.shape[0]
    return G2[:n], G2[n:]


def grad_W_pair_prepared(Ap: torch.Tensor, Bp: torch.Tensor, H: torch.Tensor,
                         plan: Optional[ConvPlan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(neg, pos) W-gradient correlations of two prepared streams, stacked
    along the channel axis (the conv's batch role)."""
    G2 = corr_W(torch.cat([Ap, Bp], dim=1), H, plan)
    c = Ap.shape[1]
    return G2[:, :c], G2[:, c:]


def grad_H_pair(Vp: torch.Tensor, R: torch.Tensor, W: torch.Tensor,
                plan: ConvPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """(neg, pos) parts of dE/dH."""
    return grad_H_pair_prepared(Vp, extend_data(R, plan), W, plan)


def grad_W_pair(Vp: torch.Tensor, R: torch.Tensor, H: torch.Tensor,
                plan: ConvPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """(neg, pos) parts of dE/dW."""
    return grad_W_pair_prepared(Vp, extend_data(R, plan), H, plan)
