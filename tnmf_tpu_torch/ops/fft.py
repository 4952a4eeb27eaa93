"""FFT strategy for the conv-NMF operators, in PyTorch.

Port of the ``torch.fft`` half of :mod:`tnmf_tpu.ops.fft`: every correlation
is ``irfft(F(X) * conj(F(K)))`` by the cross-correlation theorem, with the
mode-specific boundary extension applied to ``X`` before the transform, so
each gradient is a plain ``[0:size]`` crop.  ``'circular'`` runs its FFTs at
exactly the sample length (cyclic convolution is that mode).  The transform
of the extended data is loop-invariant: :func:`prepare_data` computes it once
per fit.  The transforms are ``torch.fft.rfftn`` / ``irfftn`` with
``s=plan.fft_shape`` over the shift axes, any number of them (rank-4 fits
take this strategy).

Not ported: the matmul-DFT transforms of the JAX module
(``_use_matmul_dft``, ``_split_len``, ``_dft_*``), which exist because XLA's
FFT on the TPU is slow and which that module gates to the TPU.  cuFFT runs
the transforms here.

The per-frequency contractions (``'nm…,mc…->nc…'`` for the reconstruction,
``'nc…,mc…->nm…'`` for the H gradient, ``'nc…,nm…->mc…'`` for the W
gradient) are each one batched ``torch.matmul`` with the frequencies as its
batch.  The forward transforms run in the canonical layout (cuFFT is about
twice as fast there as with the batch innermost, H100), and each operand
is copied once into the frequency-major layout ``(*F, a, b)``; the
conjugates are ``.mH`` views, which cuBLAS reads as conjugate transposes
without a copy.  The product stays frequency-major and is inverted over its
leading axes, so no H-sized spectrum is transposed back; the cropped result
is an ``(a, b, *size)`` view.  The engine runs the complex64 products in
full float32 (:mod:`tnmf_tpu_torch.ops.precision`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .conv import _pad_spatial
from .modes import ConvPlan


def _rfftn(x: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    return torch.fft.rfftn(x, s=plan.fft_shape, dim=plan.shift_axes)


def _freq_major(x: torch.Tensor) -> torch.Tensor:
    """A spectrum ``(a, b, *F)`` laid out frequency-major, ``(*F, a, b)``:
    the operand layout of the per-frequency products (one copy)."""
    return x.movedim((0, 1), (-2, -1)).contiguous()


def _inverse(Gf: torch.Tensor, start: Tuple[int, ...], size: Tuple[int, ...],
             plan: ConvPlan) -> torch.Tensor:
    """The inverse transform of a frequency-major product ``(*F, a, b)``
    over its leading axes, cropped to ``[start : start + size]``, as an
    ``(a, b, *size)`` view."""
    x = torch.fft.irfftn(Gf, s=plan.fft_shape, dim=tuple(range(plan.ndim)))
    x = x[tuple(slice(o, o + n) for o, n in zip(start, size))]
    return x.movedim((-2, -1), (0, 1))


def extend_data(X: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """Mode-specific boundary extension of a data-space tensor (V or R):
    afterwards both gradient correlations read only non-negative lags."""
    am1 = tuple(a - 1 for a in plan.atom_shape)
    zero = (0,) * plan.ndim
    if plan.mode == 'valid':
        return _pad_spatial(X, am1, am1, 'zero')
    if plan.mode in ('full', 'circular'):
        return X  # circular: the periodicity is the exact-length FFT's own
    if plan.mode == 'reflect':
        return _pad_spatial(X, zero, am1, 'reflect')
    raise ValueError(plan.mode)


def prepare_data(V: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """Fourier transform of the extended data tensor; loop-invariant per fit."""
    return _rfftn(extend_data(V, plan), plan)


#: the prepared domain is spectral: the beta-divergence factors are formed
#: canonically and transformed every iteration (the JAX engine's
#: ``beta_prepares_data``)
FACTORS_IN_PREPARED = False


def reconstruct(W: torch.Tensor, H: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """``R[n,c,x] = sum_{m,a} W[m,c,a] * Hext[n,m,x+(A-1)-a]``."""
    am1 = tuple(a - 1 for a in plan.atom_shape)
    if plan.mode == 'reflect':
        H = _pad_spatial(H, am1, (0,) * plan.ndim, 'reflect')
    # valid: H already spans S+A-1; full/circular: the FFT's zero fill or
    # cyclic wrap is the extension
    Rf = torch.matmul(_freq_major(_rfftn(H, plan)), _freq_major(_rfftn(W, plan)))
    start = am1 if plan.mode in ('valid', 'reflect') else (0,) * plan.ndim
    return _inverse(Rf, start, plan.sample_shape, plan).to(W.dtype)


def _corr_H(Xf: torch.Tensor, Wfm: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """``corr(Xext, W)`` from ``Xf`` and the frequency-major ``F(W)``:
    per frequency ``Xf (n, c) @ conj(F(W)) (c, m)``."""
    Gf = torch.matmul(_freq_major(Xf), Wfm.mH)
    return _inverse(Gf, (0,) * plan.ndim, plan.transform_shape, plan)


def corr_H(Xf: torch.Tensor, W: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """Single-stream H-gradient correlation ``G[n,m,t] = sum_{c,a}
    Xext[n,c,t+a] W[m,c,a]`` from the transformed prepared tensor ``Xf``
    (any batch extent)."""
    return _corr_H(Xf, _freq_major(_rfftn(W, plan)), plan)


def _corr_W(Xf: torch.Tensor, Hfm: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """``corr(Xext, H)`` from ``Xf`` and the frequency-major ``F(H)``: per
    frequency ``conj(F(H)) (m, n) @ Xf (n, c)``."""
    Gf = torch.matmul(Hfm.mH, _freq_major(Xf))
    return _inverse(Gf, (0,) * plan.ndim, plan.atom_shape, plan)


def corr_W(Xf: torch.Tensor, H: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """Single-stream W-gradient correlation, summed over samples and
    shifts; ``H`` arrives in data space."""
    return _corr_W(Xf, _freq_major(_rfftn(H, plan)), plan)


def grad_H_pair_prepared(Af: torch.Tensor, Bf: torch.Tensor, W: torch.Tensor,
                         plan: ConvPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """(neg, pos) H-gradient correlations of two transformed streams,
    stacked along the batch into one contraction."""
    G2 = corr_H(torch.cat([Af, Bf], dim=0), W, plan)
    n = Af.shape[0]
    return G2[:n], G2[n:]


def grad_W_pair_prepared(Af: torch.Tensor, Bf: torch.Tensor, H: torch.Tensor,
                         plan: ConvPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """(neg, pos) W-gradient correlations of two transformed streams,
    stacked along the channels into one contraction."""
    G2 = corr_W(torch.cat([Af, Bf], dim=1), H, plan)
    c = Af.shape[1]
    return G2[:, :c], G2[:, c:]


def grad_H_pair(Vf: torch.Tensor, R: torch.Tensor, W: torch.Tensor,
                plan: ConvPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """(neg, pos) parts of dE/dH: ``corr(Xext, W)`` summed over channels,
    from the :func:`prepare_data` transform ``Vf`` of V and the data-space
    reconstruction ``R``."""
    Rf = _rfftn(extend_data(R, plan), plan)
    Wfm = _freq_major(_rfftn(W, plan))
    return _corr_H(Vf, Wfm, plan), _corr_H(Rf, Wfm, plan)


def grad_W_pair(Vf: torch.Tensor, R: torch.Tensor, H: torch.Tensor,
                plan: ConvPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """(neg, pos) parts of dE/dW: ``corr(Xext, H)`` summed over samples and
    shifts."""
    Hfm = _freq_major(_rfftn(H, plan))
    Rf = _rfftn(extend_data(R, plan), plan)
    return _corr_W(Vf, Hfm, plan), _corr_W(Rf, Hfm, plan)
