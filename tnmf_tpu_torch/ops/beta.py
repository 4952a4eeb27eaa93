"""Beta-divergence factors and losses for the multiplicative-update rules.

Port of :mod:`tnmf_tpu.ops.beta`.  The reconstruction objective is the
beta-divergence ``D_beta(V || R)`` of Fevotte & Idier 2011: the reference's
squared Euclidean energy at beta = 2, generalized Kullback-Leibler at
beta = 1, Itakura-Saito at beta = 0, any other float in between and
beyond.  The MU update keeps the ``(neg, pos)`` contract of the Euclidean
one: with ``A = V * R**(beta-2)`` and ``B = R**(beta-1)``,

    neg = corr(A, W)   pos = corr(B, W)     (H gradient)
    neg = corr(A, H)   pos = corr(B, H)     (W gradient)

so every strategy's correlation operators, and K2 and K3, serve every beta
once they are given the two streams (:func:`tnmf_tpu_torch.engine._beta_factors`).
"""

from __future__ import annotations

import torch

#: floor applied to R wherever a non-positive power would blow up
EPS_R = 1.0e-9

_NAMED = {'frobenius': 2.0, 'kullback-leibler': 1.0, 'itakura-saito': 0.0}


def resolve_beta_loss(beta_loss) -> float:
    """Map a sklearn-style ``beta_loss`` (a float or a name) to a float."""
    if isinstance(beta_loss, str):
        try:
            return _NAMED[beta_loss]
        except KeyError as e:
            raise ValueError(
                f'unknown beta_loss {beta_loss!r}; choose a float or one of '
                f'{sorted(_NAMED)}') from e
    return float(beta_loss)


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def factors(V: torch.Tensor, R: torch.Tensor, beta: float):
    """``(A, B) = (V * R**(beta-2), R**(beta-1))`` with R floored at
    ``EPS_R``, formed in the accumulation dtype and cast back to R's."""
    acc = _acc(R.dtype)
    Rs = torch.clamp(R.to(acc), min=EPS_R)
    Vc = V.to(acc)
    if beta == 1.0:
        A = Vc / Rs
        B = torch.ones_like(Rs)
    elif beta == 0.0:
        A = Vc / (Rs * Rs)
        B = 1.0 / Rs
    else:
        A = Vc * Rs ** (beta - 2.0)
        B = Rs ** (beta - 1.0)
    return A.to(R.dtype), B.to(R.dtype)


def divergence(V: torch.Tensor, R: torch.Tensor, beta: float = 2.0,
               mask: torch.Tensor = None) -> torch.Tensor:
    """Elementwise-summed ``D_beta(V || R)`` as a 0-d tensor, accumulated in
    ``promote_types(V.dtype, float32)``: ``0.5 * sum((V - R)**2)`` at
    beta = 2, generalized KL at beta = 1 (``xlogy``, so an entry with
    ``v = 0`` adds ``r``), Itakura-Saito at beta = 0.  A ``mask``
    (broadcastable to V: 0/1 for missing data, nonnegative weights) weights
    the elementwise terms before the sum."""
    acc = _acc(V.dtype)
    Vc, Rc = V.to(acc), R.to(acc)
    if beta == 2.0:
        d = Vc - Rc
        e = 0.5 * d * d
    else:
        Rs = torch.clamp(Rc, min=EPS_R)
        if beta == 1.0:
            e = torch.xlogy(Vc, Vc) - torch.xlogy(Vc, Rs) - Vc + Rs
        elif beta == 0.0:
            q = torch.clamp(Vc, min=EPS_R) / Rs
            e = q - torch.log(q) - 1.0
        else:
            c = 1.0 / (beta * (beta - 1.0))
            e = c * (Vc ** beta + (beta - 1.0) * Rs ** beta
                     - beta * Vc * Rs ** (beta - 1.0))
    if mask is not None:
        e = e * mask.to(acc)
    return torch.sum(e)

