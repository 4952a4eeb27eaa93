"""Plain-matmul strategy for the degenerate single-transform problem, in PyTorch.

Port of :mod:`tnmf_tpu.ops.dot`.  It applies when
``prod(plan.transform_shape) == 1``, i.e. reconstruction mode ``'full'``
with ``atom_shape == sample_shape``: shift invariance degenerates to classic
Lee-Seung NMF, ``V[n,c,*S] ~ sum_m H[n,m] * W[m,c,*S]``, and every operator
is one matrix product over the flattened ``(c, *S)`` feature axis.  H keeps
its canonical ``(n, m, *transform_shape)`` layout (all shift axes of length
1).  Same contract as :mod:`tnmf_tpu_torch.ops.conv` and
:mod:`tnmf_tpu_torch.ops.fft`, with ``plan`` passed to every operator.

The products are ``torch.matmul`` calls (cuBLAS on the card), as the JAX
package leaves them to XLA; the engine runs them in full float32
(:mod:`tnmf_tpu_torch.ops.precision`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .modes import ConvPlan


def prepare_data(V: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """Identity: the single-offset correlation needs no extension."""
    del plan
    return V


#: prepare_data is the identity, so beta-divergence factors apply to
#: prepared tensors unchanged (the JAX engine's ``beta_prepares_data``)
FACTORS_IN_PREPARED = True


def reconstruct(W: torch.Tensor, H: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """``R[n,c,*S] = sum_m H[n,m] * W[m,c,*S]``: one (n,m) x (m,cF) product."""
    del plan
    R = torch.matmul(H.reshape(H.shape[:2]), W.reshape(W.shape[0], -1))
    return R.reshape((H.shape[0],) + W.shape[1:]).to(W.dtype)


def corr_H(Xp: torch.Tensor, W: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """Single-stream H-gradient product ``G[n,m] = sum_{cF} Xp[n,cF] W[m,cF]``."""
    # flatten and unit axes added by indexing: no size of the batch is read,
    # which a traced program holds symbolic (the stacked pair's is a sum)
    G = torch.matmul(Xp.flatten(1), W.flatten(1).T)
    return G.to(W.dtype)[(Ellipsis,) + (None,) * plan.ndim]


def corr_W(Xp: torch.Tensor, H: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """Single-stream W-gradient product ``G[m,c,*S] = sum_n H[n,m] Xp[n,c,*S]``."""
    del plan
    h = H.reshape(H.shape[:2])
    G = torch.matmul(h.T, Xp.reshape(Xp.shape[0], -1))
    return G.to(H.dtype).reshape((h.shape[1],) + Xp.shape[1:])


def grad_H_pair_prepared(Ap: torch.Tensor, Bp: torch.Tensor, W: torch.Tensor,
                         plan: ConvPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """(neg, pos) H-gradient products, the streams stacked along the batch."""
    n = Ap.shape[0]
    G2 = corr_H(torch.cat([Ap, Bp], dim=0), W, plan)
    return G2[:n], G2[n:]


def grad_W_pair_prepared(Ap: torch.Tensor, Bp: torch.Tensor, H: torch.Tensor,
                         plan: ConvPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """(neg, pos) W-gradient products, the streams stacked along the channels."""
    c = Ap.shape[1]
    G2 = corr_W(torch.cat([Ap, Bp], dim=1), H, plan)
    return G2[:, :c], G2[:, c:]


def grad_H_pair(Vp: torch.Tensor, R: torch.Tensor, W: torch.Tensor,
                plan: ConvPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """(neg, pos) of dE/dH: X . W over (c, *S), V and R in one product."""
    return grad_H_pair_prepared(Vp, R, W, plan)


def grad_W_pair(Vp: torch.Tensor, R: torch.Tensor, H: torch.Tensor,
                plan: ConvPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """(neg, pos) of dE/dW: H^T . X over samples, V and R in one product."""
    return grad_W_pair_prepared(Vp, R, H, plan)
