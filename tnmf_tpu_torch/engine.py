"""Execution engine of the multiplicative-update (MU) algorithm, in PyTorch.

Port of the full-batch MU path of :mod:`tnmf_tpu.engine`: the same functions
with the same ``(W, H)`` result contract, run eagerly.  The fit loop is a
Python loop; each iteration updates H, then W (reference ``fit_batch`` loop
body, ``TransformInvariantNMF.py:334-340``).

Only the direct-convolution strategy (:mod:`tnmf_tpu_torch.ops.conv`) is
ported, so the functions here take no strategy argument; the model checks
the strategy a fit resolves to with :func:`require_ported`.  On CUDA
tensors the hot operators run through the hand-written kernels: the H
update through K3 (:func:`~tnmf_tpu_torch.kernels.mu_h.mu_h`),
the W statistics through K2 (:func:`~tnmf_tpu_torch.kernels.gw.grad_w`) and
the W ratio through K1 (:func:`~tnmf_tpu_torch.kernels.mu.mu_ratio`).  On CPU
tensors the same wrappers run their plain versions.  The reconstruction
stays a convolution (cuDNN, TF32 off), as the JAX package left it to XLA.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .kernels.gw import grad_w
from .kernels.mu import mu_ratio
from .kernels.mu_h import mu_h
from .ops import beta as beta_ops
from .ops import conv as conv_ops
from .ops.modes import ConvPlan

EPS = 1.0e-9  # reference: TransformInvariantNMF.py:166

#: the ROADMAP item that ports each strategy the port does not run yet
_UNPORTED_STRATEGIES = {
    'fft': 'ROADMAP.md queue 1, item 8 (ops/fft.py)',
    'dot': 'ROADMAP.md queue 1, item 8 (ops/dot.py)',
    'phased': 'ROADMAP.md queue 1, item 15 (not ported: TPU-only lowering)',
}


def require_ported(strategy: str) -> None:
    """Raise ``NotImplementedError`` for a strategy the port lacks."""
    if strategy == 'conv':
        return
    if strategy in _UNPORTED_STRATEGIES:
        raise NotImplementedError(
            f'strategy {strategy!r} is not ported to tnmf_tpu_torch yet; see '
            f'{_UNPORTED_STRATEGIES[strategy]}')
    raise ValueError(
        f'unknown strategy {strategy!r}; choose "fft", "conv", "phased" or "dot"')


def resolve_strategy(strategy: str, plan: ConvPlan) -> str:
    """The lowering a strategy request runs on: the degenerate
    single-transform problem (plain NMF) goes to 'dot'.  The TPU-only
    'phased' upgrade of the JAX package never applies here."""
    if strategy == 'conv' and math.prod(plan.transform_shape) == 1:
        return 'dot'
    return strategy


def choose_strategy(plan: ConvPlan) -> str:
    """Heuristic strategy for ``backend='auto'``, the JAX package's rule:
    direct convolution for small atoms, fft once the per-point direct cost
    (~prod(atom)) passes ``max(512, prod(sample)/64)``."""
    if math.prod(plan.transform_shape) == 1:
        return 'conv'
    if plan.ndim > 3:
        return 'fft'
    threshold = max(512, math.prod(plan.sample_shape) // 64)
    return 'conv' if math.prod(plan.atom_shape) <= threshold else 'fft'


def prepare_data(V: torch.Tensor, *, plan: ConvPlan) -> torch.Tensor:
    """Loop-invariant preprocessing of the data tensor (mode extension)."""
    return conv_ops.prepare_data(V, plan)


def reconstruct(W: torch.Tensor, H: torch.Tensor, *, plan: ConvPlan) -> torch.Tensor:
    """The model reconstruction ``R`` (canonical data layout)."""
    return conv_ops.reconstruct(W, H, plan)


def partial_reconstruct(W: torch.Tensor, H: torch.Tensor, *, plan: ConvPlan,
                        i_atom: int) -> torch.Tensor:
    """Reconstruction restricted to one atom (reference ``_Backend.py:124``)."""
    return conv_ops.reconstruct(W[i_atom:i_atom + 1], H[:, i_atom:i_atom + 1], plan)


def energy(V: torch.Tensor, W: torch.Tensor, H: torch.Tensor, *,
           plan: ConvPlan) -> torch.Tensor:
    """Reconstruction objective ``0.5 * sum((V - R)^2)`` as a 0-d tensor,
    accumulated in ``promote_types(V.dtype, float32)``."""
    return beta_ops.divergence(V, reconstruct(W, H, plan=plan))


def _mu_H(Vp: torch.Tensor, W: torch.Tensor, H: torch.Tensor, sparsity: float, *,
          plan: ConvPlan) -> torch.Tensor:
    """One multiplicative H update (reference ``_update_H``,
    ``TransformInvariantNMF.py:246-271``):
    ``H * corr(Vp, W) / (corr(Rx, W) + EPS + sparsity)``, fused in K3."""
    Rx = conv_ops.extend_data(conv_ops.reconstruct(W, H, plan), plan)
    return mu_h(Vp, Rx, W, H, EPS + float(sparsity))


def _normalize_W(W: torch.Tensor, n_shift_axes: int) -> torch.Tensor:
    """Sum-normalize atoms; zero atoms stay zero instead of turning NaN."""
    s = W.sum(dim=tuple(range(-n_shift_axes, 0)), keepdim=True)
    return W / torch.where(s == 0, torch.ones_like(s), s)


def _mu_W(Vp: torch.Tensor, W: torch.Tensor, H: torch.Tensor, *,
          plan: ConvPlan) -> torch.Tensor:
    """One multiplicative W update with atom-wise sum normalization
    (reference ``_update_W`` + ``normalize``, ``TransformInvariantNMF.py:240-244``):
    the statistics in K2, the ratio ``W * neg / (pos + EPS)`` in K1."""
    Rx = conv_ops.extend_data(conv_ops.reconstruct(W, H, plan), plan)
    neg, pos = grad_w(torch.cat([Vp, Rx], dim=1), H, plan)
    return _normalize_W(mu_ratio(W, neg, pos, EPS), plan.ndim)


def update_step(Vp: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
                sparsity: float, *, plan: ConvPlan, update_H: bool = True,
                update_W: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """One full MU iteration: H update, then W update.  Returns ``(W, H)``."""
    if update_H:
        H = _mu_H(Vp, W, H, sparsity, plan=plan)
    if update_W:
        W = _mu_W(Vp, W, H, plan=plan)
    return W, H


def fit_loop(Vp: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
             n_iterations: int, sparsity: float, *, plan: ConvPlan,
             update_H: bool = True,
             update_W: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_iterations`` MU iterations.  Returns ``(W, H)``."""
    for _ in range(int(n_iterations)):
        W, H = update_step(Vp, W, H, sparsity, plan=plan,
                           update_H=update_H, update_W=update_W)
    return W, H
