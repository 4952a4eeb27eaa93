"""Minibatch epochs of the multiplicative-update fit, in PyTorch.

Port of :mod:`tnmf_tpu.engine_minibatch`: one epoch of the minibatch MU
algorithms 4-8 of the reference (``TransformInvariantNMF.py:457-504``;
Serizel et al. 2016), H then W per batch in the given batch order.  The
JAX package has two paths for it, one ``lax.scan`` program on the device
over zero-padded batches and a Python loop, and its tests hold them to the
same trajectory (``tests/test_minibatch.py``).  The port keeps one: a
Python loop over the batches, each batch a slice of the samples (a ragged
final batch stays a short slice), each step the engine's launches at the
batch's size.  H is updated in place, batch by batch, as the JAX
package's ``set_H_slice`` does.

The steps go through the engine (:func:`~tnmf_tpu_torch.engine._mu_H`,
:func:`~tnmf_tpu_torch.engine.grad_W_stats`,
:func:`~tnmf_tpu_torch.engine.apply_W_update`), so the kernels are K3 (K4
when inhibited) or the strategy's pair with K1's ``mu_ratio`` for H, K2 on
conv for the W statistics and K1's ``mu_w`` for every W update, under the
engine's gates and the ``use_pallas`` switch.  Nothing here reads a value
back to the host.
"""

from __future__ import annotations

from enum import Enum
from typing import Optional, Sequence, Tuple

import torch

from . import engine
from .ops.modes import ConvPlan

Stat = Optional[Tuple[torch.Tensor, torch.Tensor]]


class MiniBatchAlgorithm(Enum):
    """Minibatch MU schemes (algorithm numbers from Serizel et al. 2016;
    reference ``TransformInvariantNMF.py:47-55``)."""
    Cyclic_MU = 4   # H per batch; W from gradient summed over the epoch
    ASG_MU = 5      # shuffled batches; H then W update per batch
    GSG_MU = 6      # H per shuffled batch; single W update from the last batch
    ASAG_MU = 7     # per batch: H update + exp-averaged W gradient + W update
    GSAG_MU = 8     # H per batch; one exp-averaged W gradient + update per epoch


def _averaged(stat: Stat, neg: torch.Tensor, pos: torch.Tensor, sag_lambda: float):
    """The SAG statistics after one more batch; they start at zero, as the
    JAX package's do."""
    if stat is None:
        stat = (torch.zeros_like(neg), torch.zeros_like(pos))
    return engine.accumulate_gradient(*stat, neg, pos, sag_lambda)


def _batch_mask(mask: Optional[torch.Tensor], s: slice) -> Optional[torch.Tensor]:
    """A batch's rows of the mask; a broadcast (one-sample) mask serves
    every batch as it is (the JAX package's ``_mask_slice``)."""
    return mask if mask is None or mask.shape[0] == 1 else mask[s]


@engine._pinned
def minibatch_epoch(Vp: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
                    batches: Sequence[slice], order: Sequence[int], inner_stat: Stat,
                    sag_lambda: float, sparsity: float, inhibition: float = 0.,
                    cross_inhibition: float = 0., kernels: Sequence = (), *,
                    plan: ConvPlan, algorithm: MiniBatchAlgorithm,
                    strategy: engine.Strategy = 'conv',
                    use_inhibition: bool = False, use_cross: bool = False,
                    use_pallas: bool = True, beta: float = 2.0,
                    mask: Optional[torch.Tensor] = None, l2_H: Optional[float] = None,
                    ortho_W: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor, Stat]:
    """One epoch of ``algorithm`` over ``batches`` (sample slices of the
    prepared data ``Vp`` and of ``H``) visited in ``order``:

    * Cyclic_MU sums the batches' W statistics and updates W once, at the
      epoch's end;
    * ASG_MU updates W after each batch;
    * GSG_MU updates W once, from the last batch of the order;
    * ASAG_MU averages the statistics (``sag_lambda``) and updates W after
      each batch;
    * GSAG_MU averages the last batch's statistics once, at the epoch's end.

    ``inner_stat`` is the averaged ``(neg, pos)`` of ASAG_MU and GSAG_MU,
    carried across epochs (``None`` to start).  ``H`` is written in place.
    Returns ``(W, H, inner_stat)``; Cyclic_MU returns ``None`` for the
    statistics, which it restarts each epoch.

    ``beta``, ``l2_H`` and ``ortho_W`` (None: absent) are the objective's,
    as in :func:`~tnmf_tpu_torch.engine.update_step`.  ``mask`` has the
    samples of ``Vp`` or one broadcast sample (which serves every batch);
    each batch takes its rows.  ``ortho_W`` is formed from the current W at
    each W update, never added into the averaged statistics.  Under a
    transform group (``strategy = (base, group)``) the statistics are the
    tied-back ones, so the SAG state keeps the canonical W's shape."""
    A = MiniBatchAlgorithm
    h_flags = dict(plan=plan, strategy=strategy, use_inhibition=use_inhibition,
                   use_cross=use_cross, use_pallas=use_pallas, beta=beta, l2=l2_H)
    w_flags = dict(plan=plan, strategy=strategy, use_pallas=use_pallas, beta=beta)

    def stats(s, W, Hb):
        return engine.grad_W_stats(Vp[s], W, Hb, _batch_mask(mask, s), **w_flags)

    def apply(W, stat):
        return engine.apply_W_update(W, *stat, ortho_W, n_shift_axes=plan.ndim,
                                     use_pallas=use_pallas)

    total: Stat = None
    for s in (batches[i] for i in order):
        Hb = engine._mu_H(Vp[s], W, H[s], sparsity, inhibition, cross_inhibition, kernels,
                          mask=_batch_mask(mask, s), **h_flags)
        H[s] = Hb
        if algorithm is A.Cyclic_MU:
            neg, pos = stats(s, W, Hb)
            total = (neg, pos) if total is None else (total[0] + neg, total[1] + pos)
        elif algorithm is A.ASG_MU:
            W = apply(W, stats(s, W, Hb))
        elif algorithm is A.ASAG_MU:
            inner_stat = _averaged(inner_stat, *stats(s, W, Hb), sag_lambda)
            W = apply(W, inner_stat)
        elif algorithm not in (A.GSG_MU, A.GSAG_MU):
            raise ValueError(f'unknown minibatch algorithm {algorithm!r}')
    if algorithm is A.Cyclic_MU:
        return apply(W, total), H, None
    if algorithm is A.GSG_MU:
        W = apply(W, stats(s, W, H[s]))
    elif algorithm is A.GSAG_MU:
        inner_stat = _averaged(inner_stat, *stats(s, W, H[s]), sag_lambda)
        W = apply(W, inner_stat)
    return W, H, inner_stat
