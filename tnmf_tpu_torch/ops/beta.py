"""The reconstruction objective.

Port of :func:`tnmf_tpu.ops.beta.divergence` for the Euclidean case
(beta = 2), the reference energy ``0.5 * sum((V - R)**2)``.  The other
beta-divergences are not ported yet (ROADMAP.md queue 1, item 10).
"""

from __future__ import annotations

import torch


def divergence(V: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """``D_2(V || R) = 0.5 * sum((V - R)**2)`` as a 0-d tensor, accumulated
    in ``promote_types(V.dtype, float32)``."""
    acc = torch.promote_types(V.dtype, torch.float32)
    d = V.to(acc) - R.to(acc)
    return torch.sum(0.5 * d * d)
