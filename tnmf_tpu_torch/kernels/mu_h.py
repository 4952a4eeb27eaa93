"""K3: the fused multiplicative H update.

Replaces ``tnmf_tpu/experimental/pallas_phased.py::mu_h``; the CUDA kernel
is ``tnmf_tpu_torch/csrc/mu_h.cu``.  For the mode-extended data ``Vp`` and
reconstruction ``Rx`` it computes

    H' = H * corr(Vp, W) / (corr(Rx, W) [+ pos_extra] + denom_add)

with both correlations and the ratio in one pass and float32 accumulation,
in the canonical ``(N, M, *T)`` layout (not the TPU kernel's phase-blocked
one).  The two gradient maps never reach device memory: only H is read and
H' written at activation size.

23 GFLOP of FP32 FMAs at the flagship (64 x 1 x 256 x 256, 16 atoms of
9 x 9), so FMA issue bounds it.  A block computes a 16 x 64 position tile
of one sample for 8 atoms from shared-memory windows of Vp and Rx and a
transposed copy of its atoms; each thread holds 4 positions x 8 atoms of
both correlations in registers.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import conv
from . import _build

# must match mu_h.cu
_TILE_X = 16
_TILE_Y = 64
_ATOMS_PER_BLOCK = 8


def mu_h_plain(Vp: torch.Tensor, Rx: torch.Tensor, W: torch.Tensor,
               H: torch.Tensor, denom_add: float,
               pos_extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version: the stacked ``corr_H`` convolution, then
    the ratio (the same order of operations as ``engine._mu_H``)."""
    neg, pos = conv.grad_H_pair_prepared(Vp, Rx, W)
    if pos_extra is not None:
        pos = pos + pos_extra
    return H * neg / (pos + denom_add)


def _geometry(C: int, Ax: int, Ay: int) -> dict:
    """Window pitch and shared memory of the kernel for one problem."""
    xw = _TILE_Y + Ay - 1
    pitch = xw + (16 - xw) % 32  # 16 mod 32: a warp's two rows hit disjoint banks
    floats = 2 * C * (_TILE_X + Ax - 1) * pitch + C * Ax * Ay * _ATOMS_PER_BLOCK
    smem = 4 * floats
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(
            f'mu_h: {C} channels with {Ax}x{Ay} atoms need {smem} bytes of shared '
            'memory, more than a block can hold')
    return dict(pitch=pitch, smem_bytes=smem)


def mu_h(Vp: torch.Tensor, Rx: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
         denom_add: float, pos_extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused H update: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors (float32, contiguous, 1-D or 2-D shifts)."""
    if Vp.device.type == 'cpu':
        return mu_h_plain(Vp, Rx, W, H, denom_add, pos_extra)
    extra = () if pos_extra is None else (pos_extra,)
    _build.check_inputs('mu_h', Vp, Rx, W, H, *extra)
    nd = H.dim() - 2
    if nd not in (1, 2):
        raise ValueError(f'mu_h: the kernel takes 1-D or 2-D shifts, got {nd}-D')
    N, M = H.shape[:2]
    C = W.shape[1]
    T, A = tuple(H.shape[2:]), tuple(W.shape[2:])
    if (Vp.shape != Rx.shape or tuple(Vp.shape[:2]) != (N, C) or W.shape[0] != M
            or tuple(Vp.shape[2:]) != tuple(t + a - 1 for t, a in zip(T, A))
            or (pos_extra is not None and pos_extra.shape != H.shape)):
        raise ValueError(
            f'mu_h: shapes Vp {tuple(Vp.shape)}, Rx {tuple(Rx.shape)}, '
            f'W {tuple(W.shape)}, H {tuple(H.shape)} do not fit together')
    if N > 65535:
        raise ValueError(f'mu_h: at most 65535 samples per launch, got {N}')
    if nd == 1:  # a 1-D problem is a 2-D one with one row
        T, A = (1,) + T, (1,) + A
    (Tx, Ty), (Ax, Ay) = T, A
    g = _geometry(C, Ax, Ay)
    out = torch.empty_like(H)
    lib = _build.library()
    with torch.cuda.device(H.device):
        err = lib.tnmf_mu_h(
            Vp.data_ptr(), Rx.data_ptr(), W.data_ptr(), H.data_ptr(),
            None if pos_extra is None else pos_extra.data_ptr(),
            float(denom_add), out.data_ptr(), N, M, C, Tx + Ax - 1, Ty + Ay - 1,
            Tx, Ty, Ax, Ay, g['pitch'], g['smem_bytes'], _build.stream_of(H))
    _build.check_launch(err, 'mu_h')
    mu_h.launches += 1
    return out


#: kernel launches since the last reset (a plain count, read by chip_smoke.py)
mu_h.launches = 0
