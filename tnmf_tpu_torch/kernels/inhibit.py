"""K4: the multiplicative H update with lateral inhibition.

Replaces ``tnmf_tpu/experimental/pallas_mu.py::inhibited_mu_h``; the CUDA
kernel is ``tnmf_tpu_torch/csrc/inhibited_mu_h.cu``.  For the activations H
and the H-gradient parts ``neg``, ``pos`` (all ``(N, M, *T)``, 1 or 2 shift
axes) it computes

    g   = H (*) k_x [(*) k_y]                 (separable, zero-padded)
    pos = pos + inh * (g - H)                 (use_same)
              + cross / (M - 1) * (sum_m g - g)   (use_cross)
    H'  = H * neg / (pos + reg)

in one pass with float32 accumulation, so the inhibition field never
reaches device memory.

Bound by device-memory bandwidth: three reads and one write per element
against ``tx + ty`` FMAs of the stencil (at the inhibited flagship,
64 x 16 x 264 x 264 with 17 x 17 taps, 1.14 GB against 4.9 GFLOP).  A block
owns one sample's tile of positions for all atoms, so the cross-atom sum
stays in shared memory; it stages one atom's H tile with its halo at a
time, runs the y pass into shared scratch and the x pass into the atom's
slice of the field.  The tile shrinks along x when many atoms fill shared
memory.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops.inhibition import cross_scale, inhibition_positive_term
from . import _build

# must match inhibited_mu_h.cu
_THREADS = 256
#: columns of a 2-D tile (one warp's width of coalesced accesses)
_TILE_Y_2D = 32
_TILE_X_2D = (32, 16, 8, 4, 2, 1)
_TILE_Y_1D = (256, 128, 64, 32)


def inhibited_mu_h_plain(H: torch.Tensor, neg: torch.Tensor, pos: torch.Tensor,
                         kernels: Sequence, inhibition: float, cross_inhibition: float,
                         reg: float, *, use_same: bool = True,
                         use_cross: bool = False) -> torch.Tensor:
    """The plain PyTorch version: ``pos`` plus the inhibition term of
    :func:`~tnmf_tpu_torch.ops.inhibition.inhibition_positive_term`, then
    the ratio (the order of ``engine._mu_H`` in the JAX package)."""
    term = inhibition_positive_term(H, kernels, H.dim() - 2, inhibition, cross_inhibition,
                                    H.shape[1], use_same, use_cross)
    return H * neg / (pos + term + reg)


def _smem_floats(M: int, tile_x: int, tile_y: int, tx: int, ty: int, two_d: bool) -> int:
    hx, hy = tile_x + tx - 1, tile_y + ty - 1
    return M * tile_x * tile_y + hx * hy + (hx * tile_y if two_d else 0) + tx + ty


def _geometry(M: int, tx: int, ty: int, two_d: bool) -> dict:
    """The tile of one block and its shared memory: the largest tile that
    leaves room for two blocks per SM, else the largest that fits one."""
    tiles = ([(t, _TILE_Y_2D) for t in _TILE_X_2D] if two_d
             else [(1, t) for t in _TILE_Y_1D])
    for limit in (_build.MAX_SMEM_BYTES // 2, _build.MAX_SMEM_BYTES):
        for tile_x, tile_y in tiles:
            smem = 4 * _smem_floats(M, tile_x, tile_y, tx, ty, two_d)
            if smem <= limit:
                return dict(tile_x=tile_x, tile_y=tile_y, smem_bytes=smem)
    raise ValueError(
        f'inhibited_mu_h: {M} atoms with {tx}x{ty} taps need more shared memory '
        'than a block can hold')


def inhibited_mu_h(H: torch.Tensor, neg: torch.Tensor, pos: torch.Tensor,
                   kernels: Sequence, inhibition: float, cross_inhibition: float,
                   reg: float, *, use_same: bool = True,
                   use_cross: bool = False) -> torch.Tensor:
    """Inhibited H update: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (float32, contiguous, 1-D or 2-D shifts, odd
    taps).  The signature is the JAX package's."""
    if H.device.type == 'cpu':
        return inhibited_mu_h_plain(H, neg, pos, kernels, inhibition, cross_inhibition, reg,
                                    use_same=use_same, use_cross=use_cross)
    _build.check_inputs('inhibited_mu_h', H, neg, pos)
    nd = H.dim() - 2
    if nd not in (1, 2):
        raise ValueError(f'inhibited_mu_h: the kernel takes 1-D or 2-D shifts, got {nd}-D')
    if neg.shape != H.shape or pos.shape != H.shape:
        raise ValueError(f'inhibited_mu_h: shapes H {tuple(H.shape)}, '
                         f'neg {tuple(neg.shape)}, pos {tuple(pos.shape)} differ')
    ks = [torch.as_tensor(k, dtype=torch.float32, device=H.device).reshape(-1)
          for k in kernels]
    if len(ks) != nd or any(k.numel() % 2 == 0 for k in ks):
        raise ValueError(f'inhibited_mu_h: expected {nd} kernels of odd length, '
                         f'got lengths {[k.numel() for k in ks]}')
    N, M = H.shape[:2]
    if N > 65535:
        raise ValueError(f'inhibited_mu_h: at most 65535 samples per launch, got {N}')
    cross = cross_scale(cross_inhibition, M) if use_cross else 0.
    if nd == 1:  # a 1-D problem is a 2-D one with one row and one x tap
        ks = [torch.ones(1, dtype=torch.float32, device=H.device)] + ks
    X, Y = (1,) + tuple(H.shape[2:]) if nd == 1 else tuple(H.shape[2:])
    tx, ty = ks[0].numel(), ks[1].numel()
    g = _geometry(M, tx, ty, nd == 2)
    out = torch.empty_like(H)
    if out.numel() == 0:
        return out
    taps = torch.cat(ks)
    lib = _build.library()
    with torch.cuda.device(H.device):
        err = lib.tnmf_inhibited_mu_h(
            H.data_ptr(), neg.data_ptr(), pos.data_ptr(), taps.data_ptr(), out.data_ptr(),
            N, M, X, Y, tx, ty, g['tile_x'], g['tile_y'], float(inhibition), float(cross),
            float(reg), int(use_same), int(use_cross), int(nd == 2), g['smem_bytes'],
            _build.stream_of(H))
    _build.check_launch(err, 'inhibited_mu_h')
    inhibited_mu_h.launches += 1
    return out


#: kernel launches since the last reset (a plain count, read by chip_smoke.py)
inhibited_mu_h.launches = 0
