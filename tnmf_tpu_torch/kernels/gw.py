"""K2: the W-gradient statistics (neg, pos) of the multiplicative W update.

Replaces ``tnmf_tpu/experimental/pallas_gw.py::grad_w_gemm``; the CUDA kernel
is ``tnmf_tpu_torch/csrc/grad_w.cu``.  With ``X2 = [Vp | Rx]`` (the
mode-extended data and reconstruction stacked along channels) it computes

    G[m, c2, ax, ay] = sum_{n, tx, ty} X2[n, c2, tx+ax, ty+ay] * H[n, m, tx, ty]

and returns ``(neg, pos) = (G[:, :C], G[:, C:])``, each ``(M, C, *atom)``.

A contraction over a huge axis (``N*Tx*Ty``, 4.5 M at the flagship
64 x 1 x 256 x 256 with 16 atoms of 9 x 9) into a tiny output (2,592
values): 23 GFLOP against about 0.37 GB of reads, so FP32 FMA issue and
shared-memory loads bound it.  The kernel splits the contraction over
chunks of ``(n, tx rows, ty columns)`` staged in shared memory, keeps a
4-atom x 4-offset register tile per thread across all of a block's chunks,
and reduces the per-block partial sums in a second pass in a fixed order
(deterministic, no float atomics).  It is not the TPU kernel's lane-rolled
GEMM, which only served the TPU's matrix unit.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..ops import conv
from ..ops.modes import ConvPlan
from . import _build

# must match grad_w.cu
_THREADS = 256
_MT = 4
_AT = 4
#: shared-memory budget for one block's staged chunk (bytes); 2-3 blocks
#: stay resident per SM
_SMEM_BUDGET = 96 * 1024
_BLOCKS_PER_SM = 4


def grad_w_plain(X2: torch.Tensor, H: torch.Tensor,
                 plan: ConvPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: stacked ``corr_W`` convolutions, one per
    sample, summed over the samples.  One convolution over all ``N*Tx*Ty``
    positions is less accurate on the GPU: at the flagship cuDNN's float32
    result was 3.3e-4 off a float64 one (relative to its largest value, on
    an H100, whatever the TF32 settings), the per-sample sum is not."""
    del plan  # the shapes carry the geometry
    G = torch.stack([conv.corr_W(X2[n:n + 1], H[n:n + 1])
                     for n in range(X2.shape[0])]).sum(dim=0)
    c = X2.shape[1] // 2
    return G[:, :c], G[:, c:]


def _geometry(N: int, M: int, C2: int, Tx: int, Ty: int, Ax: int, Ay: int,
              n_sm: int) -> dict:
    """Chunk sizes, grid and shared memory of the kernel for one problem."""
    n_mt = -(-M // _MT)
    n_at = -(-Ay // _AT)
    tc = -(-Ty // -(-Ty // 64))  # <= 64 columns, near-equal chunks
    for rows in (8, 4, 2, 1):
        tr = -(-Tx // -(-Tx // rows))
        xw = tc + n_at * _AT - 1
        floats = n_mt * _MT * tr * tc + C2 * (tr + Ax - 1) * xw
        if 4 * floats <= _SMEM_BUDGET:
            break
    smem = 4 * floats
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(
            f'grad_w: a chunk of {M} atoms x {C2} channels needs {smem} bytes of '
            'shared memory, more than a block can hold')
    n_chunks = N * -(-Tx // tr) * -(-Ty // tc)
    n_tiles = n_mt * C2 * Ax * n_at
    return dict(tile_rows=tr, tile_cols=tc, smem_bytes=smem,
                grid_x=min(n_chunks, _BLOCKS_PER_SM * n_sm),
                grid_y=-(-n_tiles // _THREADS))


def grad_w(X2: torch.Tensor, H: torch.Tensor,
           plan: ConvPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(neg, pos)`` W-gradient statistics: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (float32, contiguous, 1-D or
    2-D shifts)."""
    if X2.device.type == 'cpu':
        return grad_w_plain(X2, H, plan)
    _build.check_inputs('grad_w', X2, H)
    if plan.ndim not in (1, 2):
        raise ValueError(f'grad_w: the kernel takes 1-D or 2-D shifts, got {plan.ndim}-D')
    T, A = plan.transform_shape, plan.atom_shape
    N, C2 = X2.shape[:2]
    M = H.shape[1]
    if (C2 % 2 or H.shape[0] != N or tuple(H.shape[2:]) != T
            or tuple(X2.shape[2:]) != tuple(t + a - 1 for t, a in zip(T, A))):
        raise ValueError(f'grad_w: X2 {tuple(X2.shape)} and H {tuple(H.shape)} '
                         f'do not fit the plan (T={T}, A={A})')
    if plan.ndim == 1:  # a 1-D problem is a 2-D one with one row
        T, A = (1,) + T, (1,) + A
    (Tx, Ty), (Ax, Ay) = T, A
    n_sm = torch.cuda.get_device_properties(X2.device).multi_processor_count
    g = _geometry(N, M, C2, Tx, Ty, Ax, Ay, n_sm)
    C = C2 // 2
    out = torch.empty((2, M, C) + plan.atom_shape, device=X2.device, dtype=torch.float32)
    scratch = torch.empty((g['grid_x'], M * C2 * math.prod(A)), device=X2.device,
                          dtype=torch.float32)
    lib = _build.library()
    with torch.cuda.device(X2.device):
        err = lib.tnmf_grad_w(
            X2.data_ptr(), H.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            N, M, C2, Tx + Ax - 1, Ty + Ay - 1, Tx, Ty, Ax, Ay,
            g['tile_rows'], g['tile_cols'], g['grid_x'], g['grid_y'],
            g['smem_bytes'], _build.stream_of(X2))
    _build.check_launch(err, 'grad_w')
    grad_w.launches += 1
    return out[0], out[1]


#: kernel launches since the last reset (a plain count, read by chip_smoke.py)
grad_w.launches = 0
