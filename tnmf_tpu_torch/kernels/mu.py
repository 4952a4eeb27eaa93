"""K1: the elementwise multiplicative-update ratio ``arr * neg / (pos + reg)``.

Replaces ``tnmf_tpu/experimental/pallas_mu.py::mu_ratio``; the CUDA kernel is
``tnmf_tpu_torch/csrc/mu_ratio.cu``.  On the main path it forms the W
epilogue ``W * neg / (pos + EPS)`` of :func:`tnmf_tpu_torch.engine._mu_W`.

Bound by device-memory bandwidth: three reads and one write per element and
no reuse.  The kernel is a grid-stride loop with 16-byte vector accesses.
At the flagship shape W has only 16 x 1 x 9 x 9 entries, so there the call
costs its launch.
"""

from __future__ import annotations

import torch

from . import _build


def mu_ratio_plain(arr: torch.Tensor, neg: torch.Tensor, pos: torch.Tensor,
                   reg: float) -> torch.Tensor:
    """The plain PyTorch version of the kernel."""
    return arr * neg / (pos + reg)


def mu_ratio(arr: torch.Tensor, neg: torch.Tensor, pos: torch.Tensor,
             reg: float) -> torch.Tensor:
    """``arr * neg / (pos + reg)``: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors (float32, contiguous, same shape)."""
    if arr.device.type == 'cpu':
        return mu_ratio_plain(arr, neg, pos, reg)
    _build.check_inputs('mu_ratio', arr, neg, pos)
    if neg.shape != arr.shape or pos.shape != arr.shape:
        raise ValueError(f'mu_ratio: shapes {tuple(arr.shape)}, '
                         f'{tuple(neg.shape)}, {tuple(pos.shape)} differ')
    out = torch.empty_like(arr)
    if arr.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(arr.device):
        err = lib.tnmf_mu_ratio(arr.data_ptr(), neg.data_ptr(), pos.data_ptr(),
                                float(reg), out.data_ptr(), arr.numel(),
                                _build.stream_of(arr))
    _build.check_launch(err, 'mu_ratio')
    mu_ratio.launches += 1
    return out


#: kernel launches since the last reset (a plain count, read by chip_smoke.py)
mu_ratio.launches = 0
