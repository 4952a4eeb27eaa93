"""K5: the Gauss-Seidel component sweep of the HALS solvers.

A kernel of the port with no Pallas counterpart: the JAX package runs the
sweep as one on-device ``lax.fori_loop`` of ``m`` dependent steps
(``tnmf_tpu/engine_hals.py:98``, ``_sweep_H``), which eager PyTorch would
run as about six launches per component.  :func:`hals_sweep` runs ``inner``
whole sweeps in one launch of ``tnmf_tpu_torch/csrc/hals_sweep.cu``; the
source says what bounds it and how it is laid out.

The same function serves every sweep of
:mod:`tnmf_tpu_torch.engine_hals` and :mod:`tnmf_tpu_torch.engine_hals_conv`:
the H sweep ``hals_sweep(H, W W^T, V W^T, ...)``, the W sweep
``hals_sweep(W^T, A^T, B^T, ...)^T`` (``A = H^T H``, ``B = H^T V``; the
transposes are views, and the kernel's component-major operands are then
``W``, ``A`` and ``B`` themselves, with no copy) and the per-phase sweep of
the shift-invariant solver on the rows ``(n*K, M)``.
"""

from __future__ import annotations

import functools

import torch

from . import _build

#: threads per block, largest first: the largest that still gives every
#: multiprocessor a block
_THREADS = (128, 64, 32)


def hals_sweep_plain(X: torch.Tensor, G: torch.Tensor, P: torch.Tensor, l1: float, l2: float,
                     inner: int) -> torch.Tensor:
    """The plain PyTorch version: the JAX package's ``_sweep_H``
    (``tnmf_tpu/engine_hals.py:98-121``) applied ``inner`` times, a loop
    over the components vectorised over the rows of ``X (rows, m)``.  For
    each component ``j``: ``u = P[:, j] - X @ G[:, j] + X[:, j] * G[j, j] -
    l1`` and ``X[:, j] = max(u / max(G[j, j] + l2, tiny), 0)``, kept as it
    was where ``G[j, j] + l2 <= 0`` (sklearn's ``hess != 0`` skip); ``tiny``
    is float32's smallest normal, the JAX ``_TINY``."""
    X = X.clone()
    tiny = torch.finfo(torch.float32).tiny
    for _ in range(int(inner)):
        for j in range(X.shape[1]):
            gjj = G[j, j]
            xj = X[:, j]
            u = P[:, j] - X @ G[:, j] + xj * gjj - l1
            denom = gjj + l2
            new = torch.clamp(u / torch.clamp(denom, min=tiny), min=0.0)
            X[:, j] = torch.where(denom > 0, new, xj)
    return X


@functools.lru_cache(maxsize=None)
def _multiprocessors(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_geometry(rows: int, m: int, device: torch.device) -> tuple:
    """``(threads per block, dynamic shared memory bytes)`` of a launch:
    the largest block that still gives every multiprocessor one (32 at
    least), staging its rows in shared memory when they fit a block (0
    bytes: the rows stay in device memory)."""
    sms = _multiprocessors(device)
    threads = next((t for t in _THREADS if -(-rows // t) >= sms), _THREADS[-1])
    smem = threads * m * 4
    return threads, (smem if smem <= _build.MAX_SMEM_BYTES else 0)


def hals_sweep(X: torch.Tensor, G: torch.Tensor, P: torch.Tensor, l1: float, l2: float,
               inner: int) -> torch.Tensor:
    """``inner`` Gauss-Seidel sweeps over the ``m`` columns of ``X (rows,
    m)`` (:func:`hals_sweep_plain`'s function): the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (float32; ``G (m, m)``, ``P
    (rows, m)``), one launch for all the sweeps.  Returns ``(rows, m)``, a
    transposed view of the kernel's component-major output."""
    if X.device.type == 'cpu':
        return hals_sweep_plain(X, G, P, l1, l2, inner)
    rows, m = X.shape
    if G.shape != (m, m) or P.shape != X.shape:
        raise ValueError(f'hals_sweep: X {tuple(X.shape)}, G {tuple(G.shape)} and P '
                         f'{tuple(P.shape)} do not fit')
    if int(inner) < 1:
        raise ValueError(f'hals_sweep: inner must be >= 1, got {inner!r}')
    # component-major operands; a transposed view of a contiguous tensor
    # (the W sweep's W^T, A^T, B^T) is no copy
    xt, gt, pt = X.t().contiguous(), G.t().contiguous(), P.t().contiguous()
    _build.check_inputs('hals_sweep', xt, gt, pt)
    out = torch.empty_like(xt)
    if X.numel() == 0:
        return out.t()
    threads, smem = launch_geometry(rows, m, X.device)
    lib = _build.library()
    with torch.cuda.device(X.device):
        err = lib.tnmf_hals_sweep(xt.data_ptr(), gt.data_ptr(), pt.data_ptr(), float(l1),
                                  float(l2), int(inner), out.data_ptr(), rows, m, threads,
                                  smem, _build.stream_of(X))
    _build.check_launch(err, 'hals_sweep')
    hals_sweep.launches += 1
    return out.t()


#: kernel launches since the last reset (a plain count, read by chip_smoke.py)
hals_sweep.launches = 0
