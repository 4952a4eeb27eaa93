"""K1: the elementwise multiplicative-update ratio ``arr * neg / (pos + reg)``,
and the W epilogue of the MU step built on it.

Replaces ``tnmf_tpu/experimental/pallas_mu.py::mu_ratio``; the CUDA kernels
are in ``tnmf_tpu_torch/csrc/mu_ratio.cu``.

:func:`mu_ratio` is the ratio alone, the direct counterpart of the Pallas
kernel: bound by device-memory bandwidth (three reads and one write per
element, no reuse), a grid-stride loop with 16-byte vector accesses.  It is
the H epilogue of the fft and dot strategies (``H * neg / (pos + EPS +
sparsity)`` after their gradient pair), which the JAX engine forms in
``jnp`` (``tnmf_tpu/engine.py:479``): ``pallas_mu.mu_ratio`` is the TPU
kernel with that body, and nothing in the JAX package calls it.  On the
conv strategy K3 fuses the ratio.  Any shape runs, so the engine gates K1
on the dtype alone (:func:`tnmf_tpu_torch.engine.dtype_reason`).

:func:`mu_w` is the W epilogue of :func:`tnmf_tpu_torch.engine._mu_W`: the
ratio ``W * neg / (pos + EPS)`` and the atom normalisation of the JAX
package's ``_normalize_W`` (each (atom, channel) row divided by its sum
over the shift axes, an all-zero row kept zero) in one launch, one block
per row.  At the flagship W has only 16 x 1 x 9 x 9 entries, so the launch
is the cost, and the fusion makes one launch of the six the ratio and the
normalisation took.  Its row sums run in another order than the plain
version's, so the two agree to float32 rounding, not bit for bit.

The model axis (a sweep's S models in one launch, reached through the
operators' vmap rules in :mod:`tnmf_tpu_torch.kernels.ops`): with
``model_axis=True`` the tensors are ``(S, ...)`` stacks, and
:func:`mu_ratio` takes ``reg`` as an ``(S,)`` vector of per-model values,
read on the card at ``index / per_model_numel``; :func:`mu_w` needs no
more, since W's ``reg`` is the constant ``EPS`` and its rows are
independent: the ``S * M * C`` rows of the stack are one launch.  Each
model gets the bits of its own launch.
"""

from __future__ import annotations

import math

import torch

from . import _build


def mu_ratio_plain(arr: torch.Tensor, neg: torch.Tensor, pos: torch.Tensor,
                   reg) -> torch.Tensor:
    """The plain PyTorch version of the kernel (``reg`` a float, or the
    ``(S,)`` per-model vector of ``(S, ...)`` stacks)."""
    if isinstance(reg, torch.Tensor) and reg.dim() == 1:
        reg = reg.to(arr.dtype).reshape((-1,) + (1,) * (arr.dim() - 1))
    return arr * neg / (pos + reg)


def mu_ratio(arr: torch.Tensor, neg: torch.Tensor, pos: torch.Tensor,
             reg, model_axis: bool = False) -> torch.Tensor:
    """``arr * neg / (pos + reg)``: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors (float32, contiguous, same shape).  With
    ``model_axis`` the tensors are ``(S, ...)`` stacks of a sweep's S
    models and ``reg`` may be an ``(S,)`` tensor of each model's value: one
    launch for all S models, each bit-equal to its own launch."""
    if model_axis and isinstance(reg, torch.Tensor) and tuple(reg.shape) != arr.shape[:1]:
        raise ValueError(f'mu_ratio: expected one reg per model, shape ({arr.shape[0]},), '
                         f'got {tuple(reg.shape)}')
    if arr.device.type == 'cpu':
        return mu_ratio_plain(arr, neg, pos, reg)
    _build.check_inputs('mu_ratio', arr, neg, pos)
    if neg.shape != arr.shape or pos.shape != arr.shape:
        raise ValueError(f'mu_ratio: shapes {tuple(arr.shape)}, '
                         f'{tuple(neg.shape)}, {tuple(pos.shape)} differ')
    out = torch.empty_like(arr)
    if arr.numel() == 0:
        return out
    regs = (_build.model_vector(reg, arr.shape[0], arr.device)
            if model_axis and isinstance(reg, torch.Tensor) else None)
    lib = _build.library()
    with torch.cuda.device(arr.device):
        err = lib.tnmf_mu_ratio(arr.data_ptr(), neg.data_ptr(), pos.data_ptr(),
                                0. if regs is not None else float(reg),
                                None if regs is None else regs.data_ptr(),
                                0 if regs is None else arr.numel() // arr.shape[0],
                                out.data_ptr(), arr.numel(), _build.stream_of(arr))
    _build.check_launch(err, 'mu_ratio')
    mu_ratio.launches += 1
    mu_ratio.model_launches += model_axis
    return out


#: kernel launches since the last reset (plain counts, read by chip_smoke.py):
#: all of them, and those over a model axis
mu_ratio.launches = 0
mu_ratio.model_launches = 0


def mu_w_plain(W: torch.Tensor, neg: torch.Tensor, pos: torch.Tensor, reg: float,
               n_shift_axes: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`mu_w`: the ratio, then each row
    divided by its sum over the last ``n_shift_axes`` axes (a zero sum
    divides by 1)."""
    ratio = W * neg / (pos + reg)
    s = ratio.sum(dim=tuple(range(-n_shift_axes, 0)), keepdim=True)
    return ratio / torch.where(s == 0, torch.ones_like(s), s)


def mu_w(W: torch.Tensor, neg: torch.Tensor, pos: torch.Tensor, reg: float,
         n_shift_axes: int, model_axis: bool = False) -> torch.Tensor:
    """The W epilogue ``W * neg / (pos + reg)``, sum-normalised over the
    last ``n_shift_axes`` axes: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (float32, contiguous, same shape).
    ``model_axis``: ``W`` is an ``(S, M, C, *A)`` stack of a sweep's S
    dictionaries, one launch over its ``S * M * C`` rows (which only the
    count of model-axis launches tells apart)."""
    if W.device.type == 'cpu':
        return mu_w_plain(W, neg, pos, reg, n_shift_axes)
    _build.check_inputs('mu_w', W, neg, pos)
    if neg.shape != W.shape or pos.shape != W.shape:
        raise ValueError(f'mu_w: shapes {tuple(W.shape)}, '
                         f'{tuple(neg.shape)}, {tuple(pos.shape)} differ')
    if not 0 < n_shift_axes <= W.dim():
        raise ValueError(f'mu_w: {n_shift_axes} shift axes of a {W.dim()}-D W')
    out = torch.empty_like(W)
    row_len = math.prod(W.shape[W.dim() - n_shift_axes:])
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(W.device):
        err = lib.tnmf_mu_w(W.data_ptr(), neg.data_ptr(), pos.data_ptr(), float(reg),
                            out.data_ptr(), W.numel() // row_len, row_len,
                            _build.stream_of(W))
    _build.check_launch(err, 'mu_w')
    mu_w.launches += 1
    mu_w.model_launches += model_axis
    return out


#: kernel launches since the last reset (plain counts, read by chip_smoke.py):
#: all of them, and those over a model axis
mu_w.launches = 0
mu_w.model_launches = 0
