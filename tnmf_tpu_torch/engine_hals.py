"""HALS (hierarchical alternating least squares) for the plain-NMF geometry,
in PyTorch.

Port of :mod:`tnmf_tpu.engine_hals`: exact block coordinate descent, the
alternative to the multiplicative updates where shift invariance
degenerates to classic NMF (``prod(transform_shape) == 1``).  With ``V``
flattened to ``(n, F)``, ``H`` to ``(n, m)`` and ``W`` to ``(m, F)``, each
outer iteration sweeps the components of H, then of W, in Gauss–Seidel
order, each component solved exactly:

    H[:, j] <- max(0, (P[:, j] - sum_{k != j} H[:, k] G[k, j] - l1)
                      / (G[j, j] + l2)),   G = W W^T,  P = V W^T
    W[j, :] <- max(0, (B[j, :] - sum_{k != j} A[j, k] W[k, :] - l1w)
                      / (A[j, j] + l2w)),  A = H^T H,  B = H^T V

This is sklearn's ``NMF(solver='cd')`` with the accelerated variant of
Gillis & Glineur 2012: each Gram pair is exact whatever the other factor
did last, so ``inner`` sweeps reuse it.  The Grams are four matrix products
(cuBLAS at the plan's precision, :func:`~tnmf_tpu_torch.ops.precision.matmul_pin`,
entered once per loop: TF32 at 'default' and 'high' on the card, full
float32 otherwise; K5's in-loop products stay float32 at every level, as
the JAX sweep passes no precision to them); each factor's ``inner`` sweeps
are one launch of K5
(:func:`~tnmf_tpu_torch.kernels.hals.hals_sweep`), the W sweep on ``W^T``
with ``A^T`` so that each step reads the row ``A[j, :]`` as the JAX
``_sweep_W`` does.  K5 is gated like K1 (:func:`engine.dtype_reason`):
float32 on CUDA takes the kernel, float64, CPU tensors and
``use_pallas=False`` its plain version.

The JAX package's blocked sweeps (``_sweep_H_blocked``, ``_sweep_W_blocked``)
are not ported as functions: its ``_iteration`` never routes to them, and
its docstring records them as a measured negative on the TPU (ROADMAP.md
queue 1, item 15).  Their algebra, panel products for the coupling across
blocks and a running correlation inside a block, is K5's design on the
card (``csrc/hals_sweep.cu``).

Data parallelism over the samples: with a ``process_group`` each rank
holds its own rows of V and H and a replica of W; ``G`` and ``P`` are its
own already, and ``A = H^T H`` and ``B = H^T V`` are summed over the ranks
in one ``all_reduce`` (:func:`tnmf_tpu_torch.engine.all_reduce_sum`)
after the products, so every rank's W sweep sees the whole batch's Grams,
as does the energy.

The energy is the MU engine's, ``0.5 * ||V - H W||_F^2``
(:func:`tnmf_tpu_torch.ops.beta.divergence` at beta = 2).  The JAX package
runs its loops as one on-device program each; here they are Python loops,
and the ``tol`` loop reads its stopping test on the host once per block.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from . import engine
from .kernels.hals import dot as _dot  # the Gram products: one per model under vmap
from .kernels.hals import hals_sweep_plain
from .kernels.ops import hals_sweep
from .ops import beta as beta_ops
from .ops.modes import ConvPlan
from .ops.precision import matmul_pin


def _acc_dtype(*xs) -> torch.dtype:
    """Accumulation dtype: at least float32."""
    dtype = xs[0].dtype
    for x in xs[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    return torch.promote_types(dtype, torch.float32)


def _pinned(fn):
    """Run ``fn`` with its products at the precision of its ``plan``
    keyword (None, or no plan: full float32), for the device and dtype of
    its first tensor: one pin per outermost call, none while a program is
    exported (:func:`~tnmf_tpu_torch.ops.precision.matmul_pin`)."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        plan = kwargs.get('plan')
        with matmul_pin(None if plan is None else plan.precision, args[0].device,
                        args[0].dtype):
            return fn(*args, **kwargs)
    return call


def _sweep_H(H: torch.Tensor, G: torch.Tensor, P: torch.Tensor, l1, l2, inner: int,
             use_pallas: bool = True) -> torch.Tensor:
    """``inner`` Gauss–Seidel passes over the ``m`` columns of ``H (rows,
    m)``: K5 where the gate allows it, else its plain version.  ``l1`` and
    ``l2`` are floats, or 0-d tensors (a sweep's per-model strengths under
    :func:`torch.func.vmap`, which reach K5 through ``tnmf::hals_sweep.t``)."""
    if engine.dtype_reason(H.dtype, use_pallas) is None:
        return hals_sweep(H, G, P, l1, l2, inner)
    return hals_sweep_plain(H, G, P, l1, l2, inner)


def _sweep_W(W: torch.Tensor, A: torch.Tensor, B: torch.Tensor, l1, l2, inner: int,
             use_pallas: bool = True) -> torch.Tensor:
    """``inner`` passes over the ``m`` dictionary rows of ``W (m, F)``: the
    H sweep on ``W^T`` with ``A^T`` and ``B^T``."""
    return _sweep_H(W.T, A.T, B.T, l1, l2, inner, use_pallas).T


def _iteration(V2, W2, H2, l1, l2, l1w, l2w, *, inner: int, update_H: bool,
               update_W: bool, use_pallas: bool = True, process_group=None):
    """One outer iteration: H sweeps (fresh Grams), then W sweeps.
    ``l1``/``l2`` regularize H, ``l1w``/``l2w`` the dictionary: floats, or
    0-d tensors, cast to the Grams' dtype as the JAX ``_iteration`` casts
    them.  No branch reads a tensor's value, so the sweeps run it under
    :func:`torch.func.vmap`.  ``process_group``: the ranks whose ``A`` and ``B``
    add up."""
    if update_H:
        Wt = W2.to(_acc_dtype(W2)).T
        G = _dot(W2, Wt)                                  # (m, m)
        P = _dot(V2, Wt)                                  # (n, m)
        H2 = _sweep_H(H2, G, P, _like(l1, G), _like(l2, G), inner, use_pallas)
    if update_W:
        Ht = H2.to(_acc_dtype(H2)).T
        A = _dot(Ht, H2)                                  # (m, m)
        B = _dot(Ht, V2)                                  # (m, F)
        A, B = engine.all_reduce_sum(A, B, process_group=process_group)
        W2 = _sweep_W(W2, A, B, _like(l1w, A), _like(l2w, A), inner, use_pallas)
    return W2, H2


def _like(x, G: torch.Tensor):
    """A strength in the Grams' dtype: a tensor cast, a float as it is."""
    return x.to(G.dtype) if isinstance(x, torch.Tensor) else x


def _flatten(V, W, H):
    """Canonical model tensors -> the 2-D HALS views."""
    return (V.reshape(V.shape[0], -1), W.reshape(W.shape[0], -1),
            H.reshape(H.shape[0], H.shape[1]))


def _canonical(X2: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A 2-D view back in ``like``'s shape, contiguous (K5's output takes
    its input's layout, so H stays row-major and W^T's output is a
    transposed view of a contiguous W: no copy)."""
    return X2.reshape(like.shape).contiguous()


def _energy(V2, W2, H2, process_group=None) -> torch.Tensor:
    R = _dot(H2, W2.to(_acc_dtype(W2)))
    return engine.all_reduce_sum(beta_ops.divergence(V2, R, 2.0).to(_acc_dtype(V2)),
                                 process_group=process_group)[0]


@_pinned
def update_step(V, W, H, l1, l2, l1w, l2w, *, inner: int, update_H: bool, update_W: bool,
                use_pallas: bool = True, plan: Optional[ConvPlan] = None, process_group=None):
    """One outer iteration on the canonical model shapes.  Returns ``(W, H)``.
    ``plan`` carries the precision of the Grams (the JAX engine's ``plan``
    keyword); without one they run in full float32.  ``process_group``: the ranks
    whose Grams add up (data parallelism over the samples)."""
    return fit_loop(V, W, H, 1, l1, l2, l1w, l2w, inner=inner, update_H=update_H,
                    update_W=update_W, use_pallas=use_pallas, plan=plan,
                    process_group=process_group)


@_pinned
def fit_loop(V, W, H, n_iterations, l1, l2, l1w, l2w, *, inner: int, update_H: bool,
             update_W: bool, use_pallas: bool = True, plan: Optional[ConvPlan] = None,
             process_group=None):
    """``n_iterations`` outer iterations.  Returns ``(W, H)``."""
    V2, W2, H2 = _flatten(V, W, H)
    for _ in range(int(n_iterations)):
        W2, H2 = _iteration(V2, W2, H2, l1, l2, l1w, l2w, inner=inner, update_H=update_H,
                            update_W=update_W, use_pallas=use_pallas, process_group=process_group)
    return _canonical(W2, W), _canonical(H2, H)


@_pinned
def fit_loop_energies(V, W, H, l1, l2, l1w, l2w, *, n_iterations: int, inner: int,
                      update_H: bool, update_W: bool, use_pallas: bool = True,
                      plan: Optional[ConvPlan] = None, process_group=None):
    """``n_iterations`` outer iterations with the energy after each, kept on
    the device.  Returns ``(W, H, energies)``."""
    V2, W2, H2 = _flatten(V, W, H)
    energies = engine.energy_trace(V2, int(n_iterations))
    for i in range(int(n_iterations)):
        W2, H2 = _iteration(V2, W2, H2, l1, l2, l1w, l2w, inner=inner, update_H=update_H,
                            update_W=update_W, use_pallas=use_pallas, process_group=process_group)
        energies[i] = _energy(V2, W2, H2, process_group)
    return _canonical(W2, W), _canonical(H2, H), energies


@_pinned
def fit_loop_tol(V, W, H, n_max, tol, l1, l2, l1w, l2w, *, check_every: int, n_buf: int = 0,
                 inner: int, update_H: bool, update_W: bool, use_pallas: bool = True,
                 plan: Optional[ConvPlan] = None, process_group=None):
    """Adaptive fit by :func:`tnmf_tpu_torch.engine.tol_loop`.  Returns ``(W, H, n_done, e_final,
    trace_or_None)``."""
    V2, W2, H2 = _flatten(V, W, H)

    def step(WH):
        return _iteration(V2, *WH, l1, l2, l1w, l2w, inner=inner, update_H=update_H,
                          update_W=update_W, use_pallas=use_pallas, process_group=process_group)

    (W2, H2), n_done, e, trace = engine.tol_loop(
        (W2, H2), step, lambda WH: _energy(V2, *WH, process_group), int(n_max), tol,
        int(check_every), int(n_buf), V2)
    return _canonical(W2, W), _canonical(H2, H), n_done, e, trace


#: the JAX package's cost model behind ``auto_inner``: its effective matrix
#: product rate (FLOP/s), its memory rate (bytes/s) and its time of one
#: Gauss–Seidel step (s), all three from the TPU it was tuned on.  Copied
#: unchanged so that ``'auto'`` picks the same count in both packages; not
#: calibrated on the card (ROADMAP.md queue 2).
_MXU_FLOPS = 8e13
_HBM_BPS = 6e11
_STEP_SECONDS = 3e-6


def auto_inner(n_components: int, n_features: int, inner: Optional[object] = 'auto',
               n_samples: Optional[int] = None) -> int:
    """The inner-sweep count, the JAX package's rule: an explicit count
    (>= 1) as given; ``'auto'`` (or None) ``clamp(round(0.5 + t_gram / (2
    t_sweep)), 1, 8)``, the Gram refresh's modelled time against the
    sweep's, buying extra (staler) sweeps only where a refresh costs more
    than the sweeps it would improve; without ``n_samples`` the FLOP-ratio
    fallback ``clamp(round(0.5 F / m), 1, 8)``."""
    if inner != 'auto' and inner is not None:
        iv = int(inner)
        if iv < 1:
            raise ValueError('hals_inner must be >= 1 or "auto"')
        return iv
    m, F = max(n_components, 1), n_features
    if not n_samples:
        return max(1, min(8, round(0.5 * F / m)))
    n = n_samples
    t_gram = (2 * n * m * F + 2 * m * m * F) / _MXU_FLOPS + 4 * n * F / _HBM_BPS
    t_sweep = m * _STEP_SECONDS + 2 * n * m * m / _MXU_FLOPS
    return max(1, min(8, round(0.5 + t_gram / (2 * t_sweep))))
