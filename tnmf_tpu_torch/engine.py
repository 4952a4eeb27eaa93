"""Execution engine of the multiplicative-update (MU) algorithm, in PyTorch.

Port of the full-batch MU path of :mod:`tnmf_tpu.engine`: the same functions
with the same ``(W, H)`` result contract, run eagerly.  The fit loop is a
Python loop; each iteration updates H, then W (reference ``fit_batch`` loop
body, ``TransformInvariantNMF.py:334-340``).

Three strategies of the JAX package are ported: direct convolution
(:mod:`tnmf_tpu_torch.ops.conv`), FFT (:mod:`tnmf_tpu_torch.ops.fft`) and
the plain-NMF matmuls (:mod:`tnmf_tpu_torch.ops.dot`).  The functions here
take the JAX engine's ``strategy`` keyword (default ``'conv'``) and look its
operators up with :func:`get_ops`; the TPU-only ``'phased'`` lowering is
refused by :func:`require_ported`.  On CUDA tensors the hot operators run
through the hand-written kernels.  On the conv strategy: the H update
through K3 (:func:`~tnmf_tpu_torch.kernels.mu_h.mu_h`), the W statistics
through K2 (:func:`~tnmf_tpu_torch.kernels.gw.grad_w`).  On fft and dot the
strategy's own operators form the gradient pairs (cuFFT and cuBLAS) and K1
(:func:`~tnmf_tpu_torch.kernels.mu.mu_ratio`) forms the H ratio, where the
JAX engine forms ``H * neg / (pos + EPS + sparsity)`` in ``jnp``
(``tnmf_tpu/engine.py:479``; ``pallas_mu.mu_ratio`` is the TPU kernel with
that body, which nothing there calls).  K2 and K3 stay conv-only, as
``pallas_gw`` and ``pallas_phased`` do.  On every strategy the W ratio with
the atom normalisation runs through K1's W epilogue
(:func:`~tnmf_tpu_torch.kernels.mu.mu_w`) and the inhibited H update
(lateral inhibition on) through K4
(:func:`~tnmf_tpu_torch.kernels.inhibit.inhibited_mu_h`).  On CPU tensors
the same wrappers run their plain versions.  The conv reconstruction stays a
convolution (cuDNN, TF32 off), as the JAX package left it to XLA.

Kernel gates, asked before any launch: K2, K3 and K4 serve float32
problems with 1-D and 2-D shifts, the scope of the JAX package's own
kernels (their ``supported`` gates take float32 and 1-2 shift axes), and
:func:`plain_reason` sends a 3-D or rank-4 problem, or float64 (the port's
reference precision, not its throughput path), to their plain versions on
every device.  K1 is elementwise with a row sum and takes any shape:
:func:`dtype_reason` gates it on the dtype alone, so a 3-D or rank-4
float32 fit still runs ``mu_ratio`` and ``mu_w``.

Precision: the fft and dot products (cuBLAS) obey the process-global
``torch.set_float32_matmul_precision``.  The functions here that run them
pin full float32 (:func:`~tnmf_tpu_torch.ops.precision.full_fp32_matmul`)
once, at the outermost call: a fit loop sets it before its first iteration
and gives the caller's setting back after its last.

The fit-loop variants (:func:`fit_loop_energies`, :func:`fit_loop_tol`,
:func:`fit_loop_extrapolated`), the single steps (:func:`update_H_step`,
:func:`update_W_step`) and the encoder's start (:func:`correlate_init_H`)
reach the kernels through :func:`_mu_H` and :func:`_mu_W`, which look the
wrappers up by this module's names at every call.  :func:`_mu_W` is
:func:`grad_W_stats` followed by :func:`apply_W_update`; the minibatch
epochs (:mod:`tnmf_tpu_torch.engine_minibatch`) call the two apart, with
:func:`accumulate_gradient` between them.  The JAX package runs its
adaptive loops as one on-device ``lax.while_loop``; here their stopping
tests run on the host, one synchronisation per block.

Each of these functions takes the model's kernel/plain switch as
``use_pallas`` (default True): False runs the plain versions of K1-K4 on
any device, as one more reason of :func:`plain_reason` and
:func:`dtype_reason`.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch

from .kernels.gw import grad_w, grad_w_plain
from .kernels.inhibit import inhibited_mu_h, inhibited_mu_h_plain
from .kernels.mu import mu_ratio, mu_ratio_plain, mu_w, mu_w_plain
from .kernels.mu_h import mu_h, mu_h_plain
from .ops import beta as beta_ops
from .ops import conv as conv_ops
from .ops import dot as dot_ops
from .ops import fft as fft_ops
from .ops.modes import ConvPlan
from .ops.precision import full_fp32_matmul

EPS = 1.0e-9  # reference: TransformInvariantNMF.py:166

#: shift ranks whose MU step runs through K2, K3 and K4
KERNEL_RANKS = (1, 2)

#: the operator module of each ported strategy
_OPS = {'conv': conv_ops, 'fft': fft_ops, 'dot': dot_ops}


def require_ported(strategy: str) -> None:
    """Raise ``NotImplementedError`` for the TPU-only 'phased' lowering,
    ``ValueError`` for an unknown strategy."""
    if strategy in _OPS:
        return
    if strategy == 'phased':
        raise NotImplementedError(
            "strategy 'phased' is not ported to tnmf_tpu_torch; see ROADMAP.md "
            'queue 1, item 15 (not ported: TPU-only lowering)')
    raise ValueError(
        f'unknown strategy {strategy!r}; choose "fft", "conv", "phased" or "dot"')


def get_ops(strategy: str):
    """The operator module of ``strategy`` ('conv', 'fft' or 'dot'):
    ``prepare_data`` / ``reconstruct`` / ``grad_H_pair`` / ``grad_W_pair``."""
    require_ported(strategy)
    return _OPS[strategy]


def _pinned(fn):
    """Run ``fn`` with full float32 products (:func:`full_fp32_matmul`) when
    its ``strategy`` keyword is fft or dot; conv runs no matrix product and is
    left as it was.  Nested calls find the pin set and leave it."""
    @functools.wraps(fn)
    def call(*args, strategy: str = 'conv', **kwargs):
        if strategy == 'conv':
            return fn(*args, strategy=strategy, **kwargs)
        with full_fp32_matmul():
            return fn(*args, strategy=strategy, **kwargs)
    return call


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


def prepare_data(V: torch.Tensor, *, plan: ConvPlan, strategy: str = 'conv') -> torch.Tensor:
    """Loop-invariant preprocessing of the data tensor (mode extension; its
    transform on fft)."""
    return get_ops(strategy).prepare_data(V, plan)


@_pinned
def reconstruct(W: torch.Tensor, H: torch.Tensor, *, plan: ConvPlan,
                strategy: str = 'conv') -> torch.Tensor:
    """The model reconstruction ``R`` (canonical data layout)."""
    return get_ops(strategy).reconstruct(W, H, plan)


@_pinned
def partial_reconstruct(W: torch.Tensor, H: torch.Tensor, *, plan: ConvPlan,
                        i_atom: int, strategy: str = 'conv') -> torch.Tensor:
    """Reconstruction restricted to one atom (reference ``_Backend.py:124``)."""
    return get_ops(strategy).reconstruct(W[i_atom:i_atom + 1], H[:, i_atom:i_atom + 1], plan)


@_pinned
def energy(V: torch.Tensor, W: torch.Tensor, H: torch.Tensor, *,
           plan: ConvPlan, strategy: str = 'conv') -> torch.Tensor:
    """Reconstruction objective ``0.5 * sum((V - R)^2)`` as a 0-d tensor,
    accumulated in ``promote_types(V.dtype, float32)``."""
    return beta_ops.divergence(V, reconstruct(W, H, plan=plan, strategy=strategy))


def dtype_reason(dtype: torch.dtype, use_pallas: bool = True) -> Optional[str]:
    """Why K1 (``mu_ratio``, ``mu_w``) runs its plain version on ``dtype``
    tensors, or ``None`` when it runs the kernel (float32, any shape).
    ``use_pallas=False`` (the model's switch) is a reason of its own."""
    if not use_pallas:
        return 'use_pallas=False'
    if dtype != torch.float32:
        return f'{str(dtype).removeprefix("torch.")} tensors (the kernels take float32)'
    return None


def plain_reason(plan: ConvPlan, dtype: torch.dtype, use_pallas: bool = True) -> Optional[str]:
    """Why the MU step of ``plan`` on ``dtype`` tensors runs the plain
    versions of K2, K3 and K4, or ``None`` when it runs those kernels
    (float32, 1-D and 2-D shifts, ``use_pallas`` not False).  Decided from
    the plan, the dtype and the switch before any launch, never from a
    failed one."""
    if not use_pallas:
        return 'use_pallas=False'
    if plan.ndim not in KERNEL_RANKS:
        return f'{plan.ndim}-D shifts (K2, K3 and K4 take 1-D and 2-D)'
    return dtype_reason(dtype)


@_pinned
def _mu_H(Vp: torch.Tensor, W: torch.Tensor, H: torch.Tensor, sparsity: float,
          inhibition: float = 0., cross_inhibition: float = 0., kernels: Sequence = (),
          *, plan: ConvPlan, use_inhibition: bool = False,
          use_cross: bool = False, strategy: str = 'conv',
          use_pallas: bool = True) -> torch.Tensor:
    """One multiplicative H update (reference ``_update_H``,
    ``TransformInvariantNMF.py:246-271``):
    ``H * corr(Vp, W) / (corr(Rx, W) + EPS + sparsity)``, fused in K3 on the
    conv strategy; on fft and dot the strategy's gradient pair, then K1's
    ratio.  With lateral inhibition (``use_inhibition`` same-atom,
    ``use_cross`` cross-atom) the gradient pair is computed alone (one
    stacked convolution on conv) and K4 adds the inhibition term and forms
    the ratio.  ``use_pallas=False`` runs the plain versions."""
    reg = EPS + float(sparsity)
    kernels_on = plain_reason(plan, H.dtype, use_pallas) is None
    inhibited = use_inhibition or use_cross
    if strategy == 'conv':
        Rx = conv_ops.extend_data(conv_ops.reconstruct(W, H, plan), plan)
        if not inhibited:
            return (mu_h if kernels_on else mu_h_plain)(Vp, Rx, W, H, reg)
        neg, pos = conv_ops.grad_H_pair_prepared(Vp, Rx, W)
    else:
        ops = get_ops(strategy)
        # the kernels take contiguous tensors; fft's are crops of its transforms
        neg, pos = (g.contiguous() for g in ops.grad_H_pair(
            Vp, ops.reconstruct(W, H, plan), W, plan))
        if not inhibited:
            ratio = mu_ratio if dtype_reason(H.dtype, use_pallas) is None else mu_ratio_plain
            return ratio(H, neg, pos, reg)
    update = inhibited_mu_h if kernels_on else inhibited_mu_h_plain
    return update(H, neg, pos, kernels, float(inhibition), float(cross_inhibition), reg,
                  use_same=use_inhibition, use_cross=use_cross)


def _normalize_W(W: torch.Tensor, n_shift_axes: int) -> torch.Tensor:
    """Sum-normalize atoms; zero atoms stay zero instead of turning NaN."""
    s = W.sum(dim=tuple(range(-n_shift_axes, 0)), keepdim=True)
    return W / torch.where(s == 0, torch.ones_like(s), s)


@_pinned
def grad_W_stats(Vp: torch.Tensor, W: torch.Tensor, H: torch.Tensor, *, plan: ConvPlan,
                 strategy: str = 'conv',
                 use_pallas: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``(neg, pos)`` statistics of the W gradient (the JAX engine's
    ``grad_W_stats``; reference ``_accumulate_gradient_W``,
    ``TransformInvariantNMF.py:444-455``): K2 on the stacked ``[Vp | Rx]``
    on the conv strategy, the strategy's gradient pair on fft and dot.
    Sums over the samples of ``H``, so a minibatch's statistics add up."""
    if strategy == 'conv':
        Rx = conv_ops.extend_data(conv_ops.reconstruct(W, H, plan), plan)
        grad = grad_w if plain_reason(plan, H.dtype, use_pallas) is None else grad_w_plain
        return grad(torch.cat([Vp, Rx], dim=1), H, plan)
    ops = get_ops(strategy)
    return ops.grad_W_pair(Vp, ops.reconstruct(W, H, plan), H, plan)


def apply_W_update(W: torch.Tensor, neg: torch.Tensor, pos: torch.Tensor, *,
                   n_shift_axes: int, use_pallas: bool = True) -> torch.Tensor:
    """``normalize(W * neg / (pos + EPS))`` from given statistics (the JAX
    engine's ``apply_W_update``) in one launch of K1's W epilogue (any
    rank).  The kernel takes contiguous tensors: fft's pair and plain K2's
    (3-D fits) are views; K2's own, and summed or averaged statistics, are
    contiguous already, so no copy there."""
    epilogue = mu_w if dtype_reason(W.dtype, use_pallas) is None else mu_w_plain
    return epilogue(W, neg.contiguous(), pos.contiguous(), EPS, n_shift_axes)


def accumulate_gradient(acc_neg: torch.Tensor, acc_pos: torch.Tensor, neg: torch.Tensor,
                        pos: torch.Tensor,
                        sag_lambda: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The running W statistics of the minibatch algorithms (the JAX
    engine's ``accumulate_gradient``): ``sag_lambda == 1`` sums (the
    reference's within-epoch accumulation), any other value averages
    exponentially, ``(1 - sag_lambda) * acc + sag_lambda * new``."""
    if sag_lambda == 1.0:
        return acc_neg + neg, acc_pos + pos
    keep = 1.0 - sag_lambda
    return keep * acc_neg + sag_lambda * neg, keep * acc_pos + sag_lambda * pos


@_pinned
def _mu_W(Vp: torch.Tensor, W: torch.Tensor, H: torch.Tensor, *,
          plan: ConvPlan, strategy: str = 'conv', use_pallas: bool = True) -> torch.Tensor:
    """One multiplicative W update with atom-wise sum normalization
    (reference ``_update_W`` + ``normalize``, ``TransformInvariantNMF.py:240-244``):
    :func:`grad_W_stats`, then :func:`apply_W_update`."""
    neg, pos = grad_W_stats(Vp, W, H, plan=plan, strategy=strategy, use_pallas=use_pallas)
    return apply_W_update(W, neg, pos, n_shift_axes=plan.ndim, use_pallas=use_pallas)


@_pinned
def update_step(Vp: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
                sparsity: float, inhibition: float = 0., cross_inhibition: float = 0.,
                kernels: Sequence = (), *, plan: ConvPlan, update_H: bool = True,
                update_W: bool = True, use_inhibition: bool = False,
                use_cross: bool = False, strategy: str = 'conv',
                use_pallas: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """One full MU iteration: H update, then W update.  Returns ``(W, H)``.
    ``use_pallas=False`` runs the plain versions of the kernels."""
    if update_H:
        H = _mu_H(Vp, W, H, sparsity, inhibition, cross_inhibition, kernels, plan=plan,
                  use_inhibition=use_inhibition, use_cross=use_cross, strategy=strategy,
                  use_pallas=use_pallas)
    if update_W:
        W = _mu_W(Vp, W, H, plan=plan, strategy=strategy, use_pallas=use_pallas)
    return W, H


@_pinned
def fit_loop(Vp: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
             n_iterations: int, sparsity: float, inhibition: float = 0.,
             cross_inhibition: float = 0., kernels: Sequence = (), *, plan: ConvPlan,
             update_H: bool = True, update_W: bool = True, use_inhibition: bool = False,
             use_cross: bool = False, strategy: str = 'conv',
             use_pallas: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_iterations`` MU iterations.  Returns ``(W, H)``.  ``kernels`` are
    the per-axis inhibition kernels, read when ``use_inhibition`` or
    ``use_cross`` is set."""
    for _ in range(int(n_iterations)):
        W, H = update_step(Vp, W, H, sparsity, inhibition, cross_inhibition, kernels,
                           plan=plan, update_H=update_H, update_W=update_W,
                           use_inhibition=use_inhibition, use_cross=use_cross,
                           strategy=strategy, use_pallas=use_pallas)
    return W, H


def energy_trace(V: torch.Tensor, n: int) -> torch.Tensor:
    """An energy trace of ``n`` entries, NaN until written, on ``V``'s
    device in the accumulation dtype of :func:`energy`."""
    acc = torch.promote_types(V.dtype, torch.float32)
    return torch.full((n,), math.nan, dtype=acc, device=V.device)


@_pinned
def fit_loop_energies(Vp: torch.Tensor, V: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
                      sparsity: float, inhibition: float = 0., cross_inhibition: float = 0.,
                      kernels: Sequence = (), *, n_iterations: int, plan: ConvPlan,
                      strategy: str = 'conv',
                      **step) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``n_iterations`` MU iterations that also record the energy after
    each one (one more reconstruction per iteration; reference
    ``TransformInvariantNMF.py:346``).  The trace stays on the device: the
    caller synchronises once when it reads it.  ``step`` holds
    :func:`update_step`'s keywords.  Returns ``(W, H, energies)``."""
    energies = energy_trace(V, int(n_iterations))
    for i in range(int(n_iterations)):
        W, H = update_step(Vp, W, H, sparsity, inhibition, cross_inhibition, kernels,
                           plan=plan, strategy=strategy, **step)
        energies[i] = energy(V, W, H, plan=plan, strategy=strategy)
    return W, H, energies


def _block_change(e_prev: torch.Tensor, e: torch.Tensor,
                  scale: torch.Tensor) -> Tuple[float, float]:
    """``(e_prev - e, (e_prev - e) / scale)`` in the accumulation dtype,
    read to the host in one synchronisation."""
    d = e_prev - e
    diff, rel = torch.stack([d, d / scale]).tolist()
    return diff, rel


def _tol_start(V: torch.Tensor, W: torch.Tensor, H: torch.Tensor, tol: float,
               plan: ConvPlan, strategy: str) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """The initial energy, the scale ``max(e0, tiny)`` of the relative
    improvement, and ``tol`` rounded to the accumulation dtype (the JAX
    package compares in that dtype)."""
    e0 = energy(V, W, H, plan=plan, strategy=strategy)
    scale = torch.clamp(e0, min=torch.finfo(e0.dtype).tiny)
    return e0, scale, float(torch.tensor(tol, dtype=e0.dtype))


@_pinned
def fit_loop_tol(Vp: torch.Tensor, V: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
                 n_max: int, tol: float, sparsity: float, inhibition: float = 0.,
                 cross_inhibition: float = 0., kernels: Sequence = (), *, check_every: int,
                 n_buf: int = 0, plan: ConvPlan, strategy: str = 'conv', **step):
    """Adaptive fit (port of the JAX package's ``fit_loop_tol``): MU
    iterations in blocks of ``min(check_every, n_max - i)``; after each
    block the relative improvement ``(e_prev - e) / max(e0, tiny)`` is
    read, and the fit stops at ``n_max`` iterations or once it drops below
    ``tol``.

    The JAX package runs the whole loop as one on-device ``while_loop``.
    Here the stopping test runs on the host: one synchronisation per block,
    between blocks; the iterates, the count and the trace are the same.

    ``n_buf > 0`` (at least ``n_max``) also records the energy after every
    iteration into a trace of ``n_buf`` entries, NaN past the iterations
    run; a block's last entry then serves as its energy, with no second
    reconstruction.  ``step`` holds :func:`update_step`'s keywords.

    Returns ``(W, H, n_done, e_final, trace_or_None)``.
    """
    n_max, check_every = int(n_max), int(check_every)
    trace = energy_trace(V, n_buf) if n_buf > 0 else None
    e, scale, tol = _tol_start(V, W, H, tol, plan, strategy)
    i, rel = 0, math.inf
    while i < n_max and rel >= tol:
        k = min(check_every, n_max - i)
        for j in range(k):
            W, H = update_step(Vp, W, H, sparsity, inhibition, cross_inhibition, kernels,
                               plan=plan, strategy=strategy, **step)
            if trace is not None:
                trace[i + j] = energy(V, W, H, plan=plan, strategy=strategy)
        e_prev, e = e, (trace[i + k - 1] if trace is not None
                        else energy(V, W, H, plan=plan, strategy=strategy))
        rel = _block_change(e_prev, e, scale)[1]
        i += k
    return W, H, i, e, trace


# extrapolation safeguard of the JAX package (Ang & Gillis 2019-style): the
# momentum weight grows while the energy falls, halves on a rise
_XTR_GROW, _XTR_SHRINK, _XTR_MAX = 1.05, 0.5, 0.95


def _extrapolate(Xn: torch.Tensor, Xold: torch.Tensor, bk: torch.Tensor) -> torch.Tensor:
    """Multiplicative extrapolation ``Xn * clip((Xn+EPS)/(Xold+EPS), 1/8, 8)**bk``:
    positive, with zeros kept fixed as under plain MU."""
    r = torch.clamp((Xn + EPS) / (Xold + EPS), 0.125, 8.0)
    return (Xn * r ** bk.to(Xn.dtype)).to(Xn.dtype)


@_pinned
def fit_loop_extrapolated(Vp: torch.Tensor, V: torch.Tensor, W: torch.Tensor,
                          H: torch.Tensor, n_max: int, tol: float, beta0: float,
                          sparsity: float, inhibition: float = 0.,
                          cross_inhibition: float = 0., kernels: Sequence = (), *,
                          check_every: int, n_buf: int = 0, plan: ConvPlan,
                          update_H: bool = True, update_W: bool = True,
                          use_inhibition: bool = False, use_cross: bool = False,
                          strategy: str = 'conv', use_pallas: bool = True):
    """Extrapolated MU with restarts (port of the JAX package's
    ``fit_loop_extrapolated``): each update is taken at the extrapolated
    point ``Y = X_new * clip(X_new / X_old)**beta_k`` (W's re-normalised).
    After each block of ``check_every`` iterations the energy of the
    accepted iterates is read: on a rise ``Y`` restarts from them and
    ``beta_k`` halves; else it grows by 5 % up to 0.95.  Stopping as in
    :func:`fit_loop_tol` (a restarted block never stops the fit), with the
    same host-side test, one synchronisation per block; ``n_buf > 0``
    records the accepted iterates' energies.

    Returns ``(W, H, n_done, e_final, trace_or_None)``.
    """
    n_max, check_every = int(n_max), int(check_every)
    trace = energy_trace(V, n_buf) if n_buf > 0 else None
    e, scale, tol = _tol_start(V, W, H, tol, plan, strategy)
    bk = torch.tensor(beta0, dtype=e.dtype, device=e.device)
    Wy, Hy = W, H
    i, rel = 0, math.inf
    while i < n_max and rel >= tol:
        k = min(check_every, n_max - i)
        for j in range(k):
            if update_H:
                Hn = _mu_H(Vp, Wy, Hy, sparsity, inhibition, cross_inhibition, kernels,
                           plan=plan, use_inhibition=use_inhibition, use_cross=use_cross,
                           strategy=strategy, use_pallas=use_pallas)
                Hy, H = _extrapolate(Hn, H, bk), Hn
            if update_W:
                Wn = _mu_W(Vp, Wy, Hy, plan=plan, strategy=strategy, use_pallas=use_pallas)
                Wy, W = _normalize_W(_extrapolate(Wn, W, bk), plan.ndim).to(Wn.dtype), Wn
            if trace is not None:
                trace[i + j] = energy(V, W, H, plan=plan, strategy=strategy)
        e_prev, e = e, (trace[i + k - 1] if trace is not None
                        else energy(V, W, H, plan=plan, strategy=strategy))
        diff, rel = _block_change(e_prev, e, scale)
        if diff < 0:  # the energy rose: drop the momentum
            bk = bk * _XTR_SHRINK
            Wy, Hy, rel = W, H, math.inf
        else:
            bk = torch.clamp(bk * _XTR_GROW, max=_XTR_MAX)
        i += k
    return W, H, i, e, trace


@_pinned
def update_H_step(Vp: torch.Tensor, W: torch.Tensor, H: torch.Tensor, sparsity: float,
                  inhibition: float = 0., cross_inhibition: float = 0., kernels: Sequence = (),
                  *, plan: ConvPlan, use_inhibition: bool = False,
                  use_cross: bool = False, strategy: str = 'conv',
                  use_pallas: bool = True) -> torch.Tensor:
    """One H-only MU update (W frozen)."""
    return _mu_H(Vp, W, H, sparsity, inhibition, cross_inhibition, kernels, plan=plan,
                 use_inhibition=use_inhibition, use_cross=use_cross, strategy=strategy,
                 use_pallas=use_pallas)


@_pinned
def update_W_step(Vp: torch.Tensor, W: torch.Tensor, H: torch.Tensor, *,
                  plan: ConvPlan, strategy: str = 'conv',
                  use_pallas: bool = True) -> torch.Tensor:
    """One W-only MU update (H frozen), atoms sum-normalised."""
    return _mu_W(Vp, W, H, plan=plan, strategy=strategy, use_pallas=use_pallas)


@_pinned
def correlate_init_H(Vp: torch.Tensor, Vd: torch.Tensor, W: torch.Tensor, *,
                     plan: ConvPlan, strategy: str = 'conv') -> torch.Tensor:
    """Matched-filter activations ``H0 = c * corr(Vp, W)`` with the
    least-squares scale ``c = <V, R0> / <R0, R0>``, ``R0 = reconstruct(W,
    corr(Vp, W))``, accumulated in ``promote_types(V.dtype, float32)``; a
    floor of 1 % of the mean keeps every entry positive (zero is absorbing
    under MU).  Deterministic and on the device: no host draw of H.  The
    JAX package takes the correlation as the ``neg`` half of
    ``grad_H_pair(Vp, 0, W)``; here it is that half alone (one cuDNN
    correlation on the conv strategy)."""
    neg = (conv_ops.corr_H(Vp, W) if strategy == 'conv'
           else get_ops(strategy).corr_H(Vp, W, plan))
    R0 = reconstruct(W, neg.to(W.dtype), plan=plan, strategy=strategy)
    acc = torch.promote_types(Vd.dtype, torch.float32)
    num = torch.sum(Vd.to(acc) * R0.to(acc))
    den = torch.clamp(torch.sum(R0.to(acc) ** 2), min=torch.finfo(acc).tiny)
    H0 = (num / den).to(neg.dtype) * neg
    return torch.maximum(H0, 0.01 * torch.mean(H0)).to(W.dtype)
