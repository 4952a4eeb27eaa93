"""Execution engine of the multiplicative-update (MU) algorithm, in PyTorch.

Port of the full-batch MU path of :mod:`tnmf_tpu.engine`: the same functions
with the same ``(W, H)`` result contract, run eagerly.  The fit loop is a
Python loop; each iteration updates H, then W (reference ``fit_batch`` loop
body, ``TransformInvariantNMF.py:334-340``).

Only the direct-convolution strategy (:mod:`tnmf_tpu_torch.ops.conv`) is
ported, so the functions here take no strategy argument; the model checks
the strategy a fit resolves to with :func:`require_ported`.  On CUDA
tensors the hot operators run through the hand-written kernels: the H
update through K3 (:func:`~tnmf_tpu_torch.kernels.mu_h.mu_h`),
the W statistics through K2 (:func:`~tnmf_tpu_torch.kernels.gw.grad_w`) and
the W ratio with the atom normalisation through K1's W epilogue
(:func:`~tnmf_tpu_torch.kernels.mu.mu_w`), and
the inhibited H update (lateral inhibition on) through K4
(:func:`~tnmf_tpu_torch.kernels.inhibit.inhibited_mu_h`).  On CPU tensors
the same wrappers run their plain versions.  The reconstruction stays a
convolution (cuDNN, TF32 off), as the JAX package left it to XLA.

Kernel gate: the kernels serve float32 problems with 1-D and 2-D shifts,
the scope of the JAX package's own kernels (their ``supported`` gates take
float32 and 1-2 shift axes).  ``_mu_H`` and ``_mu_W`` ask
:func:`plain_reason` before any launch: a 3-D problem, or float64 (the
port's reference precision, not its throughput path), runs the plain
versions (cuDNN, TF32 off) on every device.  Every other problem goes to
the kernels, whatever its shapes.

The fit-loop variants (:func:`fit_loop_energies`, :func:`fit_loop_tol`,
:func:`fit_loop_extrapolated`), the single steps (:func:`update_H_step`,
:func:`update_W_step`) and the encoder's start (:func:`correlate_init_H`)
reach the kernels through :func:`_mu_H` and :func:`_mu_W`, which look the
wrappers up by this module's names at every call.  The JAX package runs its
adaptive loops as one on-device ``lax.while_loop``; here their stopping
tests run on the host, one synchronisation per block.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from .kernels.gw import grad_w, grad_w_plain
from .kernels.inhibit import inhibited_mu_h, inhibited_mu_h_plain
from .kernels.mu import mu_w, mu_w_plain
from .kernels.mu_h import mu_h, mu_h_plain
from .ops import beta as beta_ops
from .ops import conv as conv_ops
from .ops.modes import ConvPlan

EPS = 1.0e-9  # reference: TransformInvariantNMF.py:166

#: shift ranks whose MU step runs through the hand-written kernels
KERNEL_RANKS = (1, 2)

#: the ROADMAP item that ports each strategy the port does not run yet
_UNPORTED_STRATEGIES = {
    'fft': 'ROADMAP.md queue 1, item 8 (ops/fft.py)',
    'dot': 'ROADMAP.md queue 1, item 8 (ops/dot.py)',
    'phased': 'ROADMAP.md queue 1, item 15 (not ported: TPU-only lowering)',
}


def require_ported(strategy: str) -> None:
    """Raise ``NotImplementedError`` for a strategy the port lacks."""
    if strategy == 'conv':
        return
    if strategy in _UNPORTED_STRATEGIES:
        raise NotImplementedError(
            f'strategy {strategy!r} is not ported to tnmf_tpu_torch yet; see '
            f'{_UNPORTED_STRATEGIES[strategy]}')
    raise ValueError(
        f'unknown strategy {strategy!r}; choose "fft", "conv", "phased" or "dot"')


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


def prepare_data(V: torch.Tensor, *, plan: ConvPlan) -> torch.Tensor:
    """Loop-invariant preprocessing of the data tensor (mode extension)."""
    return conv_ops.prepare_data(V, plan)


def reconstruct(W: torch.Tensor, H: torch.Tensor, *, plan: ConvPlan) -> torch.Tensor:
    """The model reconstruction ``R`` (canonical data layout)."""
    return conv_ops.reconstruct(W, H, plan)


def partial_reconstruct(W: torch.Tensor, H: torch.Tensor, *, plan: ConvPlan,
                        i_atom: int) -> torch.Tensor:
    """Reconstruction restricted to one atom (reference ``_Backend.py:124``)."""
    return conv_ops.reconstruct(W[i_atom:i_atom + 1], H[:, i_atom:i_atom + 1], plan)


def energy(V: torch.Tensor, W: torch.Tensor, H: torch.Tensor, *,
           plan: ConvPlan) -> torch.Tensor:
    """Reconstruction objective ``0.5 * sum((V - R)^2)`` as a 0-d tensor,
    accumulated in ``promote_types(V.dtype, float32)``."""
    return beta_ops.divergence(V, reconstruct(W, H, plan=plan))


def plain_reason(plan: ConvPlan, dtype: torch.dtype) -> Optional[str]:
    """Why the MU step of ``plan`` on ``dtype`` tensors runs the plain
    versions of the kernels, or ``None`` when it runs the hand-written
    kernels (float32, 1-D and 2-D shifts).  Decided from the plan and the
    dtype before any launch, never from a failed one."""
    if plan.ndim not in KERNEL_RANKS:
        return f'{plan.ndim}-D shifts (the kernels take 1-D and 2-D)'
    if dtype != torch.float32:
        return f'{str(dtype).removeprefix("torch.")} tensors (the kernels take float32)'
    return None


def _mu_H(Vp: torch.Tensor, W: torch.Tensor, H: torch.Tensor, sparsity: float,
          inhibition: float = 0., cross_inhibition: float = 0., kernels: Sequence = (),
          *, plan: ConvPlan, use_inhibition: bool = False,
          use_cross: bool = False) -> torch.Tensor:
    """One multiplicative H update (reference ``_update_H``,
    ``TransformInvariantNMF.py:246-271``):
    ``H * corr(Vp, W) / (corr(Rx, W) + EPS + sparsity)``, fused in K3.  With
    lateral inhibition (``use_inhibition`` same-atom, ``use_cross``
    cross-atom) the gradient pair is one stacked convolution and K4 adds the
    inhibition term and forms the ratio."""
    Rx = conv_ops.extend_data(conv_ops.reconstruct(W, H, plan), plan)
    reg = EPS + float(sparsity)
    kernels_on = plain_reason(plan, H.dtype) is None
    if not (use_inhibition or use_cross):
        return (mu_h if kernels_on else mu_h_plain)(Vp, Rx, W, H, reg)
    neg, pos = conv_ops.grad_H_pair_prepared(Vp, Rx, W)
    update = inhibited_mu_h if kernels_on else inhibited_mu_h_plain
    return update(H, neg, pos, kernels, float(inhibition), float(cross_inhibition), reg,
                  use_same=use_inhibition, use_cross=use_cross)


def _normalize_W(W: torch.Tensor, n_shift_axes: int) -> torch.Tensor:
    """Sum-normalize atoms; zero atoms stay zero instead of turning NaN."""
    s = W.sum(dim=tuple(range(-n_shift_axes, 0)), keepdim=True)
    return W / torch.where(s == 0, torch.ones_like(s), s)


def _mu_W(Vp: torch.Tensor, W: torch.Tensor, H: torch.Tensor, *,
          plan: ConvPlan) -> torch.Tensor:
    """One multiplicative W update with atom-wise sum normalization
    (reference ``_update_W`` + ``normalize``, ``TransformInvariantNMF.py:240-244``):
    the statistics in K2, the ratio ``W * neg / (pos + EPS)`` and
    :func:`_normalize_W` in one launch of K1's W epilogue."""
    Rx = conv_ops.extend_data(conv_ops.reconstruct(W, H, plan), plan)
    stats, epilogue = ((grad_w, mu_w) if plain_reason(plan, H.dtype) is None
                       else (grad_w_plain, mu_w_plain))
    neg, pos = stats(torch.cat([Vp, Rx], dim=1), H, plan)
    return epilogue(W, neg, pos, EPS, plan.ndim)


def update_step(Vp: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
                sparsity: float, inhibition: float = 0., cross_inhibition: float = 0.,
                kernels: Sequence = (), *, plan: ConvPlan, update_H: bool = True,
                update_W: bool = True, use_inhibition: bool = False,
                use_cross: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One full MU iteration: H update, then W update.  Returns ``(W, H)``."""
    if update_H:
        H = _mu_H(Vp, W, H, sparsity, inhibition, cross_inhibition, kernels, plan=plan,
                  use_inhibition=use_inhibition, use_cross=use_cross)
    if update_W:
        W = _mu_W(Vp, W, H, plan=plan)
    return W, H


def fit_loop(Vp: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
             n_iterations: int, sparsity: float, inhibition: float = 0.,
             cross_inhibition: float = 0., kernels: Sequence = (), *, plan: ConvPlan,
             update_H: bool = True, update_W: bool = True, use_inhibition: bool = False,
             use_cross: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_iterations`` MU iterations.  Returns ``(W, H)``.  ``kernels`` are
    the per-axis inhibition kernels, read when ``use_inhibition`` or
    ``use_cross`` is set."""
    for _ in range(int(n_iterations)):
        W, H = update_step(Vp, W, H, sparsity, inhibition, cross_inhibition, kernels,
                           plan=plan, update_H=update_H, update_W=update_W,
                           use_inhibition=use_inhibition, use_cross=use_cross)
    return W, H


def energy_trace(V: torch.Tensor, n: int) -> torch.Tensor:
    """An energy trace of ``n`` entries, NaN until written, on ``V``'s
    device in the accumulation dtype of :func:`energy`."""
    acc = torch.promote_types(V.dtype, torch.float32)
    return torch.full((n,), math.nan, dtype=acc, device=V.device)


def fit_loop_energies(Vp: torch.Tensor, V: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
                      sparsity: float, inhibition: float = 0., cross_inhibition: float = 0.,
                      kernels: Sequence = (), *, n_iterations: int, plan: ConvPlan,
                      **step) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``n_iterations`` MU iterations that also record the energy after
    each one (one more reconstruction per iteration; reference
    ``TransformInvariantNMF.py:346``).  The trace stays on the device: the
    caller synchronises once when it reads it.  ``step`` holds
    :func:`update_step`'s keywords.  Returns ``(W, H, energies)``."""
    energies = energy_trace(V, int(n_iterations))
    for i in range(int(n_iterations)):
        W, H = update_step(Vp, W, H, sparsity, inhibition, cross_inhibition, kernels,
                           plan=plan, **step)
        energies[i] = energy(V, W, H, plan=plan)
    return W, H, energies


def _block_change(e_prev: torch.Tensor, e: torch.Tensor,
                  scale: torch.Tensor) -> Tuple[float, float]:
    """``(e_prev - e, (e_prev - e) / scale)`` in the accumulation dtype,
    read to the host in one synchronisation."""
    d = e_prev - e
    diff, rel = torch.stack([d, d / scale]).tolist()
    return diff, rel


def _tol_start(V: torch.Tensor, W: torch.Tensor, H: torch.Tensor, tol: float,
               plan: ConvPlan) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """The initial energy, the scale ``max(e0, tiny)`` of the relative
    improvement, and ``tol`` rounded to the accumulation dtype (the JAX
    package compares in that dtype)."""
    e0 = energy(V, W, H, plan=plan)
    scale = torch.clamp(e0, min=torch.finfo(e0.dtype).tiny)
    return e0, scale, float(torch.tensor(tol, dtype=e0.dtype))


def fit_loop_tol(Vp: torch.Tensor, V: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
                 n_max: int, tol: float, sparsity: float, inhibition: float = 0.,
                 cross_inhibition: float = 0., kernels: Sequence = (), *, check_every: int,
                 n_buf: int = 0, plan: ConvPlan, **step):
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
    e, scale, tol = _tol_start(V, W, H, tol, plan)
    i, rel = 0, math.inf
    while i < n_max and rel >= tol:
        k = min(check_every, n_max - i)
        for j in range(k):
            W, H = update_step(Vp, W, H, sparsity, inhibition, cross_inhibition, kernels,
                               plan=plan, **step)
            if trace is not None:
                trace[i + j] = energy(V, W, H, plan=plan)
        e_prev, e = e, (trace[i + k - 1] if trace is not None else energy(V, W, H, plan=plan))
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


def fit_loop_extrapolated(Vp: torch.Tensor, V: torch.Tensor, W: torch.Tensor,
                          H: torch.Tensor, n_max: int, tol: float, beta0: float,
                          sparsity: float, inhibition: float = 0.,
                          cross_inhibition: float = 0., kernels: Sequence = (), *,
                          check_every: int, n_buf: int = 0, plan: ConvPlan,
                          update_H: bool = True, update_W: bool = True,
                          use_inhibition: bool = False, use_cross: bool = False):
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
    e, scale, tol = _tol_start(V, W, H, tol, plan)
    bk = torch.tensor(beta0, dtype=e.dtype, device=e.device)
    Wy, Hy = W, H
    i, rel = 0, math.inf
    while i < n_max and rel >= tol:
        k = min(check_every, n_max - i)
        for j in range(k):
            if update_H:
                Hn = _mu_H(Vp, Wy, Hy, sparsity, inhibition, cross_inhibition, kernels,
                           plan=plan, use_inhibition=use_inhibition, use_cross=use_cross)
                Hy, H = _extrapolate(Hn, H, bk), Hn
            if update_W:
                Wn = _mu_W(Vp, Wy, Hy, plan=plan)
                Wy, W = _normalize_W(_extrapolate(Wn, W, bk), plan.ndim).to(Wn.dtype), Wn
            if trace is not None:
                trace[i + j] = energy(V, W, H, plan=plan)
        e_prev, e = e, (trace[i + k - 1] if trace is not None else energy(V, W, H, plan=plan))
        diff, rel = _block_change(e_prev, e, scale)
        if diff < 0:  # the energy rose: drop the momentum
            bk = bk * _XTR_SHRINK
            Wy, Hy, rel = W, H, math.inf
        else:
            bk = torch.clamp(bk * _XTR_GROW, max=_XTR_MAX)
        i += k
    return W, H, i, e, trace


def update_H_step(Vp: torch.Tensor, W: torch.Tensor, H: torch.Tensor, sparsity: float,
                  inhibition: float = 0., cross_inhibition: float = 0., kernels: Sequence = (),
                  *, plan: ConvPlan, use_inhibition: bool = False,
                  use_cross: bool = False) -> torch.Tensor:
    """One H-only MU update (W frozen)."""
    return _mu_H(Vp, W, H, sparsity, inhibition, cross_inhibition, kernels, plan=plan,
                 use_inhibition=use_inhibition, use_cross=use_cross)


def update_W_step(Vp: torch.Tensor, W: torch.Tensor, H: torch.Tensor, *,
                  plan: ConvPlan) -> torch.Tensor:
    """One W-only MU update (H frozen), atoms sum-normalised."""
    return _mu_W(Vp, W, H, plan=plan)


def correlate_init_H(Vp: torch.Tensor, Vd: torch.Tensor, W: torch.Tensor, *,
                     plan: ConvPlan) -> torch.Tensor:
    """Matched-filter activations ``H0 = c * corr(Vp, W)`` with the
    least-squares scale ``c = <V, R0> / <R0, R0>``, ``R0 = reconstruct(W,
    corr(Vp, W))``, accumulated in ``promote_types(V.dtype, float32)``; a
    floor of 1 % of the mean keeps every entry positive (zero is absorbing
    under MU).  Deterministic and on the device: no host draw of H.  The
    JAX package takes the correlation as the ``neg`` half of
    ``grad_H_pair(Vp, 0, W)``; here it is that half alone, one cuDNN
    correlation."""
    neg = conv_ops.corr_H(Vp, W)
    R0 = reconstruct(W, neg.to(W.dtype), plan=plan)
    acc = torch.promote_types(Vd.dtype, torch.float32)
    num = torch.sum(Vd.to(acc) * R0.to(acc))
    den = torch.clamp(torch.sum(R0.to(acc) ** 2), min=torch.finfo(acc).tiny)
    H0 = (num / den).to(neg.dtype) * neg
    return torch.maximum(H0, 0.01 * torch.mean(H0)).to(W.dtype)
