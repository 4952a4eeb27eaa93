"""Shift-invariant HALS: exact block coordinate descent for conv-NMF, in
PyTorch.

Port of :mod:`tnmf_tpu.engine_hals_conv`, the ``solver='hals'`` path of the
factorization

    R[n, c, x] = sum_{m, b} H[n, m, x - b] * W[m, c, b]

in reconstruction mode ``'full'`` (``T = S - A + 1``: every activation's
atom footprint lies inside the sample), where shift invariance does not
degenerate (that corner is :mod:`tnmf_tpu_torch.engine_hals`).

Activations of one phase, positions spaced exactly ``A`` apart per axis,
have disjoint footprints, so minimizing over one phase splits into ``n *
prod(K)`` independent ``M``-dimensional NNLS problems that share the atom
Gram ``G = <W_m, W_m'>``: the plain-NMF HALS sweep on the rows ``(n*K,
M)``, with the phase's patch correlations as ``P``.  Sweeping the
``prod(A)`` phases in order, with the residual ``E = V - R`` updated after
each, is exact block coordinate descent over all of H:

    for p in phases:
        P    = corr(E, W)[phase p] + H[phase p] @ G   # own term added back
        H_p  = HALS_sweep(H_p, G, P, l1, l2)          # K5, one launch
        E   -= conv(delta H_p, W)                     # disjoint placement

The phase's correlation is one strided convolution (``F.conv{1,2,3}d``,
``stride=A``) of the phase's window of ``E``; the placement one transposed
convolution (``F.conv_transpose{1,2,3}d``, ``stride=A``), which puts each
position's atom at its stride-``A`` offset, the JAX ``lhs_dilation`` with
the flipped kernel; both run in cuDNN at the plan's precision (TF32 at
'default' and 'high' on the card, full float32 otherwise), as do the
phase's product with the Gram and the Gram itself on cuBLAS (the loops'
pin, :func:`engine_hals._pinned`) and K2 (its TF32 passes).  The two
products are the HALS solvers' :func:`~tnmf_tpu_torch.kernels.hals.dot`,
which on the CPU accumulates a float32 product in float64 (C3).  The transform axes
are zero-padded up to multiples of ``A`` so that every phase has ``K``
positions per axis; positions past ``T`` are masked back to their old
value (zero) after each sweep.  H is carried phase-major, ``(P, n, M,
prod(K))``, the JAX layout, which also keeps one phase's slice contiguous.

W steps stay multiplicative: one Lee–Seung step per outer iteration from
the maintained residual, ``neg = corr_W(V)``, ``pos = corr_W(V - E)``, K2
on the stacked streams (the engine's conv route, from the given ``R = V -
E`` instead of a fresh reconstruction), then ``W * neg / (pos + EPS)``
through K1's ``mu_ratio``, without the atom normalisation (HALS keeps W's
scale).  The energy ``0.5 * ||E||^2`` reads the residual, with no
reconstruction.

Data parallelism over the samples: the H phase sweep is per sample, so
with a ``process_group`` each rank sweeps its own rows; the W step's
statistics and the energy are summed over the ranks
(:func:`tnmf_tpu_torch.engine.all_reduce_sum`) and W stays a replica.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import engine
from .engine_hals import _acc_dtype, _pinned, _sweep_H
from .kernels.hals import dot
from .ops import conv as conv_ops
from .ops.modes import ConvPlan
from .ops.precision import convolution_pin

_CONV = {1: (F.conv1d, F.conv_transpose1d), 2: (F.conv2d, F.conv_transpose2d),
         3: (F.conv3d, F.conv_transpose3d)}


def applicable(plan: ConvPlan) -> bool:
    """Shift-invariant exact CD applies to the non-degenerate ``'full'``
    geometry (the JAX package's gate)."""
    return plan.mode == 'full' and math.prod(plan.transform_shape) > 1


def _geom(plan: ConvPlan):
    A = plan.atom_shape
    T = plan.transform_shape
    K = tuple(-(-t // a) for t, a in zip(T, A))
    Tp = tuple(k * a for k, a in zip(K, A))
    return A, T, K, Tp


def _convs(d: int):
    try:
        return _CONV[d]
    except KeyError:
        raise NotImplementedError(
            f"solver='hals' on the shift-invariant geometry takes 1 to 3 shift axes, "
            f'got {d}') from None


def gram_W(W: torch.Tensor) -> torch.Tensor:
    """Dense atom Gram ``G[m, m'] = sum_{c, b} W[m,c,b] W[m',c,b]`` in at
    least float32, a HALS product (:func:`~tnmf_tpu_torch.kernels.hals.dot`:
    the plain-NMF engine's ``G`` bit for bit)."""
    W2 = W.reshape(W.shape[0], -1)
    return dot(W2, W2.to(_acc_dtype(W2)).T)


def _phase_starts(p: int, A) -> tuple:
    """The flat phase index unravelled into per-axis offsets."""
    starts = []
    for a in reversed(A):
        p, r = divmod(p, a)
        starts.append(r)
    return tuple(reversed(starts))


def _valid(A, T, K, device) -> torch.Tensor:
    """``(prod(A), prod(K))``: whether each phase's position exists in the
    un-padded transform grid (``p_i + A_i * k_i < T_i`` on every axis)."""
    d = len(A)
    valid = torch.ones(tuple(A) + tuple(K), dtype=torch.bool, device=device)
    for i, (a, t, k) in enumerate(zip(A, T, K)):
        # built on the device: a copy from the host would wait for the stream
        v = (torch.arange(a, device=device)[:, None]
             + a * torch.arange(k, device=device)[None, :]) < t
        shape = [1] * (2 * d)
        shape[i], shape[d + i] = a, k
        valid = valid & v.view(shape)
    return valid.reshape(math.prod(A), math.prod(K))


def _sweep_phases(E_pad: torch.Tensor, phases, W: torch.Tensor, G: torch.Tensor, l1: float,
                  l2: float, plan: ConvPlan, inner: int, use_pallas: bool, store) -> None:
    """The phases of one exact Gauss–Seidel pass, in order: ``phases[p]``
    holds phase ``p``'s ``(n, M, prod(K))`` maps (a phase-major carry, or
    a sequence of them); for each phase the residual window is updated in
    place in ``E_pad`` and ``store(p, maps)`` takes the new maps, after
    the sweep's last read of ``phases[p]``."""
    A, T, K, Tp = _geom(plan)
    n, M, nk = phases[0].shape
    acc = G.dtype
    corr, place = _convs(plan.ndim)
    Wc = W.to(acc)
    valid = _valid(A, T, K, E_pad.device)
    with convolution_pin(plan.precision, E_pad.device, acc):
        for p in range(len(phases)):
            starts = _phase_starts(p, A)
            window = (slice(None), slice(None)) + tuple(
                slice(s, s + tp) for s, tp in zip(starts, Tp))
            Esl = E_pad[window]                                      # (n, C, *Tp)
            Hp = phases[p]                                           # (n, M, nk)
            rows = Hp.transpose(1, 2).reshape(n * nk, M)
            # the phase's patch correlations: one strided convolution
            Pc = corr(Esl.to(acc), Wc, stride=A)                     # (n, M, *K)
            Pc = Pc.reshape(n, M, nk).transpose(1, 2).reshape(n * nk, M)
            P = Pc + dot(rows, G)                                    # own term added back
            # K5's output takes the rows' layout, so this reshape is a view
            new = _sweep_H(rows, G, P, l1, l2, inner, use_pallas).reshape(n, nk, M)
            # positions past T overhang the valid region: keep them as they were
            new = torch.where(valid[p].view(1, nk, 1), new, rows.view(n, nk, M))
            new_pm = new.transpose(1, 2)                             # (n, M, nk)
            delta = (new_pm - Hp.to(new_pm.dtype)).reshape((n, M) + K)
            # disjoint placement of each position's atom at its stride-A offset
            dR = place(delta.to(acc), Wc, stride=A)                  # (n, C, *Tp)
            Esl.sub_(dR.to(Esl.dtype))
            store(p, new_pm)


def h_phase_sweep(E_pad: torch.Tensor, H_pm: torch.Tensor, W: torch.Tensor, G: torch.Tensor,
                  l1: float, l2: float, *, plan: ConvPlan, inner: int,
                  use_pallas: bool = True):
    """One exact Gauss–Seidel pass over all ``prod(A)`` phases of H.

    ``E_pad``: the residual ``V - R`` zero-padded to ``Tp + A - 1`` per axis;
    ``H_pm``: H in the phase-major carry ``(P, n, M, prod(K))``.  Both are
    updated in place (the loops own them) and returned; the residual stays
    consistent with the returned H.  Each phase's sweep is one K5 launch
    (or its plain version, under the engine's gate)."""
    _sweep_phases(E_pad, H_pm, W, G, l1, l2, plan, inner, use_pallas, H_pm.__setitem__)
    return E_pad, H_pm


def h_phase_sweep_copy(E_pad: torch.Tensor, H_bm: torch.Tensor, W: torch.Tensor,
                       G: torch.Tensor, l1: float, l2: float, *, plan: ConvPlan, inner: int,
                       use_pallas: bool = True):
    """:func:`h_phase_sweep` on the batch-major carry ``H_bm (n, P, M,
    prod(K))`` (:func:`_encode` with ``batch_major``) into new tensors, its
    arguments left as they were: the body of a traced loop must not write
    its carries, and under a symbolic batch no stride of a carry may depend
    on it.  The residual is copied once, the phases' maps stacked once."""
    E_pad = E_pad.clone()
    phases = []
    _sweep_phases(E_pad, H_bm.unbind(1), W, G, l1, l2, plan, inner, use_pallas,
                  lambda p, maps: phases.append(maps))
    return E_pad, torch.stack(phases, dim=1)


def _pad_to(x: torch.Tensor, spatial: tuple) -> torch.Tensor:
    """Zero-pad the trailing axes of ``x`` on the right up to ``spatial``."""
    pad = []
    for s, xs in zip(reversed(spatial), reversed(x.shape[x.dim() - len(spatial):])):
        pad += [0, s - xs]
    return F.pad(x, pad)


def _residual(V: torch.Tensor, W: torch.Tensor, H: torch.Tensor, plan: ConvPlan):
    """``V - R`` zero-padded to ``Tp + A - 1`` per axis."""
    A, _, _, Tp = _geom(plan)
    R = conv_ops.reconstruct(W, H, plan)
    return _pad_to((V - R.to(V.dtype)).to(V.dtype), tuple(t + a - 1 for t, a in zip(Tp, A)))


def _encode(V, W, H, plan: ConvPlan, batch_major: bool = False):
    """Canonical ``(V, W, H)`` -> the loop-carried ``(E_pad, H_pm)`` pair;
    ``batch_major``: H as ``(n, P, M, prod(K))``."""
    A, T, K, Tp = _geom(plan)
    d = plan.ndim
    n, M = H.shape[:2]
    Hr = _pad_to(H, Tp).reshape((n, M) + tuple(x for ka in zip(K, A) for x in ka))
    a_axes, k_axes = tuple(3 + 2 * i for i in range(d)), tuple(2 + 2 * i for i in range(d))
    if batch_major:
        H_pm = Hr.permute((0,) + a_axes + (1,) + k_axes).reshape(
            (n, math.prod(A), M, math.prod(K)))
    else:
        H_pm = Hr.permute(a_axes + (0, 1) + k_axes).reshape((math.prod(A), n, M, math.prod(K)))
    return _residual(V, W, H, plan), H_pm


def _decode_h(H_pm: torch.Tensor, plan: ConvPlan, batch_major: bool = False) -> torch.Tensor:
    """The phase-major (``batch_major``: batch-major) carry back to the
    canonical ``(n, M, *T)``."""
    A, T, K, Tp = _geom(plan)
    d = plan.ndim
    if batch_major:
        n, _, M, _ = H_pm.shape
        Hr = H_pm.reshape((n,) + tuple(A) + (M,) + tuple(K))
        inv = (0, d + 1) + tuple(x for i in range(d) for x in (d + 2 + i, 1 + i))
    else:
        _, n, M, _ = H_pm.shape
        Hr = H_pm.reshape(tuple(A) + (n, M) + tuple(K))
        inv = (d, d + 1) + tuple(x for i in range(d) for x in (d + 2 + i, i))
    H = Hr.permute(inv).reshape((n, M) + Tp)
    return H[(Ellipsis,) + tuple(slice(0, t) for t in T)].contiguous()


def _mu_W_from_residual(V, E_pad, W, H, plan: ConvPlan, use_pallas: bool = True,
                        process_group=None):
    """One multiplicative W step from the maintained residual: K2's
    ``(neg, pos)`` of the streams ``(V, V - E)``, summed over the ranks of
    ``process_group``, then ``W * neg / (pos + EPS)`` by K1's ``mu_ratio``, without
    normalisation."""
    E = E_pad[(Ellipsis,) + tuple(slice(0, s) for s in plan.sample_shape)]
    neg, pos = engine.grad_W_pair_of(conv_ops.extend_data(V, plan), V - E, H, None, plan,
                                     'conv', use_pallas, 2.0)
    neg, pos = engine.all_reduce_sum(neg, pos, process_group=process_group)
    ratio = (engine.mu_ratio if engine.dtype_reason(W.dtype, use_pallas) is None
             else engine.mu_ratio_plain)
    return ratio(W, neg.contiguous(), pos.contiguous(), engine.EPS).to(W.dtype)


def _iteration(V, E_pad, H_pm, W, G, l1, l2, *, inner: int, update_H: bool, update_W: bool,
               plan: ConvPlan, use_pallas: bool = True, process_group=None):
    """One outer iteration: the exact H phase sweep, then the W step and a
    fresh residual (one reconstruction, as the MU engine's W half pays)."""
    if update_H:
        E_pad, H_pm = h_phase_sweep(E_pad, H_pm, W, G, l1, l2, plan=plan, inner=inner,
                                    use_pallas=use_pallas)
    if update_W:
        H = _decode_h(H_pm, plan)
        W = _mu_W_from_residual(V, E_pad, W, H, plan, use_pallas, process_group)
        G = gram_W(W)
        E_pad = _residual(V, W, H, plan)
    return E_pad, H_pm, W, G


def _energy_from_residual(E_pad: torch.Tensor, process_group=None) -> torch.Tensor:
    Ef = E_pad.to(_acc_dtype(E_pad))
    return engine.all_reduce_sum(0.5 * torch.sum(Ef * Ef), process_group=process_group)[0]


@_pinned
def fit_loop(V, W, H, n_iterations, l1, l2, *, inner: int, update_H: bool, update_W: bool,
             plan: ConvPlan, use_pallas: bool = True, process_group=None):
    """``n_iterations`` outer iterations.  Returns ``(W, H)``."""
    E_pad, H_pm = _encode(V, W, H, plan)
    G = gram_W(W)
    for _ in range(int(n_iterations)):
        E_pad, H_pm, W, G = _iteration(V, E_pad, H_pm, W, G, l1, l2, inner=inner,
                                       update_H=update_H, update_W=update_W, plan=plan,
                                       use_pallas=use_pallas, process_group=process_group)
    return W, _decode_h(H_pm, plan)


@_pinned
def update_step(V, W, H, l1, l2, *, inner: int, update_H: bool, update_W: bool,
                plan: ConvPlan, use_pallas: bool = True, process_group=None):
    """One outer iteration on canonical tensors.  Returns ``(W, H)``."""
    return fit_loop(V, W, H, 1, l1, l2, inner=inner, update_H=update_H, update_W=update_W,
                    plan=plan, use_pallas=use_pallas, process_group=process_group)


@_pinned
def fit_loop_energies(V, W, H, l1, l2, *, n_iterations: int, inner: int, update_H: bool,
                      update_W: bool, plan: ConvPlan, use_pallas: bool = True, process_group=None):
    """``n_iterations`` outer iterations with the energy after each, read
    off the residual and kept on the device.  Returns ``(W, H, energies)``."""
    acc = _acc_dtype(V)
    E_pad, H_pm = _encode(V, W, H, plan)
    G = gram_W(W)
    energies = engine.energy_trace(V, int(n_iterations))
    for i in range(int(n_iterations)):
        E_pad, H_pm, W, G = _iteration(V, E_pad, H_pm, W, G, l1, l2, inner=inner,
                                       update_H=update_H, update_W=update_W, plan=plan,
                                       use_pallas=use_pallas, process_group=process_group)
        energies[i] = _energy_from_residual(E_pad, process_group).to(acc)
    return W, _decode_h(H_pm, plan), energies


@_pinned
def fit_loop_tol(V, W, H, n_max, tol, l1, l2, *, check_every: int, n_buf: int = 0,
                 inner: int, update_H: bool, update_W: bool, plan: ConvPlan,
                 use_pallas: bool = True, process_group=None):
    """Adaptive fit by :func:`tnmf_tpu_torch.engine.tol_loop` on the
    residual's energy.  Returns ``(W, H, n_done, e_final, trace_or_None)``."""
    acc = _acc_dtype(V)
    E_pad, H_pm = _encode(V, W, H, plan)

    def step(carry):
        return _iteration(V, *carry, l1, l2, inner=inner, update_H=update_H,
                          update_W=update_W, plan=plan, use_pallas=use_pallas,
                          process_group=process_group)

    (E_pad, H_pm, W, _), n_done, e, trace = engine.tol_loop(
        (E_pad, H_pm, W, gram_W(W)), step,
        lambda carry: _energy_from_residual(carry[0], process_group).to(acc), int(n_max), tol,
        int(check_every), int(n_buf), V)
    return W, _decode_h(H_pm, plan), n_done, e, trace
