"""Device-memory planning: will this fit fit, and at what batch size?

Port of :mod:`tnmf_tpu.utils.memory`.  ``estimate_fit_memory(model,
V_shape)`` predicts the device footprint of a ``fit_batch`` before anything
is allocated: the persistent tensors (the data, its loop-invariant
prepared form, H, the dictionary) are sized exactly by running the port's
own operators (:func:`tnmf_tpu_torch.engine.prepare_data`, the shift-invariant
HALS encoding) on tensors on ``device='meta'``, the counterpart of
``jax.eval_shape``: nothing is allocated and no kernel runs.  The port
carries H in its canonical layout on every strategy (it has no
phase-blocked carrier), so H's entry is the canonical ``(n, M*G, *T)``.

The transients are what the port's eager iteration holds at its peak, read
off :func:`tnmf_tpu_torch.engine.update_step` and
:func:`tnmf_tpu_torch.engine._mu_H_of` on the card's path (the kernels on,
beta = 2, no mask), not XLA's list:

* every strategy holds three H: the model's (the persistent entry, held
  until the loop returns), the loop's current one (``'H carried'``) and
  the update's output (``'H update out'``);
* conv: the reconstruction R (from H extended, outside ``'valid'`` mode),
  its extension ``Rx`` that K3 and K2 read
  (``'R prepared'``, the storage of R itself in ``'full'`` mode), the
  stacked ``(V, Rx)`` that K2 takes and K2's ``(neg, pos)``: the W step,
  where the new H is alive beside the carried one;
* fft: the H step's second correlation, its peak: the inverse transform
  that R is a crop of (frequency-major, ``(*fft_shape, n, C)``, where the
  JAX entry is the canonical ``(n, C, *S)``), R's transform, three
  H-gradient spectra (the product, the copy cuFFT's inverse transform
  takes of it and a work area of its size: at the fft flagship on an H100
  the gradient held 5799 MiB over its entry, two gradients and three
  spectra) and the two gradients at the transform's size (``(*fft_shape,
  n, M)`` each);
* dot: R, the stacked ``(V, R)`` of the gradient product and its
  ``(neg, pos)``; ``prepare_data`` is the identity there, so the prepared
  data and R's prepared form share storage with V and R.

An entry whose storage is another entry's is listed in ``shared`` and
counted once.  The last entry is the caching allocator's rounding of the
blocks it hands out (:meth:`MemoryEstimate.add_allocator_rounding`).
cuDNN's and cuFFT's workspaces are not listed apart: the fft entry counts
one, measured.

``solver='hals'`` sizes the HALS loop state under the JAX package's keys
(plain NMF: the flat views and the Gram/cross products, with the port's
sweep outputs and carried factors as transients; shift-invariant: the
padded residual and the phase-major H of
:func:`tnmf_tpu_torch.engine_hals_conv._encode`, beside the model's own
canonical H and prepared data, which it holds for the whole fit, and the
transients of the loop's largest stage, read off
:func:`~tnmf_tpu_torch.engine_hals_conv.fit_loop`: at the flagship's data
the residual of the encoding, H padded to the phase grid and H extended
for the reconstruction beside the model's H and the carrier, four
H-sized tensors).  :class:`MultiScaleTNMF` is sized scale by scale.

``suggest_batch_size`` inverts the estimate against a budget, by default
the card's memory (``torch.cuda.mem_get_info``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

from .validation import require

#: meta tensors: shapes, dtypes and strides with no storage
_META = torch.device('meta')


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype, device=_META)


@dataclass
class MemoryEstimate:
    """Per-tensor device-memory breakdown of one ``fit_batch``.

    ``tensors`` maps a tensor name to ``(shape, dtype, bytes)``; transient
    entries are suffixed ``(transient)``.  ``shared`` names the entries
    whose storage is another entry's (counted once).  ``peak_bytes`` is
    persistent + transient, the high-water mark of an iteration."""

    strategy: str
    tensors: Dict[str, Tuple[Tuple[int, ...], str, int]] = field(default_factory=dict)
    shared: Tuple[str, ...] = ()

    def _sum(self, transient: bool) -> int:
        return sum(b for k, (_, _, b) in self.tensors.items()
                   if ('transient' in k) == transient and k not in self.shared)

    @property
    def persistent_bytes(self) -> int:
        return self._sum(False)

    @property
    def transient_bytes(self) -> int:
        return self._sum(True)

    @property
    def peak_bytes(self) -> int:
        return self.persistent_bytes + self.transient_bytes

    def __str__(self) -> str:
        rows = [f'strategy: {self.strategy}']
        for name, (shape, dtype, b) in self.tensors.items():
            note = ' (shared)' if name in self.shared else ''
            rows.append(f'  {name:28s} {str(shape):24s} {dtype:9s} '
                        f'{b / 2**20:10.1f} MiB{note}')
        rows.append(f'  {"persistent":28s} {"":24s} {"":9s} '
                    f'{self.persistent_bytes / 2**20:10.1f} MiB')
        rows.append(f'  {"peak (est.)":28s} {"":24s} {"":9s} '
                    f'{self.peak_bytes / 2**20:10.1f} MiB')
        return '\n'.join(rows)

    def add_allocator_rounding(self) -> 'MemoryEstimate':
        """Add ``'allocator rounding (transient)'``: PyTorch's CUDA caching
        allocator hands each tensor a block of its size rounded up to 512
        bytes, and a block over 1 MiB may keep up to 1 MiB of its segment
        unsplit, so each counted entry may take that much more."""
        slack = sum(-(-b // 512) * 512 - b + (2 ** 20 if b > 2 ** 20 else 0)
                    for k, (_, _, b) in self.tensors.items() if k not in self.shared)
        self.tensors['allocator rounding (transient)'] = ((), 'uint8', slack)
        return self

    def add(self, name: str, t: torch.Tensor, shares: bool = False) -> torch.Tensor:
        """Record ``t`` (a meta tensor) under ``name``; ``shares``: its
        storage is another entry's."""
        self.tensors[name] = (tuple(int(x) for x in t.shape),
                              str(t.dtype).removeprefix('torch.'),
                              t.numel() * t.element_size())
        if shares:
            self.shared = self.shared + (name,)
        return t


def _check_model(model, dtype) -> torch.dtype:
    """The storage dtype of the estimate; a mesh or bfloat16 raises as the
    model does."""
    if getattr(model, '_mesh', None) is not None:
        raise NotImplementedError(
            'meshes are not ported to tnmf_tpu_torch yet (ROADMAP.md queue 1, item 14e)')
    from ..models.tnmf import _torch_dtype
    return _torch_dtype(model.dtype if dtype is None else dtype)


def estimate_fit_memory(model, V_shape: Tuple[int, ...], dtype=None,
                        solver: str = 'mu') -> MemoryEstimate:
    """Predict the device-memory footprint of ``model.fit_batch(V)`` for a
    data tensor of shape ``V_shape = (n_samples, n_channels,
    *sample_shape)``, without allocating anything.

    Uses the model's constructor configuration (atoms, mode, backend,
    transform group, dtype) and the port's own operators on meta tensors;
    the strategy resolves as the model's ``_initialize_matrices`` resolves
    it.  ``solver='hals'`` accounts the coordinate-descent loop state
    instead."""
    require(len(V_shape) >= 3, 'V_shape must be (n_samples, n_channels, *sample_shape)')
    dt = _check_model(model, dtype)
    n, c = int(V_shape[0]), int(V_shape[1])
    sample_shape = tuple(int(s) for s in V_shape[2:])
    if hasattr(model, 'atom_shapes'):  # MultiScaleTNMF
        return _estimate_multiscale(model, n, c, sample_shape, dt).add_allocator_rounding()
    plan = model._plan_for(sample_shape)
    if solver == 'hals':
        return _estimate_hals(model, plan, n, c, sample_shape, dt).add_allocator_rounding()
    if solver != 'mu':
        raise ValueError(f"solver must be 'mu' or 'hals', got {solver!r}")
    strategy = model._strategy_for(plan)
    est = MemoryEstimate(strategy=str(strategy))
    n_maps = model.n_atoms * model.n_transforms
    _mu_entries(est, '', plan, strategy, n, c, n_maps, model.n_atoms, dt,
                est.add('V (device copy)', _meta((n, c) + sample_shape, dt)),
                names=('V prepared (loop-invariant)', 'H (loop carrier)', 'W (dictionary)'))
    return est.add_allocator_rounding()


def _mu_entries(est: MemoryEstimate, scale: str, plan, strategy, n: int, c: int, n_maps: int,
                n_atoms: int, dt: torch.dtype, V: torch.Tensor, names: tuple,
                with_R: bool = True) -> None:
    """The persistent entries under ``names`` and the transients of one MU
    model (or one scale of a multi-scale one: ``scale`` suffixes the
    transients' names)."""
    from .. import engine
    base = strategy[0] if isinstance(strategy, tuple) else strategy
    Vp = engine.prepare_data(V, plan=plan, strategy=base)
    est.add(names[0], Vp, shares=Vp is V)
    H = est.add(names[1], _meta((n, n_maps) + plan.transform_shape, dt))
    est.add(names[2], _meta((n_atoms, c) + plan.atom_shape, dt))
    R = _meta((n, c) + plan.sample_shape, dt)
    if base == 'fft':
        F = plan.fft_shape
        Fh = F[:-1] + (F[-1] // 2 + 1,)
        cdt = Vp.dtype
        if with_R:
            est.add('R (transient)', _meta(F + (n, c), dt))
        est.add(f'R prepared{scale} (transient)', engine.prepare_data(R, plan=plan, strategy=base))
        est.add(f'H gradient spectra{scale} (transient)', _meta((3,) + Fh + (n, n_maps), cdt))
        est.add(f'H gradient pair at the FFT size{scale} (transient)',
                _meta((2,) + F + (n, n_maps), dt))
    else:
        if with_R:
            est.add('R (transient)', R)
        if base == 'conv':  # the reconstruction's input: H extended but in 'valid' mode
            from ..ops import conv as conv_ops
            Hx = conv_ops._extend_H(H, plan)
            if Hx is not H:
                est.add(f'H extended{scale} (transient)', Hx)
        Rx = engine.prepare_data(R, plan=plan, strategy=base)
        est.add(f'R prepared{scale} (transient)', Rx, shares=Rx is R and with_R)
        if base == 'conv':
            est.add(f'V and R stacked{scale} (transient)', torch.cat([Vp, Rx], dim=1))
            est.add(f'W gradient pair{scale} (transient)',
                    _meta((2, n_maps, c) + plan.atom_shape, dt))
        else:  # dot: the H gradient's product of the stacked streams
            est.add(f'V and R stacked{scale} (transient)', torch.cat([Vp, Rx], dim=0))
            est.add(f'H gradient pair{scale} (transient)', _meta((2 * n, n_maps), dt))
    est.add(f'H carried{scale} (transient)', H)
    est.add(f'H update out{scale} (transient)', H)


def _estimate_hals(model, plan, n, c, sample_shape, dt) -> MemoryEstimate:
    """Loop-state accounting for ``solver='hals'`` under the JAX package's
    keys: the plain-NMF engine's flat views and Gram/cross products; the
    shift-invariant engine's padded residual and phase-major H.  The JAX
    entries without a ``(transient)`` suffix keep it off theirs here too;
    the port adds its sweep outputs and carried factors as transients."""
    m = model.n_atoms
    acc = torch.promote_types(dt, torch.float32)
    if math.prod(plan.transform_shape) == 1:  # plain-NMF engine
        F = c * math.prod(sample_shape)
        est = MemoryEstimate(strategy='hals')
        est.add('V (device copy, flat view)', _meta((n, F), dt))
        H = est.add('H (n, m)', _meta((n, m), dt))
        W = est.add('W (m, F)', _meta((m, F), dt))
        est.add('Gram G / A (m, m)', _meta((m, m), acc))
        est.add('cross P (n, m)', _meta((n, m), acc))
        est.add('cross B (m, F)', _meta((m, F), acc))
        est.add('Gram A (transient)', _meta((m, m), acc))
        est.add('H carried (transient)', H)
        est.add('H sweep out (transient)', H)
        est.add('W carried (transient)', W)
        est.add('W sweep out (transient)', W)
        return est

    from .. import engine, engine_hals_conv as ehc
    from ..ops import conv as conv_ops
    if not ehc.applicable(plan):
        raise ValueError("solver='hals' requires the degenerate plain-NMF "
                         "geometry or reconstruction_mode='full'")
    A, T, K, Tp = ehc._geom(plan)
    est = MemoryEstimate(strategy='hals-conv')
    V = est.add('V (device copy)', _meta((n, c) + sample_shape, dt))
    # the model prepares V for its MU strategy whatever the solver
    strategy = model._strategy_for(plan)
    Vp = engine.prepare_data(V, plan=plan,
                             strategy=strategy[0] if isinstance(strategy, tuple) else strategy)
    est.add('V prepared (loop-invariant)', Vp, shares=Vp is V)
    H = est.add("H (canonical, the model's)", _meta((n, m) + T, dt))
    W = _meta((m, c) + A, dt)
    E_pad, H_pm = ehc._encode(V, W, H, plan)
    est.add('E residual (padded carrier)', E_pad)
    est.add('H (phase-major carrier)', H_pm)
    est.add('W (dictionary)', W)
    est.add('Gram G (m, m)', _meta((m, m), acc))
    # the sweep's residual window is a view of the carrier; its NNLS rows
    est.add('phase patch slice (transient)', E_pad[(Ellipsis,) + tuple(
        slice(0, t) for t in Tp)], shares=True)
    est.add('phase rows (transient)', _meta((n * math.prod(K), m), acc))
    # the stages of the loop beside the carriers, the largest counted: the
    # residual of _encode (H padded to the phase grid, H extended for the
    # reconstruction, R); the W step (H decoded, V - E, K2's streams and
    # output); the fresh residual after it (H decoded, R, V - R and the next
    # carrier beside the old).  The decode and the reconstruction after the
    # W step hold less than the first, the phase sweep less than any
    R = _meta((n, c) + sample_shape, dt)
    Vx = conv_ops.extend_data(V, plan)
    streams = torch.cat([Vx, conv_ops.extend_data(R, plan)], dim=1)
    stages = (
        (('H padded to the phase grid (transient)', ehc._pad_to(H, Tp), False),
         ('H extended (transient)', conv_ops._extend_H(H, plan), False),
         ('R (transient)', R, False)),
        (('H decoded (transient)', H, False),
         ('V extended (transient)', Vx, Vx is V),
         ('V - E (transient)', R, False),
         ('V and R stacked (transient)', streams, False),
         ('W gradient pair (transient)', _meta((2, m, c) + A, acc), False)),
        (('H decoded (transient)', H, False),
         ('R (transient)', R, False),
         ('V - R (transient)', R, False),
         ('E residual, the next (transient)', E_pad, False)))
    for name, t, shares in max(stages, key=lambda stage: sum(
            t.numel() * t.element_size() for _, t, shares in stage if not shares)):
        est.add(name, t, shares=shares)
    return est


def _estimate_multiscale(model, n, c, sample_shape, dt) -> MemoryEstimate:
    """Per-scale accounting for :class:`MultiScaleTNMF` (its ``_initialize``'s
    resolution chain): each scale's prepared data, H, W and transients, and
    the total R with the two partial sums that form it."""
    from ..ops.modes import ConvPlan
    plans = tuple(ConvPlan.create(model._mode, sample_shape, a, precision=model._precision)
                  for a in model.atom_shapes)
    strategies = model._strategies_for(plans)
    est = MemoryEstimate(strategy=str(tuple(strategies)))
    V = est.add('V (device copy)', _meta((n, c) + sample_shape, dt))
    for k, (m, p, s) in enumerate(zip(model.n_atoms, plans, strategies)):
        _mu_entries(est, f', scale {k}', p, s, n, c, m, m, dt, V, with_R=False,
                    names=(f'V prepared, scale {k}', f'H, scale {k} (loop carrier)',
                           f'W, scale {k}'))
    R = est.add('R (transient)', _meta((n, c) + sample_shape, dt))
    est.add('R partial sums (transient)', torch.cat([R, R]))
    return est


def _default_budget(model) -> int:
    """The card's memory (``torch.cuda.mem_get_info``) for a CUDA model."""
    device = torch.device(getattr(model, 'device', 'cpu'))
    if device.type != 'cuda':
        raise ValueError('the runtime reports no device memory limit; '
                         'pass budget_bytes explicitly')
    return int(torch.cuda.mem_get_info(device)[1])


def suggest_batch_size(model, sample_shape: Tuple[int, ...], n_channels: int = 1,
                       budget_bytes: Optional[int] = None, safety: float = 0.85,
                       dtype=None) -> int:
    """Largest ``n_samples`` whose estimated fit peak stays within
    ``budget_bytes`` (default: the card's memory, ``torch.cuda.mem_get_info``,
    on a CUDA model; a CPU model raises), scaled by ``safety``.  Returns 0
    when even one sample does not fit."""
    if budget_bytes is None:
        budget_bytes = _default_budget(model)
    budget = int(budget_bytes * safety)

    def peak(n):
        return estimate_fit_memory(
            model, (n, n_channels) + tuple(sample_shape), dtype=dtype).peak_bytes

    if peak(1) > budget:
        return 0
    lo, hi = 1, 2
    while peak(hi) <= budget:
        lo, hi = hi, hi * 2
        if hi > 2 ** 40:  # pragma: no cover - absurd budgets
            return lo
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if peak(mid) <= budget:
            lo = mid
        else:
            hi = mid
    return lo
