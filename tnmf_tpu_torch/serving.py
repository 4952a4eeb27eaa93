"""Serialized serving artifacts: the encoding step as one file, on ``torch.export``.

Port of :mod:`tnmf_tpu.serving`.  ``export_serving(model, ...)`` serializes
the model's frozen-dictionary encoding step ``V -> H`` (the matched-filter
activation init followed by H-only updates, ``model.transform``'s compute)
as a ``torch.export`` program.  The dictionary (and, for HALS, its Gram),
the plan, the strategy and the regularizer strengths are baked in; the
batch dimension is symbolic by default (``torch.export.Dim``), so one
artifact serves any request size.  ``load_serving(path_or_bytes)``
rehydrates a callable that needs torch and this package, not JAX, and none
of the model's Python state or RNG (the matched-filter init is
deterministic).

The artifact's signature is ``(V, n_iterations) -> H``: the iteration count
stays a runtime argument, a 0-d int64 tensor on the host that bounds one
``while_loop`` whose counter also lives on the host, so testing the
condition never waits for the card.  The regularizer strengths are
export-time constants (they select which kernels the program calls).

The kernels reach the program as the custom operators of
:mod:`tnmf_tpu_torch.kernels.ops`, which ``import tnmf_tpu_torch``
registers: a program exported on CUDA tensors calls K3 ``tnmf::mu_h`` on
the conv strategy, K1 ``tnmf::mu_ratio`` on fft and dot, K4
``tnmf::inhibited_mu_h`` with inhibition and K5 ``tnmf::hals_sweep`` under
``solver='hals'``, and no plain version; a CPU program calls the same
operators, whose bodies run the plain versions on CPU tensors.

Precision: a program is exported at the model's ``precision`` and the
header records it as ``'precision'`` (the JAX header bakes it into its
program and has no such key; an artifact without it, written before the
port took ``precision``, is ``None``).  K3's pass count is a constant of
the traced ``tnmf::mu_h`` call, but the graph does not carry cuDNN's and
cuBLAS's TF32 flags, and the engine's pins stand aside while it is traced
(:func:`~tnmf_tpu_torch.ops.precision.exporting`).  :class:`ServingModel`
runs every loaded program inside
:func:`~tnmf_tpu_torch.ops.precision.pinned` at the header's level, so an
artifact computes at its own precision whatever the caller's TF32
settings.

With ``include_decoder=True`` the file also carries the reconstruction
``H -> R`` as a second program (cuDNN or cuFFT, no kernel of the port).

A :class:`~tnmf_tpu_torch.MultiScaleTNMF` exports ``(V, n_iterations) ->
(H_0, H_1, ...)``: each scale's matched-filter start, then joint
frozen-dictionary block MU steps in one ``while_loop`` (K3 per conv scale,
K1's ``tnmf::mu_ratio`` per fft scale), and the summed reconstruction as
its decoder; its header carries the JAX package's ``'multiscale'`` key
(the scale count) with per-scale ``n_atoms``, ``atom_shape`` and
``sparsity_H`` lists.

File format: the JAX package's layout with a magic of its own,
``b'TNMFSRT1' + <u32 header length> + <JSON header> + <concatenated
torch.export.save payloads>``.  The header's ``sections`` dict gives each
payload's name, ``'<program>@<platform>'`` (``transform@cuda``,
``inverse_transform@cpu``, ...), and byte length, in file order; the other
keys are the JAX header's, with ``'library': 'tnmf_tpu_torch'``.  Each
package's loader refuses the other's files.
"""

from __future__ import annotations

import dataclasses
import io
import json
import math
import os
import struct
import tempfile
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch._higher_order_ops.while_loop import while_loop

from . import engine, engine_hals
from . import engine_hals_conv as ehc
from .ops.modes import ConvPlan
from .ops.precision import pinned

_MAGIC = b'TNMFSRT1'
#: the JAX package's artifacts (StableHLO), which this loader refuses
_JAX_MAGIC = b'TNMFSRV1'
#: the platforms a program is exported for: the device types of its tensors
PLATFORMS = ('cpu', 'cuda')


@dataclasses.dataclass(frozen=True)
class _Recipe:
    """What an artifact bakes in, read off the model once."""
    W: torch.Tensor
    plan: ConvPlan
    strategy: engine.Strategy
    beta: float
    n_atoms: int
    n_transforms: int
    kernels: tuple            # the 1-D inhibition taps (arrays or tensors)
    sparsity: float
    inhibition: float
    cross: float
    l2: Optional[float]       # None: absent
    solver: str
    use_pallas: bool
    in_dtype: torch.dtype

    @property
    def h_leading(self) -> tuple:
        """H's axes after the batch and before the shifts."""
        return (self.n_atoms, self.n_transforms) if self.n_transforms > 1 else (self.n_atoms,)


def _loop(n_iterations: torch.Tensor, step, carry: tuple) -> tuple:
    """``carry = step(*carry)``, ``n_iterations`` times, as one
    ``while_loop`` whose counter lives on the host beside the count."""
    def cond(i, *c):
        return i < n_iterations

    def body(i, *c):
        return (i + 1,) + tuple(step(*c))

    return tuple(while_loop(cond, body, (torch.zeros((), dtype=torch.int64),) + carry))[1:]


def _on(t: torch.Tensor, device: str) -> torch.Tensor:
    """``t`` on the platform ``device`` ('cpu' or 'cuda'): itself when it
    is there already."""
    return t if t.device.type == device else t.to(device)


class _Program(torch.nn.Module):
    """The tensors of a recipe as buffers (each its own copy: the loop body
    may not capture two views of one tensor) on the program's device."""

    def __init__(self, recipe: _Recipe, device: str, **tensors):
        super().__init__()
        self.r = recipe
        self.register_buffer('W', _on(recipe.W.detach(), device).clone())
        self.n_kernels = len(recipe.kernels)
        for i, k in enumerate(recipe.kernels):
            self.register_buffer(f'k{i}', _on(torch.as_tensor(k, dtype=self.W.dtype), device))
        for name, t in tensors.items():
            self.register_buffer(name, _on(t.detach(), device).clone())

    def _init(self, V: torch.Tensor) -> tuple:
        """``(V, prepare(V), H0)``: the data in the compute dtype, its
        prepared tensor and the matched-filter activations."""
        r = self.r
        V = V.to(self.W.dtype)
        Vp = engine.prepare_data(V, plan=r.plan, strategy=r.strategy)
        return V, Vp, engine.correlate_init_H(Vp, V, self.W, plan=r.plan, strategy=r.strategy)


class _MUEncoder(_Program):
    """``(V, n_iterations) -> H`` by H-only MU steps (the engine's
    ``_mu_H``, as ``transform`` runs them)."""

    def forward(self, V: torch.Tensor, n_iterations: torch.Tensor) -> torch.Tensor:
        r, W = self.r, self.W
        V, Vp, H0 = self._init(V)
        # a beta != 2 fft loop reads the canonical V (the model's prepared
        # slot); every other configuration the prepared tensor
        Vloop = (Vp if r.beta == 2.0 or engine.get_ops(r.strategy).FACTORS_IN_PREPARED
                 else V)
        kernels = tuple(getattr(self, f'k{i}') for i in range(self.n_kernels))

        def step(H):
            return (engine._mu_H(Vloop, W, H, r.sparsity, r.inhibition, r.cross, kernels,
                                 plan=r.plan, use_inhibition=r.inhibition > 0,
                                 use_cross=r.cross > 0, strategy=r.strategy,
                                 use_pallas=r.use_pallas, beta=r.beta, l2=r.l2),)

        (H,) = _loop(n_iterations, step, (H0,))
        return H.reshape((H.shape[0],) + r.h_leading + tuple(H.shape[2:]))


class _HALSEncoder(_Program):
    """Plain-NMF geometry: ``P = V W^T`` once, then exact H sweeps against
    the baked Gram ``G = W W^T`` (:func:`engine_hals._sweep_H`, K5), one
    Gauss–Seidel pass per iteration."""

    def forward(self, V: torch.Tensor, n_iterations: torch.Tensor) -> torch.Tensor:
        r = self.r
        V, _, H0 = self._init(V)
        W2 = self.W.reshape(self.W.shape[0], -1)
        P = engine_hals._dot(V.reshape(V.shape[0], -1), W2.to(engine_hals._acc_dtype(W2)).T)

        def step(H2):
            return (engine_hals._sweep_H(H2, self.G, P, r.sparsity, r.l2 or 0., 1,
                                         r.use_pallas),)

        H2 = H0.reshape(H0.shape[0], H0.shape[1])  # K5's output keeps this layout
        (H2,) = _loop(n_iterations, step, (H2,))
        return H2.reshape(H0.shape)


class _ConvHALSEncoder(_Program):
    """Shift-invariant ``'full'`` geometry: exact phase-blocked H sweeps
    against the baked Gram (:func:`engine_hals_conv.h_phase_sweep_copy`,
    one K5 launch per phase), one whole sweep per iteration."""

    def forward(self, V: torch.Tensor, n_iterations: torch.Tensor) -> torch.Tensor:
        r = self.r
        V, _, H0 = self._init(V)

        def step(E_pad, H_bm):
            return ehc.h_phase_sweep_copy(E_pad, H_bm, self.W, self.G, r.sparsity, r.l2 or 0.,
                                          plan=r.plan, inner=1, use_pallas=r.use_pallas)

        # contiguous carries, as the sweep returns them; H batch-major, so
        # that no stride depends on the symbolic batch
        carry = tuple(t.contiguous() for t in ehc._encode(V, self.W, H0, r.plan,
                                                          batch_major=True))
        _, H_bm = _loop(n_iterations, step, carry)
        return ehc._decode_h(H_bm, r.plan, batch_major=True)


class _MSProgram(torch.nn.Module):
    """A multi-scale recipe's dictionaries as buffers ``W0``, ``W1``, ...
    (each its own copy) on the program's device."""

    def __init__(self, recipe: '_MSRecipe', device: str):
        super().__init__()
        self.r = recipe
        for k, W in enumerate(recipe.Ws):
            self.register_buffer(f'W{k}', _on(W.detach(), device).clone())

    def _Ws(self) -> tuple:
        return tuple(getattr(self, f'W{k}') for k in range(len(self.r.plans)))


class _MSEncoder(_MSProgram):
    """``(V, n_iterations) -> (H_0, H_1, ...)``: the per-scale matched-filter
    start, then joint frozen-dictionary block MU steps (the multi-scale
    model's ``_step`` with ``update_W=False``, as ``transform`` runs it) in
    one ``while_loop``."""

    def forward(self, V: torch.Tensor, n_iterations: torch.Tensor) -> tuple:
        from .models import multiscale as ms
        r, Ws = self.r, self._Ws()
        V = V.to(Ws[0].dtype)
        Vps = tuple(engine.prepare_data(V, plan=p, strategy=s)
                    for p, s in zip(r.plans, r.strategies))
        Hs0 = tuple(engine.correlate_init_H(vp, V, W, plan=p, strategy=s)
                    for vp, W, p, s in zip(Vps, Ws, r.plans, r.strategies))
        # the canonical V where the beta factors are formed from the total R
        Vloop = (V,) * len(Ws) if r.beta != 2.0 else Vps

        def step(*Hs):
            return ms._step(V, Vloop, Ws, Hs, r.sparsities, None, plans=r.plans,
                            strategies=r.strategies, update_H=True, update_W=False,
                            beta=r.beta, use_pallas=r.use_pallas)[1]

        return _loop(n_iterations, step, Hs0)


class _MSDecoder(_MSProgram):
    """``(H_0, H_1, ...) -> R``: the summed reconstruction."""

    def forward(self, Hs: tuple) -> torch.Tensor:
        from .models import multiscale as ms
        r, Ws = self.r, self._Ws()
        R = ms._reconstruct(Ws, tuple(h.to(Ws[0].dtype) for h in Hs), r.plans, r.strategies)
        return R.to(r.in_dtype)


@dataclasses.dataclass(frozen=True)
class _MSRecipe:
    """What a multi-scale artifact bakes in."""
    Ws: tuple
    plans: tuple
    strategies: tuple
    beta: float
    n_atoms: tuple
    sparsities: tuple
    use_pallas: bool
    in_dtype: torch.dtype


def _export_serving_multiscale(model, *, n_iterations, sparsity_H, inhibition_strength,
                               cross_atom_inhibition_strength, batch_size, path, platforms,
                               input_dtype, include_decoder, sample_shape) -> bytes:
    """Multi-scale artifact: one program encoding V into the per-scale
    activation tuple, optionally the summed reconstruction as decoder (the
    JAX package's ``_export_serving_multiscale``, its checks in its
    order)."""
    from .models.multiscale import _sparsities

    if getattr(model, '_Ws', None) is None:
        raise RuntimeError(
            'export_serving() requires a fitted model or a loaded '
            'checkpoint; call fit() first')
    if getattr(model, '_plans', None) is None and sample_shape is None:
        raise RuntimeError(
            'export_serving(): the model has dictionaries but no sample '
            'geometry yet; pass sample_shape=... or run one fit first')
    if inhibition_strength or cross_atom_inhibition_strength:
        raise ValueError('MultiScaleTNMF has no lateral-inhibition '
                         'regularizers; only sparsity_H applies')
    if sample_shape is not None:
        # the requested geometry's plans and strategies (the model's own chain)
        plans = tuple(ConvPlan.create(model._mode, tuple(int(s) for s in sample_shape), a,
                                      precision=model._precision)
                      for a in model.atom_shapes)
        strategies = model._strategies_for(plans)
    else:
        plans, strategies = model._plans, model._strategies
    sparsity_H = _sparsities(sparsity_H, model.n_scales)
    Ws = model._Ws
    recipe = _MSRecipe(Ws=Ws, plans=plans, strategies=strategies, beta=model._beta,
                       n_atoms=model.n_atoms, sparsities=sparsity_H,
                       use_pallas=model._use_pallas is not False,
                       in_dtype=Ws[0].dtype if input_dtype is None else _torch_dtype(input_dtype))
    plats = _platforms(model, platforms)
    n_ch = int(Ws[0].shape[1])
    payloads = {}
    for p in plats:
        for name, program in _ms_programs(recipe, p, batch_size, include_decoder).items():
            payloads[f'{name}@{p}'] = _serialize(program)
    header = {
        'format': 1,
        'sections': {k: len(v) for k, v in payloads.items()},
        'library': 'tnmf_tpu_torch',
        'torch': torch.__version__,
        'multiscale': int(model.n_scales),
        'n_iterations': int(n_iterations),
        'input_shape': ['b' if batch_size is None else int(batch_size),
                        n_ch] + [int(x) for x in plans[0].sample_shape],
        'input_dtype': _dtype_name(recipe.in_dtype),
        'n_atoms': [int(m) for m in model.n_atoms],
        'n_transforms': 1,
        'mode': plans[0].mode,
        'atom_shape': [[int(x) for x in a] for a in model.atom_shapes],
        'platforms': list(plats),
        'sparsity_H': list(sparsity_H),
        'beta_loss': float(model._beta),
        'precision': plans[0].precision,
    }
    return _assemble(header, payloads, path)


def _ms_programs(recipe: _MSRecipe, device: str, batch_size: Optional[int],
                 include_decoder: bool) -> dict:
    """The exported programs of a multi-scale ``recipe`` on ``device``
    (:func:`_programs`' counterpart; runs under a ``FakeTensorMode`` as
    well)."""
    r = recipe
    b = 2 if batch_size is None else int(batch_size)
    dims = None if batch_size is not None else {0: torch.export.Dim('b', min=1)}
    V0 = torch.zeros((b, int(r.Ws[0].shape[1])) + r.plans[0].sample_shape, dtype=r.in_dtype,
                     device=device)
    n0 = torch.ones((), dtype=torch.int64)
    programs = {'transform': torch.export.export(
        _MSEncoder(r, device), (V0, n0), dynamic_shapes=dims and (dims, None), strict=False)}
    if include_decoder:
        H0 = tuple(torch.zeros((b, m) + p.transform_shape, dtype=r.in_dtype, device=device)
                   for m, p in zip(r.n_atoms, r.plans))
        programs['inverse_transform'] = torch.export.export(
            _MSDecoder(r, device), (H0,), dynamic_shapes=dims and ((dims,) * len(H0),),
            strict=False)
    return programs


def _platforms(model, platforms) -> tuple:
    """The platforms to export for: the model's device by default."""
    plats = (model.device.type,) if platforms is None else tuple(platforms)
    for p in plats:
        if p not in PLATFORMS:
            raise ValueError(f'platforms must be among {PLATFORMS}, got {p!r}')
    if 'cuda' in plats and not torch.cuda.is_available():
        raise RuntimeError("export_serving(platforms=('cuda', ...)) exports on the card; "
                           'torch.cuda.is_available() is False')
    return plats


class _Decoder(_Program):
    """``H -> R``: the reconstruction, H in the public layout."""

    def forward(self, H: torch.Tensor) -> torch.Tensor:
        r = self.r
        shift = tuple(H.shape[1 + len(r.h_leading):])
        H = H.reshape((H.shape[0], r.n_atoms * r.n_transforms) + shift)
        R = engine.reconstruct(self.W, H.to(self.W.dtype), plan=r.plan, strategy=r.strategy)
        return R.to(r.in_dtype)


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or anything ``np.dtype`` takes."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype == 'bfloat16':  # NumPy has no bfloat16
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix('torch.')


def _recipe(model, *, sparsity_H, inhibition_strength, cross_atom_inhibition_strength, l2_H,
            input_dtype, sample_shape, solver) -> _Recipe:
    """The JAX ``export_serving``'s checks, in its order, and what the
    artifact bakes in."""
    if getattr(model, '_W', None) is None:
        raise RuntimeError(
            'export_serving() requires a fitted model, a loaded checkpoint '
            'or set_dictionary(); call fit() first')
    if getattr(model, '_plan', None) is None and sample_shape is None:
        raise RuntimeError(
            'export_serving(): the model has a dictionary but no sample '
            'geometry yet (W-only checkpoint / set_dictionary); pass '
            'sample_shape=... or run one fit/transform first')
    model._check_regs(sparsity_H, inhibition_strength, cross_atom_inhibition_strength, l2_H)
    if sample_shape is not None:
        # the plan and strategy of the requested geometry (the model's own
        # resolution chain)
        plan = model._plan_for(tuple(int(s) for s in sample_shape))
        strategy = model._strategy_for(plan)
    else:
        plan, strategy = model._plan, model._strategy
    use_inh, use_cross = inhibition_strength > 0, cross_atom_inhibition_strength > 0
    if solver not in ('mu', 'hals'):
        raise ValueError(f"solver must be 'mu' or 'hals', got {solver!r}")
    if solver == 'hals':
        if use_inh or use_cross:
            raise ValueError('inhibition regularizers are MU-only under '
                             "solver='hals'")
        if model._beta != 2.0 or model.n_transforms > 1:
            raise ValueError("solver='hals' artifacts require beta_loss=2 "
                             'and no transform group')
        if math.prod(plan.transform_shape) != 1 and not ehc.applicable(plan):
            raise ValueError(
                "export_serving(solver='hals') requires the "
                "degenerate plain-NMF geometry or "
                "reconstruction_mode='full' (shift-invariant exact "
                'CD); other modes have boundary-clipped footprints')
    W = model._W
    return _Recipe(
        W=W, plan=plan, strategy=strategy, beta=model._beta, n_atoms=model.n_atoms,
        n_transforms=model.n_transforms, kernels=tuple(model._inhibition_kernels_1D),
        sparsity=float(sparsity_H), inhibition=float(inhibition_strength),
        cross=float(cross_atom_inhibition_strength),
        l2=float(l2_H) if l2_H > 0 else None, solver=solver,
        use_pallas=model._use_pallas is not False,
        in_dtype=W.dtype if input_dtype is None else _torch_dtype(input_dtype))


def _programs(recipe: _Recipe, device: str, batch_size: Optional[int],
              include_decoder: bool) -> dict:
    """The exported programs of ``recipe`` on ``device``: ``'transform'``,
    and ``'inverse_transform'`` with the decoder.  Runs under a
    ``FakeTensorMode`` as well (a CUDA program's graph, traced without a
    card)."""
    r = recipe
    W = _on(r.W, device)
    if r.solver == 'mu':
        encoder = _MUEncoder(r, device)
    else:
        with pinned(r.plan.precision, W.device, W.dtype):  # as the fit's loops pin it
            G = ehc.gram_W(W)
        encoder = (_HALSEncoder if math.prod(r.plan.transform_shape) == 1
                   else _ConvHALSEncoder)(r, device, G=G)
    # a fixed batch, or a symbolic one traced at 2 (export specialises 0 and 1)
    b = 2 if batch_size is None else int(batch_size)
    dims = None if batch_size is not None else {0: torch.export.Dim('b', min=1)}
    V0 = torch.zeros((b, W.shape[1]) + r.plan.sample_shape, dtype=r.in_dtype, device=device)
    n0 = torch.ones((), dtype=torch.int64)
    programs = {'transform': torch.export.export(
        encoder, (V0, n0), dynamic_shapes=dims and (dims, None), strict=False)}
    if include_decoder:
        H0 = torch.zeros((b,) + r.h_leading + r.plan.transform_shape, dtype=r.in_dtype,
                         device=device)
        programs['inverse_transform'] = torch.export.export(
            _Decoder(r, device), (H0,), dynamic_shapes=dims and (dims,), strict=False)
    return programs


def _serialize(program) -> bytes:
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_serving(model, *,
                   n_iterations: int = 100,
                   sparsity_H: float = 0.,
                   inhibition_strength: float = 0.,
                   cross_atom_inhibition_strength: float = 0.,
                   l2_H: float = 0.,
                   batch_size: Optional[int] = None,
                   path: Optional[str] = None,
                   platforms: Optional[Sequence[str]] = None,
                   input_dtype=None,
                   include_decoder: bool = False,
                   sample_shape: Optional[Tuple[int, ...]] = None,
                   solver: str = 'mu') -> bytes:
    """Serialize ``model``'s encoding step to a self-contained artifact.

    Parameters (the JAX package's)
    ----------
    model : TransformInvariantNMF
        A fitted (or checkpoint-loaded / ``set_dictionary``-initialized)
        model.  The artifact encodes against the *current* dictionary with
        the sample geometry of the last fit.
    n_iterations : int
        Default iteration count recorded in the artifact header; the
        program also takes the count as a runtime argument.
    sparsity_H, inhibition_strength, cross_atom_inhibition_strength, l2_H : float
        Regularizer strengths, baked in as constants (``transform``'s
        keywords).
    batch_size : int, optional
        Fix the batch dimension.  Default: symbolic, one artifact serves
        any batch size.
    path : str, optional
        Also write the artifact to ``path`` (atomically).
    platforms : sequence of {'cpu', 'cuda'}, optional
        One program per platform in one file (``('cuda', 'cpu')``:
        :class:`ServingModel` runs the program of the input's device).
        Default: the model's device.  A CUDA program is exported on the
        card.
    input_dtype : dtype-like, optional
        Input dtype the artifact accepts (cast to the model's compute dtype
        inside).  Default: the model dtype.
    include_decoder : bool
        Also export the reconstruction ``H -> R``: the loaded artifact then
        serves ``inverse_transform`` too.
    sample_shape : tuple of int, optional
        Export for this sample geometry instead of the last fit's, required
        when the model only carries a dictionary (a W-only checkpoint or
        ``set_dictionary``).
    solver : {'mu', 'hals'}
        ``'mu'`` bakes MU H steps; ``'hals'`` exact H coordinate sweeps
        (the Gram of the frozen dictionary baked in, one Gauss–Seidel pass
        per iteration, K5) on the plain-NMF geometry, or one exact
        phase-blocked sweep per iteration on the shift-invariant ``'full'``
        geometry, from the same matched-filter init.  HALS artifacts
        reject inhibition.

    A :class:`~tnmf_tpu_torch.MultiScaleTNMF` exports its multi-scale
    artifact: ``(V, n_iterations) -> (H_0, H_1, ...)`` (the per-scale
    matched-filter start, then joint block MU steps), ``sparsity_H`` a
    scalar or one value per scale, the decoder the summed reconstruction;
    ``l2_H`` and inhibition raise, as in the JAX package.

    Returns the artifact bytes.
    """
    if hasattr(model, 'atom_shapes'):  # MultiScaleTNMF
        if l2_H:
            raise ValueError('l2_H is not supported by the MultiScaleTNMF '
                             'serving export yet; only sparsity_H applies')
        return _export_serving_multiscale(
            model, n_iterations=n_iterations, sparsity_H=sparsity_H,
            inhibition_strength=inhibition_strength,
            cross_atom_inhibition_strength=cross_atom_inhibition_strength,
            batch_size=batch_size, path=path, platforms=platforms, input_dtype=input_dtype,
            include_decoder=include_decoder, sample_shape=sample_shape)
    recipe = _recipe(model, sparsity_H=sparsity_H, inhibition_strength=inhibition_strength,
                     cross_atom_inhibition_strength=cross_atom_inhibition_strength,
                     l2_H=l2_H, input_dtype=input_dtype, sample_shape=sample_shape,
                     solver=solver)
    plats = _platforms(model, platforms)
    payloads = {}
    for p in plats:
        for name, program in _programs(recipe, p, batch_size, include_decoder).items():
            payloads[f'{name}@{p}'] = _serialize(program)
    plan, W = recipe.plan, recipe.W
    header = {
        'format': 1,
        'sections': {k: len(v) for k, v in payloads.items()},
        'library': 'tnmf_tpu_torch',
        'torch': torch.__version__,
        'n_iterations': int(n_iterations),
        'input_shape': ['b' if batch_size is None else int(batch_size),
                        int(W.shape[1])] + [int(x) for x in plan.sample_shape],
        'input_dtype': _dtype_name(recipe.in_dtype),
        'h_leading': [int(x) for x in recipe.h_leading],
        'n_atoms': int(recipe.n_atoms),
        'n_transforms': int(recipe.n_transforms),
        'mode': plan.mode,
        'atom_shape': [int(x) for x in plan.atom_shape],
        'platforms': list(plats),
        'sparsity_H': float(sparsity_H),
        'inhibition_strength': float(inhibition_strength),
        'cross_atom_inhibition_strength': float(cross_atom_inhibition_strength),
        'l2_H': float(l2_H),
        'beta_loss': float(recipe.beta),
        'solver': solver,
        'precision': plan.precision,
    }
    return _assemble(header, payloads, path)


def _assemble(header: dict, payloads: dict, path: Optional[str]) -> bytes:
    """Magic + length-prefixed JSON header + concatenated payloads; atomic
    file write when ``path`` is given."""
    head = json.dumps(header).encode('utf-8')
    blob = (_MAGIC + struct.pack('<I', len(head)) + head
            + b''.join(payloads.values()))
    if path is not None:
        d = os.path.dirname(os.path.abspath(path))
        fd, tmp = tempfile.mkstemp(dir=d, suffix='.tmp')
        try:
            with os.fdopen(fd, 'wb') as f:
                f.write(blob)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
    return blob


class ServingModel:
    """A loaded serving artifact: ``transform(V)`` encodes against the
    baked-in dictionary.  Construct via :func:`load_serving`.

    A tensor input runs the program of its device's platform and gives a
    tensor on that device; a NumPy array runs on the artifact's first
    platform that this process can use (``'cuda'`` needs a card) and gives
    a NumPy array.  Each program is deserialized at its first use, and runs
    under the pins of the header's ``'precision'`` (None when absent)."""

    def __init__(self, payloads: dict, header: dict):
        self._payloads = payloads
        self._modules = {}
        self.header = header

    @property
    def n_atoms(self) -> int:
        return self.header['n_atoms']

    @property
    def platforms(self) -> tuple:
        return tuple(self.header['platforms'])

    @property
    def precision(self):
        """The precision level the programs were exported at."""
        return self.header.get('precision')

    def _module(self, name: str, platform: str):
        key = f'{name}@{platform}'
        if key not in self._modules:
            program = torch.export.load(io.BytesIO(self._payloads[key]))
            self._modules[key] = program.module()
        return self._modules[key]

    def _input(self, x) -> tuple:
        """``(tensor, platform, as_numpy)`` of an input, in the artifact's
        input dtype."""
        dtype = _torch_dtype(self.header['input_dtype'])
        if isinstance(x, torch.Tensor):
            platform = x.device.type
            if platform not in self.platforms:
                raise ValueError(f'the artifact holds programs for {self.platforms}; '
                                 f'got a tensor on {x.device}')
            return x.to(dtype), platform, False
        usable = [p for p in self.platforms if p == 'cpu' or torch.cuda.is_available()]
        if not usable:
            raise RuntimeError(f'the artifact holds programs for {self.platforms}, and '
                               'torch.cuda.is_available() is False')
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=usable[0]), usable[0], True

    def transform(self, V, n_iterations: Optional[int] = None):
        """Infer activations for ``V`` (``(n, channels, *sample_shape)``,
        a NumPy array or a tensor) with ``n_iterations`` refinement steps
        (default: the count recorded at export time).  Multi-scale
        artifacts return the per-scale activation tuple."""
        n = self.header['n_iterations'] if n_iterations is None else n_iterations
        V, platform, as_numpy = self._input(V)
        exp_shape = self.header['input_shape']
        if (V.dim() != len(exp_shape)
                or any(isinstance(e, int) and e != s for e, s in zip(exp_shape, V.shape))):
            raise ValueError(
                f'input shape {tuple(V.shape)} does not match the '
                f'artifact signature {tuple(exp_shape)}')
        with pinned(self.precision, platform):
            H = self._module('transform', platform)(V, torch.tensor(int(n), dtype=torch.int64))
        if isinstance(H, (tuple, list)):  # multi-scale: the per-scale tuple
            return tuple(h.cpu().numpy() if as_numpy else h for h in H)
        return H.cpu().numpy() if as_numpy else H

    __call__ = transform

    def warmup(self, batch_sizes=(1,)) -> 'ServingModel':
        """Pay the first-call costs up front (deserializing the program, and
        on the card building the kernels and cuDNN's and cuFFT's plans) with
        a zeros request per listed batch size, one iteration each, so the
        first real request serves at steady-state latency.  Returns
        ``self``."""
        shape = self.header['input_shape']
        for n in batch_sizes:
            V0 = np.zeros([int(n)] + [int(s) for s in shape[1:]],
                          np.dtype(self.header['input_dtype']))
            self.transform(V0, n_iterations=1)
        return self

    def inverse_transform(self, H):
        """Reconstruction from activations (present when the artifact was
        exported with ``include_decoder=True``); inputs and outputs as in
        :meth:`transform`.  Multi-scale artifacts take the per-scale
        activation tuple."""
        if not any(k.startswith('inverse_transform@') for k in self._payloads):
            raise RuntimeError(
                'this artifact has no decoder section; export with '
                'include_decoder=True to serve inverse_transform')
        if 'multiscale' in self.header:  # the per-scale tuple
            parts = [self._input(h) for h in H]
            H, (_, platform, as_numpy) = tuple(p[0] for p in parts), parts[0]
        else:
            H, platform, as_numpy = self._input(H)
        with pinned(self.precision, platform):
            R = self._module('inverse_transform', platform)(H)
        return R.cpu().numpy() if as_numpy else R


def load_serving(src: Union[str, bytes, os.PathLike]) -> ServingModel:
    """Load a serving artifact written by :func:`export_serving` from a
    path or raw bytes."""
    if isinstance(src, (str, os.PathLike)):
        with open(src, 'rb') as f:
            blob = f.read()
    else:
        blob = bytes(src)
    if blob[:len(_JAX_MAGIC)] == _JAX_MAGIC:
        raise ValueError('bad magic: this is a serving artifact of the JAX package '
                         '(StableHLO); load it with tnmf_tpu.load_serving')
    if blob[:len(_MAGIC)] != _MAGIC:
        raise ValueError('not a tnmf_tpu_torch serving artifact (bad magic)')
    off = len(_MAGIC)
    (hlen,) = struct.unpack('<I', blob[off:off + 4])
    off += 4
    header = json.loads(blob[off:off + hlen].decode('utf-8'))
    if header.get('format', 0) > 1:
        raise ValueError(
            f"artifact format {header['format']} is newer than this "
            'library understands; upgrade tnmf_tpu_torch')
    off += hlen
    payloads = {}
    for name, length in header['sections'].items():
        payloads[name] = blob[off:off + length]
        off += length
    return ServingModel(payloads, header)
