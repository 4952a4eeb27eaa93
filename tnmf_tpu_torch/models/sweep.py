"""Hyperparameter sweeps: many independent TNMF models fitted on the same
data at once, with one launch of each kernel for all of them.

Port of :mod:`tnmf_tpu.models.sweep`, MU and HALS.  Users fit the same
data many times (restarts over seeds, grids over sparsity or inhibition,
sklearn users' alpha grids over ``NMF(solver='cd')``) and keep the best
model.  A Python loop of S fits costs S times the launches, and small fits
are bound by the host's rate of launches; here the model axis is folded
into each launch instead.  The
JAX package's ``jax.vmap(fit_one)`` is :func:`torch.func.vmap` over the
port's own single-model engine (:mod:`tnmf_tpu_torch.engine`): W and H gain
a leading model axis, the data and its loop-invariant preparation are
shared, and every kernel of the MU step (K1's ``mu_ratio`` and ``mu_w``,
K2, K3 and K4) is reached through an operator whose vmap rule launches it
once for all S models (:mod:`tnmf_tpu_torch.kernels.ops`).  The
convolutions, transforms and products between the kernels run batched
(a convolution with a per-model weight is a grouped convolution).

Strengths are per-model tensors in the storage dtype (the JAX package's
rule), so a grid is exact: strength 0 adds ``0 * term`` to the MU
denominator, bit for bit the update without the term.  Anything that
changes the step's structure (mode, beta, strategy, atom count and shape,
inhibition range) is one value per sweep.

``solver='hals'`` (plain-NMF geometry only) runs :func:`torch.func.vmap`
over :func:`tnmf_tpu_torch.engine_hals._iteration` instead, the JAX
package's ``_hals_vmap_pieces``: the four Gram products batch, and each
side's Gauss–Seidel sweep is one launch of K5 for all S models
(``tnmf::hals_sweep``'s vmap rule, :func:`~tnmf_tpu_torch.kernels.hals.hals_sweep_models`).
Its per-model ``l1`` (``sparsity``) and ``l2`` ride in the accumulation
dtype, as in the JAX package; the dictionary side is unregularized.

Initialization: each model draws ``1 - U[0, 1)`` on the sweep's device,
first its H, then its W (sum-normalised), from a ``torch.Generator``: one
per entry of a vector of seeds, or, with ``n_models`` and a scalar seed,
one generator seeded with it that draws model 0's H and W, then model 1's,
and so on.  The draws are the port's own: the JAX package's PRNG keys
give other numbers, and a sweep started from the JAX package's inits
(:func:`_sweep_from_init`) follows its trajectory.

Not ported here: ``mesh=`` (ROADMAP.md queue 1, item 14e-iv).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .. import engine, engine_hals
from ..ops.inhibition import inhibition_kernels, resolve_inhibition_range
from ..ops.modes import ConvPlan
from ..ops.precision import matmul_pin
from ..ops.transforms import make_group
from .tnmf import _ITEM, _torch_dtype, from_numpy

__all__ = ['SweepResult', 'sweep_fit']


@dataclass(frozen=True)
class SweepResult:
    """Outcome of :func:`sweep_fit`: per-model tensors stacked on axis 0, on
    the sweep's device."""

    W: torch.Tensor          # (S, n_atoms, n_channels, *atom_shape)
    H: torch.Tensor          # (S, n_samples, n_atoms * n_transforms, *transform_shape)
    energies: torch.Tensor   # (S,) final objective per model
    seeds: np.ndarray        # (S,) per-model seed labels
    energy_traces: Optional[torch.Tensor] = None  # (S, n_iterations) if recorded
    n_iters: Optional[torch.Tensor] = None  # (S,) iterations run, if tol= was set

    @property
    def n_models(self) -> int:
        return self.W.shape[0]

    @property
    def best(self) -> int:
        """Index of the model with the lowest final objective."""
        return int(torch.argmin(self.energies))

    def model(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """``(W, H)`` of model ``i`` as NumPy arrays."""
        return self.W[i].cpu().numpy(), self.H[i].cpu().numpy()


def _per_model(x, n_models: int, name: str, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """Broadcast a scalar, or validate a length-S vector, of strengths."""
    arr = torch.as_tensor(x, dtype=dtype, device=device)
    if arr.dim() == 0:
        return arr.expand(n_models).clone()
    if tuple(arr.shape) != (n_models,):
        raise ValueError(
            f'{name} must be a scalar or a vector of one value per model '
            f'(expected shape ({n_models},), got {tuple(arr.shape)})')
    return arr


def _any_positive(x) -> bool:
    x = x.cpu().numpy() if isinstance(x, torch.Tensor) else x
    return bool(np.any(np.asarray(x, np.float64) > 0))


def _draw(gens, n_models: int, w_shape: tuple, h_shape: tuple, n_shift_axes: int,
          dtype: torch.dtype, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The S models' ``(W0, H0)``: model s draws its H, then its W, from
    ``gens[s]`` (or from ``gens[0]`` for every model, in model order, when
    there is one generator)."""
    Ws, Hs = [], []
    for s in range(n_models):
        g = gens[s if len(gens) > 1 else 0]
        Hs.append(1 - torch.rand(h_shape, generator=g, dtype=dtype, device=device))
        W = 1 - torch.rand(w_shape, generator=g, dtype=dtype, device=device)
        Ws.append(W / W.sum(dim=tuple(range(-n_shift_axes, 0)), keepdim=True))
    return torch.stack(Ws), torch.stack(Hs)


def _check_loop(record_energies: bool, tol, tol_check_every) -> None:
    if tol is None:
        return
    if record_energies:
        raise ValueError('tol= and record_energies are mutually '
                         'exclusive (per-iteration traces need a '
                         'static iteration count)')
    if tol < 0 or int(tol_check_every) < 1:
        raise ValueError('tol must be >= 0 and tol_check_every >= 1')


def sweep_fit(
    V,
    n_atoms: int,
    atom_shape: Tuple[int, ...],
    *,
    n_models: Optional[int] = None,
    seed: Union[int, np.ndarray] = 0,
    n_iterations: int = 100,
    sparsity=0.0,
    inhibition=0.0,
    cross_inhibition=0.0,
    l2=0.0,
    ortho=0.0,
    inhibition_range: Optional[Tuple[int, ...]] = None,
    reconstruction_mode: str = 'valid',
    strategy: str = 'auto',
    beta_loss: float = 2.0,
    transform_type: str = 'shift',
    mask=None,
    dtype=None,
    precision: Optional[str] = None,
    mesh=None,
    record_energies: bool = False,
    tol: Optional[float] = None,
    tol_check_every: int = 10,
    solver: str = 'mu',
    hals_inner='auto',
    device='cuda',
    use_pallas: bool = True,
) -> SweepResult:
    """Fit ``n_models`` independent TNMF models on the same data at once and
    return all of them with their final objectives.

    The JAX package's signature, defaults, validation and errors, plus
    ``device`` (the sweep's; the card by default) and ``use_pallas`` (False
    runs the kernels' plain versions: the A/B switch).  Each model gets its
    own random initialization (see the module's docstring for the order of
    the draws) and its own strengths: ``sparsity``, ``inhibition``,
    ``cross_inhibition``, ``l2`` (ridge on H) and ``ortho`` (cross-atom
    dictionary orthogonality) may each be a scalar (shared) or a
    length-``n_models`` vector (a grid).  float64 data is fitted in
    float32, as in the JAX package.

    ``tol`` enables per-model early stopping (the model's ``fit(tol=...)``
    semantics, checked every ``tol_check_every`` iterations): converged
    models freeze in place while the rest keep iterating, the host reads
    the models' state once per block of ``tol_check_every`` iterations, and
    the sweep stops once every model converged (or at ``n_iterations``).
    The result then carries ``n_iters``.  Mutually exclusive with
    ``record_energies``, which records every model's objective after every
    iteration (one more reconstruction per iteration).

    ``solver='hals'`` runs every model with exact block coordinate
    descent instead of MU (the model class's ``fit(solver='hals')``,
    :mod:`tnmf_tpu_torch.engine_hals`): the degenerate plain-NMF geometry
    only, with ``sparsity`` (L1 on H) and ``l2`` grids, ``tol`` and
    ``record_energies``; the MU-only knobs (inhibition, ortho, masks,
    ``beta_loss != 2``, transform groups) are rejected with the JAX
    package's errors.  ``hals_inner`` as in the model class (``'auto'`` by
    default).

    Not ported: ``mesh`` (ROADMAP.md queue 1, item 14e-iv) raises
    ``NotImplementedError``.
    """
    device = torch.device(device)
    V = torch.as_tensor(V, device=device)
    if dtype is not None:
        V = V.to(_torch_dtype(dtype))
    if V.dtype == torch.float64:
        V = V.to(torch.float32)
    if not bool(torch.all(V >= 0)):
        raise ValueError('sweep_fit requires nonnegative data '
                         '(reference precondition, '
                         'TransformInvariantNMF.py:326)')
    if float(beta_loss) <= 0 and not bool(torch.all(V > 0)) and mask is None:
        raise ValueError('beta_loss <= 0 (Itakura-Saito family) requires '
                         'strictly positive data (or a mask excluding the '
                         'zeros): D_beta(v || r) diverges as v -> 0')
    if mesh is not None:
        raise NotImplementedError(
            'sweep_fit(mesh=...) is not ported to tnmf_tpu_torch yet; see '
            + _ITEM.format('14e-iv'))

    if n_models is None:
        seeds = np.atleast_1d(np.asarray(seed, dtype=np.uint32))
        if np.ndim(seed) == 0:
            raise ValueError('pass n_models (or a vector of per-model '
                             'seeds) to size the sweep')
        n_models = int(seeds.shape[0])
        gens = [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]
    else:
        if np.ndim(seed) != 0:
            raise ValueError('pass either n_models with a scalar seed, or a '
                             'vector of per-model seeds without n_models')
        gens = [torch.Generator(device=device).manual_seed(int(seed))]
        seeds = np.arange(n_models, dtype=np.uint32)  # positional labels

    n_atoms = int(n_atoms)
    atom_shape = tuple(int(a) for a in atom_shape)
    group = make_group(transform_type, atom_shape)
    n_maps = n_atoms * (group.size if group is not None else 1)
    plan = ConvPlan.create(reconstruction_mode, tuple(V.shape[2:]), atom_shape,
                           precision=precision)
    if solver not in ('mu', 'hals'):
        raise ValueError(f"solver must be 'mu' or 'hals', got {solver!r}")
    if solver == 'hals':
        _check_hals(group, beta_loss, mask, inhibition, cross_inhibition, ortho, plan)
    W0, H0 = _draw(gens, n_models, (n_atoms, V.shape[1]) + atom_shape,
                   (V.shape[0], n_maps) + plan.transform_shape, plan.ndim, V.dtype, device)
    if solver == 'hals':
        return _sweep_from_init_hals(
            V, W0, H0, seeds=seeds, n_iterations=n_iterations, sparsity=sparsity, l2=l2,
            hals_inner=hals_inner, precision=precision, record_energies=record_energies,
            tol=tol, tol_check_every=tol_check_every, device=device, use_pallas=use_pallas)
    return _sweep_from_init(
        V, W0, H0, seeds=seeds, n_iterations=n_iterations, sparsity=sparsity,
        inhibition=inhibition, cross_inhibition=cross_inhibition, l2=l2, ortho=ortho,
        inhibition_range=inhibition_range, reconstruction_mode=reconstruction_mode,
        strategy=strategy, beta_loss=beta_loss, transform_type=transform_type, mask=mask,
        precision=precision, record_energies=record_energies, tol=tol,
        tol_check_every=tol_check_every, device=device, use_pallas=use_pallas)


def _sweep_from_init(
    V, W0, H0, *, seeds=None, n_iterations: int = 100, sparsity=0.0, inhibition=0.0,
    cross_inhibition=0.0, l2=0.0, ortho=0.0,
    inhibition_range: Optional[Tuple[int, ...]] = None, reconstruction_mode: str = 'valid',
    strategy: str = 'auto', beta_loss: float = 2.0, transform_type: str = 'shift',
    mask=None, precision: Optional[str] = None, record_energies: bool = False,
    tol: Optional[float] = None, tol_check_every: int = 10, device='cuda',
    use_pallas: bool = True,
) -> SweepResult:
    """The MU sweep from given inits: ``W0 (S, n_atoms, C, *atom_shape)`` and
    ``H0 (S, n_samples, n_maps, *shift)``, NumPy arrays or tensors (the
    JAX package's ``jax.vmap(init_one)(keys)`` feeds the same states to
    both packages).  ``V`` is fitted in its own dtype (no float32 cast);
    the other keywords are :func:`sweep_fit`'s."""
    device = torch.device(device)
    V = torch.as_tensor(V, device=device)
    W0, H0 = (x.to(device=device, dtype=V.dtype) if isinstance(x, torch.Tensor)
              else from_numpy(x, device=device, dtype=V.dtype)[0] for x in (W0, H0))
    S = W0.shape[0]
    seeds = np.arange(S, dtype=np.uint32) if seeds is None else seeds
    atom_shape = tuple(W0.shape[3:])
    group = make_group(transform_type, atom_shape)
    plan = ConvPlan.create(reconstruction_mode, tuple(V.shape[2:]), atom_shape,
                           precision=precision)
    if strategy == 'auto':
        strategy = engine.choose_strategy(plan)
    strategy = engine.resolve_strategy(strategy, plan)
    engine.require_ported(strategy)
    if group is not None:
        strategy = (strategy, group)
    _check_loop(record_energies, tol, tol_check_every)

    sdt = V.dtype  # strengths ride in the storage dtype, like the model
    sp = _per_model(sparsity, S, 'sparsity', sdt, device)
    inh = _per_model(inhibition, S, 'inhibition', sdt, device)
    cross = _per_model(cross_inhibition, S, 'cross_inhibition', sdt, device)
    # zero is exact under MU (pos + 0*X == pos), so when either term is
    # active both ride as per-model vectors; all-zero -> None keeps the
    # unregularized step
    if _any_positive(l2) or _any_positive(ortho):
        reg = (_per_model(l2, S, 'l2', sdt, device), _per_model(ortho, S, 'ortho', sdt, device))
    else:
        reg = ()
    use_inh, use_cross = _any_positive(inh), _any_positive(cross)
    kernels = tuple(torch.as_tensor(k, dtype=sdt, device=device)
                    for k in inhibition_kernels(resolve_inhibition_range(inhibition_range,
                                                                         atom_shape)))
    beta = float(beta_loss)
    if mask is not None:
        mask = torch.as_tensor(mask, device=device).broadcast_to(V.shape).to(sdt)
    Vc = V if mask is None or beta != 2.0 else V * mask
    if beta == 2.0 or (mask is None and engine.get_ops(strategy).FACTORS_IN_PREPARED):
        Vp = engine.prepare_data(Vc, plan=plan, strategy=strategy)
    else:
        # the canonical tensor where the beta factors are formed canonically
        Vp = Vc

    step = dict(plan=plan, strategy=strategy, update_H=True, update_W=True,
                use_inhibition=use_inh, use_cross=use_cross, use_pallas=use_pallas,
                beta=beta, mask=mask)

    def step_one(W, H, sp, inh, cross, l2v=None, orv=None):
        return engine.update_step(Vp, W, H, sp, inh, cross, kernels, l2_H=l2v, ortho_W=orv,
                                  **step)

    def fit_one(W, H, sp, inh, cross, l2v=None, orv=None):
        return engine.fit_loop(Vp, W, H, int(n_iterations), sp, inh, cross, kernels,
                               l2_H=l2v, ortho_W=orv, **step)

    def energy_one(W, H):
        return engine.energy(V, W, H, mask, plan=plan, strategy=strategy, beta=beta)

    strengths = (sp, inh, cross) + reg
    vstep, venergy = torch.func.vmap(step_one), torch.func.vmap(energy_one)
    if tol is not None:
        W, H, E, iters = _tol_loop(vstep, venergy, W0, H0, strengths, int(n_iterations),
                                   tol, int(tol_check_every))
        return SweepResult(W=W, H=H, energies=E, seeds=seeds, n_iters=iters)
    if record_energies:
        acc = torch.promote_types(sdt, torch.float32)
        traces = torch.empty((S, int(n_iterations)), dtype=acc, device=device)
        W, H = W0, H0
        for i in range(int(n_iterations)):
            W, H = vstep(W, H, *strengths)
            traces[:, i] = venergy(W, H)
        return SweepResult(W=W, H=H, energies=traces[:, -1], seeds=seeds,
                           energy_traces=traces)
    W, H = torch.func.vmap(fit_one)(W0, H0, *strengths)
    return SweepResult(W=W, H=H, energies=venergy(W, H), seeds=seeds)


def _check_hals(group, beta_loss, mask, inhibition, cross_inhibition, ortho,
                plan: ConvPlan) -> None:
    """The JAX package's rejections of ``solver='hals'``, in its order and
    with its messages (``tnmf_tpu/models/sweep.py:482-511``)."""
    if group is not None:
        raise ValueError("transform groups are MU-only under "
                         "solver='hals' (plain-NMF geometry)")
    if float(beta_loss) != 2.0:
        raise ValueError("solver='hals' requires beta_loss=2 "
                         '(Frobenius) — no closed-form coordinate '
                         'minimizer exists for other divergences')
    if mask is not None:
        raise ValueError("masked/weighted sweeps are MU-only under "
                         "solver='hals'")
    if _any_positive(inhibition) or _any_positive(cross_inhibition) or _any_positive(ortho):
        raise ValueError("inhibition / cross_inhibition / ortho are "
                         "MU-only regularizers under solver='hals' "
                         '(the exact sweep minimizes the L1/L2-'
                         'regularized Frobenius objective)')
    if math.prod(plan.transform_shape) != 1:
        raise ValueError(
            "solver='hals' requires the degenerate plain-NMF geometry "
            "(mode 'full' with atom_shape == sample_shape)")


def _sweep_from_init_hals(
    V, W0, H0, *, seeds=None, n_iterations: int = 100, sparsity=0.0, l2=0.0,
    hals_inner='auto', precision: Optional[str] = None, record_energies: bool = False,
    tol: Optional[float] = None, tol_check_every: int = 10, device='cuda',
    use_pallas: bool = True,
) -> SweepResult:
    """The HALS sweep from given inits (the plain-NMF geometry, which
    :func:`sweep_fit` checks): ``W0 (S, n_atoms, C, *atom_shape)`` and
    ``H0 (S, n_samples, n_atoms, 1, ...)``, NumPy arrays or tensors.  The
    JAX package's ``_sweep_impl_hals`` (plain and traced) and
    ``_sweep_impl_hals_tol``: :func:`torch.func.vmap` over
    :func:`engine_hals._iteration` with the model's ``l1``/``l2`` on H and
    none on W, the Grams at ``precision`` (pinned once around the loop,
    as :func:`engine_hals.fit_loop` pins it).  ``V`` is fitted in its own
    dtype; the other keywords are :func:`sweep_fit`'s."""
    device = torch.device(device)
    V = torch.as_tensor(V, device=device)
    W0, H0 = (x.to(device=device, dtype=V.dtype) if isinstance(x, torch.Tensor)
              else from_numpy(x, device=device, dtype=V.dtype)[0] for x in (W0, H0))
    S, n_atoms = W0.shape[:2]
    seeds = np.arange(S, dtype=np.uint32) if seeds is None else seeds
    acc = torch.promote_types(V.dtype, torch.float32)
    l1v = _per_model(sparsity, S, 'sparsity', acc, device)
    l2v = _per_model(l2, S, 'l2', acc, device)
    inner = engine_hals.auto_inner(n_atoms, math.prod(W0.shape[2:]), hals_inner,
                                   n_samples=int(V.shape[0]))
    _check_loop(record_energies, tol, tol_check_every)
    V2 = V.reshape(V.shape[0], -1)

    def flat(W, H):
        return W.reshape(W.shape[0], -1), H.reshape(H.shape[0], H.shape[1])

    def iter_one(W, H, l1, l2):
        W2, H2 = engine_hals._iteration(V2, *flat(W, H), l1, l2, 0.0, 0.0, inner=inner,
                                        update_H=True, update_W=True, use_pallas=use_pallas)
        return W2.reshape(W.shape), H2.reshape(H.shape)

    def fit_one(W, H, l1, l2):
        for _ in range(int(n_iterations)):
            W, H = iter_one(W, H, l1, l2)
        return W, H

    def energy_one(W, H):
        return engine_hals._energy(V2, *flat(W, H))

    viter, venergy = torch.func.vmap(iter_one), torch.func.vmap(energy_one)
    with matmul_pin(precision, device, V.dtype):
        if tol is not None:
            W, H, E, iters = _tol_loop(viter, venergy, W0, H0, (l1v, l2v), int(n_iterations),
                                       tol, int(tol_check_every))
            return SweepResult(W=W, H=H, energies=E, seeds=seeds, n_iters=iters)
        if record_energies:
            traces = torch.empty((S, int(n_iterations)), dtype=acc, device=device)
            W, H = W0, H0
            for i in range(int(n_iterations)):
                W, H = viter(W, H, l1v, l2v)
                traces[:, i] = venergy(W, H)
            return SweepResult(W=W, H=H, energies=traces[:, -1], seeds=seeds,
                               energy_traces=traces)
        W, H = torch.func.vmap(fit_one)(W0, H0, l1v, l2v)
        return SweepResult(W=W, H=H, energies=venergy(W, H), seeds=seeds)


def _tol_loop(vstep, venergy, W: torch.Tensor, H: torch.Tensor, strengths: tuple,
              n_max: int, tol: float, check_every: int):
    """Per-model convergence (the JAX package's ``_sweep_impl_tol``):
    blocks of ``min(check_every, n_max - i)`` iterations; after each block
    every model's relative improvement ``(e_prev - e) / max(e0, tiny)`` is
    tested against ``tol``.  A converged model freezes (its W, H, energy
    and count stay as they were) while the rest go on; the host reads one
    flag per block (one synchronisation), and the loop ends at ``n_max``
    or once every model converged.  Returns ``(W, H, energies, n_iters)``."""
    e = venergy(W, H)
    acc = e.dtype
    scale = torch.clamp(e, min=torch.finfo(acc).tiny)
    tol_t = torch.tensor(tol, dtype=acc, device=e.device)
    S = W.shape[0]
    done = torch.zeros(S, dtype=torch.bool, device=e.device)
    iters = torch.zeros(S, dtype=torch.int32, device=e.device)

    def lane(x):  # the (S,) done mask over a model tensor
        return done.reshape((S,) + (1,) * (x.dim() - 1))

    i = 0
    while i < n_max:
        k = min(check_every, n_max - i)
        W2, H2 = W, H
        for _ in range(k):
            W2, H2 = vstep(W2, H2, *strengths)
        e2 = venergy(W2, H2)
        rel = (e - e2) / scale
        W = torch.where(lane(W2), W, W2)
        H = torch.where(lane(H2), H, H2)
        e = torch.where(done, e, e2)
        iters = torch.where(done, iters, torch.full_like(iters, i + k))
        done = done | (rel < tol_t)
        i += k
        if bool(done.all()):
            break
    return W, H, e, iters
