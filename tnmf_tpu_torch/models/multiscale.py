"""Multi-scale transform-invariant NMF in PyTorch: atoms of several sizes, one model.

Port of :mod:`tnmf_tpu.models.multiscale`.  The dictionary is a tuple of
atom banks with shapes of their own, one activation tensor per scale,

    R = sum_k  sum_m  H_k[n, m] * W_k[m]        (k = scale, m = atom)

and each scale's MU gradients are the single-scale ones taken against the
*total* reconstruction ``R``.  All scales update from the same ``R`` (a
Jacobi block update: scale k's new H never feeds scale k + 1's update in
the same half), then ``R`` is recomputed for the W half, as the reference
orders H before W.

Each scale has its own :class:`~tnmf_tpu_torch.ops.modes.ConvPlan` and
strategy ('conv' or 'fft', resolved per scale as the single-scale model
resolves its one; the plain-NMF corner keeps 'conv', never 'dot', as in the
JAX package) and its own prepared data.  The kernels are the single-scale
model's, one launch per scale: on a conv scale K3 forms the H update from
the scale's prepared data and the total ``R`` extended for the scale's
plan (:func:`tnmf_tpu_torch.engine._mu_H_of`), K2 the W statistics and K1's
W epilogue ``mu_w`` the W update; on an fft scale the strategy's gradient
pair and K1's ``mu_ratio``, then ``mu_w``.  A two-scale conv iteration is
four reconstructions (one per scale per half), two K3, two K2 and two
``mu_w`` launches.  The JAX package's phased lowering (TPU only) and its
encode/decode of H are not ported: every H here is canonical.

The functions run eagerly; the fit loop is a Python loop, and the ``tol``
loop reads its stopping test on the host once per block
(:func:`tnmf_tpu_torch.engine.tol_loop`).  ``mesh``, the sharded
checkpoints and bfloat16 storage raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import functools
import logging
import math
import os
from itertools import count, islice
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import engine
from ..engine_minibatch import MiniBatchAlgorithm
from ..ops import beta as beta_ops
from ..ops.modes import ConvPlan
from ..ops.precision import exporting, matmul_pin
from ..utils.initialization import patches_init
from .tnmf import (_BACKEND_STRATEGY, _as_input, _assert_nonnegative, _np_dtype, _require,
                   _sequential_slices, _stacked, _torch_dtype, _trace_buf, from_numpy)

EPS = engine.EPS

#: iterations per energy-trace chunk of a ``record_energies`` fit (the JAX
#: engine's ``ENERGY_CHUNK``)
ENERGY_CHUNK = 32

_MESH_ITEM = 'ROADMAP.md queue 1, item 14e-iv'
_CHECKPOINT_ITEM = 'ROADMAP.md queue 1, item 14e-v'


def _pinned(fn):
    """Run ``fn`` with its matrix products at its plans' precision
    (:func:`~tnmf_tpu_torch.ops.precision.matmul_pin`, for the device and
    dtype of its first tensor, or of the first of a tuple) when a scale runs
    fft; an all-conv model runs no matrix product.  Nested calls find the
    pin set and leave it."""
    @functools.wraps(fn)
    def call(*args, plans, strategies, **kwargs):
        if all(s == 'conv' for s in strategies) or exporting():
            return fn(*args, plans=plans, strategies=strategies, **kwargs)
        like = args[0] if isinstance(args[0], torch.Tensor) else args[0][0]
        with matmul_pin(plans[0].precision, like.device, like.dtype):
            return fn(*args, plans=plans, strategies=strategies, **kwargs)
    return call


# ---------------------------------------------------------------------------
# the multi-scale step (tuples of per-scale tensors, plans and strategies)
# ---------------------------------------------------------------------------

def _reconstruct(Ws, Hs, plans, strategies) -> torch.Tensor:
    """The total reconstruction: the sum of every scale's."""
    R = None
    for W, H, plan, strat in zip(Ws, Hs, plans, strategies):
        r = engine.get_ops(strat).reconstruct(W, H, plan)
        R = r if R is None else R + r
    return R


@_pinned
def ms_reconstruct(Ws, Hs, *, plans, strategies) -> torch.Tensor:
    """The total reconstruction (canonical data layout)."""
    return _reconstruct(Ws, Hs, plans, strategies)


def _grad_inputs(Vd, Vps, R, mask, beta, plans, strategies):
    """Per-scale ``(prepared numerator, denominator R)`` pairs for the
    current total reconstruction.  beta = 2: the loop-invariant ``Vps``
    carry ``prepare(mask * V)`` and R is masked once.  Other betas: the
    ``(A, B)`` factors are formed from the total R, masked, and A is
    prepared per scale (B is extended per scale where it is correlated)."""
    if beta == 2.0:
        Rm = R if mask is None else R * mask.to(R.dtype)
        return Vps, [Rm] * len(plans)
    A, B = beta_ops.factors(Vd, R, beta)
    if mask is not None:
        A = A * mask.to(A.dtype)
        B = B * mask.to(B.dtype)
    nums = [engine.get_ops(s).prepare_data(A, p) for p, s in zip(plans, strategies)]
    return nums, [B] * len(plans)


def _step(Vd, Vps, Ws, Hs, sparsities, mask, *, plans, strategies, update_H, update_W, beta,
          use_pallas):
    """One joint iteration: every scale's H from the same total R (K3, or
    the fft pair and ``mu_ratio``), then, from the recomputed R, every
    scale's W (K2 or the fft pair, then ``mu_w``).  The streams reach the
    engine as given ones (its beta = 2 slot, no mask): the numerator
    prepared, the denominator canonical, extended per scale."""
    if update_H:
        R = _reconstruct(Ws, Hs, plans, strategies)
        nums, dens = _grad_inputs(Vd, Vps, R, mask, beta, plans, strategies)
        Hs = tuple(engine._mu_H_of(num, den, W, H, sp, plan=plan, strategy=strat,
                                   use_pallas=use_pallas)
                   for num, den, W, H, sp, plan, strat in zip(nums, dens, Ws, Hs, sparsities,
                                                               plans, strategies))
    if update_W:
        R = _reconstruct(Ws, Hs, plans, strategies)
        nums, dens = _grad_inputs(Vd, Vps, R, mask, beta, plans, strategies)
        Ws = tuple(engine.apply_W_update(
            W, *engine.grad_W_pair_of(num, den, H, None, plan, strat, use_pallas, 2.0),
            n_shift_axes=plan.ndim, use_pallas=use_pallas)
            for num, den, W, H, plan, strat in zip(nums, dens, Ws, Hs, plans, strategies))
    return Ws, Hs


@_pinned
def ms_update_step(Vd, Vps, Ws, Hs, sparsities, mask=None, *, plans, strategies,
                   update_H=True, update_W=True, beta=2.0, use_pallas=True):
    """One joint block-MU iteration.  Returns ``(Ws, Hs)``."""
    return _step(Vd, Vps, Ws, Hs, sparsities, mask, plans=plans, strategies=strategies,
                 update_H=update_H, update_W=update_W, beta=beta, use_pallas=use_pallas)


@_pinned
def ms_fit_loop(Vd, Vps, Ws, Hs, n_iterations, sparsities, mask=None, *, plans, strategies,
                update_H=True, update_W=True, beta=2.0, use_pallas=True):
    """``n_iterations`` joint iterations.  Returns ``(Ws, Hs)``."""
    for _ in range(int(n_iterations)):
        Ws, Hs = _step(Vd, Vps, Ws, Hs, sparsities, mask, plans=plans, strategies=strategies,
                       update_H=update_H, update_W=update_W, beta=beta,
                       use_pallas=use_pallas)
    return Ws, Hs


@_pinned
def ms_fit_loop_tol(Vd, Vps, Ws, Hs, n_max, tol, sparsities, mask=None, *, check_every,
                    n_buf=0, plans, strategies, update_H=True, update_W=True, beta=2.0,
                    use_pallas=True):
    """Adaptive multi-scale fit, the single-scale semantics of
    :func:`tnmf_tpu_torch.engine.fit_loop_tol`: blocks of ``check_every``
    joint iterations, stopping when the relative objective improvement
    over a block, ``(e_prev - e) / e_init``, drops below ``tol``, or at
    ``n_max``; the test runs on the host, one synchronisation per block.
    ``n_buf > 0`` (at least ``n_max``) also records every iteration's
    objective (NaN past the iterations run).  Returns ``(Ws, Hs, n_done,
    e_final, energies_or_None)``."""
    def e_of(WH):
        return beta_ops.divergence(Vd, _reconstruct(*WH, plans, strategies), beta, mask)

    def step(WH):
        return _step(Vd, Vps, *WH, sparsities, mask, plans=plans, strategies=strategies,
                     update_H=update_H, update_W=update_W, beta=beta, use_pallas=use_pallas)

    (Ws, Hs), n_done, e, trace = engine.tol_loop((Ws, Hs), step, e_of, int(n_max), tol,
                                                 int(check_every), int(n_buf), Vd)
    return Ws, Hs, n_done, e, trace


@_pinned
def _ms_energies_chunk(Vd, Vps, Ws, Hs, k, sparsities, mask=None, *, chunk, plans, strategies,
                       update_H=True, update_W=True, beta=2.0, use_pallas=True):
    """``k`` (at most ``chunk``) joint iterations with the objective after
    each, as a ``(chunk,)`` trace on the device, +inf past ``k`` (the JAX
    package's fixed-length chunk).  Returns ``(Ws, Hs, energies)``."""
    es = torch.full((int(chunk),), math.inf, device=Vd.device,
                    dtype=torch.promote_types(Vd.dtype, torch.float32))
    for i in range(int(k)):
        Ws, Hs = _step(Vd, Vps, Ws, Hs, sparsities, mask, plans=plans, strategies=strategies,
                       update_H=update_H, update_W=update_W, beta=beta, use_pallas=use_pallas)
        es[i] = beta_ops.divergence(Vd, _reconstruct(Ws, Hs, plans, strategies), beta, mask)
    return Ws, Hs, es


@_pinned
def ms_grad_W_stats(Vd, Vps, Ws, Hs, mask=None, *, plans, strategies, beta=2.0,
                    use_pallas=True):
    """Per-scale W-gradient ``(neg, pos)`` pairs against the current total
    reconstruction (K2 on conv scales; the minibatch accumulation unit, the
    counterpart of :func:`tnmf_tpu_torch.engine.grad_W_stats`)."""
    R = _reconstruct(Ws, Hs, plans, strategies)
    nums, dens = _grad_inputs(Vd, Vps, R, mask, beta, plans, strategies)
    return tuple(engine.grad_W_pair_of(num, den, H, None, plan, strat, use_pallas, 2.0)
                 for num, den, H, plan, strat in zip(nums, dens, Hs, plans, strategies))


def ms_apply_W_stats(Ws, stats, *, plans, use_pallas=True):
    """The MU ratio and atom normalisation per scale from accumulated
    statistics (K1's ``mu_w``)."""
    return tuple(engine.apply_W_update(W, neg, pos, n_shift_axes=plan.ndim,
                                       use_pallas=use_pallas)
                 for W, (neg, pos), plan in zip(Ws, stats, plans))


def from_numpy_scales(Ws: Sequence[np.ndarray], Hs: Optional[Sequence[np.ndarray]] = None, *,
                      device, dtype: torch.dtype):
    """The JAX multi-scale model's per-scale ``W_k`` (and ``H_k``), as NumPy
    arrays, as the port's tensors on ``device`` in ``dtype``
    (:func:`tnmf_tpu_torch.models.tnmf.from_numpy` per scale).  Returns
    ``(Ws, Hs_or_None)``, tuples."""
    Wt = tuple(from_numpy(w, device=device, dtype=dtype)[0] for w in Ws)
    Ht = None if Hs is None else tuple(from_numpy(h, device=device, dtype=dtype)[0]
                                       for h in Hs)
    return Wt, Ht


def _sparsities(sparsity_H, n_scales: int) -> tuple:
    """A scalar or per-scale ``sparsity_H`` as one float per scale."""
    if np.isscalar(sparsity_H):
        sparsity_H = (float(sparsity_H),) * n_scales
    sparsity_H = tuple(float(s) for s in sparsity_H)
    _require(len(sparsity_H) == n_scales and min(sparsity_H) >= 0,
             'sparsity_H must give one value >= 0 per scale')
    return sparsity_H


class MultiScaleTNMF:
    """Shift-invariant NMF with per-scale atom banks, in PyTorch.

    Parameters (the JAX package's, in its order)
    ----------
    n_atoms : Tuple[int, ...]
        Atoms per scale, e.g. ``(8, 4)``.
    atom_shapes : Tuple[Tuple[int, ...], ...]
        One spatial shape per scale, e.g. ``((5, 5), (13, 13))``; all of one
        rank.
    reconstruction_mode, backend, seed, verbose, beta_loss, precision, logger
        As in :class:`tnmf_tpu_torch.TransformInvariantNMF`; ``'auto'``
        resolves per scale (conv or fft).
    dtype : torch.dtype or {'float32', 'float64'}, default torch.float32
        Compute dtype (None: float32).  bfloat16 raises
        ``NotImplementedError`` (ROADMAP.md queue 2, item f).
    mesh
        Not ported yet: any value but ``None`` raises
        ``NotImplementedError`` (ROADMAP.md queue 1, item 14e-iv).
    w_init : {'random', 'patches'}, h_init : {'random', 'correlate'}
        The JAX package's initialisations, per scale.
    device : str or torch.device, default 'cuda'
        Keyword-only.  Where the factors live and the updates run.
    use_pallas : bool, optional
        Keyword.  The kernel/plain switch: ``None`` runs the kernels where
        the engine's gates take them (CUDA, float32), ``False`` their plain
        versions everywhere, ``True`` is ``None`` on a CUDA model and
        raises ``ValueError`` on a CPU one.

    Host initialisation (the JAX package's documented stream order): every
    H bank first, in scale order, as ``1 - rng.random``, then every W bank
    (sum-normalised); ``h_init='correlate'`` draws no H (the per-scale
    matched filter, on the device).
    """

    def __init__(self, n_atoms: Tuple[int, ...], atom_shapes: Tuple[Tuple[int, ...], ...],
                 reconstruction_mode: str = 'valid', backend: str = 'auto',
                 dtype=torch.float32, seed: Optional[int] = None, verbose: int = 0,
                 beta_loss=2.0, precision: Optional[str] = None, mesh=None,
                 logger: Optional[logging.Logger] = None, w_init: str = 'random',
                 h_init: str = 'random', *, device='cuda', use_pallas: Optional[bool] = None):
        # the arguments as given, for get_params / set_params / clone
        self._init_params = dict(
            n_atoms=n_atoms, atom_shapes=atom_shapes, reconstruction_mode=reconstruction_mode,
            backend=backend, dtype=dtype, seed=seed, verbose=verbose, beta_loss=beta_loss,
            precision=precision, mesh=mesh, logger=logger, w_init=w_init, h_init=h_init,
            device=device, use_pallas=use_pallas)
        if mesh is not None:
            raise NotImplementedError(
                f'MultiScaleTNMF(mesh={mesh!r}) is not ported to tnmf_tpu_torch yet; '
                f'see {_MESH_ITEM}')
        if len(n_atoms) != len(atom_shapes) or not n_atoms:
            raise ValueError('n_atoms and atom_shapes must be equal-length, '
                             'non-empty tuples (one entry per scale)')
        ranks = {len(a) for a in atom_shapes}
        if len(ranks) != 1:
            raise ValueError(f'all atom shapes must share one rank, got {atom_shapes}')
        self.n_scales = len(n_atoms)
        self.n_atoms = tuple(int(m) for m in n_atoms)
        self.atom_shapes = tuple(tuple(int(a) for a in s) for s in atom_shapes)
        self._mode = reconstruction_mode
        self._backend = backend
        self._precision = precision
        self._beta = beta_ops.resolve_beta_loss(beta_loss)
        if w_init not in ('random', 'patches'):
            raise ValueError(
                "w_init must be 'random' or 'patches' for MultiScaleTNMF "
                f"(got {w_init!r}; 'nndsvd' needs the plain-NMF geometry, "
                "which is single-scale by construction)")
        self._w_init = w_init
        if h_init not in ('random', 'correlate'):
            raise ValueError(f"h_init must be 'random' or 'correlate', got {h_init!r}")
        self._h_init = h_init
        self.device = torch.device(device)
        self.dtype = torch.float32 if dtype is None else _torch_dtype(dtype)
        if use_pallas not in (None, False, True):
            raise ValueError(f'use_pallas must be None, False or True, got {use_pallas!r}')
        if use_pallas and self.device.type == 'cpu':
            raise ValueError('use_pallas=True forces the CUDA kernels, and a CPU model has '
                             'none; pass use_pallas=None or False')
        self._use_pallas = use_pallas
        self._rng = np.random.default_rng(seed) if seed is not None else np.random
        self._logger = (logger if logger is not None
                        else logging.getLogger(self.__class__.__name__))
        self._logger.setLevel(
            [logging.ERROR, logging.WARNING, logging.INFO, logging.DEBUG][verbose])

        self._plans: Optional[tuple] = None
        self._strategies: Optional[tuple] = None
        self._Ws: Optional[tuple] = None
        self._Hs: Optional[tuple] = None
        self._Vd: Optional[torch.Tensor] = None
        self._Vps: Optional[tuple] = None
        self._mask_d: Optional[torch.Tensor] = None
        self.energies_ = None
        self.n_iterations_: Optional[int] = None
        # online-learning state (partial_fit): per-scale averaged (neg, pos)
        # W statistics, and the steps taken
        self._sag_stat_ = None
        self.n_steps_: int = 0

    # -- accessors ------------------------------------------------------

    @property
    def W(self) -> Tuple[np.ndarray, ...]:
        """Per-scale dictionaries, ``W[k]: (n_atoms[k], C, *atom_shapes[k])``."""
        return tuple(w.cpu().numpy() for w in self._Ws)

    @property
    def H(self) -> Tuple[np.ndarray, ...]:
        """Per-scale activations, ``H[k]: (N, n_atoms[k], *transform_k)``
        (host copies: the minibatch fits write H in place)."""
        return tuple(h.to('cpu', copy=True).numpy() for h in self._Hs)

    @property
    def R(self) -> np.ndarray:
        return ms_reconstruct(self._Ws, self._Hs, plans=self._plans,
                              strategies=self._strategies).cpu().numpy()

    def R_scale(self, k: int) -> np.ndarray:
        """The reconstruction of scale ``k`` alone."""
        return engine.reconstruct(self._Ws[k], self._Hs[k], plan=self._plans[k],
                                  strategy=self._strategies[k]).cpu().numpy()

    def _energy(self) -> torch.Tensor:
        R = ms_reconstruct(self._Ws, self._Hs, plans=self._plans, strategies=self._strategies)
        return beta_ops.divergence(self._Vd, R, self._beta, self._mask_d)

    def _energy_function(self) -> float:
        return float(self._energy())

    def _statics(self, **flags) -> dict:
        return dict(plans=self._plans, strategies=self._strategies, beta=self._beta,
                    use_pallas=self._use_pallas is not False, **flags)

    # -- fitting --------------------------------------------------------

    def _strategies_for(self, plans) -> tuple:
        """Each scale's strategy: ``'auto'``/``'jax'`` by the JAX rule per
        scale, with the plain-NMF corner kept on 'conv'; any other backend
        name its strategy for every scale (unknown names raise
        ``KeyError``)."""
        if self._backend in ('auto', 'jax'):
            strategies = tuple(engine.resolve_strategy(engine.choose_strategy(p), p,
                                                       allow_dot=False) for p in plans)
        else:
            strategies = (_BACKEND_STRATEGY[self._backend.lower()],) * self.n_scales
        for s in strategies:
            engine.require_ported(s)
        return strategies

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def _prepare_mask(self, mask, V) -> Optional[torch.Tensor]:
        if mask is None:
            return None
        mask = _as_input(mask, self.device)
        if mask.ndim != V.ndim:
            raise ValueError(
                f'mask must have the same rank as V ({V.ndim}), got {mask.ndim}')
        np.broadcast_shapes(tuple(mask.shape), tuple(V.shape))
        if bool((mask < 0).any()):
            raise ValueError('mask entries must be nonnegative')
        return self._tensor(mask)

    def _initialize(self, V, keep_W: bool, mask):
        V = _as_input(V, self.device)
        _assert_nonnegative(V)
        sample_shape = tuple(V.shape[2:])
        self._plans = tuple(ConvPlan.create(self._mode, sample_shape, a,
                                            precision=self._precision)
                            for a in self.atom_shapes)
        self._strategies = self._strategies_for(self._plans)

        # host init, the reference's distribution (1 - U[0,1)) in V's dtype:
        # all H banks first (scale order), then all W banks; h_init='correlate'
        # draws no H (the per-scale matched filter, on the device below)
        draw_dtype = _np_dtype(V)
        if self._h_init == 'correlate':
            Hs = None
        else:
            Hs = tuple(np.asarray(1 - self._rng.random((V.shape[0], m) + p.transform_shape),
                                  dtype=draw_dtype)
                       for m, p in zip(self.n_atoms, self._plans))
        if keep_W and self._Ws is not None:
            Ws = self._Ws
        else:
            Ws = []
            for m, a in zip(self.n_atoms, self.atom_shapes):
                axes = tuple(range(-len(a), 0))
                if self._w_init == 'patches':
                    # per-scale data windows (a tensor is cut on its device)
                    Wk = patches_init(V, m, a, self._rng)
                    if isinstance(Wk, torch.Tensor):
                        Ws.append(Wk / Wk.sum(dim=axes, keepdim=True))
                        continue
                    Wk = Wk.astype(draw_dtype)
                else:
                    Wk = np.asarray(1 - self._rng.random((m, V.shape[1]) + a), dtype=draw_dtype)
                Wk /= Wk.sum(axis=axes, keepdims=True)
                Ws.append(Wk)
        self._Vd = self._tensor(V)
        self._Ws = tuple(self._tensor(w) for w in Ws)
        self._mask_d = self._prepare_mask(mask, V)
        if self._beta != 2.0:
            self._Vps = (self._Vd,) * self.n_scales  # factors prepared per step
        else:
            Vm = self._Vd if self._mask_d is None else self._Vd * self._mask_d
            self._Vps = tuple(engine.prepare_data(Vm, plan=p, strategy=s)
                              for p, s in zip(self._plans, self._strategies))
        if Hs is None:
            # the matched filter of the masked objective is prepare(mask * V)
            # at beta = 2; prepare(V) where the slot holds the canonical V
            self._Hs = tuple(
                engine.correlate_init_H(
                    (engine.prepare_data(self._Vd, plan=p, strategy=s)
                     if self._beta != 2.0 else vp),
                    self._Vd, w, plan=p, strategy=s)
                for vp, w, p, s in zip(self._Vps, self._Ws, self._plans, self._strategies))
        else:
            self._Hs = tuple(self._tensor(h) for h in Hs)

    def get_params(self, deep: bool = True) -> dict:
        """The constructor's arguments as given (sklearn estimator API)."""
        del deep  # no nested estimators
        return dict(self._init_params)

    def set_params(self, **params) -> 'MultiScaleTNMF':
        """Re-run the constructor with ``params`` over the current arguments
        (drops any fitted state).  Unknown names raise ``ValueError``."""
        unknown = set(params) - set(self._init_params)
        if unknown:
            raise ValueError(
                f'invalid parameter(s) {sorted(unknown)} for estimator '
                f'{type(self).__name__}; valid parameters are '
                f'{sorted(self._init_params)}')
        self.__init__(**{**self._init_params, **params})
        return self

    def __sklearn_tags__(self):
        """Estimator tags (the sklearn >= 1.6 protocol); sklearn is imported
        here, when sklearn asks."""
        from sklearn.utils import Tags, TargetTags, TransformerTags
        return Tags(estimator_type='transformer', target_tags=TargetTags(required=False),
                    transformer_tags=TransformerTags(), regressor_tags=None,
                    classifier_tags=None, no_validation=True)

    def fit(self, V, y=None, n_iterations: int = 1000, update_H: bool = True,
            update_W: bool = True, keep_W: bool = False, sparsity_H=0.0, mask=None,
            record_energies: bool = False, progress_callback=None,
            tol: Optional[float] = None, tol_check_every: int = 10):
        """Full-batch multi-scale MU fit (a NumPy array or a tensor).
        ``sparsity_H`` is a scalar or a per-scale tuple.  ``tol`` stops
        once the relative objective improvement over a block of
        ``tol_check_every`` iterations drops below it (not with
        ``progress_callback``; with ``record_energies`` the trace is trimmed
        to the iterations run); ``n_iterations_`` reports where the fit
        stopped.  ``progress_callback(model, iteration)`` runs after every
        iteration and stops the fit when it returns a false value.  ``y``
        is ignored."""
        del y
        _require(update_H or update_W, 'at least one of update_H / update_W must be True')
        self._sag_stat_ = None  # a fresh fit drops partial_fit's state
        sp = _sparsities(sparsity_H, self.n_scales)
        self._initialize(V, keep_W, mask)
        statics = self._statics(update_H=update_H, update_W=update_W)
        data = (self._Vd, self._Vps)

        self.energies_ = None
        self.n_iterations_ = int(n_iterations)
        if tol is not None:
            if progress_callback is not None:
                raise ValueError(
                    'tol-based early stopping runs as one on-device '
                    'while_loop and cannot combine with progress_callback')
            _require(tol >= 0, f'tol must be >= 0, got {tol!r}')
            _require(int(tol_check_every) >= 1, 'tol_check_every must be >= 1')
            self._Ws, self._Hs, n_done, _, trace = ms_fit_loop_tol(
                *data, self._Ws, self._Hs, int(n_iterations), tol, sp, self._mask_d,
                check_every=int(tol_check_every),
                n_buf=_trace_buf(n_iterations) if record_energies else 0, **statics)
            self.n_iterations_ = int(n_done)
            if record_energies:
                self.energies_ = trace.cpu().numpy()[:self.n_iterations_]
            self._logger.info('MultiScale TNMF finished.')
            return self
        if record_energies and progress_callback is None:
            traces, done, n = [], 0, int(n_iterations)
            while done < n:
                self._Ws, self._Hs, es = _ms_energies_chunk(
                    *data, self._Ws, self._Hs, min(ENERGY_CHUNK, n - done), sp, self._mask_d,
                    chunk=ENERGY_CHUNK, **statics)
                traces.append(es)
                done += ENERGY_CHUNK
            self.energies_ = (torch.cat(traces).cpu().numpy()[:n] if traces
                              else np.zeros((0,)))
        elif progress_callback is None:
            self._Ws, self._Hs = ms_fit_loop(*data, self._Ws, self._Hs, n_iterations, sp,
                                             self._mask_d, **statics)
        else:
            energies = [] if record_energies else None
            for it in range(int(n_iterations)):
                self._Ws, self._Hs = ms_update_step(*data, self._Ws, self._Hs, sp,
                                                    self._mask_d, **statics)
                if record_energies:
                    energies.append(self._energy_function())
                if not progress_callback(self, it):
                    self.n_iterations_ = it + 1  # stopped early
                    break
            if record_energies:
                self.energies_ = np.asarray(energies)
        self._logger.info('MultiScale TNMF finished.')
        return self

    def fit_minibatches(self, V, algorithm: Optional[MiniBatchAlgorithm] = None,
                        batch_size: Optional[int] = 3, n_epochs: int = 1000,
                        sag_lambda: float = 0.2, keep_W: bool = False, sparsity_H=0.0,
                        mask=None, record_energies: bool = False, progress_callback=None):
        """Minibatch MU for multi-scale dictionaries: the reference's five
        epoch schedules (:class:`~tnmf_tpu_torch.MiniBatchAlgorithm`) on the
        joint block updates.  Per batch every scale's H slice updates
        against the batch's total reconstruction and is written back in
        place; the W schedules use per-scale ``(neg, pos)`` statistics as the
        single-scale model does (summed for Cyclic_MU, per batch for ASG and
        GSG, averaged with ``sag_lambda`` for ASAG and GSAG).  The shuffled
        order of each epoch is drawn from the model's NumPy stream
        (``permutation(n_batches)``); ``batch_size=None`` is one batch."""
        if algorithm is None:
            algorithm = MiniBatchAlgorithm.ASG_MU
        self._sag_stat_ = None  # a fresh fit drops partial_fit's state
        sp = _sparsities(sparsity_H, self.n_scales)
        self._initialize(V, keep_W, mask)
        statics = self._statics()
        n = int(self._Vd.shape[0])
        batches = ([slice(0, n)] if batch_size is None
                   else list(_sequential_slices(n, int(batch_size))))

        def mask_slice(s):
            if self._mask_d is None:
                return None
            if self._mask_d.shape[0] == n:
                return self._mask_d[s]
            return self._mask_d  # broadcast mask (a sample axis of 1)

        def sliced(s):
            return (self._Vd[s], tuple(vp[s] for vp in self._Vps),
                    tuple(h[s] for h in self._Hs), mask_slice(s))

        def update_H_batch(s):
            Vb, Vpb, Hb, Mb = sliced(s)
            _, Hn = ms_update_step(Vb, Vpb, self._Ws, Hb, sp, Mb, update_H=True,
                                   update_W=False, **statics)
            for h, hn in zip(self._Hs, Hn):
                h[s] = hn

        def update_W_batch(s):
            Vb, Vpb, Hb, Mb = sliced(s)
            self._Ws, _ = ms_update_step(Vb, Vpb, self._Ws, Hb, sp, Mb, update_H=False,
                                         update_W=True, **statics)

        def grad_W_batch(s):
            Vb, Vpb, Hb, Mb = sliced(s)
            return ms_grad_W_stats(Vb, Vpb, self._Ws, Hb, Mb, **statics)

        def apply_W(stats):
            self._Ws = ms_apply_W_stats(self._Ws, stats, plans=self._plans,
                                        use_pallas=statics['use_pallas'])

        def shuffled():
            return [batches[i] for i in self._rng.permutation(len(batches))]

        def acc_sum(acc, stats):
            if acc is None:
                return stats
            return tuple((a[0] + s[0], a[1] + s[1]) for a, s in zip(acc, stats))

        def acc_avg(acc, stats):
            if acc is None:
                acc = tuple((torch.zeros_like(s[0]), torch.zeros_like(s[1])) for s in stats)
            return tuple(engine.accumulate_gradient(*a, *s, float(sag_lambda))
                         for a, s in zip(acc, stats))

        A = MiniBatchAlgorithm
        inner_stat = None
        log_each = progress_callback is None and self._logger.isEnabledFor(logging.INFO)
        energies = []
        for epoch in range(int(n_epochs)):
            if algorithm is A.Cyclic_MU:
                acc = None
                for b in batches:
                    update_H_batch(b)
                    acc = acc_sum(acc, grad_W_batch(b))
                apply_W(acc)
            elif algorithm is A.ASG_MU:
                for b in shuffled():
                    update_H_batch(b)
                    update_W_batch(b)
            elif algorithm is A.GSG_MU:
                for b in shuffled():
                    update_H_batch(b)
                update_W_batch(b)
            elif algorithm is A.ASAG_MU:
                for b in shuffled():
                    update_H_batch(b)
                    inner_stat = acc_avg(inner_stat, grad_W_batch(b))
                    apply_W(inner_stat)
            elif algorithm is A.GSAG_MU:
                for b in shuffled():
                    update_H_batch(b)
                inner_stat = acc_avg(inner_stat, grad_W_batch(b))
                apply_W(inner_stat)
            else:
                raise ValueError(f'unknown algorithm {algorithm!r}')
            if record_energies or log_each:
                energies.append(self._energy())
            if progress_callback is not None:
                if not progress_callback(self, epoch):
                    break
            elif log_each:
                self._logger.info('Epoch: %d\tEnergy function: %s', epoch, float(energies[-1]))
        self.energies_ = (np.asarray(torch.stack(energies).tolist() if energies else [])
                          if record_energies else None)
        self._logger.info('MultiScale MiniBatch TNMF finished.')
        return self

    def fit_stream(self, V, subsample_size: int = 3, max_subsamples: Optional[int] = None,
                   **kwargs):
        """Streaming fit over an iterator of samples: each subsample refits
        with ``keep_W=True``, so the banks carry across chunks while the
        activations re-solve per chunk.  A subsample of tensors is stacked
        on their device."""
        for isub in count(0):
            subsample = list(islice(V, subsample_size))
            if not subsample:
                self._logger.info('Sample iterator exhausted.')
                return self
            self._logger.info('Processing subsample %d.', isub)
            self.fit(_stacked(subsample), keep_W=True, **kwargs)
            if max_subsamples is not None and isub == max_subsamples - 1:
                self._logger.info('Processed %d subsamples.', max_subsamples)
                return self

    def partial_fit(self, V, y=None, sag_lambda: float = 0.2, sparsity_H=0.0,
                    mask=None) -> 'MultiScaleTNMF':
        """Update the model with one minibatch (online learning): fresh
        per-scale activations for the batch, updated once jointly, then
        every scale's dictionary from ``(neg, pos)`` statistics averaged
        across calls (``sag_lambda``; 1 keeps no memory, and a first call
        equals one ``fit`` iteration).  Any ``fit*`` call drops the averaged
        state."""
        del y
        sp = _sparsities(sparsity_H, self.n_scales)
        self._initialize(V, keep_W=True, mask=mask)
        statics = self._statics()
        data = (self._Vd, self._Vps)
        _, self._Hs = ms_update_step(*data, self._Ws, self._Hs, sp, self._mask_d,
                                     update_H=True, update_W=False, **statics)
        stats = ms_grad_W_stats(*data, self._Ws, self._Hs, self._mask_d, **statics)
        if sag_lambda == 1.0 or self._sag_stat_ is None:
            stat = stats  # the batch's own statistics
        else:
            stat = tuple(engine.accumulate_gradient(*a, *s, float(sag_lambda))
                         for a, s in zip(self._sag_stat_, stats))
        self._sag_stat_ = None if sag_lambda == 1.0 else stat
        self._Ws = ms_apply_W_stats(self._Ws, stat, plans=self._plans,
                                    use_pallas=statics['use_pallas'])
        self.n_steps_ += 1
        return self

    def transform(self, V, n_iterations: int = 100, **kwargs) -> Tuple[np.ndarray, ...]:
        """Encode new data against the frozen multi-scale dictionary:
        ``fit(V, update_W=False, keep_W=True, ...)``; the per-scale H."""
        if self._Ws is None:
            raise RuntimeError('transform() requires a fitted model')
        self.fit(V, n_iterations=n_iterations, update_W=False, keep_W=True, **kwargs)
        return self.H

    def inverse_transform(self) -> np.ndarray:
        return self.R

    def export_serving(self, path: Optional[str] = None, **kwargs) -> bytes:
        """Serialize the multi-scale encoding step (per-scale matched-filter
        init, then joint frozen-dictionary block MU steps) as a serving
        artifact whose ``transform`` returns the per-scale activation tuple
        (:func:`tnmf_tpu_torch.serving.export_serving`)."""
        from ..serving import export_serving
        return export_serving(self, path=path, **kwargs)

    # -- checkpointing ---------------------------------------------------

    def save(self, path: str, include_H: bool = False):
        """Atomic ``.npz`` checkpoint of the per-scale banks in the JAX
        package's keys, which its ``load`` reads."""
        if self._Ws is None:
            raise ValueError('nothing to save: the model has not been fit yet')
        payload = dict(
            n_scales=self.n_scales,
            n_atoms=np.asarray(self.n_atoms),
            reconstruction_mode=self._mode,
            dtype=str(self._Ws[0].dtype).removeprefix('torch.'),
            version=1,
        )
        for k in range(self.n_scales):
            payload[f'atom_shape_{k}'] = np.asarray(self.atom_shapes[k])
            payload[f'W_{k}'] = self._Ws[k].cpu().numpy()
            if include_H and self._Hs is not None:
                payload[f'H_{k}'] = self._Hs[k].cpu().numpy()
        final = path if path.endswith('.npz') else path + '.npz'
        tmp = final + '.tmp'
        with open(tmp, 'wb') as f:
            np.savez(f, **payload)
        os.replace(tmp, final)

    @classmethod
    def load(cls, path: str, *, device='cuda', dtype: Optional[torch.dtype] = None,
             **kwargs) -> 'MultiScaleTNMF':
        """Restore a checkpoint of either package; ``dtype`` defaults to the
        stored one, ``kwargs`` override constructor arguments.  A checkpoint
        written with ``include_H`` restores the activations and the plans,
        so ``R`` and ``R_scale`` work at once."""
        with np.load(path, allow_pickle=False) as data:
            K = int(data['n_scales'])
            cfg = dict(
                n_atoms=tuple(int(m) for m in data['n_atoms']),
                atom_shapes=tuple(tuple(int(a) for a in data[f'atom_shape_{k}'])
                                  for k in range(K)),
                reconstruction_mode=str(data['reconstruction_mode']),
            )
            cfg.update(kwargs)
            if dtype is None:
                dtype = _torch_dtype(str(data['dtype']))
            model = cls(**cfg, device=device, dtype=dtype)
            model._Ws = tuple(model._tensor(data[f'W_{k}']) for k in range(K))
            if 'H_0' in data:
                model._Hs = tuple(model._tensor(data[f'H_{k}']) for k in range(K))
                model._restore_plans_from_h()
        return model

    def _restore_plans_from_h(self):
        """Rebuild the per-scale plans and strategies from the restored H
        geometry."""
        t0 = tuple(self._Hs[0].shape[2:])
        a0 = self.atom_shapes[0]
        if self._mode == 'valid':
            sample = tuple(t - a + 1 for t, a in zip(t0, a0))
        elif self._mode == 'full':
            sample = tuple(t + a - 1 for t, a in zip(t0, a0))
        else:
            sample = t0
        self._plans = tuple(ConvPlan.create(self._mode, sample, a, precision=self._precision)
                            for a in self.atom_shapes)
        self._strategies = self._strategies_for(self._plans)

    def save_sharded(self, path: str, include_H: bool = True, block: bool = True):
        raise NotImplementedError(
            f'MultiScaleTNMF.save_sharded is not ported to tnmf_tpu_torch yet; see {_CHECKPOINT_ITEM}')

    def wait_for_checkpoints(self):
        raise NotImplementedError(
            'MultiScaleTNMF.wait_for_checkpoints is not ported to tnmf_tpu_torch yet; '
            f'see {_CHECKPOINT_ITEM}')

    @classmethod
    def load_sharded(cls, path: str, mesh=None, **kwargs):
        raise NotImplementedError(
            f'MultiScaleTNMF.load_sharded is not ported to tnmf_tpu_torch yet; see {_CHECKPOINT_ITEM}')
