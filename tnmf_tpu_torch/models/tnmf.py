"""Transform-Invariant Non-Negative Matrix Factorization in PyTorch (batch slice).

Port of the full-batch multiplicative-update fit of
:class:`tnmf_tpu.models.tnmf.TransformInvariantNMF`: the constructor, ``fit``
/ ``fit_batch`` with the L1 and lateral-inhibition regularizers, the
host-NumPy initialization (reference RNG stream, so seeded fits match the
JAX package), the ``W`` / ``H`` / ``V`` / ``R``
accessors, ``R_partial``, the energy, and loading the JAX package's ``.npz``
checkpoints.  Arguments of the JAX API that select parts not ported yet
raise ``NotImplementedError`` naming the ROADMAP item that ports them.

The constructor takes the JAX package's positional order.  The model lives
on an explicit ``device`` (keyword-only, default ``'cuda'``, no automatic
choice) in an explicit ``dtype`` (default float32).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from .. import engine
from ..ops.inhibition import cross_scale, inhibition_kernels, resolve_inhibition_range
from ..ops.modes import ConvPlan

# reference backend names (tnmf/TransformInvariantNMF.py:168-176) and the
# JAX package's own, with the strategy each requests
_BACKEND_STRATEGY = {
    'auto': 'auto',
    'jax': 'auto',
    'jax_fft': 'fft',
    'jax_conv': 'conv',
    'numpy': 'conv',
    'numpy_fft': 'fft',
    'numpy_caching_fft': 'fft',
    'pytorch': 'conv',
    'pytorch_fft': 'fft',
}

_ITEM = 'ROADMAP.md queue 1, item {}'

#: constructor arguments of the JAX API not ported yet: (default, ROADMAP item)
_UNPORTED_INIT = {
    'logger': (None, _ITEM.format(4)),
    'verbose': (0, _ITEM.format(4)),
    'mesh': (None, _ITEM.format(14)),
    'fft_policy': ('5-smooth', _ITEM.format(8)),
    'use_pallas': (None, 'ROADMAP.md queue 2 (kernel/plain switch)'),
    'init': ('host', _ITEM.format(12)),
    'shard_axis': ('samples', _ITEM.format(14)),
    'precision': (None, _ITEM.format(16)),
    'beta_loss': (2.0, _ITEM.format(10)),
    'transform_type': ('shift', _ITEM.format(12)),
    'w_init': ('random', _ITEM.format(12)),
    'h_init': ('random', _ITEM.format(12)),
}

#: fit_batch arguments of the JAX API not ported yet: (default, ROADMAP item)
_UNPORTED_FIT = {
    'l2_H': (0., _ITEM.format(10)),
    'ortho_W': (0., _ITEM.format(10)),
    'mask': (None, _ITEM.format(10)),
    'progress_callback': (None, _ITEM.format(4)),
    'callback_interval': (1, _ITEM.format(4)),
    'record_energies': (False, _ITEM.format(9)),
    'tol': (None, _ITEM.format(9)),
    'tol_check_every': (10, _ITEM.format(9)),
    'extrapolate': (False, _ITEM.format(9)),
    'keep_H': (False, _ITEM.format(12)),
    'checkpoint_every': (None, _ITEM.format(12)),
    'checkpoint_path': (None, _ITEM.format(12)),
    'revive_every': (None, _ITEM.format(12)),
    'revive_threshold': (1e-4, _ITEM.format(12)),
    'solver': ('mu', _ITEM.format(13)),
    'hals_inner': ('auto', _ITEM.format(13)),
    'sparsity_W': (0., _ITEM.format(13)),
    'l2_W': (0., _ITEM.format(13)),
}

#: fit() keywords that select the minibatch / streaming drivers
_MINIBATCH_KWARGS = ('batch_size', 'algorithm', 'subsample_size', 'max_subsamples')


def _is_default(value, default) -> bool:
    if value is default:
        return True
    if default is None or not isinstance(value, (bool, int, float, str)):
        return False
    return value == default


def _reject_unported(where: str, kwargs: dict, table: dict) -> None:
    """``TypeError`` for names the JAX API lacks, ``NotImplementedError``
    for JAX arguments set to a value whose code is not ported yet."""
    for name, value in kwargs.items():
        if name not in table:
            raise TypeError(f'{where}() got an unexpected keyword argument {name!r}')
        default, item = table[name]
        if name == 'beta_loss' and value == 'frobenius':
            continue
        if not _is_default(value, default):
            raise NotImplementedError(
                f'{where}({name}={value!r}) is not ported to tnmf_tpu_torch yet; '
                f'see {item}')


def _torch_dtype(name) -> torch.dtype:
    """The torch dtype of a ``torch.dtype`` or of the JAX package's dtype
    strings (a constructor argument or a checkpoint's ``dtype``)."""
    name = str(name).removeprefix('torch.')
    if name == 'float32':
        return torch.float32
    if name == 'float64':
        return torch.float64
    raise NotImplementedError(
        f'{name} storage is not ported to tnmf_tpu_torch yet (ROADMAP.md queue 2, bf16 kernels)')


def from_numpy(W: np.ndarray, H: Optional[np.ndarray] = None, *, device,
               dtype: torch.dtype) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The JAX model's ``W`` (and ``H``), as NumPy arrays, as the port's
    tensors on ``device`` in ``dtype``."""
    Wt = torch.as_tensor(np.ascontiguousarray(W), dtype=dtype, device=device)
    Ht = None if H is None else torch.as_tensor(np.ascontiguousarray(H), dtype=dtype,
                                                device=device)
    return Wt, Ht


class TransformInvariantNMF:
    r"""Shift-invariant NMF via multiplicative updates, in PyTorch.

    Parameters
    ----------
    n_atoms : int
        Number of dictionary atoms; ``W`` has shape
        ``(n_atoms, n_channels, *atom_shape)``.
    atom_shape : Tuple[int, ...]
        Spatial shape of the atoms.
    inhibition_range : int or Tuple[int, ...], optional
        Lateral inhibition range per shift axis; defaults to
        ``atom_shape - 1`` (reference ``TransformInvariantNMF.py:154-160``).
    backend : str, default 'auto'
        A backend name of the JAX package.  Only the direct-convolution
        strategy is ported: names (or an ``'auto'`` choice) that resolve to
        another strategy raise ``NotImplementedError``.
    logger, verbose
        Not ported yet: any value but the default (``None``, ``0``) raises
        ``NotImplementedError``.
    reconstruction_mode : {'valid', 'full', 'circular', 'reflect'}, default 'valid'
    dtype : torch.dtype or {'float32', 'float64'}, default torch.float32
        Compute dtype.  On CUDA float32 runs the hand-written kernels;
        float64, the reference precision, runs their plain versions (the
        JAX kernels' own dtype gate).
    mesh
        Not ported yet: any value but ``None`` raises ``NotImplementedError``.
    seed : int, optional
        If given, W/H initialization draws from a private
        ``np.random.default_rng(seed)``; otherwise from the global NumPy
        stream in the reference's order (H, then W).
    device : str or torch.device, default 'cuda'
        Keyword-only.  Where the factors live and the updates run.  On CUDA
        the hot operators are the hand-written kernels; on the CPU their
        plain versions.

    The JAX package's later parameters (``fft_policy`` … ``h_init``) are
    taken by keyword; those whose code is not ported raise
    ``NotImplementedError`` unless they hold their default.
    """

    def __init__(self, n_atoms: int, atom_shape: Tuple[int, ...],
                 inhibition_range: Union[int, Tuple[int, ...], None] = None,
                 backend: str = 'auto', logger=None, verbose: int = 0,
                 reconstruction_mode: str = 'valid',
                 dtype: Union[torch.dtype, str] = torch.float32, mesh=None,
                 seed: Optional[int] = None, *, device='cuda', **unported):
        _reject_unported('TransformInvariantNMF',
                         dict(logger=logger, verbose=verbose, mesh=mesh, **unported),
                         _UNPORTED_INIT)
        self.n_atoms = int(n_atoms)
        self.atom_shape = tuple(int(a) for a in atom_shape)
        self._inhibition_range = resolve_inhibition_range(inhibition_range, self.atom_shape)
        self._inhibition_kernels_1D = inhibition_kernels(self._inhibition_range)
        self._kernels: Tuple[torch.Tensor, ...] = ()
        self._axes_W_normalization = tuple(range(-len(self.atom_shape), 0))
        try:
            self._strategy_request = _BACKEND_STRATEGY[backend.lower()]
        except KeyError as e:
            raise KeyError(
                f'unknown backend {backend!r}; choose one of {sorted(_BACKEND_STRATEGY)}') from e
        self._reconstruction_mode = reconstruction_mode
        self.device = torch.device(device)
        self.dtype = _torch_dtype(dtype)
        self._rng = np.random.default_rng(seed) if seed is not None else np.random

        self._plan: Optional[ConvPlan] = None
        self._W: Optional[torch.Tensor] = None
        self._H: Optional[torch.Tensor] = None
        self._V: Optional[np.ndarray] = None   # host copy for the V property
        self._Vd: Optional[torch.Tensor] = None
        self._Vp: Optional[torch.Tensor] = None  # prepared (mode-extended) data
        self.n_iterations_: Optional[int] = None

    # ------------------------------------------------------------------
    # accessors (reference TransformInvariantNMF.py:188-215)
    # ------------------------------------------------------------------

    @property
    def W(self) -> np.ndarray:
        return self._W.cpu().numpy()

    @property
    def H(self) -> np.ndarray:
        return self._H.cpu().numpy()

    @property
    def V(self) -> np.ndarray:
        return self._V

    @property
    def R(self) -> np.ndarray:
        return engine.reconstruct(self._W, self._H, plan=self._plan).cpu().numpy()

    def R_partial(self, i_atom: int) -> np.ndarray:
        return engine.partial_reconstruct(
            self._W, self._H, plan=self._plan, i_atom=int(i_atom)).cpu().numpy()

    def _energy_function(self) -> float:
        return float(engine.energy(self._Vd, self._W, self._H, plan=self._plan))

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------

    def _check_strategy(self):
        """Raise unless the requested backend resolves to the ported
        direct-convolution strategy for the current plan."""
        strategy = self._strategy_request
        if strategy == 'auto':
            strategy = engine.choose_strategy(self._plan)
        engine.require_ported(engine.resolve_strategy(strategy, self._plan))

    def _initialize_matrices(self, V: np.ndarray, keep_W: bool):
        self._V = V
        self._plan = ConvPlan.create(self._reconstruction_mode, V.shape[2:], self.atom_shape)
        self._check_strategy()

        keep = keep_W and self._W is not None
        if keep:
            expected = (self.n_atoms, V.shape[1]) + self.atom_shape
            if tuple(self._W.shape) != expected:
                raise ValueError(
                    f'keep_W: existing dictionary of shape {tuple(self._W.shape)} '
                    f'does not match the new data (expected {expected}); '
                    f'the channel count must stay constant across fits')
        # host-side init replicating the reference RNG stream exactly (H then
        # W, 1 - U[0,1); _Backend.py:83-98) so seeded runs match
        H = np.asarray(
            1 - self._rng.random((V.shape[0], self.n_atoms) + self._plan.transform_shape),
            dtype=V.dtype)
        if keep:
            W = self._W.cpu().numpy()
        else:
            W = np.asarray(
                1 - self._rng.random((self.n_atoms, V.shape[1]) + self.atom_shape),
                dtype=V.dtype)
            W /= W.sum(axis=self._axes_W_normalization, keepdims=True)
        self._W, self._H = from_numpy(W, H, device=self.device, dtype=self.dtype)
        self._Vd = torch.as_tensor(V, dtype=self.dtype, device=self.device)
        self._Vp = engine.prepare_data(self._Vd, plan=self._plan)
        # built in float64, cast to the compute dtype
        self._kernels = tuple(torch.as_tensor(k, dtype=self.dtype, device=self.device)
                              for k in self._inhibition_kernels_1D)

    # ------------------------------------------------------------------
    # batch fitting (reference fit_batch, TransformInvariantNMF.py:282-348)
    # ------------------------------------------------------------------

    def fit_batch(self, V, n_iterations: int = 1000, update_H: bool = True,
                  update_W: bool = True, keep_W: bool = False,
                  sparsity_H: float = 0., inhibition_strength: float = 0.,
                  cross_atom_inhibition_strength: float = 0., **unported):
        """Full-batch multiplicative-update factorization of ``V``
        (``(n_samples, n_channels, *sample_shape)``, nonnegative):
        ``n_iterations`` H+W updates; ``update_H`` / ``update_W`` freeze a
        factor; ``keep_W`` warm-starts from the current dictionary;
        ``sparsity_H`` is the L1 weight on the activations;
        ``inhibition_strength`` and ``cross_atom_inhibition_strength``
        weight the same-atom and cross-atom lateral inhibition."""
        _reject_unported('fit_batch', unported, _UNPORTED_FIT)
        V = np.asarray(V)
        if not np.all(V >= 0):
            raise ValueError('The input data V must be non-negative.')
        if not (update_H or update_W):
            raise ValueError('at least one of update_H / update_W must be True')
        for name, value in dict(
                sparsity_H=sparsity_H, inhibition_strength=inhibition_strength,
                cross_atom_inhibition_strength=cross_atom_inhibition_strength).items():
            if not value >= 0:
                raise ValueError(f'{name} must be >= 0, got {value!r}')
        if cross_atom_inhibition_strength > 0:
            cross_scale(cross_atom_inhibition_strength, self.n_atoms)  # raises for one atom
        self._initialize_matrices(V, keep_W)
        self._W, self._H = engine.fit_loop(
            self._Vp, self._W, self._H, int(n_iterations), float(sparsity_H),
            float(inhibition_strength), float(cross_atom_inhibition_strength), self._kernels,
            plan=self._plan, update_H=update_H, update_W=update_W,
            use_inhibition=inhibition_strength > 0,
            use_cross=cross_atom_inhibition_strength > 0)
        self.n_iterations_ = int(n_iterations)

    def fit(self, V, y=None, **kwargs):
        """sklearn-style front door: ``fit_batch`` (``y`` is ignored).  The
        minibatch and streaming drivers are not ported yet."""
        del y
        batch = [k for k in _MINIBATCH_KWARGS if k in kwargs]
        if batch:
            raise NotImplementedError(
                f'fit({batch[0]}=...) selects the minibatch/streaming drivers, '
                f'not ported to tnmf_tpu_torch yet; see {_ITEM.format(11)}')
        self.fit_batch(V, **kwargs)

    # ------------------------------------------------------------------
    # checkpoints of the JAX package (tnmf_tpu TransformInvariantNMF.save)
    # ------------------------------------------------------------------

    @classmethod
    def load(cls, path: str, *, device='cuda',
             dtype: Optional[torch.dtype] = None) -> 'TransformInvariantNMF':
        """Restore a model from the JAX package's ``.npz`` checkpoint
        (``W``, optional ``H``, ``n_atoms``, ``atom_shape``,
        ``inhibition_range``, ``reconstruction_mode``, ``dtype``).  ``dtype``
        defaults to the stored one.  Continue with ``fit(V, keep_W=True)``."""
        with np.load(path, allow_pickle=False) as data:
            if 'transform_type' in data and str(data['transform_type']) != 'shift':
                raise NotImplementedError(
                    f'transform_type={str(data["transform_type"])!r} is not ported to '
                    f'tnmf_tpu_torch yet; see {_ITEM.format(12)}')
            if dtype is None:
                dtype = _torch_dtype(str(data['dtype'])) if 'dtype' in data \
                    else _torch_dtype(str(data['W'].dtype))
            model = cls(n_atoms=int(data['n_atoms']),
                        atom_shape=tuple(int(a) for a in data['atom_shape']),
                        reconstruction_mode=str(data['reconstruction_mode']),
                        inhibition_range=(tuple(int(r) for r in data['inhibition_range'])
                                          if 'inhibition_range' in data else None),
                        device=device, dtype=dtype)
            H = data['H'] if 'H' in data else None
            model._W, model._H = from_numpy(data['W'], H, device=model.device, dtype=dtype)
            if H is not None:
                model._restore_plan()
        return model

    def _restore_plan(self):
        """Rebuild the plan from the restored W/H geometry so R / R_partial
        work right after loading a checkpoint that holds H."""
        tshape = tuple(self._H.shape[2:])
        mode = self._reconstruction_mode
        if mode == 'valid':
            sample = tuple(t - a + 1 for t, a in zip(tshape, self.atom_shape))
        elif mode == 'full':
            sample = tuple(t + a - 1 for t, a in zip(tshape, self.atom_shape))
        else:
            sample = tshape
        self._plan = ConvPlan.create(mode, sample, self.atom_shape)
        self._check_strategy()
