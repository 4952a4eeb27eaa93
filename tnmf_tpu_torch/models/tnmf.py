"""Transform-Invariant Non-Negative Matrix Factorization in PyTorch.

Port of the multiplicative-update fits of
:class:`tnmf_tpu.models.tnmf.TransformInvariantNMF`: the constructor (with
``logger`` / ``verbose``, ``h_init`` and the kernel/plain switch
``use_pallas``), ``fit`` (the JAX dispatch) / ``fit_batch`` with the L1 and
lateral-inhibition regularizers, the objectives of the JAX package
(``beta_loss``, ``mask``, ``l2_H``, ``ortho_W``) and every MU branch of the
JAX ``fit_batch`` (progress callbacks, chunked callbacks, ``record_energies``,
``tol``, ``extrapolate``, ``keep_H``, periodic checkpoints, dead-atom
revival), the minibatch and streaming drivers (``fit_minibatches`` with the
five algorithms of :class:`MiniBatchAlgorithm`, ``fit_stream``,
``partial_fit`` and :class:`MiniBatchTransformInvariantNMF`), the transform
groups (``transform_type``: flips, quarter turns, D4), the initializations
(the host-NumPy draw in the reference's RNG stream, so seeded fits match
the JAX package; ``init='device'``; ``w_init='patches'`` / ``'nndsvd'``;
``h_init='correlate'``), the encoder API (``set_dictionary``,
``transform``, ``fit_transform``, ``inverse_transform``), the ``W`` / ``H``
/ ``V`` / ``R`` accessors, ``R_partial``, the energy, ``.npz`` checkpoints
both packages read (``save`` / ``load``), the sklearn estimator protocol
(``get_params`` / ``set_params`` / ``__sklearn_tags__``) and the HALS
solvers (``fit_batch(solver='hals')``, :mod:`tnmf_tpu_torch.engine_hals`
and :mod:`tnmf_tpu_torch.engine_hals_conv`), data parallelism over the
samples (``mesh=``, ``shard_axis='samples'``; :mod:`tnmf_tpu_torch.parallel`)
for the MU and HALS full-batch fits and ``transform``, and model parallelism
over the atoms (``shard_axis='atoms'`` and ``'samples+atoms'``) for the MU
full-batch fits and ``transform``.  Every strategy
the JAX package picks off the TPU runs: direct convolution, FFT (with
either ``fft_policy``) and the plain-NMF matmuls.  Arguments of the JAX API
that select parts not ported yet raise ``NotImplementedError`` naming the
ROADMAP item that ports them.

Data may arrive as NumPy arrays or as ``torch.Tensor``s.  A tensor on the
model's device stays there, with no host copy: the non-negativity check runs
on the device and reads back one scalar, and the ``V`` property makes its
NumPy copy only when read (the JAX package keeps device arrays the same
way).  A tensor on another device is moved with ``.to(device)``.

The constructor takes the JAX package's positional order, and
``fit_batch``, ``fit_minibatches`` and ``partial_fit`` the JAX methods'.
The model lives on an explicit ``device`` (keyword-only, default
``'cuda'``, no automatic choice) in an explicit ``dtype`` (default
float32).
"""

from __future__ import annotations

import functools
import logging
import math
import os
from itertools import count, islice
from typing import Callable, Iterable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from .. import engine
from ..engine_minibatch import MiniBatchAlgorithm, minibatch_epoch
from ..ops import beta as beta_ops
from ..ops.inhibition import cross_scale, inhibition_kernels, resolve_inhibition_range
from ..ops.modes import ConvPlan
from ..ops.transforms import TransformGroup, make_group
from ..parallel.distributed import SampleShards
from ..parallel.sharding import (check_axis, check_mesh, data_rows, local_atoms, local_rows,
                                 not_ported)
from ..utils.initialization import nndsvda_init, patches_init

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


def _trace_buf(n_iterations: int) -> int:
    """Trace length of the ``tol`` / ``extrapolate`` loops with
    ``record_energies``: the JAX package's (the next power of two, at least
    64), so both packages' untrimmed traces have the same length.  Entries
    past the iterations run stay NaN and are trimmed off ``energies_``."""
    return max(64, 1 << max(int(n_iterations) - 1, 0).bit_length())


def _validate_tol(tol, tol_check_every):
    """``ValueError`` for a negative ``tol`` or a block shorter than one
    iteration."""
    if not tol >= 0:
        raise ValueError(f'tol must be >= 0, got {tol!r}')
    if not int(tol_check_every) >= 1:
        raise ValueError(
            f'tol_check_every must be >= 1, got {tol_check_every!r}')


def _as_input(x, device: torch.device):
    """Data as the model takes it: a tensor (detached, moved to ``device``
    if it lies elsewhere; no host copy), the blocks of a batch that spans
    processes (:class:`~tnmf_tpu_torch.parallel.distributed.SampleShards`,
    this process's block moved likewise) or a NumPy array."""
    if isinstance(x, SampleShards):
        return SampleShards(x.local.detach().to(device), x.mesh)
    if isinstance(x, torch.Tensor):
        return x.detach().to(device)
    return np.asarray(x)


def _all_ranks(ok: bool, x) -> bool:
    """``ok`` on every rank of the mesh of ``x`` where it spans processes
    (one ``all_reduce`` of the ranks' failures, so all of them raise or
    none), else ``ok``."""
    if not isinstance(x, SampleShards):
        return ok
    failed = torch.tensor(0.0 if ok else 1.0, device=x.local.device)
    torch.distributed.all_reduce(failed, group=x.mesh.get_group())
    return float(failed) == 0.0


def _assert_nonnegative(x) -> None:
    """``ValueError`` unless every entry is >= 0 (NaN fails); a tensor is
    checked on its device, one scalar read back; a batch that spans
    processes on every rank's block."""
    local = x.local if isinstance(x, SampleShards) else x
    ok = (bool(torch.all(local >= 0)) if isinstance(local, torch.Tensor)
          else bool(np.all(local >= 0)))
    if not _all_ranks(ok, x):
        raise ValueError('The input data V must be non-negative.')


def _np_dtype(x) -> np.dtype:
    """The NumPy dtype of an array's or a tensor's entries: the dtype of the
    host draws of H and W, as the JAX package draws them in ``V.dtype``."""
    if isinstance(x, (torch.Tensor, SampleShards)):
        return np.dtype(str(x.dtype).removeprefix('torch.'))
    return x.dtype


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _require_nonneg(**values) -> None:
    """``ValueError`` for a regularizer weight that is not >= 0 (NaN fails)."""
    for name, value in values.items():
        if not value >= 0:
            raise ValueError(f'{name} must be >= 0, got {value!r}')


def _stacked(samples: list):
    """A subsample of the stream as one batch: tensors stacked on their
    device (no host copy), anything else through ``np.asarray`` as the JAX
    package does."""
    if all(isinstance(x, torch.Tensor) for x in samples):
        return torch.stack(samples)
    return np.asarray(samples)


def _sequential_slices(length: int, batch_size: int) -> Iterable[slice]:
    """Contiguous sample slices of at most ``batch_size``."""
    for start in range(0, length, batch_size):
        yield slice(start, min(length, start + batch_size))


def _torch_dtype(name) -> torch.dtype:
    """The torch dtype of a ``torch.dtype`` or of the JAX package's dtype
    strings (a constructor argument or a checkpoint's ``dtype``)."""
    name = str(name).removeprefix('torch.')
    if name == 'float32':
        return torch.float32
    if name == 'float64':
        return torch.float64
    raise NotImplementedError(
        f'{name} storage is not ported to tnmf_tpu_torch yet (ROADMAP.md queue 2, item f)')


def from_numpy(W: np.ndarray, H: Optional[np.ndarray] = None, *, device,
               dtype: torch.dtype) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The JAX model's ``W`` (and ``H``), as NumPy arrays, as the port's
    tensors on ``device`` in ``dtype``.  Under a transform group ``H`` is
    the flat m-major ``(n_samples, n_atoms * n_transforms, *shift)`` layout
    both packages hold internally (the JAX model's ``_H``), not the
    ``H`` property's 4-axis view."""
    # a copy only where the array is not contiguous or not writable (a JAX
    # array's host view is read-only, and the minibatch epochs write H)
    Wt = torch.as_tensor(np.require(W, requirements=('C', 'W')), dtype=dtype, device=device)
    Ht = None if H is None else torch.as_tensor(np.require(H, requirements=('C', 'W')),
                                                dtype=dtype, device=device)
    return Wt, Ht


class TransformInvariantNMF:
    r"""Transform-invariant NMF via multiplicative updates, in PyTorch.

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
        A backend name of the JAX package or of the reference: the ``*fft``
        names request the FFT strategy, the others direct convolution, and
        ``'auto'`` picks by the JAX rule (:func:`tnmf_tpu_torch.engine.choose_strategy`).
        Plain NMF (``'full'`` mode, atoms as large as the samples) runs the
        matmul strategy.  The resolved strategy is ``_strategy``.
    logger : logging.Logger, optional
        Defaults to ``logging.getLogger('TransformInvariantNMF')``.
    verbose : {0, 1, 2, 3}, default 0
        The logger's level: 0 errors, 1 warnings, 2 info (the per-iteration
        energy lines; forces the per-iteration fit path), 3 debug.
    reconstruction_mode : {'valid', 'full', 'circular', 'reflect'}, default 'valid'
    dtype : torch.dtype or {'float32', 'float64'}, default torch.float32
        Compute dtype.  On CUDA float32 runs the hand-written kernels;
        float64, the reference precision, runs their plain versions (the
        JAX kernels' own dtype gate).
    mesh : torch.distributed.device_mesh.DeviceMesh, optional
        Data parallelism over the samples
        (:func:`tnmf_tpu_torch.parallel.make_mesh`, a 1-D mesh over the
        ranks of the default process group; every rank constructs the
        model and calls the same methods).  Each rank keeps its contiguous
        rows of V and H (the ``rank``-th of ``world`` equal blocks; the
        sample count must divide) and a replica of W; the W statistics,
        the energy and HALS's ``H^T H``/``H^T V`` are summed over the
        ranks in one ``all_reduce`` each (:mod:`tnmf_tpu_torch.engine`), so
        the fit is the mesh-free fit of the whole batch up to the order of
        the sums.  ``fit`` takes the whole batch on every rank, or each
        rank's block through
        :func:`tnmf_tpu_torch.parallel.distributed.distribute_samples`
        (``init='device'`` then, as in the JAX package).  The model's
        device must be of the mesh's device type (its rank's card, or the
        CPU).  Under a world above one ``V``, ``H``, ``R`` and
        ``reconstruction_err_`` raise (no property hides a collective),
        ``W`` reads on every rank, ``_energy_function()`` is the whole
        batch's and ``transform`` returns the rank's rows; the minibatch,
        streaming and online fits, ``save`` and ``checkpoint_every``
        raise ``NotImplementedError`` naming their sub-items of ROADMAP.md
        item 14e.

        With ``shard_axis='atoms'`` (a mesh from
        :func:`tnmf_tpu_torch.parallel.make_mesh_atoms`) each rank keeps its
        contiguous block of atoms of W (the ``rank``-th of ``world`` equal
        blocks; the atom count must divide), H's maps of them (m-major, so
        an atom's maps under a transform group stay on its rank) and all of
        V; with ``'samples+atoms'`` (:func:`~tnmf_tpu_torch.parallel.make_mesh_2d_atoms`)
        its data row's samples and its atom column's atoms.  Every sum over
        the atoms (the reconstruction, the cross-atom inhibition field,
        ``ortho_W``'s atom sum) is one ``all_reduce`` over the atom group
        (:mod:`tnmf_tpu_torch.engine`), so the fit is the mesh-free fit up
        to the order of the sums.  The host draw of W and H is the whole
        model's, cut to the rank's share, so a seeded fit starts where the
        mesh-free one starts.  Under a world above one ``W``, ``H``,
        ``R_partial``, ``inverse_transform(H)`` and ``export_serving``
        raise (the rank's atoms: ``_local_W()``); ``R`` reads under
        ``'atoms'``, where every rank's reconstruction is whole (one
        ``all_reduce``, called on every rank); ``solver='hals'`` raises the
        JAX package's ``ValueError``.
    seed : int, optional
        If given, W/H initialization (and dead-atom revival) draws from a
        private ``np.random.default_rng(seed)``; otherwise from the global
        NumPy stream in the reference's order (H, then W).  With
        ``init='device'`` it seeds the model's ``torch.Generator`` (0 when
        None).
    fft_policy : {'5-smooth', 'pow2'}, default '5-smooth'
        FFT length per axis of the fft strategy: the smallest 5-smooth
        length, or the next power of two, covering the linear correlation.
    init : {'host', 'device'}, default 'host'
        Keyword.  ``'host'`` draws W and H with NumPy (the reference's RNG
        stream, so seeded fits match the JAX package).  ``'device'`` draws
        ``1 - U[0, 1)`` on the model's device from one ``torch.Generator``
        the model holds (seeded with ``seed``, or 0), H then W (sum-normalised),
        no host draw and no upload; each fit advances it.  Its stream is not
        ``jax.random``'s, so parity with the JAX package is in
        distribution, not in bits.
    transform_type : {'shift', 'shift+flip', 'shift+rot90', 'shift+rot90+flip'}, default 'shift'
        Keyword.  The invariance group (:mod:`tnmf_tpu_torch.ops.transforms`):
        ``'shift'`` is the reference's model; the others also match every
        atom under mirror flips (``2**ndim`` transforms), quarter turns (4;
        square atoms in the last two axes) or both (D4, 8), each canonical
        atom learned once and tied across its copies.  H then holds one map
        per (atom, transform): the ``H`` property is ``(n_samples, n_atoms,
        n_transforms, *shift)``, inhibition acts per map and cross-atom
        inhibition spans all ``n_atoms * n_transforms`` maps.  A
        :class:`~tnmf_tpu_torch.ops.transforms.TransformGroup` is accepted
        too.  Every strategy and fit driver runs it on the kernels (K3, K4
        and K2 take the ``M*G`` maps); ``n_transforms`` is the group's size.
    w_init : {'random', 'patches', 'nndsvd'}, default 'random'
        Keyword.  ``'patches'`` starts each atom as a data window at a random
        (sample, position) of the host RNG (a tensor is cut on its device);
        ``'nndsvd'`` is sklearn's ``NMF(init='nndsvda')`` for W and H,
        plain-NMF geometry only (:mod:`tnmf_tpu_torch.utils.initialization`).
        Both need ``init='host'``.
    h_init : {'random', 'correlate'}, default 'random'
        Keyword.  ``'correlate'`` starts H at the matched filter
        :func:`tnmf_tpu_torch.engine.correlate_init_H`, computed on the
        device (no host draw, no RNG consumed for H); ``keep_H=True`` still
        wins.
    device : str or torch.device, default 'cuda'
        Keyword-only.  Where the factors live and the updates run.  On CUDA
        the hot operators are the hand-written kernels; on the CPU their
        plain versions.
    use_pallas : bool, optional
        Keyword.  The kernel/plain switch, the JAX package's name for it:
        ``None`` runs the kernels wherever the engine's gates take them
        (CUDA, float32); ``False`` runs their plain PyTorch versions on
        every device (the comparator of A/B runs); ``True`` is ``None`` on
        a CUDA model and raises ``ValueError`` on a CPU one, which has no
        kernel to force, and with ``beta_loss != 2``, as the JAX
        constructor does.
    beta_loss : float or {'frobenius', 'kullback-leibler', 'itakura-saito'}, default 2.0
        Keyword.  The objective ``D_beta(V || R)`` (:mod:`tnmf_tpu_torch.ops.beta`):
        2 the reference's Euclidean energy, 1 generalized KL, 0
        Itakura-Saito (which needs ``V > 0`` wherever the mask is
        positive), any float.  Every strategy runs it on the same kernels
        (K2 and K3 take the factor streams ``V * R**(beta-2)`` and
        ``R**(beta-1)``).  Checkpoints do not store it: pass it to
        :meth:`load` again.
    precision : {None, 'default', 'high', 'highest'}, optional
        Keyword.  The multiply precision of the contractions, the JAX
        package's switch of speed for accuracy; on the card
        (:func:`tnmf_tpu_torch.ops.precision.settings`) ``'default'`` and
        ``'high'`` run TF32 (JAX's "tensorfloat32" on a GPU: 10 mantissa
        bits per operand, float32 sums): cuDNN's convolutions and cuBLAS's
        products with TF32 on, and K3 and K2 in one TF32 pass on their
        tensor cores.  ``None`` and ``'highest'`` compute in full float32
        (3xTF32 in K3 and K2), the same bits.  K1, K4 and K5 compute in
        float32 at every level; on the CPU, and for float64, every level is
        full precision.  Any other value raises ``ValueError`` when a fit
        builds its plan, as in the JAX package.  Checkpoints do not store
        it; serving artifacts record it.

    shard_axis : {'samples', 'atoms', 'samples+atoms'}, default 'samples'
        Keyword.  The axis ``mesh`` splits: the samples, the atoms, or both
        on a 2-D mesh; it must be the axis the mesh was built for.  The JAX
        package's other axes ('spatial' and 'both') raise
        ``NotImplementedError`` naming ROADMAP.md item 14e-iii.

    ``get_params`` / ``set_params`` hand
    the constructor's arguments back as given (the sklearn protocol, with
    ``device`` among them).
    """

    def __init__(self, n_atoms: int, atom_shape: Tuple[int, ...],
                 inhibition_range: Union[int, Tuple[int, ...], None] = None,
                 backend: str = 'auto', logger: Optional[logging.Logger] = None,
                 verbose: int = 0, reconstruction_mode: str = 'valid',
                 dtype: Union[torch.dtype, str] = torch.float32, mesh=None,
                 seed: Optional[int] = None, fft_policy: str = '5-smooth', *,
                 init: str = 'host', transform_type: Union[str, TransformGroup] = 'shift',
                 w_init: str = 'random', h_init: str = 'random', device='cuda',
                 use_pallas: Optional[bool] = None, beta_loss: Union[float, str] = 2.0,
                 precision: Optional[str] = None, shard_axis: str = 'samples'):
        # the arguments as given, for get_params / set_params / clone
        self._init_params = dict(
            n_atoms=n_atoms, atom_shape=atom_shape, inhibition_range=inhibition_range,
            backend=backend, logger=logger, verbose=verbose,
            reconstruction_mode=reconstruction_mode, dtype=dtype, seed=seed,
            fft_policy=fft_policy, init=init, transform_type=transform_type, w_init=w_init,
            h_init=h_init, device=device, use_pallas=use_pallas, beta_loss=beta_loss,
            precision=precision, mesh=mesh, shard_axis=shard_axis)
        self.n_atoms = int(n_atoms)
        self.atom_shape = tuple(int(a) for a in atom_shape)
        self._group = make_group(transform_type, self.atom_shape)
        self.transform_type = (transform_type if isinstance(transform_type, str)
                               else self._group.name)
        self.n_transforms = 1 if self._group is None else self._group.size
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
        self._fft_policy = fft_policy
        # checked where a plan is built (ConvPlan), as the JAX package does
        self._precision = precision
        if init not in ('host', 'device'):
            raise ValueError(f"init must be 'host' or 'device', got {init!r}")
        if w_init not in ('random', 'patches', 'nndsvd'):
            raise ValueError(
                f"w_init must be 'random', 'patches' or 'nndsvd', got {w_init!r}")
        if w_init != 'random' and init == 'device':
            raise ValueError(
                f"w_init={w_init!r} is a data-dependent host-side scheme; "
                "it requires init='host'")
        if w_init == 'nndsvd' and self._group is not None:
            raise ValueError(
                "w_init='nndsvd' applies to the plain-NMF geometry only and "
                'does not combine with transform groups')
        if h_init not in ('random', 'correlate'):
            raise ValueError(
                f"h_init must be 'random' or 'correlate', got {h_init!r}")
        if h_init == 'correlate' and w_init == 'nndsvd':
            raise ValueError(
                "w_init='nndsvd' already initializes H from the SVD; it "
                "does not combine with h_init='correlate'")
        self._init = init
        self._w_init = w_init
        self._h_init = h_init
        self.device = torch.device(device)
        self.dtype = _torch_dtype(dtype)
        check_axis(shard_axis)
        self._mesh, self._shard_axis = mesh, shard_axis
        # the data and atom groups (None where the mesh does not split that
        # axis) and the mesh's size
        self._pg, self._ag, self._world = None, None, 1
        if mesh is not None:
            self._pg, self._ag, self._world = self._mesh_group(mesh)
        if use_pallas not in (None, False, True):
            raise ValueError(f'use_pallas must be None, False or True, got {use_pallas!r}')
        if use_pallas and self.device.type == 'cpu':
            raise ValueError('use_pallas=True forces the CUDA kernels, and a CPU model has '
                             'none; pass use_pallas=None or False')
        self._use_pallas = use_pallas
        if self._group is not None and use_pallas is True:
            raise ValueError(
                'use_pallas=True with transform_type != "shift" raises, as in the JAX package, '
                'whose Pallas kernels implement the canonical (untied) statistics; the default '
                'use_pallas=None runs the kernels on the card with every transform group')
        self._beta = beta_ops.resolve_beta_loss(beta_loss)
        if self._beta != 2.0 and use_pallas is True:
            raise ValueError(
                'use_pallas=True with beta_loss != 2 raises, as in the JAX package, whose '
                'Pallas kernels implement the Euclidean (beta = 2) statistics; the default '
                'use_pallas=None runs the kernels on the card for every beta_loss')
        self._rng = np.random.default_rng(seed) if seed is not None else np.random
        # init='device': one generator on the model's device, made at the
        # first draw (a CUDA generator needs the card)
        self._device_seed = 0 if seed is None else int(seed)
        self._device_gen: Optional[torch.Generator] = None
        self._row_draws = 0  # H draws of init='device' under a mesh (_device_rows)

        self._logger = (logger if logger is not None
                        else logging.getLogger(self.__class__.__name__))
        self._logger.setLevel(
            [logging.ERROR, logging.WARNING, logging.INFO, logging.DEBUG][verbose])
        self._logger.debug('Using %s backend (strategy request: %s).', backend,
                           self._strategy_request)

        self._plan: Optional[ConvPlan] = None
        # resolved per fit: 'conv', 'fft' or 'dot'; (base, group) under a group
        self._strategy: Optional[engine.Strategy] = None
        self._W: Optional[torch.Tensor] = None
        self._H: Optional[torch.Tensor] = None
        self._V = None   # the data as given (array or tensor), for the V property
        self._Vd: Optional[torch.Tensor] = None
        self._Vp: Optional[torch.Tensor] = None  # prepared (mode-extended) data
        self._mask_d: Optional[torch.Tensor] = None  # per-entry mask/weights of the fit
        # iteration stamp of the checkpoint this model was loaded from
        self.last_checkpoint_iteration_: Optional[int] = None
        # iterations the last fit_batch ran (fewer than asked when tol or a
        # callback stopped it)
        self.n_iterations_: Optional[int] = None
        # online-learning state of partial_fit: the averaged (neg, pos) W
        # statistics carried across calls, and the steps taken
        self._sag_stat_ = None
        self.n_steps_: int = 0

    def _mesh_group(self, mesh) -> tuple:
        """``(data group, atom group, world size)`` of a ``DeviceMesh``
        whose device type is the model's and whose axes are the shard
        axis's (:func:`~tnmf_tpu_torch.parallel.sharding.check_mesh`): the
        data group None under ``'atoms'``, the atom group None under
        ``'samples'``."""
        from torch.distributed.device_mesh import DeviceMesh
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(
                f'mesh must be a torch.distributed DeviceMesh '
                f'(tnmf_tpu_torch.parallel.make_mesh), got {type(mesh).__name__}')
        check_mesh(mesh, self._shard_axis)
        if mesh.device_type != self.device.type:
            raise ValueError(
                f'the mesh computes on {mesh.device_type!r} devices and the model on '
                f'{self.device.type!r}: pass device={mesh.device_type!r}, or build the '
                f'mesh with make_mesh(devices={self.device.type!r})')
        if self._shard_axis == 'samples':
            return mesh.get_group(), None, mesh.size()
        if self._shard_axis == 'atoms':
            return None, mesh.get_group(), mesh.size()
        return mesh.get_group('data'), mesh.get_group('atoms'), mesh.size()

    def _local_only(self, what: str) -> None:
        """``RuntimeError`` where ``what`` would need the rows of other
        ranks (a world above one): no property hides a collective."""
        if self._world > 1:
            raise RuntimeError(
                f'{what} is not host-addressable under a process-spanning mesh; '
                'access the per-process shards (this rank\'s rows: model._H, '
                'model._Vd) instead')

    def _whole_W(self, what: str) -> None:
        """``RuntimeError`` where ``what`` would need the atoms of other
        ranks (an atom axis in a world above one)."""
        if self._ag is not None and self._world > 1:
            raise RuntimeError(
                f'{what} is not host-addressable under a process-spanning mesh over the '
                "atoms; access the per-process shards (this rank's atoms: "
                'model._local_W(), its maps: model._H) instead')

    def _not_under_mesh(self, what: str, item: str) -> None:
        """``NotImplementedError`` naming the sub-item of item 14e that
        ports ``what`` to a world above one."""
        if self._world > 1:
            raise not_ported(f'{what} under a mesh of {self._world} processes', item)

    # ------------------------------------------------------------------
    # accessors (reference TransformInvariantNMF.py:188-215)
    # ------------------------------------------------------------------

    @property
    def n_iter_(self) -> Optional[int]:
        """sklearn-style alias of ``n_iterations_``."""
        return self.n_iterations_

    @property
    def reconstruction_err_(self) -> float:
        """sklearn ``NMF``'s reconstruction error of the last fit,
        ``sqrt(2 * D_beta(V || R))`` (``||V - R||_F`` at beta = 2; one
        reconstruction)."""
        if self._plan is None:
            raise RuntimeError('reconstruction_err_ requires a fitted model')
        self._local_only('reconstruction_err_')
        return float(np.sqrt(max(2.0 * self._energy_function(), 0.0)))

    @property
    def W(self) -> np.ndarray:
        """The dictionary; under a world above one with an atom axis it
        raises: each rank holds its own atoms (``_local_W()``)."""
        self._whole_W('W')
        return self._local_W()

    def _local_W(self) -> np.ndarray:
        """This rank's atoms of W (all of them without an atom axis)."""
        return self._W.cpu().numpy()

    @property
    def H(self) -> np.ndarray:
        """Activations ``(n_samples, n_atoms, *shift)``; under a transform
        group ``(n_samples, n_atoms, n_transforms, *shift)``, a view of the
        flat m-major maps.  A host copy: the minibatch epochs write H in
        place.  Under a world above one it raises: each rank holds its own
        rows (``_H``)."""
        self._local_only('H')
        return self._local_H()

    def _local_H(self) -> np.ndarray:
        """This rank's share of H (all of it without a mesh: its rows, and
        under an atom axis its atoms' maps) as the ``H`` property shapes
        them."""
        H = self._H.to('cpu', copy=True).numpy()
        if self.n_transforms > 1:
            H = H.reshape((H.shape[0], -1, self.n_transforms) + H.shape[2:])
        return H

    @property
    def V(self) -> np.ndarray:
        """The last fit's data as a NumPy array (a tensor's host copy is made
        here, on each read)."""
        self._local_only('V')
        if isinstance(self._V, torch.Tensor):
            return self._V.detach().cpu().numpy()
        return self._V

    @property
    def R(self) -> np.ndarray:
        """The reconstruction; under ``shard_axis='atoms'`` every rank's is
        whole once summed over the atom group (one ``all_reduce``: read it
        on every rank), elsewhere a world above one raises."""
        if self._shard_axis != 'atoms':
            self._local_only('R')
        return engine.reconstruct(self._W, self._H, plan=self._plan, strategy=self._strategy,
                                  atom_group=self._ag).cpu().numpy()

    def R_partial(self, i_atom: int) -> np.ndarray:
        """The reconstruction of one atom (with all its tied copies under a
        transform group)."""
        self._local_only('R_partial')
        self._whole_W('R_partial')
        return engine.partial_reconstruct(
            self._W, self._H, plan=self._plan, i_atom=int(i_atom),
            strategy=self._strategy).cpu().numpy()

    def _energy(self) -> torch.Tensor:
        """The fit's objective (its ``beta_loss``, weighted by its mask)
        as a 0-d tensor on the device; under a mesh the whole batch's (one
        ``all_reduce``, called on every rank)."""
        return engine.energy(self._Vd, self._W, self._H, self._mask_d, plan=self._plan,
                             strategy=self._strategy, beta=self._beta, process_group=self._pg,
                             atom_group=self._ag)

    def _energy_function(self) -> float:
        return float(self._energy())

    def _assert_beta_domain(self, V, mask: Optional[torch.Tensor] = None) -> None:
        """``beta_loss <= 0`` (the Itakura-Saito family) needs strictly
        positive data, as in sklearn's ``NMF``: ``D_beta(v || r)`` diverges
        as v -> 0.  Masked-out entries are exempt, they never enter the
        objective.  A tensor is checked on its device, one scalar read
        back; a batch that spans processes on every rank's block."""
        if self._beta > 0:
            return
        local = V.local if isinstance(V, SampleShards) else V
        positive = local > 0
        if mask is not None:
            observed = mask > 0
            if not isinstance(local, torch.Tensor):
                observed = observed.cpu().numpy()
            positive = positive | ~observed
        if not _all_ranks(bool(positive.all()), V):
            raise ValueError(
                f'beta_loss = {self._beta} (Itakura-Saito family) requires '
                'strictly positive data, but V contains zeros')

    def _prepare_mask(self, mask, V) -> Optional[torch.Tensor]:
        """A per-entry mask (0/1 for missing data, nonnegative float
        weights; an array or a tensor) of V's rank, broadcastable to V, as
        a tensor on the model's device in its dtype, or None.  Under a mesh
        it has V's full shape (the JAX package's rule); for a batch that
        spans processes it is distributed likewise, and the result is this
        rank's block."""
        if mask is None:
            return None
        if isinstance(V, SampleShards):
            if not isinstance(mask, SampleShards):
                raise ValueError(
                    'under a process-spanning global V the mask must itself '
                    'be a process-spanning global array of the same shape; '
                    'wrap the per-host slice with '
                    'parallel.distributed.distribute_samples(mesh, mask_local)')
            if tuple(mask.shape) != tuple(V.shape):
                raise ValueError(
                    f'global mask of shape {tuple(mask.shape)} must match V '
                    f'{tuple(V.shape)} (broadcasting is not supported across '
                    f'process-spanning shards)')
            local = mask.local.to(self.device)
            if not _all_ranks(not bool((local < 0).any()), mask):
                raise ValueError('mask entries must be nonnegative '
                                 '(0/1 for missing data, floats for weights)')
            return self._tensor(local)
        mask = _as_input(mask, self.device)
        if self._mesh is not None and tuple(mask.shape) != tuple(V.shape):
            raise ValueError(
                'under a mesh the mask must have the full data shape '
                f'{tuple(V.shape)} (broadcasting across shards is not '
                f'supported), got {tuple(mask.shape)}')
        if mask.ndim != V.ndim:
            raise ValueError(
                f'mask must have the same rank as V ({V.ndim}), got '
                f'{mask.ndim}; use singleton axes to broadcast')
        try:
            np.broadcast_shapes(tuple(mask.shape), tuple(V.shape))
        except ValueError as e:
            raise ValueError(
                f'mask of shape {tuple(mask.shape)} does not broadcast to V '
                f'{tuple(V.shape)}') from e
        if bool((mask < 0).any()):
            raise ValueError('mask entries must be nonnegative '
                             '(0/1 for missing data, floats for weights)')
        return self._tensor(mask)

    def _check_data(self, V, mask) -> tuple:
        """The data and the mask of a fit as the model takes them, after
        the JAX package's checks: V nonnegative, the mask valid, and the
        beta_loss domain."""
        V = _as_input(V, self.device)
        _assert_nonnegative(V)
        mask = self._prepare_mask(mask, V)
        self._assert_beta_domain(V, mask)
        return V, mask

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------

    def _strategy_for(self, plan: ConvPlan) -> engine.Strategy:
        """The requested backend resolved for ``plan`` (the JAX
        ``choose_strategy`` / ``resolve_strategy``), the tuple ``(base,
        group)`` under a transform group."""
        strategy = self._strategy_request
        if strategy == 'auto':
            strategy = engine.choose_strategy(plan)
        strategy = engine.resolve_strategy(strategy, plan)
        engine.require_ported(strategy)
        return strategy if self._group is None else (strategy, self._group)

    def _check_strategy(self):
        """Resolve the requested backend for the current plan into
        ``_strategy``."""
        self._strategy = self._strategy_for(self._plan)

    def _plan_for(self, sample_shape) -> ConvPlan:
        return ConvPlan.create(self._reconstruction_mode, sample_shape, self.atom_shape,
                               self._fft_policy, precision=self._precision)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def _device_uniform(self, shape: tuple) -> torch.Tensor:
        """``1 - U[0, 1)`` of ``shape`` in the model's dtype, drawn on its
        device from the model's generator (``init='device'``)."""
        if self._device_gen is None:
            self._device_gen = torch.Generator(device=self.device)
            self._device_gen.manual_seed(self._device_seed)
        U = torch.rand(shape, generator=self._device_gen, dtype=self.dtype, device=self.device)
        return U.neg_().add_(1)

    def _device_rows(self, shape: tuple, rows: slice,
                     maps: Optional[slice] = None) -> torch.Tensor:
        """The rows ``rows`` (and under an atom axis the maps ``maps``) of a
        ``1 - U[0, 1)`` draw of ``shape`` under a mesh (``init='device'``):
        each sample's row drawn on the model's device from a seed of its own
        (the model's seed, the count of such draws and the row's index), so
        that the ranks' shares put together are a world of one's draw
        whatever the world, and no rank draws another's rows or the whole
        batch.  With ``maps`` each row is drawn whole into a buffer of one
        row and its maps kept."""
        self._row_draws += 1
        gen = torch.Generator(device=self.device)
        n_maps = shape[1] if maps is None else maps.stop - maps.start
        out = torch.empty((rows.stop - rows.start, n_maps) + tuple(shape[2:]), dtype=self.dtype,
                          device=self.device)
        row_buf = None if maps is None else torch.empty(tuple(shape[1:]), dtype=self.dtype,
                                                        device=self.device)
        for i, row in enumerate(range(rows.start, rows.stop)):
            state = np.random.SeedSequence((self._device_seed, self._row_draws, row))
            gen.manual_seed(int(state.generate_state(1, np.uint64)[0] >> np.uint64(1)))
            if row_buf is None:
                out[i].uniform_(generator=gen)
            else:
                out[i] = row_buf.uniform_(generator=gen)[maps]
        return out.neg_().add_(1)

    def _share(self, n_samples: int) -> tuple:
        """``(rows, atoms)`` of this rank under the model's mesh: slices of
        the samples and of the atoms, each None where the mesh does not
        split that axis (the JAX package's divisibility errors)."""
        if self._mesh is None:
            return None, None
        if self._shard_axis == 'samples':
            return local_rows(self._mesh, n_samples), None
        rows = (data_rows(self._mesh, n_samples) if self._shard_axis == 'samples+atoms'
                else slice(0, n_samples))
        return rows, local_atoms(self._mesh, self.n_atoms)

    def _initialize_matrices(self, V, keep_W: bool, keep_H: bool = False,
                             mask: Optional[torch.Tensor] = None):
        """W, H and the prepared data for a fit of ``V`` (a NumPy array, or
        a tensor on the model's device, kept there, or the blocks of a batch
        that spans processes) and its ``mask`` (from :meth:`_prepare_mask`).

        Under a mesh W is drawn whole and alike on every rank, and H and the
        data are this rank's rows (:func:`~tnmf_tpu_torch.parallel.sharding.local_rows`):
        the host draw is the whole batch's, as without a mesh, cut to the
        rows, so a seeded mesh fit starts where the JAX fit starts;
        ``init='device'`` draws the rows alone (:meth:`_device_rows`).
        Under an atom axis W and H are cut likewise to the rank's atoms and
        their maps (m-major), ``init='device'`` drawing H's rows whole one
        at a time; ``w_init='patches'`` and ``'nndsvd'`` are computed whole
        and cut, ``h_init='correlate'`` runs on the rank's atoms."""
        rows = atoms = maps = None
        if isinstance(V, SampleShards):
            if self._mesh is None or self._init != 'device':
                raise ValueError(
                    "a process-spanning global array requires mesh=... and "
                    "init='device' (no host ever holds the full batch)")
            if self._ag is not None:
                raise not_ported('a process-spanning global array under '
                                 f'shard_axis={self._shard_axis!r}', '14e-iv')
            rows = local_rows(self._mesh, V.shape[0])
            local = V.local
            if local.dtype != self.dtype:
                raise ValueError(
                    f'global array dtype {local.dtype} must match the compute dtype '
                    f'{self.dtype}')
        elif self._mesh is not None:
            rows, atoms = self._share(V.shape[0])
            local = V[rows]
            mask = None if mask is None else mask[rows].clone()
        else:
            local = V
        self._V = local if isinstance(V, SampleShards) else V
        self._n_samples = int(V.shape[0])
        self._plan = self._plan_for(V.shape[2:])
        self._check_strategy()

        if atoms is not None:
            maps = slice(atoms.start * self.n_transforms, atoms.stop * self.n_transforms)
        keep = keep_W and self._W is not None
        if keep:
            n_atoms = self.n_atoms if atoms is None else atoms.stop - atoms.start
            expected = (n_atoms, V.shape[1]) + self.atom_shape
            if tuple(self._W.shape) != expected:
                raise ValueError(
                    f'keep_W: existing dictionary of shape {tuple(self._W.shape)} '
                    f'does not match the new data (expected {expected}); '
                    f'the channel count must stay constant across fits')
        # H holds one map per (atom, transform)
        h_shape = (V.shape[0], self.n_atoms * self.n_transforms) + self._plan.transform_shape
        w_shape = (self.n_atoms, V.shape[1]) + self.atom_shape
        keep_h = keep_H and self._H is not None
        if keep_h:
            expected_h = h_shape if rows is None else (local.shape[0],) + h_shape[1:]
            if maps is not None:
                expected_h = expected_h[:1] + (maps.stop - maps.start,) + expected_h[2:]
            if tuple(self._H.shape) != expected_h:
                raise ValueError(
                    f'keep_H: existing activations of shape {tuple(self._H.shape)} '
                    f'do not match the new data (expected {expected_h}); '
                    f'exact resume requires the same batch')
        # host-side init replicating the reference RNG stream exactly (H then
        # W, 1 - U[0,1); _Backend.py:83-98), in V's dtype, so seeded runs
        # match; keep_H skips the H draw, h_init='correlate' computes H on
        # the device below, and init='device' draws both there
        draw_dtype = _np_dtype(V)
        if keep_h:
            H = self._H
        elif self._h_init == 'correlate':
            H = None
        elif self._init == 'device' and rows is None:
            H = self._device_uniform(h_shape)
        elif self._init == 'device':
            H = (self._device_rows(h_shape, rows) if maps is None
                 else self._device_rows(h_shape, rows, maps))
        else:
            H = np.asarray(1 - self._rng.random(h_shape), dtype=draw_dtype)
        if keep:
            W = self._W
        elif self._init == 'device':
            W = self._device_uniform(w_shape)
            W /= W.sum(dim=self._axes_W_normalization, keepdim=True)
        elif self._w_init == 'patches':
            # atoms start as data windows; a tensor is cut on its device
            W = patches_init(V, self.n_atoms, self.atom_shape, self._rng)
            if isinstance(W, torch.Tensor):
                W = W / W.sum(dim=self._axes_W_normalization, keepdim=True)
            else:
                W = W.astype(draw_dtype)
                W /= W.sum(axis=self._axes_W_normalization, keepdims=True)
        elif self._w_init == 'nndsvd':
            W, H = self._nndsvd(V, H, keep_h, draw_dtype)
        else:
            W = np.asarray(1 - self._rng.random(w_shape), dtype=draw_dtype)
            W /= W.sum(axis=self._axes_W_normalization, keepdims=True)
        if rows is not None and self._init == 'host' and H is not None and not keep_h:
            H = H[rows]  # the whole batch's host draw, cut to this rank's rows
            if maps is not None:  # and to its atoms' maps
                H = np.ascontiguousarray(H[:, maps])
        if atoms is not None and not keep:
            W = W[atoms]  # the whole dictionary, cut to this rank's atoms
        self._W = self._tensor(W)
        self._Vd = self._tensor(local)
        self._mask_d = mask
        # the prepared-data slot, as the JAX package fills it: prepare(V);
        # with a mask at beta = 2 the loop-invariant prepare(mask * V); the
        # canonical V where the beta factors are formed canonically (fft,
        # and every masked fit at beta != 2)
        prepare = functools.partial(engine.prepare_data, plan=self._plan,
                                    strategy=self._strategy)
        canonical = self._beta != 2.0 and (
            mask is not None or not engine.get_ops(self._strategy).FACTORS_IN_PREPARED)
        if canonical:
            self._Vp = self._Vd
        elif mask is not None:
            self._Vp = prepare(self._Vd * mask)
        else:
            self._Vp = prepare(self._Vd)
        if H is None:
            # the matched filter of the masked objective is prepare(mask * V)
            # at beta = 2; prepare(V) where the slot holds the canonical V
            Vp0 = prepare(self._Vd) if canonical else self._Vp
            H = engine.correlate_init_H(Vp0, self._Vd, self._W, plan=self._plan,
                                        strategy=self._strategy, process_group=self._pg,
                                        atom_group=self._ag)
        self._H = self._tensor(H)
        # built in float64, cast to the compute dtype
        self._kernels = tuple(self._tensor(k) for k in self._inhibition_kernels_1D)

    def _nndsvd(self, V, H, keep_h: bool, draw_dtype):
        """``(W, H)`` of ``w_init='nndsvd'`` (sklearn's ``nndsvda``) from the
        host float64 SVD of V, as the JAX package computes it: W
        sum-normalised, H (unless kept) rescaled so that the product is the
        SVD's."""
        if math.prod(self._plan.transform_shape) != 1:
            raise ValueError(
                "w_init='nndsvd' applies to the plain-NMF geometry only "
                "(reconstruction_mode='full' with atom_shape == sample_shape); "
                "use w_init='patches' for transform-invariant problems")
        X = V.detach().cpu().numpy() if isinstance(V, torch.Tensor) else V
        A, B = nndsvda_init(np.asarray(X, dtype=np.float64).reshape(V.shape[0], -1),
                            self.n_atoms)
        W = B.reshape((self.n_atoms, V.shape[1]) + self.atom_shape)
        s = W.sum(axis=self._axes_W_normalization, keepdims=True)
        W = (W / s).astype(draw_dtype)
        if not keep_h:
            H = (A * s.reshape(1, self.n_atoms)).reshape(
                (V.shape[0], self.n_atoms) + self._plan.transform_shape).astype(draw_dtype)
        return W, H

    def _check_regs(self, sparsity_H, inhibition_strength, cross_atom_inhibition_strength,
                    l2_H=0., ortho_W=0.):
        _require_nonneg(sparsity_H=sparsity_H, inhibition_strength=inhibition_strength,
                        cross_atom_inhibition_strength=cross_atom_inhibition_strength,
                        l2_H=l2_H, ortho_W=ortho_W)
        if cross_atom_inhibition_strength > 0:
            # raises for one map; a transform group gives each atom G maps
            cross_scale(cross_atom_inhibition_strength, self.n_atoms * self.n_transforms)

    def _regs(self, sparsity_H, inhibition_strength, cross_atom_inhibition_strength) -> tuple:
        """The engine's regularizer arguments: the weights and the
        inhibition kernels."""
        return (float(sparsity_H), float(inhibition_strength),
                float(cross_atom_inhibition_strength), self._kernels)

    def _flags(self, inhibition_strength, cross_atom_inhibition_strength) -> dict:
        """The engine's keywords for the current fit: plan, strategy, the
        inhibition terms, the kernel/plain switch and the beta_loss."""
        return dict(plan=self._plan, strategy=self._strategy,
                    use_inhibition=inhibition_strength > 0,
                    use_cross=cross_atom_inhibition_strength > 0,
                    use_pallas=self._use_pallas is not False, beta=self._beta)

    def _objective(self, l2_H, ortho_W) -> dict:
        """The engine's objective keywords besides ``beta``: the fit's mask
        and the two penalty weights, None where absent (a zero weight
        leaves the default path as it was)."""
        return dict(mask=self._mask_d, l2_H=float(l2_H) if l2_H > 0 else None,
                    ortho_W=float(ortho_W) if ortho_W > 0 else None)

    # ------------------------------------------------------------------
    # the sklearn estimator protocol (tnmf_tpu's get_params / set_params):
    # the model composes with sklearn.base.clone, Pipeline and the CV tools
    # ------------------------------------------------------------------

    def get_params(self, deep: bool = True) -> dict:
        """The constructor's arguments as given (``device`` among them)."""
        del deep  # no nested estimators
        return dict(self._init_params)

    def set_params(self, **params) -> 'TransformInvariantNMF':
        """Re-run the constructor with ``params`` over the current arguments,
        which drops any fitted state (configure before ``fit``, as sklearn
        does).  Unknown names raise ``ValueError``."""
        unknown = set(params) - set(self._init_params)
        if unknown:
            raise ValueError(
                f'invalid parameter(s) {sorted(unknown)} for estimator '
                f'{type(self).__name__}; valid parameters are '
                f'{sorted(self._init_params)}')
        self.__init__(**{**self._init_params, **params})
        return self

    def __sklearn_tags__(self):
        """Estimator tags (the sklearn >= 1.6 protocol).  sklearn is imported
        here, when sklearn asks: the package does not need it."""
        from sklearn.utils import Tags, TargetTags, TransformerTags
        return Tags(estimator_type='transformer', target_tags=TargetTags(required=False),
                    transformer_tags=TransformerTags(), regressor_tags=None,
                    classifier_tags=None, non_deterministic=False,
                    no_validation=True)  # V is an n-d tensor, not a 2-D X

    # ------------------------------------------------------------------
    # batch fitting (reference fit_batch, TransformInvariantNMF.py:282-348)
    # ------------------------------------------------------------------

    def fit_batch(self, V, n_iterations: int = 1000, update_H: bool = True,
                  update_W: bool = True, keep_W: bool = False,
                  sparsity_H: float = 0., inhibition_strength: float = 0.,
                  cross_atom_inhibition_strength: float = 0., l2_H: float = 0.,
                  ortho_W: float = 0.,
                  progress_callback: Optional[Callable[['TransformInvariantNMF', int],
                                                       bool]] = None,
                  callback_interval: int = 1, record_energies: bool = False,
                  keep_H: bool = False, checkpoint_every: Optional[int] = None,
                  checkpoint_path: Optional[str] = None, tol: Optional[float] = None,
                  tol_check_every: int = 10, mask=None, revive_every: Optional[int] = None,
                  revive_threshold: float = 1e-4, extrapolate=False, solver: str = 'mu',
                  hals_inner='auto', sparsity_W: float = 0., l2_W: float = 0.):
        """Full-batch multiplicative-update factorization of ``V``
        (``(n_samples, n_channels, *sample_shape)``, nonnegative), with the
        JAX package's arguments in its order.

        ``n_iterations`` H+W updates; ``update_H`` / ``update_W`` freeze a
        factor; ``keep_W`` / ``keep_H`` continue from the current
        dictionary / activations (``keep_H`` needs the same batch shape);
        ``sparsity_H`` is the L1 weight on the activations;
        ``inhibition_strength`` and ``cross_atom_inhibition_strength``
        weight the same-atom and cross-atom lateral inhibition.

        * ``progress_callback(model, iteration) -> bool`` runs after every
          iteration and aborts the fit when it returns a false value; with
          ``callback_interval=k > 1`` it runs after iterations k-1, 2k-1, …
          only, with plain loops in between.
        * ``record_energies`` stores the energy after every iteration in
          ``energies_`` (one more reconstruction per iteration).
        * ``tol`` stops once the relative energy improvement over a block of
          ``tol_check_every`` iterations, ``(e_prev - e) / e_init``, drops
          below it (:func:`tnmf_tpu_torch.engine.fit_loop_tol`).
        * ``extrapolate`` (True, or an initial momentum weight in (0, 1);
          True means 0.5) runs the extrapolated MU with restarts
          (:func:`tnmf_tpu_torch.engine.fit_loop_extrapolated`), with or
          without ``tol``.
        * ``checkpoint_every=k`` with ``checkpoint_path`` saves W, H and the
          iteration count atomically every k iterations; exact resume is
          ``m = load(path); m.fit_batch(V, n_iterations=total -
          m.last_checkpoint_iteration_, keep_W=True, keep_H=True)``.
        * ``revive_every=k`` re-draws, every k iterations, the atoms whose
          activation mass fell below ``revive_threshold`` times the mean
          (:func:`tnmf_tpu_torch.utils.atoms.revive_dead_atoms`).

        The objective is the model's ``beta_loss``, with two penalties and
        a weighting (the JAX package's):

        * ``l2_H`` adds the ridge penalty ``(l2_H/2) * ||H||^2``;
        * ``ortho_W`` adds the cross-atom orthogonality penalty
          ``(ortho_W/2) * sum_{m != m'} <W_m, W_m'>`` (dictionary
          diversity);
        * ``mask`` (V's rank, broadcastable to V; an array or a tensor)
          weights every entry of the objective: 0/1 for missing data,
          nonnegative floats for weights.  Masked-out entries never enter
          the fit, so their values do not matter.

        ``solver='hals'`` replaces the multiplicative updates with exact
        block coordinate descent (fast HALS, sklearn's ``NMF(solver='cd')``;
        the JAX package's): on the plain-NMF geometry
        (``prod(transform_shape) == 1``) every component of H and of W is
        solved exactly per sweep (:mod:`tnmf_tpu_torch.engine_hals`), and on
        the shift-invariant geometry under ``reconstruction_mode='full'``
        H takes exact phase-blocked sweeps and W a multiplicative step
        (:mod:`tnmf_tpu_torch.engine_hals_conv`).  The sweeps run through
        K5 (:func:`~tnmf_tpu_torch.kernels.hals.hals_sweep`).
        ``hals_inner`` sets the sweeps per pair of Gram matrices (``'auto'``:
        the JAX package's rule, 1 on the shift-invariant geometry);
        ``sparsity_W`` / ``l2_W`` are the dictionary's L1 / L2 weights
        (plain-NMF HALS only).  HALS leaves W un-normalised, composes with
        ``sparsity_H``, ``l2_H``, the update flags, ``keep_W`` / ``keep_H``,
        ``tol``, ``record_energies``, callbacks and checkpoints, and
        rejects what the JAX package rejects (``ValueError``): inhibition,
        ``ortho_W``, ``beta_loss != 2``, ``mask``, ``extrapolate``,
        ``revive_every``, transform groups and other geometries.

        ``n_iterations_`` holds the count actually run.
        """
        V, mask = self._check_data(V, mask)
        _require(update_H or update_W, 'at least one of update_H / update_W must be True')
        self._check_regs(sparsity_H, inhibition_strength, cross_atom_inhibition_strength,
                         l2_H, ortho_W)
        _require_nonneg(sparsity_W=sparsity_W, l2_W=l2_W)
        _require(callback_interval >= 1, 'callback_interval must be >= 1')
        self._check_solver(solver, sparsity_W, l2_W, inhibition_strength,
                           cross_atom_inhibition_strength, ortho_W, mask, extrapolate,
                           revive_every)
        if (checkpoint_every is None) != (checkpoint_path is None):
            raise ValueError(
                'checkpoint_every and checkpoint_path must be given together')
        if tol is not None and checkpoint_every is not None:
            raise ValueError(
                'tol-based early stopping cannot combine with checkpoint_every '
                '(as in the JAX package, whose tol loop runs on the device)')
        if extrapolate:
            if (progress_callback is not None or checkpoint_every is not None
                    or revive_every is not None):
                raise ValueError(
                    'extrapolate cannot combine with progress_callback, '
                    'checkpoint_every or revive_every (as in the JAX package, '
                    'whose extrapolated loop runs on the device)')
            xtr_beta0 = 0.5 if extrapolate is True else float(extrapolate)
            if not 0.0 < xtr_beta0 < 1.0:
                raise ValueError('extrapolate must be True or an initial '
                                 'momentum weight in (0, 1)')
        if checkpoint_every is not None:
            _require(checkpoint_every >= 1, 'checkpoint_every must be >= 1')
            if progress_callback is not None:
                raise ValueError(
                    'checkpoint_every uses the chunked loop and cannot combine '
                    'with progress_callback; call save() from your callback instead')
            self._not_under_mesh('checkpoint_every', '14e-v')
            ckpt_path = checkpoint_path

            def progress_callback(model, iteration):  # noqa: F811
                model.save(ckpt_path, include_H=True, completed_iterations=iteration + 1)
                return True

            callback_interval = int(checkpoint_every)
        if revive_every is not None:
            _require(revive_every >= 1, 'revive_every must be >= 1')
            if progress_callback is not None or tol is not None:
                raise ValueError(
                    'revive_every uses the chunked loop and cannot combine with '
                    'progress_callback / checkpoint_every / tol; call '
                    'utils.atoms.revive_dead_atoms from your own callback instead')
            if not (update_H and update_W):
                raise ValueError('revive_every requires update_H and update_W '
                                 '(revival re-draws both factors)')
            if self._world > 1:
                raise ValueError(
                    'revive_every re-draws atoms host-side and needs fully '
                    'addressable factors; with multi-process global arrays, '
                    'run utils.atoms.revive_dead_atoms between fits from '
                    'gathered copies instead')
            from ..utils.atoms import revive_dead_atoms
            thr = float(revive_threshold)

            def progress_callback(model, iteration):  # noqa: F811
                revived = revive_dead_atoms(model, thr)
                if revived.size:
                    model._logger.info('Revived %d dead atom(s) at iteration %d.',
                                       revived.size, iteration + 1)
                return True

            callback_interval = int(revive_every)

        self._sag_stat_ = None  # a fresh fit drops partial_fit's state
        self._initialize_matrices(V, keep_W, keep_H=keep_H, mask=mask)
        n_iterations = int(n_iterations)
        if solver == 'hals':
            self._fit_batch_hals(
                n_iterations, update_H=update_H, update_W=update_W, l1=sparsity_H, l2=l2_H,
                l1w=sparsity_W, l2w=l2_W, hals_inner=hals_inner,
                progress_callback=progress_callback, callback_interval=callback_interval,
                record_energies=record_energies, tol=tol, tol_check_every=tol_check_every)
            return
        regs = self._regs(sparsity_H, inhibition_strength, cross_atom_inhibition_strength)
        flags = dict(self._flags(inhibition_strength, cross_atom_inhibition_strength),
                     update_H=update_H, update_W=update_W, process_group=self._pg,
                     atom_group=self._ag, **self._objective(l2_H, ortho_W))
        if extrapolate:
            # the JAX package leaves the block length unchecked here (a
            # length of 0 never ends its loop)
            _validate_tol(0.0 if tol is None else tol, tol_check_every)
            self._W, self._H, n_done, _, trace = engine.fit_loop_extrapolated(
                self._Vp, self._Vd, self._W, self._H, n_iterations,
                0.0 if tol is None else tol, xtr_beta0, *regs,
                check_every=int(tol_check_every),
                n_buf=_trace_buf(n_iterations) if record_energies else 0, **flags)
            self.n_iterations_ = n_done
            self.energies_ = trace.cpu().numpy()[:n_done] if record_energies else None
            self._logger.info('TNMF finished.')
            return
        Vp, Vd = self._Vp, self._Vd
        self._run_loops(
            n_iterations,
            loop_tol=lambda n, t, ce, nb: engine.fit_loop_tol(
                Vp, Vd, self._W, self._H, n, t, *regs, check_every=ce, n_buf=nb, **flags),
            loop_energies=lambda n: engine.fit_loop_energies(
                Vp, Vd, self._W, self._H, *regs, n_iterations=n, **flags),
            loop_plain=lambda n: engine.fit_loop(Vp, self._W, self._H, n, *regs, **flags),
            step=lambda: engine.update_step(Vp, self._W, self._H, *regs, **flags),
            progress_callback=progress_callback, callback_interval=callback_interval,
            record_energies=record_energies, tol=tol, tol_check_every=tol_check_every)

    # ------------------------------------------------------------------
    # the HALS solvers (the JAX package's solver='hals')
    # ------------------------------------------------------------------

    def _check_solver(self, solver, sparsity_W, l2_W, inhibition_strength,
                      cross_atom_inhibition_strength, ortho_W, mask, extrapolate,
                      revive_every) -> None:
        """The JAX ``fit_batch``'s checks of ``solver`` and of what HALS does
        not take, with its exception types and messages."""
        if solver not in ('mu', 'hals'):
            raise ValueError(f"solver must be 'mu' or 'hals', got {solver!r}")
        if solver == 'mu' and (sparsity_W > 0 or l2_W > 0):
            raise ValueError(
                'sparsity_W / l2_W regularize the un-normalized HALS '
                'dictionary; MU sum-normalizes atoms every update '
                '(reference _Backend.py:75-77), which makes W penalties '
                "ill-posed — use solver='hals'")
        if solver != 'hals':
            return
        if inhibition_strength > 0 or cross_atom_inhibition_strength > 0 or ortho_W > 0:
            raise ValueError(
                "solver='hals' minimizes the plain (L1/L2-regularized) "
                'Frobenius objective exactly; inhibition and ortho_W '
                'are MU-only regularizers')
        if self._beta != 2.0:
            raise ValueError(
                "solver='hals' requires beta_loss=2 (Frobenius); the "
                'closed-form coordinate minimizer does not exist for '
                'other beta divergences — use the MU solver')
        if mask is not None:
            raise ValueError(
                'masked/weighted fits are MU-only (the masked Gram '
                'matrices are no longer shared across components)')
        if extrapolate:
            raise ValueError(
                'extrapolate accelerates MU; HALS takes exact '
                'coordinate steps and does not compose with it')
        if revive_every is not None:
            raise ValueError(
                'revive_every is unnecessary under HALS: zero is not '
                'absorbing (a zeroed atom re-enters a later sweep when '
                'its partial residual correlation turns positive)')
        if self._group is not None:
            raise ValueError(
                "transform groups are MU-only (solver='hals' applies "
                'to the degenerate plain-NMF geometry)')
        if self._mesh is not None and self._shard_axis != 'samples':
            raise ValueError(
                "solver='hals' supports shard_axis='samples' meshes "
                '(Grams become all-reduces); atom/spatial sharding '
                'would serialize the Gauss-Seidel sweep')

    def _fit_batch_hals(self, n_iterations, *, update_H, update_W, l1, l2, l1w, l2w,
                        hals_inner, progress_callback, callback_interval, record_energies,
                        tol, tol_check_every):
        """Loop dispatch of ``solver='hals'`` after the matrices are
        initialised: the plain-NMF solver (:mod:`tnmf_tpu_torch.engine_hals`)
        on the degenerate geometry, the shift-invariant one
        (:mod:`tnmf_tpu_torch.engine_hals_conv`) on ``'full'``, else the JAX
        package's ``ValueError``."""
        from .. import engine_hals, engine_hals_conv as ehc
        V, l1, l2, l1w, l2w = self._Vd, float(l1), float(l2), float(l1w), float(l2w)
        flags = dict(update_H=update_H, update_W=update_W,
                     use_pallas=self._use_pallas is not False, plan=self._plan,
                     process_group=self._pg)
        if math.prod(self._plan.transform_shape) != 1:
            if not ehc.applicable(self._plan):
                raise ValueError(
                    "solver='hals' requires the degenerate plain-NMF "
                    "geometry (prod(transform_shape) == 1, any mode) "
                    "or reconstruction_mode='full' (shift-invariant "
                    'exact CD via phase-blocked sweeps, '
                    ':mod:`tnmf_tpu.engine_hals_conv`); other modes '
                    'have boundary-clipped atom footprints whose '
                    'position-dependent Grams break the shared-Gram '
                    'phase blocks — use the MU solver there')
            if l1w > 0 or l2w > 0:
                raise ValueError(
                    'sparsity_W / l2_W apply to the plain-NMF HALS '
                    'W sweeps; the shift-invariant solver updates W '
                    'multiplicatively (engine_hals_conv) where W '
                    'penalties are ill-posed')
            # one Gauss-Seidel pass per phase block unless asked: the JAX
            # package's default (fresh phases see fresher residuals)
            inner = 1 if hals_inner in (None, 'auto') else int(hals_inner)
            if inner < 1:
                raise ValueError('hals_inner must be >= 1 or "auto"')
            flags['inner'] = inner
            loops = dict(
                loop_tol=lambda n, t, ce, nb: ehc.fit_loop_tol(
                    V, self._W, self._H, n, t, l1, l2, check_every=ce, n_buf=nb, **flags),
                loop_energies=lambda n: ehc.fit_loop_energies(
                    V, self._W, self._H, l1, l2, n_iterations=n, **flags),
                loop_plain=lambda n: ehc.fit_loop(V, self._W, self._H, n, l1, l2, **flags),
                step=lambda: ehc.update_step(V, self._W, self._H, l1, l2, **flags))
        else:
            # the whole batch's sample count: under a mesh the rank's rows
            # would pick another count than the JAX fit
            flags['inner'] = engine_hals.auto_inner(
                self._W.shape[0], math.prod(self._W.shape[1:]), hals_inner,
                n_samples=self._n_samples)
            regs = (l1, l2, l1w, l2w)
            loops = dict(
                # the JAX package hands this loop tol in float32
                loop_tol=lambda n, t, ce, nb: engine_hals.fit_loop_tol(
                    V, self._W, self._H, n, float(np.float32(t)), *regs, check_every=ce,
                    n_buf=nb, **flags),
                loop_energies=lambda n: engine_hals.fit_loop_energies(
                    V, self._W, self._H, *regs, n_iterations=n, **flags),
                loop_plain=lambda n: engine_hals.fit_loop(V, self._W, self._H, n, *regs,
                                                          **flags),
                step=lambda: engine_hals.update_step(V, self._W, self._H, *regs, **flags))
        self._run_loops(n_iterations, progress_callback=progress_callback,
                        callback_interval=callback_interval, record_energies=record_energies,
                        tol=tol, tol_check_every=tol_check_every, **loops)

    def _run_loops(self, n_iterations, *, loop_tol, loop_energies, loop_plain, step,
                   progress_callback, callback_interval, record_energies, tol,
                   tol_check_every):
        """The loop dispatch of ``fit_batch`` for MU (without
        ``extrapolate``) and the coordinate-descent solvers (the JAX
        package's MU branches and its ``_run_cd_loops``, which repeat each
        other): the ``tol`` loop, the loop recording the energies, the plain
        loop, chunked callbacks (the callback sees iterations k-1, 2k-1, …)
        or one iteration at a time (the callback, or without one the INFO
        energy line, after each).  The callables read ``self._W`` /
        ``self._H`` when called:

        * ``loop_tol(n_max, tol, check_every, n_buf)`` -> ``(W, H, n_done,
          e, trace_or_None)``
        * ``loop_energies(n)`` -> ``(W, H, energies)``
        * ``loop_plain(n)`` -> ``(W, H)``
        * ``step()`` -> ``(W, H)``
        """
        log_each = self._logger.isEnabledFor(logging.INFO)
        self.energies_ = None
        if tol is not None:
            if progress_callback is not None:
                raise ValueError(
                    'tol-based early stopping cannot combine with progress_callback '
                    '(as in the JAX package, whose tol loop runs on the device)')
            _validate_tol(tol, tol_check_every)
            self._W, self._H, n_done, _, trace = loop_tol(
                int(n_iterations), tol, int(tol_check_every),
                _trace_buf(n_iterations) if record_energies else 0)
            self.n_iterations_ = int(n_done)
            if record_energies:
                self.energies_ = trace.cpu().numpy()[:self.n_iterations_]
        elif record_energies and progress_callback is None:
            self._W, self._H, energies = loop_energies(int(n_iterations))
            self.n_iterations_ = int(n_iterations)
            self.energies_ = energies.cpu().numpy()
            if log_each:
                for i, e in enumerate(self.energies_):
                    self._logger.info('Iteration: %d\tEnergy function: %s', i, e)
        elif progress_callback is None and not log_each:
            self._W, self._H = loop_plain(n_iterations)
            self.n_iterations_ = int(n_iterations)
        elif progress_callback is not None and callback_interval > 1:
            traces = []
            done = 0
            while done < n_iterations:
                chunk = min(callback_interval, n_iterations - done)
                if record_energies:
                    self._W, self._H, es = loop_energies(chunk)
                    traces.append(es.cpu().numpy())
                else:
                    self._W, self._H = loop_plain(chunk)
                done += chunk
                if not progress_callback(self, done - 1):
                    break
            self.n_iterations_ = done
            if record_energies:
                self.energies_ = np.concatenate(traces) if traces else np.zeros((0,))
        else:
            energies = []
            self.n_iterations_ = int(n_iterations)
            for iteration in range(n_iterations):
                self._W, self._H = step()
                self.n_iterations_ = iteration + 1
                if record_energies:
                    energies.append(self._energy_function())
                if progress_callback is not None:
                    if not progress_callback(self, iteration):
                        break
                else:
                    self._logger.info('Iteration: %d\tEnergy function: %s',
                                      iteration, self._energy_function())
            if record_energies:
                self.energies_ = np.asarray(energies)
        self._logger.info('TNMF finished.')

    def fit(self, V, y=None, **kwargs):
        """sklearn-style front door (the JAX dispatch; reference :525-531):
        ``subsample_size`` / ``max_subsamples`` go to :meth:`fit_stream`,
        ``batch_size`` / ``algorithm`` to :meth:`fit_minibatches`, anything
        else to :meth:`fit_batch`.  ``y`` is ignored."""
        del y
        if 'subsample_size' in kwargs or 'max_subsamples' in kwargs:
            self.fit_stream(iter(V), **kwargs)
        elif 'batch_size' in kwargs or 'algorithm' in kwargs:
            self.fit_minibatches(V, **kwargs)
        else:
            self.fit_batch(V, **kwargs)

    # ------------------------------------------------------------------
    # minibatch fitting (reference fit_minibatches, TransformInvariantNMF.py:350-504)
    # ------------------------------------------------------------------

    def fit_minibatches(self, V, algorithm: MiniBatchAlgorithm = MiniBatchAlgorithm.ASG_MU,
                        batch_size: Optional[int] = 3, n_epochs: int = 1000,
                        sag_lambda: float = 0.2, keep_W: bool = False,
                        sparsity_H: float = 0., inhibition_strength: float = 0.,
                        cross_atom_inhibition_strength: float = 0., l2_H: float = 0.,
                        ortho_W: float = 0.,
                        progress_callback: Optional[Callable[['TransformInvariantNMF', int],
                                                             bool]] = None,
                        record_energies: bool = False, mask=None):
        """Minibatch MU fit of ``V``: ``n_epochs`` epochs of ``algorithm``
        (:class:`~tnmf_tpu_torch.engine_minibatch.MiniBatchAlgorithm`) over
        contiguous batches of ``batch_size`` samples (``None``: one batch),
        the last one shorter when the count does not divide.  Algorithms
        5-8 visit the batches in an order drawn each epoch from the
        model's NumPy stream (``permutation(n_batches)``), as the JAX
        package and the reference draw it; Cyclic_MU visits them in order.
        ``sag_lambda`` weighs the newest batch in the averaged statistics
        of ASAG_MU and GSAG_MU (1 sums them).

        After each epoch ``progress_callback(model, epoch)`` runs and stops
        the fit when it returns a false value; without one, INFO logging
        writes the epoch's energy.  ``record_energies`` keeps the energy
        after each epoch in ``energies_`` (a list, read from the device once
        at the end).  Any earlier ``partial_fit`` state is dropped.
        ``l2_H``, ``ortho_W`` and ``mask`` are :meth:`fit_batch`'s; each
        batch takes its rows of the mask (a mask of one sample serves every
        batch), and the epoch's energy is the masked one.  Under a mesh of
        more than one process it raises (ROADMAP.md item 14e-iv)."""
        self._not_under_mesh('fit_minibatches', '14e-iv')
        V, mask = self._check_data(V, mask)
        self._sag_stat_ = None  # a fresh fit drops partial_fit's state
        self._check_regs(sparsity_H, inhibition_strength, cross_atom_inhibition_strength,
                         l2_H, ortho_W)
        _require(isinstance(algorithm, MiniBatchAlgorithm),
                 f'algorithm must be a MiniBatchAlgorithm, got {algorithm!r}')
        self._initialize_matrices(V, keep_W, mask=mask)
        n = int(self._Vd.shape[0])
        batches = ([slice(0, n)] if batch_size is None
                   else list(_sequential_slices(n, int(batch_size))))
        regs = self._regs(sparsity_H, inhibition_strength, cross_atom_inhibition_strength)
        flags = dict(self._flags(inhibition_strength, cross_atom_inhibition_strength),
                     **self._objective(l2_H, ortho_W))
        log_each = progress_callback is None and self._logger.isEnabledFor(logging.INFO)
        energies = []
        inner_stat = None
        for epoch in range(int(n_epochs)):
            order = (range(len(batches)) if algorithm is MiniBatchAlgorithm.Cyclic_MU
                     else self._rng.permutation(len(batches)))
            self._W, self._H, inner_stat = minibatch_epoch(
                self._Vp, self._W, self._H, batches, order, inner_stat, float(sag_lambda),
                *regs, algorithm=algorithm, **flags)
            if record_energies or log_each:
                e = self._energy()
                energies.append(e)
            if progress_callback is not None:
                if not progress_callback(self, epoch):
                    break
            elif log_each:
                self._logger.info('Epoch: %d\tEnergy function: %s', epoch, float(e))
        self.energies_ = None
        if record_energies:
            self.energies_ = torch.stack(energies).tolist() if energies else []
        self._logger.info('MiniBatch TNMF finished.')

    # ------------------------------------------------------------------
    # streaming fit (reference fit_stream, TransformInvariantNMF.py:506-523)
    # ------------------------------------------------------------------

    def fit_stream(self, V: Iterator, subsample_size: int = 3,
                   max_subsamples: Optional[int] = None, **kwargs):
        """Fit on an iterator of samples: subsamples of ``subsample_size``
        samples each go to ``fit(subsample, keep_W=True, **kwargs)`` in
        turn, until the iterator is exhausted or ``max_subsamples`` were
        fitted.  A subsample of tensors is stacked on their device (no host
        copy); anything else goes through ``np.asarray``.  Under a mesh of
        more than one process it raises (ROADMAP.md item 14e-iv)."""
        self._not_under_mesh('fit_stream', '14e-iv')
        for isub in count(0):
            subsample = list(islice(V, subsample_size))
            if not subsample:
                self._logger.info('Sample iterator exhausted. TNMF on full iterator finished.')
                return
            self._logger.info('Processing subsample %d.', isub)
            self.fit(_stacked(subsample), keep_W=True, **kwargs)
            if max_subsamples is not None and isub == max_subsamples - 1:
                self._logger.info('Processed %d subsamples. TNMF on iterator will stop.',
                                  max_subsamples)
                return

    # ------------------------------------------------------------------
    # online learning (the JAX package's partial_fit, sklearn MiniBatchNMF's protocol)
    # ------------------------------------------------------------------

    def partial_fit(self, V, y=None, sag_lambda: float = 0.2, sparsity_H: float = 0.,
                    inhibition_strength: float = 0., cross_atom_inhibition_strength: float = 0.,
                    l2_H: float = 0., ortho_W: float = 0., mask=None) -> 'TransformInvariantNMF':
        """Update the model with one minibatch ``V``: H drawn for the batch
        and updated once, then W from the batch's statistics averaged with
        those of earlier calls (``(1 - sag_lambda) * old + sag_lambda *
        new``, ASAG_MU's rule).  ``sag_lambda=1`` keeps no memory: each call
        uses its own batch's statistics, so a first call equals
        ``fit_batch(V, n_iterations=1)``.  The first call draws the
        dictionary, later ones keep it; batches may differ in sample count
        and size, not in channels.  Any ``fit*`` call drops the averaged
        state.  Returns ``self``; ``n_steps_`` counts the calls.  ``l2_H``,
        ``ortho_W`` and ``mask`` are :meth:`fit_batch`'s, the mask the
        batch's; ``ortho_W`` is formed from the current W at the update,
        never averaged into the statistics.  Under a mesh of more than one
        process it raises (ROADMAP.md item 14e-iv)."""
        del y
        self._not_under_mesh('partial_fit', '14e-iv')
        V, mask = self._check_data(V, mask)
        self._check_regs(sparsity_H, inhibition_strength, cross_atom_inhibition_strength,
                         l2_H, ortho_W)
        self._initialize_matrices(V, keep_W=True, mask=mask)
        flags = self._flags(inhibition_strength, cross_atom_inhibition_strength)
        objective = self._objective(l2_H, ortho_W)
        self._H = engine.update_H_step(
            self._Vp, self._W, self._H,
            *self._regs(sparsity_H, inhibition_strength, cross_atom_inhibition_strength),
            mask=mask, l2_H=objective['l2_H'], **flags)
        neg, pos = engine.grad_W_stats(self._Vp, self._W, self._H, mask, plan=self._plan,
                                       strategy=self._strategy, use_pallas=flags['use_pallas'],
                                       beta=self._beta)
        if sag_lambda == 1.0 or self._sag_stat_ is None:
            # the batch's own statistics: online learning replaces them at
            # sag_lambda == 1, where accumulate_gradient would sum
            stat = (neg, pos)
        else:
            stat = engine.accumulate_gradient(*self._sag_stat_, neg, pos, float(sag_lambda))
        self._sag_stat_ = None if sag_lambda == 1.0 else stat
        self._W = engine.apply_W_update(self._W, *stat, objective['ortho_W'],
                                        n_shift_axes=self._plan.ndim,
                                        use_pallas=flags['use_pallas'])
        self.n_steps_ += 1
        self._logger.info('partial_fit step %d done.', self.n_steps_)
        return self

    # ------------------------------------------------------------------
    # the encoder: a frozen dictionary (tnmf_tpu TransformInvariantNMF.transform)
    # ------------------------------------------------------------------

    def set_dictionary(self, W) -> 'TransformInvariantNMF':
        """Install a dictionary (nonnegative, ``(n_atoms, n_channels,
        *atom_shape)``, an array or a tensor) so that ``transform`` /
        ``fit(keep_W=True)`` run against it; its atoms are sum-normalised.
        Drops any earlier fit state.  Returns ``self``.

        The normalisation runs on the host in NumPy for either kind of
        input, as the JAX package's does (``np.asarray``), so an array and a
        tensor give the same bits; a tensor's host copy is of the dictionary
        alone (n_atoms x n_channels x atom entries), never of the data."""
        if isinstance(W, torch.Tensor):
            W = W.detach().cpu().numpy()
        W = np.asarray(W)
        if W.ndim != 2 + len(self.atom_shape) or W.shape[0] != self.n_atoms \
                or W.shape[2:] != self.atom_shape:
            raise ValueError(
                f'dictionary shape {tuple(W.shape)} does not match the '
                f'model: expected (n_atoms={self.n_atoms}, n_channels, '
                f'*atom_shape={self.atom_shape})')
        if np.any(W < 0):
            raise ValueError('dictionary entries must be nonnegative')
        s = W.sum(axis=self._axes_W_normalization, keepdims=True)
        W = W / np.where(s == 0, 1, s)
        if self._ag is not None:  # this rank's atoms
            W = W[local_atoms(self._mesh, self.n_atoms)]
        self._W = self._tensor(W)
        self._H = None
        self._plan = None
        return self

    def transform(self, V, n_iterations: int = 100, batch_size: Optional[int] = None,
                  **kwargs) -> np.ndarray:
        """Activations ``H`` of new data against the frozen dictionary:
        ``fit_batch(V, update_W=False, keep_W=True, ...)`` (``kwargs`` are
        ``fit_batch``'s), returned as a NumPy array.  With ``batch_size``
        the samples are encoded in independent chunks of that many and the
        chunks' H concatenated on the host; the model's ``V`` / ``H`` /
        ``R`` then hold the last chunk.  A ``mask`` with a row per sample
        is sliced with the chunks; a broadcast one serves each chunk.

        Under a mesh each rank encodes its own rows (under an atom axis
        against its atoms), and a world above one returns this rank's share
        of H (the rows of its block of V, the maps of its atoms); the
        chunks of ``batch_size`` are not ported there (ROADMAP.md item
        14e-iv)."""
        if self._W is None:
            raise RuntimeError(
                'transform() requires a fitted or loaded dictionary; '
                'call fit() or load() first')
        if batch_size is None:
            self.fit_batch(V, n_iterations=n_iterations, update_W=False, keep_W=True,
                           **kwargs)
            return self._local_H()
        self._not_under_mesh('transform(batch_size=...)', '14e-iv')
        V = _as_input(V, self.device)
        mask = kwargs.pop('mask', None)
        per_sample = (mask is not None and np.ndim(mask) == V.ndim
                      and np.shape(mask)[0] == V.shape[0])
        out = []
        for s in _sequential_slices(V.shape[0], batch_size):
            self.fit_batch(V[s], n_iterations=n_iterations, update_W=False, keep_W=True,
                           mask=mask[s] if per_sample else mask, **kwargs)
            out.append(self.H)
        return np.concatenate(out, axis=0)

    def export_serving(self, path: Optional[str] = None, **kwargs) -> bytes:
        """Serialize the encoding step ``V -> H`` against the current
        dictionary to a serving artifact (:func:`tnmf_tpu_torch.serving.export_serving`;
        ``kwargs`` are its keywords); also written to ``path`` when given.
        Returns the artifact bytes.  Under a world above one with an atom
        axis it raises: the artifact holds the whole dictionary."""
        self._whole_W('export_serving')
        from ..serving import export_serving
        return export_serving(self, path=path, **kwargs)

    def fit_transform(self, V, y=None, **kwargs) -> np.ndarray:
        """``fit(V, **kwargs)``, then the learned activations ``H``."""
        self.fit(V, y, **kwargs)
        return self.H

    def inverse_transform(self, H=None) -> np.ndarray:
        """The reconstruction of ``H`` (an array or a tensor, flat or the
        ``H`` property's view under a transform group; default: the last
        fit's or transform's own activations, ``self.R``)."""
        if self._plan is None:
            raise RuntimeError(
                'inverse_transform() requires a fitted model; call fit() '
                '(or load a checkpoint that includes H) first')
        if H is None:
            return self.R
        self._whole_W('inverse_transform(H)')
        H = self._tensor(_as_input(H, self.device))
        if self.n_transforms > 1 and H.dim() == 3 + self._plan.ndim:
            # the H property's (n, atoms, transforms, *shift) view -> m-major maps
            H = H.reshape((H.shape[0], self.n_atoms * self.n_transforms) + tuple(H.shape[3:]))
        return engine.reconstruct(self._W, H, plan=self._plan,
                                  strategy=self._strategy).cpu().numpy()

    # ------------------------------------------------------------------
    # checkpoints, in the JAX package's .npz format
    # ------------------------------------------------------------------

    def save(self, path: str, include_H: bool = False,
             completed_iterations: Optional[int] = None):
        """Write the dictionary (and with ``include_H`` the activations)
        with the constructor configuration to an ``.npz`` checkpoint the
        JAX package's ``load`` reads; ``completed_iterations`` stamps the
        iterations that produced it.  Written to ``<path>.tmp`` and moved
        into place with ``os.replace``, so a crash never leaves a torn
        checkpoint.  Under a mesh of more than one process it raises
        (ROADMAP.md item 14e-v)."""
        self._not_under_mesh('save', '14e-v')
        if self._W is None:
            raise ValueError('nothing to save: the model has not been fit yet')
        payload = dict(
            W=self._W.cpu().numpy(),
            dtype=str(self._W.dtype).removeprefix('torch.'),
            n_atoms=self.n_atoms,
            atom_shape=np.asarray(self.atom_shape),
            inhibition_range=np.asarray(self._inhibition_range),
            reconstruction_mode=self._reconstruction_mode,
            transform_type=self.transform_type,
            version=1,
        )
        if include_H and self._H is not None:
            payload['H'] = self._H.cpu().numpy()  # the flat m-major maps
        if completed_iterations is not None:
            payload['completed_iterations'] = int(completed_iterations)
        final = path if path.endswith('.npz') else path + '.npz'
        tmp = final + '.tmp'
        with open(tmp, 'wb') as f:
            np.savez(f, **payload)
        os.replace(tmp, final)

    def save_sharded(self, path: str, include_H: bool = True, block: bool = True):
        raise not_ported('TransformInvariantNMF.save_sharded', '14e-v')

    def wait_for_checkpoints(self):
        raise not_ported('TransformInvariantNMF.wait_for_checkpoints', '14e-v')

    @classmethod
    def load_sharded(cls, path: str, mesh=None, shard_axis: str = 'samples', **kwargs):
        raise not_ported('TransformInvariantNMF.load_sharded', '14e-v')

    @classmethod
    def load(cls, path: str, *, device='cuda', dtype: Optional[torch.dtype] = None,
             **kwargs) -> 'TransformInvariantNMF':
        """Restore a model from a checkpoint of either package (``W``,
        optional ``H`` and ``completed_iterations``, ``n_atoms``,
        ``atom_shape``, ``inhibition_range``, ``reconstruction_mode``,
        ``transform_type``, ``dtype``).  ``kwargs`` override constructor arguments, as in the
        JAX package; ``dtype`` defaults to the stored one.  Continue with
        ``fit(V, keep_W=True)``, or resume exactly with ``keep_H=True``."""
        with np.load(path, allow_pickle=False) as data:
            if dtype is None:
                dtype = _torch_dtype(str(data['dtype'])) if 'dtype' in data \
                    else _torch_dtype(str(data['W'].dtype))
            cfg = dict(n_atoms=int(data['n_atoms']),
                       atom_shape=tuple(int(a) for a in data['atom_shape']),
                       reconstruction_mode=str(data['reconstruction_mode']))
            if 'inhibition_range' in data:
                cfg['inhibition_range'] = tuple(int(r) for r in data['inhibition_range'])
            if 'transform_type' in data:
                cfg['transform_type'] = str(data['transform_type'])
            cfg.update(kwargs)
            model = cls(**cfg, device=device, dtype=dtype)
            model._W = model._tensor(data['W'])
            if 'H' in data:
                model._H = model._tensor(data['H'])
                model._restore_plan()
            model.last_checkpoint_iteration_ = (
                int(data['completed_iterations']) if 'completed_iterations' in data else None)
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
        self._plan = self._plan_for(sample)
        self._check_strategy()


class MiniBatchTransformInvariantNMF(TransformInvariantNMF):
    """The minibatch-first model of the JAX package (its sklearn
    ``MiniBatchNMF`` analogue): the batch schedule is configuration, set in
    the constructor, and ``fit`` runs :meth:`fit_minibatches
    <TransformInvariantNMF.fit_minibatches>` with it.

    Parameters (besides the base class's, which pass through ``kwargs``):
    ``batch_size``, ``algorithm`` (a :class:`MiniBatchAlgorithm` or its
    name, default ASG_MU), ``n_epochs`` and ``sag_lambda``; a ``fit`` call
    may override each.  ``save`` / ``load`` carry what the base class's
    checkpoint carries, not the schedule.
    """

    def __init__(self, n_atoms: int, atom_shape: Tuple[int, ...], batch_size: Optional[int] = 3,
                 algorithm: Union[MiniBatchAlgorithm, str] = MiniBatchAlgorithm.ASG_MU,
                 n_epochs: int = 1000, sag_lambda: float = 0.2, **kwargs):
        super().__init__(n_atoms, atom_shape, **kwargs)
        if isinstance(algorithm, str):
            algorithm = MiniBatchAlgorithm[algorithm]
        _require(isinstance(algorithm, MiniBatchAlgorithm),
                 f'algorithm must be a MiniBatchAlgorithm, got {algorithm!r}')
        self.batch_size = None if batch_size is None else int(batch_size)
        self.algorithm = algorithm
        self.n_epochs = int(n_epochs)
        self.sag_lambda = float(sag_lambda)
        self._init_params.update(batch_size=batch_size, algorithm=algorithm,
                                 n_epochs=n_epochs, sag_lambda=sag_lambda)

    def fit(self, V, y=None, **kwargs):
        """Minibatch fit with the constructor's schedule, which ``kwargs``
        may override; ``subsample_size`` / ``max_subsamples`` still go to
        :meth:`fit_stream <TransformInvariantNMF.fit_stream>`, which runs
        this fit on each subsample."""
        del y
        if 'subsample_size' in kwargs or 'max_subsamples' in kwargs:
            self.fit_stream(iter(V), **kwargs)
            return
        kwargs.setdefault('batch_size', self.batch_size)
        kwargs.setdefault('algorithm', self.algorithm)
        kwargs.setdefault('n_epochs', self.n_epochs)
        kwargs.setdefault('sag_lambda', self.sag_lambda)
        self.fit_minibatches(V, **kwargs)
