"""Interactive demo utilities: parameter widgets, signal tooling, model
fitting with progress reporting (port of :mod:`tnmf_tpu.utils.demo`).

The parameter sidebar, ``SignalTool`` with its 1-D/2-D dispatch and the
cached ``fit_nmf_model``, on the port's :class:`TransformInvariantNMF`.
Runs headless through the streamlit shim (:mod:`._st_shim`).  Every gallery
computes what it shows (energies, ``R``, each atom's ``R_partial``) before
it draws; where matplotlib is missing the drawing alone is skipped
(:func:`.drawing.pyplot`).

Fits run on ``DEVICE`` (the card) unless a call names another device.
"""

from __future__ import annotations

import hashlib
from abc import ABC, abstractmethod
from typing import Optional, Tuple

import numpy as np

from ..engine_minibatch import MiniBatchAlgorithm
from ..models.tnmf import TransformInvariantNMF
from ._st_shim import get_streamlit
from .drawing import pyplot

st, HAVE_STREAMLIT = get_streamlit()

#: the device of the demos' fits when a call names none
DEVICE = 'cuda'


def device_of(device=None):
    """``device``, or :data:`DEVICE` when it is None."""
    return DEVICE if device is None else device


def explanation(text: str, verbose: bool):
    """Render an explanatory markdown block when verbose mode is on."""
    if verbose:
        st.markdown(text)


# ---------------------------------------------------------------------------
# parameter widgets
# ---------------------------------------------------------------------------

def st_define_nmf_params(default_params: dict, have_ground_truth: bool = True,
                         verbose: bool = True) -> Tuple[dict, dict]:
    """Sidebar widgets for the model and fit parameters.

    Returns ``(nmf_params, fit_params)`` ready to be passed to
    ``TransformInvariantNMF(**nmf_params)`` and ``nmf.fit(V, **fit_params)``.
    """
    explanation('## Model parameters', verbose)
    explanation(
        'The model decomposes the data `V` into a dictionary `W` of small '
        'atoms and sparse activation maps `H`: every sample is explained as '
        'a sum of atoms placed at the positions (and, optionally, under the '
        'transforms) where their activations are non-zero. The settings '
        'below control how large that dictionary is and how the atoms may '
        'be placed.', verbose)

    # with known ground truth the oracle values can simply be adopted
    # (reference sidebar role: tnmf/utils/demo.py:54-79)
    use_gt_atoms = have_ground_truth and st.sidebar.checkbox(
        'Use ground-truth number of atoms', value=True,
        help='The demo data is generated from a known dictionary, so the '
             'true number of atoms is available. Untick to choose your own '
             'and watch how the factorization under- or over-fits.')
    use_gt_shape = have_ground_truth and st.sidebar.checkbox(
        'Use ground-truth atom size', value=True,
        help='Adopt the exact extent of the generating symbols. Untick to '
             'see the effect of atoms that are too small to hold one '
             'feature, or needlessly large.')
    if use_gt_shape:
        atom_shape = tuple(int(a) for a in default_params['atom_shape'])
    else:
        atom_shape = tuple(
            int(st.sidebar.number_input(
                f'Atom size (axis {i})', min_value=1, value=int(a),
                help='Extent of every dictionary atom along this axis. Atoms '
                     'should be large enough to hold one recurring feature of '
                     'the data; every position of the signal is explained by '
                     'shifted copies of these atoms.'))
            for i, a in enumerate(default_params['atom_shape']))
    if use_gt_atoms:
        n_atoms = int(default_params['n_atoms'])
    else:
        n_atoms = int(st.sidebar.number_input(
            'Number of atoms', min_value=1, value=int(default_params['n_atoms']),
            help='Dictionary size: how many distinct features the model may '
                 'learn. More atoms lower the reconstruction error but risk '
                 'splitting one true feature across several atoms — lateral '
                 'inhibition and the cross-atom penalty counteract that.'))
    reconstruction_mode = st.sidebar.selectbox(
        'Reconstruction mode', ['valid', 'full', 'circular', 'reflect'],
        index=['valid', 'full', 'circular', 'reflect'].index(
            default_params.get('reconstruction_mode', 'valid')),
        help="Boundary handling of the shift-invariant reconstruction: "
             "'valid' lets atoms extend past the signal edges (activation "
             "maps are larger than the signal), 'full' requires atoms to "
             "lie fully inside (smaller maps), 'circular' wraps around "
             "(periodic signals), 'reflect' mirrors at the edges.")
    backend = st.sidebar.selectbox(
        'Backend', ['auto', 'jax_fft', 'jax_conv'], index=0,
        help="Numerical strategy for the convolution operators. 'auto' "
             "picks by atom/sample geometry (direct convolution for small "
             "atoms, FFT for large ones, matrix products for plain NMF); "
             "'jax_fft' forces the FFT strategy and 'jax_conv' direct "
             "convolution. The strategies compute the same factorization "
             "up to rounding.")
    # transform invariances beyond shift (tnmf_tpu_torch.ops.transforms);
    # rotations need square atoms in the last two axes
    transform_options = ['shift', 'shift+flip']
    if len(atom_shape) >= 2 and atom_shape[-1] == atom_shape[-2]:
        transform_options += ['shift+rot90', 'shift+rot90+flip']
    transform_type = st.sidebar.selectbox(
        'Transform invariance', transform_options,
        index=transform_options.index(
            default_params.get('transform_type', 'shift')),
        help="Invariances of the dictionary beyond shifts: with "
             "'shift+flip' / 'shift+rot90' every atom also matches its "
             "mirrored / quarter-turned copies through one tied canonical "
             "atom (one activation map per transform). Rotations require "
             "square atoms in the last two axes.")

    nmf_params = dict(
        n_atoms=n_atoms,
        atom_shape=atom_shape,
        reconstruction_mode=reconstruction_mode,
        backend=backend,
        transform_type=transform_type,
    )

    explanation('## Fit parameters', verbose)
    minibatch = st.sidebar.checkbox(
        'Minibatch updates', value=False,
        help='Optimize on sample subsets (Serizel/Essid/Richard 2016, '
             'algorithms 4-8) instead of the full batch: faster early '
             'progress on large datasets at the cost of noisier updates.')
    fit_params = dict(
        sparsity_H=float(st.sidebar.number_input(
            'Sparsity weight', min_value=0.0, value=0.0,
            help='L1 penalty on the activations: larger values push more H '
                 'entries to exactly zero, producing sparser codes and '
                 'cleaner atoms at the cost of reconstruction energy.')),
        inhibition_strength=float(st.sidebar.number_input(
            'Lateral inhibition weight', min_value=0.0, value=0.1,
            help='Suppresses activations of the SAME atom at nearby shifts '
                 '(within roughly one atom extent), so a feature is '
                 'explained by one activation peak instead of a smear of '
                 'adjacent ones.')),
        cross_atom_inhibition_strength=float(st.sidebar.number_input(
            'Cross-atom inhibition weight', min_value=0.0, value=0.0,
            help='Suppresses activations of OTHER atoms at nearby shifts: '
                 'discourages several atoms from explaining the same data '
                 'region, i.e. pushes toward non-overlapping, diverse '
                 'atoms.')),
    )
    if minibatch:
        fit_params['algorithm'] = MiniBatchAlgorithm[st.sidebar.selectbox(
            'Minibatch algorithm', [a.name for a in MiniBatchAlgorithm],
            index=1,
            help='Update schedule: Cyclic_MU accumulates W statistics over '
                 'an epoch, ASG_MU (recommended) updates W per shuffled '
                 'batch, GSG_MU once per epoch from the last batch, '
                 'ASAG_MU/GSAG_MU average statistics across epochs with '
                 'the SAG forgetting factor.')]
        fit_params['batch_size'] = int(st.sidebar.number_input(
            'Batch size', min_value=1, value=3,
            help='Samples per minibatch step. Smaller batches update more '
                 'often (faster early descent, more noise); larger batches '
                 'approach full-batch behavior.'))
        fit_params['n_epochs'] = int(st.sidebar.number_input(
            'Epochs', min_value=1, value=100,
            help='Full passes over the data; one epoch visits every batch '
                 'once.'))
        fit_params['sag_lambda'] = float(st.sidebar.number_input(
            'SAG forgetting factor', min_value=0.0, max_value=1.0, value=0.2,
            help='Exponential averaging weight of the ASAG/GSAG W '
                 'statistics: new batch gradients enter with this weight, '
                 'history keeps (1 - weight); 1.0 degenerates to plain '
                 'summation.'))
    else:
        fit_params['n_iterations'] = int(st.sidebar.number_input(
            'Iterations', min_value=1, value=100,
            help='Multiplicative H+W update steps. MU monotonically '
                 'decreases the objective; more iterations refine the '
                 'factorization with diminishing returns.'))
    return nmf_params, fit_params


# ---------------------------------------------------------------------------
# signal tooling
# ---------------------------------------------------------------------------

class SignalTool(ABC):
    """Input generation and result plotting, dispatched on dimensionality."""

    def __new__(cls, n_dims: int):
        if cls is SignalTool:
            sub = {1: SignalTool1D, 2: SignalTool2D}
            try:
                cls = sub[n_dims]
            except KeyError as e:
                raise ValueError(f'unsupported number of dimensions: {n_dims}') from e
        return super().__new__(cls)

    def __init__(self, n_dims: int):
        self.n_dims = n_dims

    # -- input ----------------------------------------------------------
    def st_generate_input(self, verbose: bool = True) -> Tuple[np.ndarray, dict]:
        """Generate demo input and the matching 'oracle' NMF parameters."""
        explanation('## Input generation', verbose)
        explanation(
            'The demo input is synthesized from a **known ground-truth '
            'dictionary**: a handful of symbols placed at random positions. '
            'That makes the learning task transparent — a good factorization '
            'should rediscover the generating symbols as its atoms and place '
            'activations exactly where symbols were planted.', verbose)
        return self._generate(verbose)

    @abstractmethod
    def _generate(self, verbose: bool) -> Tuple[np.ndarray, dict]:
        ...

    # -- output ---------------------------------------------------------
    def st_compare_signals(self, V: np.ndarray, R: np.ndarray, verbose: bool = True):
        """Global reconstruction view: energy, the whole batch as
        input / reconstruction / error matrices (every sample flattened to
        one row — reference gallery role: ``tnmf/utils/demo.py:257-295``),
        plus the first sample as a signal-space pair."""
        explanation('## Reconstruction quality', verbose)
        explanation(
            'A first global impression of the fit. Each row of the three '
            'matrices is one sample with its channels and signal dimensions '
            'flattened: **left** the input, **middle** its reconstruction '
            'from the learned factorization, **right** their difference. A '
            'structureless right panel means the model captured the data; '
            'visible symbol outlines there point to missing atoms or too '
            'few iterations. Below, the first sample is shown in its native '
            'signal space.', verbose)
        err = float(0.5 * np.sum((V - R) ** 2))
        st.markdown(f'Reconstruction energy: **{err:.4f}**')
        plt = pyplot()
        if plt is not None:
            fig, axes = plt.subplots(1, 3, figsize=(12, 3.5))
            for ax, X, title in zip(axes, (V, R, V - R),
                                    ('Input', 'Reconstruction', 'Error')):
                ax.imshow(np.asarray(X).reshape(len(X), -1), aspect='auto',
                          interpolation='nearest')
                ax.set_title(title)
                ax.set_ylabel('sample')
            st.pyplot(fig)
        self._plot_pair(V[0], R[0], labels=('input', 'reconstruction'))

    def st_compare_individual_signals(self, V: np.ndarray, R: np.ndarray, verbose: bool = True):
        """Per-sample comparison: interactive sample selector under
        streamlit, the full gallery when headless (reference role:
        ``tnmf/utils/demo.py:297-319``)."""
        explanation('## Per-sample comparison', verbose)
        explanation(
            'The same comparison, one sample at a time and channel by '
            'channel — pick a sample to inspect how closely its '
            'reconstruction follows the input. Systematic deviations (e.g. '
            'every pulse slightly too wide) indicate a dictionary problem; '
            'isolated ones indicate activations the sparsity or inhibition '
            'penalties suppressed.', verbose)
        if HAVE_STREAMLIT and len(V) > 1:
            idx = [int(st.slider('Sample number', 1, len(V))) - 1]
        else:
            idx = range(len(V))
        for i in idx:
            self._plot_pair(V[i], R[i], labels=(f'V[{i}]', f'R[{i}]'))

    def st_plot_partial_reconstructions(self, V: np.ndarray, nmf: TransformInvariantNMF,
                                        verbose: bool = True):
        """Atom gallery: for EVERY atom, the learned dictionary atom next to
        its partial contribution to the selected sample's reconstruction
        (reference gallery role: ``tnmf/utils/demo.py:321-355``)."""
        explanation('## Atom-wise partial reconstructions', verbose)
        explanation(
            'What did each atom learn, and what part of the signal does it '
            'explain? Every row shows one dictionary atom next to its '
            '**partial reconstruction** — the contribution of that atom '
            'alone (its activation map convolved with it). Ideally each '
            'atom matches one generating symbol and its contribution covers '
            'exactly the occurrences of that symbol; atoms sharing one '
            'symbol between them call for cross-atom inhibition, dead atoms '
            'for fewer atoms or more iterations.', verbose)
        if HAVE_STREAMLIT and len(V) > 1:
            i_signal = int(st.slider('Sample number', 1, len(V),
                                     key='i_signal_partial')) - 1
        else:
            i_signal = 0
        W = nmf.W
        for i_atom in range(nmf.n_atoms):
            self._plot_atom_row(W[i_atom], V[i_signal],
                                nmf.R_partial(i_atom)[i_signal], i_atom)

    @abstractmethod
    def _plot_pair(self, a: np.ndarray, b: np.ndarray, labels):
        ...

    @abstractmethod
    def _plot_atom_row(self, w: np.ndarray, v: np.ndarray, r: np.ndarray, i_atom: int):
        """One gallery row: dictionary atom ``w``, sample ``v``, and the
        atom's partial contribution ``r`` to its reconstruction."""
        ...


class SignalTool1D(SignalTool):
    def __init__(self, n_dims: int = 1):
        super().__init__(1)

    def _generate(self, verbose: bool) -> Tuple[np.ndarray, dict]:
        from .signals import generate_pulse_train
        n_signals = int(st.sidebar.number_input(
            'Number of signals', min_value=1, value=3,
            help='Independent pulse trains in the batch. All signals share '
                 'one symbol dictionary, so more signals give the model '
                 'more evidence per symbol.'))
        n_pulses = int(st.sidebar.number_input(
            'Pulses per signal', min_value=1, value=3,
            help='Symbols concatenated into each signal; its length is '
                 'pulses x pulse length.'))
        pulse_length = int(st.sidebar.number_input(
            'Pulse length', min_value=2, value=20,
            help='Samples per symbol — also the ground-truth atom size.'))
        n_channels = int(st.sidebar.number_input(
            'Number of channels', min_value=1, max_value=5, value=3,
            help='Channels of the multi-channel signal. Each symbol plays '
                 'the same pulse shape on every channel, and each atom must '
                 'explain all channels at once (channels are not shifted '
                 'independently).'))
        shapes = st.sidebar.multiselect(
            'Pulse shapes', ['n', '-', '^', 'v', '_'], default=['n', '^', 'v'],
            help="Ground-truth symbol shapes: 'n' half-sine bump, '-' "
                 "constant high, '^' rising ramp, 'v' falling ramp, '_' "
                 "constant low. One dictionary atom per selected shape.")
        symbols = [s * n_channels for s in shapes]
        V, W = [], None
        for _ in range(n_signals):
            signal, W = generate_pulse_train(symbols=symbols,
                                             pulse_length=pulse_length, n_pulses=n_pulses)
            V.append(signal)
        V = np.stack(V)
        return V, dict(n_atoms=len(symbols), atom_shape=(pulse_length,))

    def _plot_pair(self, a, b, labels):
        plt = pyplot()
        if plt is None:
            return
        n_channels = a.shape[0]
        fig, axes = plt.subplots(n_channels, 1, squeeze=False, figsize=(8, 1.8 * n_channels))
        for c in range(n_channels):
            axes[c, 0].plot(a[c], label=labels[0])
            axes[c, 0].plot(b[c], '--', label=labels[1])
            axes[c, 0].legend(loc='upper right', fontsize=7)
        st.pyplot(fig)

    def _plot_atom_row(self, w, v, r, i_atom):
        plt = pyplot()
        if plt is None:
            return
        n_channels = v.shape[0]
        fig, axes = plt.subplots(n_channels, 2, squeeze=False,
                                 figsize=(9, 1.8 * n_channels),
                                 gridspec_kw={'width_ratios': [1, 3]})
        for c in range(n_channels):
            axes[c, 0].plot(w[c], color='tab:red')
            axes[c, 1].plot(v[c], label='signal', zorder=-1)
            axes[c, 1].plot(r[c], '--', color='tab:red', label='atom contribution')
            axes[c, 1].legend(loc='upper right', fontsize=7)
        axes[0, 0].set_title(f'Atom {i_atom + 1}', fontsize=9)
        axes[0, 1].set_title('Contribution to the reconstruction', fontsize=9)
        st.pyplot(fig)


class SignalTool2D(SignalTool):
    def __init__(self, n_dims: int = 2):
        super().__init__(2)

    def _generate(self, verbose: bool) -> Tuple[np.ndarray, dict]:
        from .signals import PATCH_PATTERNS, generate_block_image
        n_symbols = int(st.sidebar.number_input(
            'Patches per image side', min_value=2, value=5,
            help='The image is a grid of n x n randomly chosen patches; '
                 'larger grids give more occurrences of every patch to '
                 'learn from.'))
        symbol_size = int(st.sidebar.number_input(
            'Patch size', min_value=3, value=10,
            help='Pixels per patch side — also the ground-truth atom size. '
                 'Patches tile the image exactly, so atoms sit on a regular '
                 'grid the model does not know about.'))
        color = st.sidebar.radio(
            'Channels', ['3 (color patches)', '1 (grayscale patches)'], index=0,
            help='Color draws every pattern in several colors (one '
                 'ground-truth atom per pattern-color pair, 3-channel '
                 'image); grayscale keeps one atom per pattern.')
        symbols = None if color.startswith('3') else list(PATCH_PATTERNS)
        image, W = generate_block_image(symbols=symbols,
                                        symbol_size=symbol_size, n_symbols=n_symbols)
        V = image[np.newaxis]
        return V, dict(n_atoms=len(W), atom_shape=(symbol_size, symbol_size))

    @staticmethod
    def _as_image(img):
        return (np.clip(np.moveaxis(img, 0, -1), 0, 1)
                if img.shape[0] in (3, 4) else img[0])

    def _plot_pair(self, a, b, labels):
        plt = pyplot()
        if plt is None:
            return
        fig, axes = plt.subplots(1, 2, figsize=(8, 4))
        for ax, img, title in zip(axes, (a, b), labels):
            im = self._as_image(img)
            ax.imshow(im, cmap='gray' if im.ndim == 2 else None)
            ax.set_title(title)
            ax.axis('off')
        st.pyplot(fig)

    def _plot_atom_row(self, w, v, r, i_atom):
        plt = pyplot()
        if plt is None:
            return
        fig, axes = plt.subplots(1, 3, figsize=(10, 3.2),
                                 gridspec_kw={'width_ratios': [1, 2, 2]})
        wmax = float(np.max(w)) or 1.0
        for ax, img, title in zip(
                axes, (w / wmax, v, r),
                (f'Atom {i_atom + 1}', 'Input', 'Atom contribution')):
            im = self._as_image(np.asarray(img))
            ax.imshow(im, cmap='gray' if im.ndim == 2 else None)
            ax.set_title(title, fontsize=9)
            ax.axis('off')
        st.pyplot(fig)


# ---------------------------------------------------------------------------
# cached fitting
# ---------------------------------------------------------------------------

_FIT_CACHE: dict = {}


def fit_nmf_model(V: np.ndarray, nmf_params: dict, fit_params: dict,
                  progress_bar=None, seed: int = 42, *, device=None,
                  use_pallas: Optional[bool] = None, dtype=None) -> TransformInvariantNMF:
    """Fit a model with progress reporting; memoized on (V, params, device,
    ``use_pallas``, dtype) like the reference's ``@st.cache``-wrapped
    helper.  The model lives on ``device`` (:data:`DEVICE` when None), in
    ``dtype`` (the model's default, float32, when None); ``use_pallas`` is
    the model's kernel/plain switch."""
    device = device_of(device)
    model_params = dict(nmf_params, device=device, use_pallas=use_pallas)
    if dtype is not None:
        model_params['dtype'] = dtype
    key = hashlib.sha1(
        V.tobytes() + repr(sorted(model_params.items())).encode()
        + repr(sorted(fit_params.items())).encode() + str(seed).encode()).hexdigest()
    if key in _FIT_CACHE:
        return _FIT_CACHE[key]

    total = fit_params.get('n_iterations', fit_params.get('n_epochs', 1))

    def callback(nmf, iteration) -> bool:
        if progress_bar is not None:
            progress_bar.progress((iteration + 1) / total)
        return True

    np.random.seed(seed)
    nmf = TransformInvariantNMF(**model_params)
    nmf.fit(V, progress_callback=callback, **fit_params)
    _FIT_CACHE[key] = nmf
    return nmf
