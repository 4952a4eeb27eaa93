"""tnmf_tpu_torch — the PyTorch/CUDA port of tnmf_tpu.

Shift-invariant NMF by multiplicative updates on an NVIDIA Hopper GPU: plain
tensor code in PyTorch, and every kernel that the JAX package wrote in
Pallas for the TPU as a kernel hand-written in CUDA C++ for ``sm_90a``
(``tnmf_tpu_torch/csrc``, built at first use by
:mod:`tnmf_tpu_torch.kernels._build`).  The JAX package ``tnmf_tpu`` is the
reference the port is held against; this package imports neither it nor
JAX.

Ported so far: the full-batch MU fit on the direct-convolution, FFT and
plain-NMF (matmul) strategies, with lateral inhibition and every objective
of the JAX package, its fit driver and the encoder (``transform``), the
minibatch and streaming fits (the five algorithms of
:class:`MiniBatchAlgorithm`, ``fit_stream``, ``partial_fit``,
:class:`MiniBatchTransformInvariantNMF`), the transform groups
(``transform_type``), ``init='device'``, ``w_init``, the sklearn
protocol, the HALS solvers (``fit(solver='hals')``, whose sweeps run
through K5), the MU hyperparameter sweeps (:func:`sweep_fit`, many
models at once, each kernel launched once for all of them) and the
multi-scale model (:class:`MultiScaleTNMF`, atom banks of several sizes,
each scale on the kernels against the total reconstruction);
``use_pallas=False`` runs the kernels' plain versions (see ROADMAP.md for
the rest)::

    from tnmf_tpu_torch import MiniBatchAlgorithm, TransformInvariantNMF
    nmf = TransformInvariantNMF(n_atoms=16, atom_shape=(9, 9), device='cuda')
    nmf.fit(V, n_iterations=100, sparsity_H=0.1, inhibition_strength=0.1)
    nmf.fit(V, algorithm=MiniBatchAlgorithm.ASG_MU, batch_size=16, n_epochs=10)
    d4 = TransformInvariantNMF(16, (9, 9), transform_type='shift+rot90+flip', init='device')
    res = sweep_fit(V, 16, (9, 9), n_models=8, n_iterations=100, sparsity=[0.05, 0.1] * 4)
    ms = MultiScaleTNMF((12, 4), ((9, 9), (5, 5)), device='cuda').fit(V, n_iterations=100)
"""

from .engine_minibatch import MiniBatchAlgorithm
from .models.multiscale import MultiScaleTNMF, from_numpy_scales
from .models.sweep import SweepResult, sweep_fit
from .models.tnmf import MiniBatchTransformInvariantNMF, TransformInvariantNMF, from_numpy
from .serving import ServingModel, export_serving, load_serving

__all__ = ['TransformInvariantNMF', 'MiniBatchTransformInvariantNMF', 'MiniBatchAlgorithm',
           'from_numpy', 'export_serving', 'load_serving', 'ServingModel', 'SweepResult',
           'sweep_fit', 'MultiScaleTNMF', 'from_numpy_scales']

__version__ = '0.3.0.dev0'
