"""tnmf_tpu_torch — the PyTorch/CUDA port of tnmf_tpu.

Shift-invariant NMF by multiplicative updates on an NVIDIA Hopper GPU: plain
tensor code in PyTorch, and every kernel that the JAX package wrote in
Pallas for the TPU as a kernel hand-written in CUDA C++ for ``sm_90a``
(``tnmf_tpu_torch/csrc``, built at first use by
:mod:`tnmf_tpu_torch.kernels._build`).  The JAX package ``tnmf_tpu`` is the
reference the port is held against; this package imports neither it nor
JAX.

Ported so far: the full-batch MU fit with the direct-convolution strategy,
with lateral inhibition (see ROADMAP.md for the rest)::

    from tnmf_tpu_torch import TransformInvariantNMF
    nmf = TransformInvariantNMF(n_atoms=16, atom_shape=(9, 9), device='cuda')
    nmf.fit(V, n_iterations=100, sparsity_H=0.1, inhibition_strength=0.1)
"""

from .models.tnmf import TransformInvariantNMF, from_numpy

__all__ = ['TransformInvariantNMF', 'from_numpy']

__version__ = '0.3.0.dev0'
