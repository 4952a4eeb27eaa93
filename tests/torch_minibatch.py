"""The minibatch fits of both packages on the goldens' data, for
``tests/test_torch_minibatch.py`` and ``tests/test_torch_minibatch_jax.py``:
64 patches of 32 x 32 (``tests/test_minibatch.py``), 10 atoms of 7 x 7,
``batch_size=5`` (a ragged final batch of 4), 3 epochs,
``sag_lambda=0.8``; the port's in float64 on the CPU."""

from functools import lru_cache

import numpy as np
import torch

import tnmf_tpu

import tnmf_tpu_torch
from tnmf_tpu_torch import MiniBatchAlgorithm

from .fixtures import patches_2d as _patches_2d

F64 = torch.float64
TOL = dict(rtol=1e-8, atol=1e-10)
ALGORITHMS = [a.name for a in MiniBatchAlgorithm]
SCHEDULE = dict(batch_size=5, n_epochs=3, sag_lambda=0.8)


@lru_cache(maxsize=None)
def patches_2d():
    """The goldens' patches, synthesized once per process."""
    return _patches_2d()


def _model(module, backend='jax_fft', cls='TransformInvariantNMF', **init):
    kw = dict(device='cpu', dtype=F64) if module is tnmf_tpu_torch else {}
    return getattr(module, cls)(n_atoms=10, atom_shape=(7, 7), backend=backend, **init, **kw)


def _fit(module, backend, algorithm, **fit):
    """The golden fit from ``np.random.seed(42)``; returns the model and the
    global stream's next draw after the fit."""
    np.random.seed(seed=42)
    nmf = _model(module, backend)
    if algorithm == 'full_batch':
        nmf.fit_batch(patches_2d(), sparsity_H=0.1, n_iterations=3)
    else:
        nmf.fit_minibatches(patches_2d(), sparsity_H=0.1,
                            algorithm=module.MiniBatchAlgorithm[algorithm], **SCHEDULE, **fit)
    return nmf, np.random.random()


@lru_cache(maxsize=None)
def _jax_fit(backend, algorithm, inhibited=False, record_energies=False):
    fit = dict(inhibition_strength=0.2, cross_atom_inhibition_strength=0.1) if inhibited else {}
    return _fit(tnmf_tpu, backend, algorithm, record_energies=record_energies, **fit)


def _assert_same(pm, jm):
    np.testing.assert_allclose(pm.W, jm.W, **TOL)
    np.testing.assert_allclose(pm.H, jm.H, **TOL)
