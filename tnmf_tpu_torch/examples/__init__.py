"""The port's bundled examples (port of the repository's ``examples/``).

Each example module computes, reports and draws apart:

* ``run(smoke=False, device='cuda', use_pallas=None, dtype=torch.float32)``
  runs the example's data, seeds, models and fits on ``device`` and returns
  its figures (energies, divergences, errors, shapes, iterations) in a
  dict, with what the figures draw under ``'plot'``; ``smoke=True`` takes
  the smaller sizes of ``TNMF_TPU_SMOKE``, ``use_pallas`` is the models'
  kernel/plain switch;
* ``lines(result)`` the lines the example prints;
* ``plot(result)`` draws them where matplotlib is installed;
* ``main()`` runs, prints and draws: ``python -m
  tnmf_tpu_torch.examples.<name>``, ``TNMF_TPU_SMOKE=1`` for the smaller
  sizes.

Figures named in a module's ``NOT_COMPARED`` (wall and CPU times, paths,
file sizes, platforms, the memory planner's table) differ from run to run
or from the JAX package's by nature; every other figure is a result.

The two data-parallel examples (``data_parallel_fit``, a world of one
unless run under ``torchrun``; ``multihost_fit``, two worker processes)
start process groups of their own; ``model_parallel_fit`` waits for the
port's mesh over the atoms (ROADMAP.md queue 1, item 14e-ii).
"""

from __future__ import annotations

import os

import torch

#: the ported examples that run in this process alone, by module name
SINGLE_PROCESS_EXAMPLES = (
    'beta_divergence', 'convergence_control', 'hyperparameter_sweep', 'masked_inpainting',
    'minibatch_algorithms', 'multiscale_decomposition', 'online_learning',
    'plain_nmf_solvers', 'serving_deployment', 'shift_invariant_decomposition',
    'shift_invariant_solvers', 'transform_invariances', 'volumetric_decomposition')
#: the ported examples that start process groups of their own
DATA_PARALLEL_EXAMPLES = ('data_parallel_fit', 'multihost_fit')
#: every ported example
EXAMPLES = SINGLE_PROCESS_EXAMPLES + DATA_PARALLEL_EXAMPLES

#: the JAX package's examples that need a mesh not ported yet
MESH_EXAMPLES = ('model_parallel_fit',)
MESH_ITEM = 'ROADMAP.md queue 1, item 14e-ii'


def smoke_from_env() -> bool:
    """True where ``TNMF_TPU_SMOKE`` is set to a non-empty value, as the
    JAX package's examples read it."""
    return bool(os.environ.get('TNMF_TPU_SMOKE'))


def synchronize(device) -> None:
    """Wait for the card's queued work (no-op elsewhere): wall-clock
    figures of a fit then include its device time."""
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)
