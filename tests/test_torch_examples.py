"""The port's examples (``tnmf_tpu_torch.examples``) against the JAX
package's (``examples/*.py``), on the CPU at their smoke settings: the 1-D
examples, the sweep and the 3-D one (``tests/test_torch_examples_2d.py``
holds the others).

Each JAX example runs unedited and in-process (``runpy`` under
``TNMF_TPU_SMOKE=1`` and ``MPLBACKEND=Agg``, stdout captured); the port's
``run(smoke=True, device='cpu')`` runs in the dtype the JAX example runs in
under the tests' x64 switch (``tests/conftest.py``): float64 where its data
is float64, float32 where it casts its data to float32 (the sweeps always
fit in float32).  The lines the port's ``lines`` prints are held to the JAX
example's figure by figure (``tests/torch_examples.py``): float64 examples
within rtol 1e-8, float32 ones within 1e-3, each plus the printed figures'
rounding.  Left out, because they cannot match: the CPU times of
``minibatch_algorithms`` and the sweep's wall time, and the JAX sweep's
last line, its mesh run (the port's meshes are ROADMAP.md item 14e)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnmf_tpu import engine as jengine
from tnmf_tpu_torch.models import sweep as port_sweep

from .torch_examples import check_example, jax_lines
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

F64 = torch.float64

CASES = {
    'beta_divergence': dict(dtype=F64, rtol=1e-8),
    'convergence_control': dict(dtype=F64, rtol=1e-8),
    'minibatch_algorithms': dict(dtype=F64, rtol=1e-8,
                                 drop=[(r'cpu_time=\s*[-\d.]+s', 'cpu_time=?')]),
    'multiscale_decomposition': dict(dtype=F64, rtol=1e-8),
    'online_learning': dict(dtype=F64, rtol=1e-8),
    'volumetric_decomposition': dict(dtype=F64, rtol=1e-8),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_example_matches_jax(name, monkeypatch, capsys):
    assert check_example(name, monkeypatch, capsys, **CASES[name]) > 0


def _jax_draw(gens, n_models, w_shape, h_shape, n_shift_axes, dtype, device):
    """``port_sweep._draw`` replaced by the JAX sweep's inits: model s from
    ``jax.random.PRNGKey(seed_s)`` through ``engine.init_matrices``, as the
    JAX ``sweep_fit`` draws them for a vector of seeds (its float32 cast of
    the data makes them float32)."""
    keys = jnp.stack([jax.random.PRNGKey(int(g.initial_seed())) for g in gens])
    W0, H0 = jax.vmap(lambda k: jengine.init_matrices(
        k, w_shape=w_shape, h_shape=h_shape, n_shift_axes=n_shift_axes,
        dtype=jnp.float32))(keys)
    return (torch.as_tensor(np.array(W0), dtype=dtype, device=device),
            torch.as_tensor(np.array(H0), dtype=dtype, device=device))


def test_hyperparameter_sweep_matches_jax(monkeypatch, capsys):
    """The port's sweeps draw their inits from ``torch.Generator``s, the JAX
    sweeps from ``jax.random``: the port's example runs from the JAX inits
    (``_jax_draw``), in float32 as both sweeps fit."""
    monkeypatch.setattr(port_sweep, '_draw', _jax_draw)
    n = check_example('hyperparameter_sweep', monkeypatch, capsys, dtype=torch.float32,
                      rtol=1e-3, keep=lambda line: not line.startswith('mesh('),
                      drop=[(r' in [\d.]+ s \(one (compiled graph|vmapped fit)', ' in ? s (')],
                      same_text=False)
    assert n > 40


def test_main_prints_what_the_jax_example_prints(monkeypatch, capsys):
    """``main()`` under ``TNMF_TPU_SMOKE=1`` (its ``run`` pointed at the CPU
    in float64) prints the JAX example's lines, character for character,
    and draws them."""
    from tnmf_tpu_torch.examples import convergence_control as example
    run = example.run
    monkeypatch.setattr(example, 'run',
                        lambda smoke: run(smoke=smoke, device='cpu', dtype=F64))
    jax_printed = jax_lines('convergence_control', monkeypatch, capsys)
    example.main()
    assert capsys.readouterr().out.splitlines() == jax_printed
    import matplotlib.pyplot as plt
    assert plt.get_fignums()
    plt.close('all')
