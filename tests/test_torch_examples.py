"""The port's examples (``tnmf_tpu_torch.examples``) against the JAX
package's (``examples/*.py``), on the CPU at their smoke settings: the 1-D
examples, the sweep, the 3-D one and the two data-parallel ones
(``tests/test_torch_examples_2d.py`` holds the others).

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
last line, its mesh run (a 'models' mesh, ROADMAP.md item 14e-iv).

``data_parallel_fit`` runs at a world of one against the JAX example on
one device; ``multihost_fit``'s two workers run on the CPU from the JAX
package's device draws (the port's ``init='device'`` draws from torch's
generators) against the lines the JAX example's two processes print."""

import functools
import json
import os
import runpy
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tnmf_tpu
import tnmf_tpu.parallel as jax_parallel
from tnmf_tpu import engine as jengine
from tnmf_tpu_torch.examples import multihost_fit
from tnmf_tpu_torch.models import sweep as port_sweep

from .torch_examples import REPO, assert_figures, check_example, jax_lines
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


def test_data_parallel_fit_matches_jax_at_a_world_of_one(monkeypatch, capsys):
    """The port's example starts a world of one on the CPU (gloo); the JAX
    example runs on one of its devices (its mesh and count patched to
    one).  Left out: the layout line and the mesh fit's distance from the
    mesh-free one (0 in the port's world of one, where the all-reduce is
    the identity; about 2e-7 in the JAX package's sharded program)."""
    monkeypatch.setattr(jax_parallel, 'make_mesh',
                        functools.partial(jax_parallel.make_mesh, n_devices=1))
    monkeypatch.setattr(jax, 'device_count', lambda: 1)
    n = check_example('data_parallel_fit', monkeypatch, capsys, dtype=torch.float32, rtol=1e-3,
                      keep=lambda line: not line.startswith(('sharded H layout', 'max |W')))
    assert n == 4
    assert not torch.distributed.is_initialized()


MULTIHOST_WORKER = r'''
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from tnmf_tpu_torch import TransformInvariantNMF
from tnmf_tpu_torch.examples import multihost_fit
init = np.load(sys.argv[3])
TransformInvariantNMF._device_uniform = lambda self, shape: torch.as_tensor(init['W'])
TransformInvariantNMF._device_rows = lambda self, shape, rows: torch.as_tensor(init['H'][rows])
print('RESULT ' + json.dumps(multihost_fit.worker(sys.argv[1], int(sys.argv[2]), 'cpu')))
'''


def test_multihost_fit_workers_match_the_jax_examples_energies(tmp_path, monkeypatch, capfd):
    """Two port workers on the CPU, each drawing the JAX package's
    ``init='device'`` start (its ``_device_uniform`` and ``_device_rows``
    patched to hand back the JAX draws: W whole, H the rank's rows),
    against the JAX example's two processes: every rank's final energy
    and atom norms within rtol 1e-3 (float32), the layout lines left out
    (the JAX processes hold four virtual devices each)."""
    V = np.random.default_rng(0).random((16, 2, 24, 24)).astype(np.float32)
    jm = tnmf_tpu.TransformInvariantNMF(n_atoms=4, atom_shape=(5, 5), init='device', seed=0)
    jm._initialize_matrices(V, keep_W=False)
    init = str(tmp_path / 'init.npz')
    np.savez(init, W=np.asarray(jm._W), H=np.asarray(jm._H))
    store = 'file://' + str(tmp_path / 'store')
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, '-c', MULTIHOST_WORKER, store, str(rank), init],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for rank in range(2)]
    try:
        capfd.readouterr()
        monkeypatch.setenv('TNMF_TPU_SMOKE', '1')
        runpy.run_path(os.path.join(REPO, 'examples', 'multihost_fit.py'), run_name='__main__')
        jax_printed = capfd.readouterr().out.splitlines()
        outputs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outputs
    workers = [json.loads(next(line[7:] for line in out.splitlines()
                               if line.startswith('RESULT '))) for out, _ in outputs]
    port = multihost_fit.lines(dict(workers=workers))

    def results(lines):
        return sorted(line for line in lines if 'final energy' in line or 'finished' in line)
    # each rank's line: its number, its energy and the 8 atom norms
    assert assert_figures(results(port), results(jax_printed), 1e-3) == 2 * (2 + 8)
