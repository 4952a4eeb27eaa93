"""A world of two processes on the CPU for the port's mesh tests
(``tests/test_torch_mesh*.py``, ``tests/test_torch_distributed.py``).

:class:`World` spawns two workers (``python -m tests.torch_mesh SUITE
STORE RANK OUT``) that meet through a ``file://`` store (no port: Tier-1
runs several pytest workers at once) over gloo, each on one torch thread,
with a 60 s timeout on every collective.  The workers run every case of
the suite on ``TransformInvariantNMF(mesh=make_mesh(devices='cpu'))`` in
float64; rank 0 gathers the ranks' rows of H and writes one ``.npz``.
:meth:`World.result` waits for both (at most ``TIMEOUT`` seconds, then
kills them) and reads it, so a hung worker fails the tests of one file.

The cases' data and arguments live here, in NumPy alone: the workers
import no JAX, and the tests fit the same cases with the JAX package.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180
WORLD = 2

#: the MU cases: (model keywords, fit keywords) on ``data()``
MU_CASES = {
    'conv': ({}, dict(n_iterations=5, sparsity_H=0.1)),
    'fft': (dict(backend='jax_fft'), dict(n_iterations=5, sparsity_H=0.1)),
    'mask': ({}, dict(n_iterations=5, sparsity_H=0.1, mask='mask')),
    'beta1': (dict(beta_loss=1.0), dict(n_iterations=5, sparsity_H=0.1)),
    'beta1_fft': (dict(beta_loss=1.0, backend='jax_fft'), dict(n_iterations=5)),
    'inhibition': ({}, dict(n_iterations=5, sparsity_H=0.1, inhibition_strength=0.1,
                            cross_atom_inhibition_strength=0.05)),
    'flip': (dict(transform_type='shift+flip'), dict(n_iterations=4, sparsity_H=0.1)),
    'ortho_W': ({}, dict(n_iterations=5, ortho_W=0.2, l2_H=0.05)),
    'correlate': (dict(h_init='correlate'), dict(n_iterations=4)),
    'record_energies': ({}, dict(n_iterations=6, sparsity_H=0.1, record_energies=True)),
    'tol': ({}, dict(n_iterations=60, tol=2e-3, tol_check_every=3, record_energies=True)),
    'extrapolate': ({}, dict(n_iterations=40, tol=1e-3, tol_check_every=2, extrapolate=True,
                             record_energies=True)),
}
#: ``transform`` against a fixed dictionary
TRANSFORM = dict(n_iterations=5, sparsity_H=0.1)

#: the HALS cases: (data shape, model keywords, fit keywords); the plain-NMF
#: case's 'auto' inner count is 2 for its 2000 samples and 1 for a rank's
#: 1000 (engine_hals.auto_inner)
HALS_CASES = {
    'plain': ((2000, 1, 1024), dict(n_atoms=2, atom_shape=(1024,), reconstruction_mode='full'),
              dict(n_iterations=3, solver='hals', sparsity_H=0.01, l2_W=0.1,
                   record_energies=True)),
    'shift_invariant': ((8, 1, 12, 12), dict(n_atoms=3, atom_shape=(3, 3),
                                             reconstruction_mode='full'),
                        dict(n_iterations=3, solver='hals', sparsity_H=0.1,
                             record_energies=True)),
    'plain_tol': ((64, 1, 36), dict(n_atoms=3, atom_shape=(36,), reconstruction_mode='full'),
                  dict(n_iterations=50, solver='hals', tol=1e-3, tol_check_every=2)),
}


def data(shape=(8, 2, 12, 12), seed=0) -> np.ndarray:
    return np.random.default_rng(seed).random(shape)


def mask(shape=(8, 2, 12, 12)) -> np.ndarray:
    return (np.random.default_rng(1).random(shape) > 0.2).astype(np.float64)


def dictionary() -> np.ndarray:
    W = np.random.default_rng(2).random((4, 2, 3, 3))
    return W / W.sum(axis=(-2, -1), keepdims=True)


def fit_kwargs(kw: dict) -> dict:
    """The fit keywords with the mask's name replaced by the mask."""
    return {k: mask() if v == 'mask' else v for k, v in kw.items()}


class World:
    """Two workers running ``suite``; :meth:`result` waits for them."""

    def __init__(self, suite: str, tmp_path):
        self.out = os.path.join(str(tmp_path), f'{suite}.npz')
        store = 'file://' + os.path.join(str(tmp_path), 'store')
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (ROOT, os.environ.get('PYTHONPATH', '')) if p))
        self.procs = [subprocess.Popen(
            [sys.executable, '-m', 'tests.torch_mesh', suite, store, str(rank), self.out],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for rank in range(WORLD)]
        self._result = None

    def result(self) -> dict:
        if self._result is None:
            outputs = []
            try:
                for p in self.procs:
                    outputs.append(p.communicate(timeout=TIMEOUT))
            except subprocess.TimeoutExpired:
                raise AssertionError(f'a worker did not finish within {TIMEOUT} s') from None
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            codes = [p.returncode for p in self.procs]
            if codes != [0] * WORLD:
                raise AssertionError(f'workers exited {codes}:\n' + '\n'.join(
                    f'--- rank {r}\n{out}\n{err}' for r, (out, err) in enumerate(outputs)))
            with np.load(self.out, allow_pickle=False) as f:
                self._result = dict(f)
        return self._result


# ---------------------------------------------------------------- workers

def _results(model, name: str, out: dict) -> None:
    """W, this rank's H rows, the energy and the fit's trace and count."""
    out[f'{name}/W'] = model.W
    out[f'{name}/H'] = model._local_H()
    out[f'{name}/energy'] = np.float64(model._energy_function())
    out[f'{name}/n_iter'] = np.int64(model.n_iterations_)
    if getattr(model, 'energies_', None) is not None:
        out[f'{name}/energies'] = np.asarray(model.energies_)


def _mu(mesh, out: dict) -> None:
    from tnmf_tpu_torch import TransformInvariantNMF
    V = data()
    for name, (model_kw, fit_kw) in MU_CASES.items():
        m = TransformInvariantNMF(4, (3, 3), seed=0, dtype='float64', device='cpu', mesh=mesh,
                                  **model_kw)
        m.fit(V, **fit_kwargs(fit_kw))
        _results(m, name, out)
    m = TransformInvariantNMF(4, (3, 3), seed=0, dtype='float64', device='cpu', mesh=mesh)
    m.set_dictionary(dictionary())
    out['transform/H'] = m.transform(V, **TRANSFORM)
    out['transform/energy'] = np.float64(m._energy_function())


def _hals(mesh, out: dict) -> None:
    from tnmf_tpu_torch import TransformInvariantNMF
    for name, (shape, model_kw, fit_kw) in HALS_CASES.items():
        m = TransformInvariantNMF(seed=0, dtype='float64', device='cpu', mesh=mesh, **model_kw)
        m.fit(data(shape, seed=3), **fit_kw)
        _results(m, name, out)


def _errors(model, V) -> dict:
    """What each call that a world of two refuses raises: (type, message)."""
    from tnmf_tpu_torch import MiniBatchAlgorithm
    calls = {
        'H': lambda: model.H, 'V': lambda: model.V, 'R': lambda: model.R,
        'reconstruction_err_': lambda: model.reconstruction_err_,
        'fit_minibatches': lambda: model.fit(V, algorithm=MiniBatchAlgorithm.Cyclic_MU,
                                             batch_size=4, n_epochs=1),
        'fit_stream': lambda: model.fit(iter(V), subsample_size=4, max_subsamples=1),
        'partial_fit': lambda: model.partial_fit(V),
        'save': lambda: model.save('unused.npz'),
        'checkpoint_every': lambda: model.fit(V, n_iterations=2, checkpoint_every=1,
                                              checkpoint_path='unused.npz'),
        'transform_batch_size': lambda: model.transform(V, n_iterations=1, batch_size=4),
        'revive_every': lambda: model.fit(V, n_iterations=2, revive_every=1),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
        except (NotImplementedError, RuntimeError, ValueError) as e:
            out[f'error:{name}'] = np.array(f'{type(e).__name__}: {e}')
        else:
            out[f'error:{name}'] = np.array('no error')
    return out


def _distributed(mesh, out: dict) -> None:
    import torch
    from tnmf_tpu_torch import TransformInvariantNMF
    from tnmf_tpu_torch.parallel import distributed
    V = data()
    rank, n_local = mesh.get_local_rank(), V.shape[0] // WORLD
    V_local = V[rank * n_local:(rank + 1) * n_local]
    kw = dict(seed=0, dtype='float64', device='cpu', mesh=mesh, init='device')
    fit = dict(n_iterations=5, sparsity_H=0.1)
    whole = TransformInvariantNMF(4, (3, 3), **kw)
    whole.fit(V, **fit)
    _results(whole, 'device_whole', out)
    blocks = distributed.fit_distributed(TransformInvariantNMF(4, (3, 3), **kw), V_local, **fit)
    _results(blocks, 'device_blocks', out)
    # a mask distributed like V, against the same mask given whole
    M = mask()
    masked = TransformInvariantNMF(4, (3, 3), **kw)
    masked.fit(distributed.distribute_samples(mesh, V_local), n_iterations=4,
               mask=distributed.distribute_samples(mesh, M[rank * n_local:(rank + 1) * n_local]))
    _results(masked, 'mask_blocks', out)
    masked_whole = TransformInvariantNMF(4, (3, 3), **kw)
    masked_whole.fit(V, n_iterations=4, mask=M)
    _results(masked_whole, 'mask_whole', out)
    out.update(_errors(whole, V))
    host = TransformInvariantNMF(4, (3, 3), seed=0, dtype='float64', device='cpu', mesh=mesh)
    try:
        distributed.fit_distributed(host, V_local, n_iterations=1)
    except ValueError as e:
        out['error:host_init'] = np.array(f'ValueError: {e}')
    try:
        distributed.distribute_samples(mesh, V_local[:1 + rank])
    except ValueError as e:
        out['error:unequal_blocks'] = np.array(f'ValueError: {e}')
    # every rank's replica of W is the same tensor, bit for bit
    W = torch.as_tensor(whole.W)
    gathered = [torch.empty_like(W) for _ in range(WORLD)]
    torch.distributed.all_gather(gathered, W)
    out['replicas_equal'] = np.array(all(torch.equal(g, W) for g in gathered))


SUITES = {'mu': _mu, 'hals': _hals, 'distributed': _distributed}


def main(suite: str, store: str, rank: int, path: str) -> None:
    from datetime import timedelta

    import torch
    torch.set_num_threads(1)
    torch.distributed.init_process_group('gloo', init_method=store, rank=rank,
                                         world_size=WORLD, timeout=timedelta(seconds=60))
    from tnmf_tpu_torch.parallel import make_mesh
    mesh = make_mesh(devices='cpu')
    out = {}
    SUITES[suite](mesh, out)
    gathered = [None] * WORLD
    torch.distributed.all_gather_object(gathered, out)
    if rank == 0:
        merged = dict(out)
        for key in out:
            if key.endswith('/H'):  # the ranks' rows, in rank order
                merged[key] = np.concatenate([g[key] for g in gathered])
            elif key.endswith('/W'):
                merged[key + '_ranks_equal'] = np.array(
                    all(np.array_equal(g[key], out[key]) for g in gathered))
        np.savez(path, **merged)
    torch.distributed.destroy_process_group()


if __name__ == '__main__':
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4])
