"""The port's fit_batch dispatch against the JAX package, in float64 on the CPU:
every MU branch of ``fit_batch`` (callbacks, chunked callbacks, logging,
``record_energies``, ``tol``, ``extrapolate``, ``keep_H``, periodic
checkpoints and dead-atom revival), its guard rails, and checkpoints
written by one package and resumed by the other."""

import inspect
import logging
import os
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tnmf_tpu
from tnmf_tpu.utils import atoms as jatoms

import tnmf_tpu_torch
from tnmf_tpu_torch import engine
from tnmf_tpu_torch.utils import atoms

from .fixtures import image_2d as _image_2d, load_goldens

F64 = torch.float64
TOL = dict(rtol=1e-8, atol=1e-10)
PACKAGES = (tnmf_tpu, tnmf_tpu_torch)

# 2-D: 2 x 2 x 24 x 24 with 3 atoms of 5 x 5; 1-D: 1 x 3 x 100 with 3 atoms of 7
PROBLEMS = {
    '2d': (np.random.default_rng(0).random((2, 2, 24, 24)), (5, 5)),
    '1d': (np.random.default_rng(1).random((1, 3, 100)), (7,)),
}


@lru_cache(maxsize=None)
def image_2d():
    """The golden 2-D fixture, synthesized once for the module."""
    return _image_2d()


def _model(module, dim='2d', seed=1, **init):
    kw = dict(device='cpu', dtype=F64) if module is tnmf_tpu_torch else {}
    return module.TransformInvariantNMF(3, PROBLEMS[dim][1], seed=seed, **init, **kw)


def _fit_both(dim='2d', init=None, **fit):
    """The JAX model and the port's, built alike and fit alike."""
    out = []
    for module in PACKAGES:
        m = _model(module, dim, **(init or {}))
        m.fit(PROBLEMS[dim][0], **fit)
        out.append(m)
    return out


def _assert_same(jm, pm, energies=False):
    assert pm.n_iterations_ == jm.n_iterations_
    np.testing.assert_allclose(pm.W, jm.W, **TOL)
    np.testing.assert_allclose(pm.H, jm.H, **TOL)
    if energies:
        assert pm.energies_.shape == jm.energies_.shape
        assert pm.energies_.dtype == jm.energies_.dtype
        np.testing.assert_allclose(pm.energies_, jm.energies_, **TOL)


@pytest.mark.parametrize('inhibited', [False, True])
@pytest.mark.parametrize('dim', ['1d', '2d'])
@pytest.mark.parametrize('mode', ['valid', 'full', 'circular'])
def test_record_energies_matches_jax(mode, dim, inhibited):
    fit = dict(n_iterations=6, sparsity_H=0.1, record_energies=True)
    if inhibited:
        fit.update(inhibition_strength=0.1, cross_atom_inhibition_strength=0.05)
    jm, pm = _fit_both(dim, dict(reconstruction_mode=mode), **fit)
    _assert_same(jm, pm, energies=True)
    assert pm.energies_.shape == (6,)
    np.testing.assert_allclose(pm.energies_[-1], pm._energy_function(), rtol=1e-12)


@pytest.mark.parametrize('mode', ['valid', 'full', 'circular'])
def test_record_energies_golden_2d(mode):
    """The golden 2-D fixture's trace ends at the golden energy."""
    np.random.seed(42)
    nmf = tnmf_tpu_torch.TransformInvariantNMF(
        n_atoms=10, atom_shape=(7, 7), reconstruction_mode=mode, device='cpu', dtype=F64)
    nmf.fit(image_2d(), sparsity_H=0.1, n_iterations=10, record_energies=True)
    golden = load_goldens()['2d'][mode]
    assert nmf.energies_.shape == (10,)
    assert abs(nmf.energies_[-1] - golden) / golden <= 1e-4


def test_record_energies_never_rise_without_regularizers():
    """MU never raises the plain objective, so the golden 2-D fixture's
    trace falls at every iteration once sparsity_H is 0 (with it the
    recorded reconstruction energy alone may rise, as it does there)."""
    np.random.seed(42)
    nmf = tnmf_tpu_torch.TransformInvariantNMF(n_atoms=10, atom_shape=(7, 7), device='cpu',
                                               dtype=F64)
    nmf.fit(image_2d(), n_iterations=10, record_energies=True)
    assert np.all(np.diff(nmf.energies_) < 0)


@pytest.mark.parametrize('record', [False, True])
@pytest.mark.parametrize('check_every', [3, 7])
def test_tol_matches_jax(check_every, record):
    jm, pm = _fit_both(n_iterations=60, sparsity_H=0.1, tol=5e-3,
                       tol_check_every=check_every, record_energies=record)
    assert pm.n_iterations_ < 60 and pm.n_iterations_ % check_every == 0
    _assert_same(jm, pm, energies=record)
    if record:
        assert pm.energies_.shape == (pm.n_iterations_,)
    else:
        assert pm.energies_ is None


def test_tol_zero_runs_every_iteration_as_the_plain_loop():
    """tol=0 runs n_iterations, bit for bit the plain loop (a last block
    shorter than tol_check_every)."""
    V = PROBLEMS['2d'][0]
    plain, adaptive = _model(tnmf_tpu_torch), _model(tnmf_tpu_torch)
    plain.fit(V, n_iterations=7, sparsity_H=0.1)
    adaptive.fit(V, n_iterations=7, sparsity_H=0.1, tol=0.0, tol_check_every=3)
    assert adaptive.n_iterations_ == 7
    np.testing.assert_array_equal(adaptive.W, plain.W)
    np.testing.assert_array_equal(adaptive.H, plain.H)


@pytest.mark.parametrize('extrapolate,tol,update_W,record', [
    (True, None, True, False),
    (0.3, None, True, True),
    (True, 5e-3, True, True),
    (0.3, 5e-3, True, False),
    (True, None, False, True),
    (0.3, 5e-3, False, False),
])
def test_extrapolate_matches_jax(extrapolate, tol, update_W, record):
    jm, pm = _fit_both(n_iterations=30, sparsity_H=0.1, extrapolate=extrapolate, tol=tol,
                       tol_check_every=3, update_W=update_W, record_energies=record)
    if tol is not None:
        assert pm.n_iterations_ < 30
    _assert_same(jm, pm, energies=record)
    if not update_W:
        np.testing.assert_array_equal(pm.W, _fresh_W())


def _fresh_W():
    """The dictionary a seed-1 model draws for the 2-D problem (after H)."""
    m = _model(tnmf_tpu_torch)
    m.fit(PROBLEMS['2d'][0], n_iterations=0)
    return m.W


def test_extrapolate_restarts_match_jax(monkeypatch):
    """An aggressive momentum weight makes the energy rise: the restarts
    (momentum dropped, weight halved) take the JAX package's path."""
    rises = []
    change = engine._block_change

    def counting(*args):
        diff, rel = change(*args)
        rises.append(diff < 0)
        return diff, rel
    monkeypatch.setattr(engine, '_block_change', counting)
    jm, pm = _fit_both(n_iterations=40, sparsity_H=0.5, extrapolate=0.9, tol_check_every=1,
                       record_energies=True)
    assert sum(rises) >= 2
    _assert_same(jm, pm, energies=True)


@pytest.mark.parametrize('k', [0, 3])
def test_callback_abort_matches_jax(k):
    """A callback that returns False at iteration k stops after k + 1
    iterations with the JAX model's W and H, and the plain loop's bits."""
    seen = {m: [] for m in PACKAGES}

    def callback(module):
        def fn(model, iteration):
            seen[module].append(iteration)
            return iteration < k
        return fn
    models = []
    for module in PACKAGES:
        m = _model(module)
        m.fit(PROBLEMS['2d'][0], n_iterations=9, sparsity_H=0.1,
              progress_callback=callback(module))
        models.append(m)
    _assert_same(*models)
    assert models[1].n_iterations_ == k + 1 and seen[tnmf_tpu_torch] == list(range(k + 1))
    plain = _model(tnmf_tpu_torch)
    plain.fit(PROBLEMS['2d'][0], n_iterations=k + 1, sparsity_H=0.1)
    np.testing.assert_array_equal(models[1].W, plain.W)
    np.testing.assert_array_equal(models[1].H, plain.H)


@pytest.mark.parametrize('record', [False, True])
@pytest.mark.parametrize('abort', [False, True])
def test_callback_interval_matches_jax(abort, record):
    """With callback_interval=3 the callback sees iterations 2, 5, 8 (and
    the last, 9); aborting at 5 stops after 6 iterations."""
    seen = {m: [] for m in PACKAGES}
    models = []
    for module in PACKAGES:
        def fn(model, iteration, module=module):
            seen[module].append(iteration)
            return not (abort and iteration >= 5)
        m = _model(module)
        m.fit(PROBLEMS['2d'][0], n_iterations=10, sparsity_H=0.1, callback_interval=3,
              progress_callback=fn, record_energies=record)
        models.append(m)
    assert seen[tnmf_tpu_torch] == seen[tnmf_tpu] == ([2, 5] if abort else [2, 5, 8, 9])
    _assert_same(*models, energies=record)
    assert models[1].n_iterations_ == (6 if abort else 10)


def test_n_iterations_on_every_path():
    """``n_iterations_`` (and ``n_iter_``) is the count actually run: the
    plain loop, a callback abort, chunked callbacks, record_energies, tol,
    extrapolate, and zero iterations."""
    V = PROBLEMS['2d'][0]
    cases = [
        (dict(n_iterations=4), 4),
        (dict(n_iterations=9, progress_callback=lambda m, i: i < 5), 6),
        (dict(n_iterations=9, callback_interval=4, progress_callback=lambda m, i: i < 4), 8),
        (dict(n_iterations=5, record_energies=True), 5),
        (dict(n_iterations=0), 0),
        (dict(n_iterations=0, progress_callback=lambda m, i: True), 0),
    ]
    for fit, want in cases:
        for module in PACKAGES:
            m = _model(module)
            m.fit(V, **fit)
            assert m.n_iterations_ == m.n_iter_ == want, (module.__name__, fit)
    for fit in (dict(tol=5e-3, tol_check_every=4), dict(extrapolate=True, tol=5e-3)):
        jm, pm = _fit_both(n_iterations=60, sparsity_H=0.1, **fit)
        assert pm.n_iter_ == jm.n_iter_ < 60


def test_reconstruction_err_matches_jax():
    unfitted = _model(tnmf_tpu_torch)
    with pytest.raises(RuntimeError, match='fitted model'):
        unfitted.reconstruction_err_  # noqa: B018
    jm, pm = _fit_both(n_iterations=3, sparsity_H=0.1)
    np.testing.assert_allclose(pm.reconstruction_err_, jm.reconstruction_err_, rtol=1e-12)
    np.testing.assert_allclose(pm.reconstruction_err_,
                               np.linalg.norm(pm.V - pm.R), rtol=1e-12)


def _records(caplog, logger_name='TransformInvariantNMF'):
    out = [(r.levelno, r.msg, r.args) for r in caplog.records if r.name == logger_name]
    caplog.clear()
    return out


@pytest.mark.parametrize('verbose,fit', [
    (0, dict()),
    (1, dict()),
    (2, dict()),
    (2, dict(record_energies=True)),
    (2, dict(tol=5e-3, tol_check_every=2)),
    (2, dict(progress_callback=lambda m, i: i < 2)),
])
def test_logging_matches_jax(caplog, verbose, fit):
    """The same logger, level and lines as the JAX package: at INFO one
    ``Iteration: %d\\tEnergy function: %s`` line per iteration (none when a
    callback or tol runs the fit), then ``TNMF finished.``."""
    lines = {}
    for module in PACKAGES:
        m = _model(module, verbose=verbose)
        assert m._logger.name == 'TransformInvariantNMF'
        assert m._logger.level == [logging.ERROR, logging.WARNING, logging.INFO,
                                   logging.DEBUG][verbose]
        _records(caplog)
        m.fit(PROBLEMS['2d'][0], n_iterations=4, sparsity_H=0.1, **fit)
        lines[module] = _records(caplog)
    want, got = lines[tnmf_tpu], lines[tnmf_tpu_torch]
    assert [(lvl, msg) for lvl, msg, _ in got] == [(lvl, msg) for lvl, msg, _ in want]
    for (_, _, a), (_, _, b) in zip(got, want):
        assert len(a) == len(b)
        if a:
            assert a[0] == b[0]
            np.testing.assert_allclose(float(a[1]), float(b[1]), rtol=1e-10)
    if verbose == 2 and not fit:
        assert [msg for _, msg, _ in got] == ['Iteration: %d\tEnergy function: %s'] * 4 + [
            'TNMF finished.']
    if verbose < 2:
        assert got == []


def test_debug_line_and_own_logger(caplog):
    """verbose=3 logs the backend line at DEBUG; a given logger is used."""
    own = logging.getLogger('tnmf_tpu_torch.test')
    _records(caplog)
    m = _model(tnmf_tpu_torch, logger=own, verbose=3)
    assert m._logger is own and own.level == logging.DEBUG
    assert _records(caplog, own.name) == [
        (logging.DEBUG, 'Using %s backend (strategy request: %s).', ('auto', 'auto'))]


def _raises_in_both(match, init=None, **fit):
    for module in PACKAGES:
        m = _model(module, **(init or {}))
        with pytest.raises(ValueError, match=match):
            m.fit(PROBLEMS['2d'][0], **{'n_iterations': 2, **fit})


def _noop(model, iteration):
    return True


@pytest.mark.parametrize('fit,match', [
    (dict(update_H=False, update_W=False), 'update_H / update_W'),
    (dict(sparsity_H=-1.), 'sparsity_H must be >= 0'),
    (dict(callback_interval=0, progress_callback=_noop), 'callback_interval must be >= 1'),
    (dict(checkpoint_every=2), 'checkpoint_every and checkpoint_path'),
    (dict(checkpoint_path='x.npz'), 'checkpoint_every and checkpoint_path'),
    (dict(checkpoint_every=2, checkpoint_path='x.npz', tol=1e-3), 'checkpoint_every'),
    (dict(extrapolate=True, progress_callback=_noop), 'extrapolate'),
    (dict(extrapolate=True, checkpoint_every=2, checkpoint_path='x.npz'), 'extrapolate'),
    (dict(extrapolate=True, revive_every=2), 'extrapolate'),
    (dict(extrapolate=1.5), 'extrapolate must be True'),
    (dict(extrapolate=-0.2), 'extrapolate must be True'),
    (dict(checkpoint_every=0, checkpoint_path='x.npz'), 'checkpoint_every must be >= 1'),
    (dict(checkpoint_every=2, checkpoint_path='x.npz', progress_callback=_noop),
     'call save'),
    (dict(revive_every=0), 'revive_every must be >= 1'),
    (dict(revive_every=2, progress_callback=_noop), 'revive_every'),
    (dict(revive_every=2, tol=1e-3), 'revive_every'),
    (dict(revive_every=2, update_W=False), 'revive_every requires'),
    (dict(tol=1e-3, progress_callback=_noop), 'tol-based'),
    (dict(tol=-1e-3), 'tol must be >= 0'),
    (dict(tol=1e-3, tol_check_every=0), 'tol_check_every must be >= 1'),
])
def test_guard_rails_match_jax(fit, match):
    _raises_in_both(match, **fit)


def test_h_init_guard_rail_matches_jax():
    for module in PACKAGES:
        with pytest.raises(ValueError, match="h_init must be 'random' or 'correlate'"):
            _model(module, h_init='zeros')


def test_keep_H_matches_jax():
    """keep_H continues from the current activations and skips the H draw:
    the RNG stream stays in step with the JAX package's for a later fit."""
    V = PROBLEMS['2d'][0]
    models = []
    for module in PACKAGES:
        m = _model(module)
        m.fit(V, n_iterations=3, sparsity_H=0.1)
        m.fit(V, n_iterations=2, sparsity_H=0.1, keep_W=True, keep_H=True)
        models.append(m)
    _assert_same(*models)
    for m in models:
        m.fit(V, n_iterations=1)
    _assert_same(*models)
    for m in models:
        with pytest.raises(ValueError, match='keep_H: existing activations'):
            m.fit(V[:1], n_iterations=1, keep_W=True, keep_H=True)


def test_keep_H_continues_the_trajectory():
    V = PROBLEMS['2d'][0]
    whole, split = _model(tnmf_tpu_torch), _model(tnmf_tpu_torch)
    whole.fit(V, n_iterations=5, sparsity_H=0.1)
    split.fit(V, n_iterations=2, sparsity_H=0.1)
    split.fit(V, n_iterations=3, sparsity_H=0.1, keep_W=True, keep_H=True)
    np.testing.assert_array_equal(split.W, whole.W)
    np.testing.assert_array_equal(split.H, whole.H)


@pytest.mark.parametrize('writer', PACKAGES, ids=['jax', 'port'])
def test_checkpoint_crosses_packages(tmp_path, writer):
    """A checkpoint written by either package (with H and the iteration
    stamp) loads in both, with constructor overrides, and both resume it to
    the same W and H."""
    V = PROBLEMS['2d'][0]
    m = _model(writer, reconstruction_mode='circular', inhibition_range=2)
    m.fit(V, n_iterations=4, sparsity_H=0.1, inhibition_strength=0.1)
    path = str(tmp_path / 'ckpt')
    m.save(path, include_H=True, completed_iterations=4)
    assert sorted(os.listdir(tmp_path)) == ['ckpt.npz']
    with np.load(path + '.npz') as data:
        assert str(data['dtype']) == 'float64'
        assert int(data['completed_iterations']) == 4
    resumed = []
    for module in PACKAGES:
        kw = dict(device='cpu') if module is tnmf_tpu_torch else {}
        r = module.TransformInvariantNMF.load(path + '.npz', seed=7, verbose=1, **kw)
        assert r.last_checkpoint_iteration_ == 4
        assert r._reconstruction_mode == 'circular'
        assert tuple(r._inhibition_range) == (2, 2)
        assert r._logger.level == logging.WARNING
        np.testing.assert_array_equal(r.W, m.W)
        np.testing.assert_array_equal(np.asarray(r._H), m.H)
        r.fit(V, n_iterations=3, sparsity_H=0.1, inhibition_strength=0.1, keep_W=True,
              keep_H=True)
        resumed.append(r)
    _assert_same(*resumed)
    # overrides reach the constructor in the port too
    port = tnmf_tpu_torch.TransformInvariantNMF.load(path + '.npz', device='cpu',
                                                      reconstruction_mode='reflect')
    assert port._reconstruction_mode == 'reflect' and port.dtype == F64


def test_load_without_stamp_and_save_errors(tmp_path):
    m = _model(tnmf_tpu_torch)
    with pytest.raises(ValueError, match='not been fit'):
        m.save(str(tmp_path / 'x.npz'))
    m.fit(PROBLEMS['2d'][0], n_iterations=1)
    m.save(str(tmp_path / 'x.npz'))
    r = tnmf_tpu_torch.TransformInvariantNMF.load(str(tmp_path / 'x.npz'), device='cpu',
                                                   dtype=torch.float32)
    assert r.last_checkpoint_iteration_ is None and r._H is None
    assert r.dtype == torch.float32 and r._W.dtype == torch.float32


def test_checkpoint_every_resumes_exactly(tmp_path):
    """checkpoint_every writes W, H and the count every k iterations (as
    the JAX package's does); load then fit(keep_W, keep_H) for the rest is
    the uninterrupted fit, bit for bit."""
    V = PROBLEMS['2d'][0]
    fit = dict(sparsity_H=0.1, inhibition_strength=0.1)
    whole = _model(tnmf_tpu_torch)
    whole.fit(V, n_iterations=8, **fit)
    paths = {}
    for module in PACKAGES:
        paths[module] = str(tmp_path / f'{module.__name__}.npz')
        m = _model(module)
        m.fit(V, n_iterations=6, checkpoint_every=4, checkpoint_path=paths[module], **fit)
        with np.load(paths[module]) as data:
            assert int(data['completed_iterations']) == 6
            np.testing.assert_array_equal(data['H'], m.H)
    with np.load(paths[tnmf_tpu]) as j, np.load(paths[tnmf_tpu_torch]) as p:
        assert sorted(j.files) == sorted(p.files)
        np.testing.assert_allclose(p['W'], j['W'], **TOL)
        np.testing.assert_allclose(p['H'], j['H'], **TOL)
    r = tnmf_tpu_torch.TransformInvariantNMF.load(paths[tnmf_tpu_torch], device='cpu')
    r.fit(V, n_iterations=8 - r.last_checkpoint_iteration_, keep_W=True, keep_H=True, **fit)
    np.testing.assert_array_equal(r.W, whole.W)
    np.testing.assert_array_equal(r.H, whole.H)


def _kill_atom(model, m):
    H = np.asarray(model._H).copy()
    H[:, m] = 0.
    model._H = (torch.tensor(H) if isinstance(model._H, torch.Tensor)
                else jnp.asarray(H, dtype=model._H.dtype))


def test_revive_every_matches_jax(caplog):
    """A dead atom is re-drawn from the model's RNG mid-fit, as in the JAX
    package, and the fit continues with the full dictionary live."""
    V = PROBLEMS['2d'][0]
    models = []
    for module in PACKAGES:
        m = _model(module, seed=5, verbose=2)
        m.fit(V, n_iterations=2)
        _kill_atom(m, 2)
        _records(caplog)
        m.fit(V, n_iterations=6, keep_W=True, keep_H=True, revive_every=2)
        assert (logging.INFO, 'Revived %d dead atom(s) at iteration %d.', (1, 2)) in \
            _records(caplog)
        models.append(m)
    _assert_same(*models)
    assert atoms.find_dead_atoms(models[1]).size == 0


@pytest.mark.parametrize('threshold', [1e-4, 0.7])
def test_revive_dead_atoms_matches_jax(threshold):
    """find_dead_atoms and revive_dead_atoms draw what the JAX package's
    draw, in its order (a high threshold revives more than one atom)."""
    models = []
    for module in PACKAGES:
        m = _model(module, seed=5)
        m.fit(PROBLEMS['2d'][0], n_iterations=2)
        _kill_atom(m, 1)
        models.append(m)
    jm, pm = models
    np.testing.assert_array_equal(atoms.find_dead_atoms(pm, threshold),
                                  jatoms.find_dead_atoms(jm, threshold))
    np.testing.assert_array_equal(atoms.revive_dead_atoms(pm, threshold),
                                  jatoms.revive_dead_atoms(jm, threshold))
    np.testing.assert_allclose(pm.W, jm.W, **TOL)
    np.testing.assert_allclose(pm.H, np.asarray(jm._H), **TOL)
    assert atoms.revive_dead_atoms(pm).size == 0
    with pytest.raises(RuntimeError, match='fitted model'):
        atoms.find_dead_atoms(_model(tnmf_tpu_torch))


def test_fit_batch_takes_the_jax_order():
    def positional(cls):
        return [p.name for p in inspect.signature(cls.fit_batch).parameters.values()
                if p.kind == p.POSITIONAL_OR_KEYWORD]
    assert positional(tnmf_tpu_torch.TransformInvariantNMF) == positional(
        tnmf_tpu.TransformInvariantNMF)
