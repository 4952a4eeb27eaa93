"""Device-memory planning of the PyTorch port (``tnmf_tpu_torch.utils.memory``)
against the JAX package's (``tnmf_tpu.utils.memory``), on the CPU.

The cases of ``tests/test_memory.py`` but the mesh and phased ones (item
14e; TPU only): the persistent entries equal the port's live tensors after
a fit, byte for byte and shape for shape, across strategies, modes, a
transform group, HALS and the multi-scale model; every key of the JAX
estimate is the port's, with the JAX shape where the layouts agree (the
fft reconstruction's R is frequency-major in the port); ``suggest_batch_size``
inverts the estimate; the errors.  The peak of shift-invariant HALS against
the peak of the storage a CPU fit holds, sampled after every operator; the
peaks against the card's measured high-water mark are checked by
``chip_smoke.py`` phase 21."""

import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

import tnmf_tpu
import tnmf_tpu_torch
from tnmf_tpu.utils.memory import estimate_fit_memory as jax_estimate
from tnmf_tpu_torch.utils import memory
from tnmf_tpu_torch.utils.memory import estimate_fit_memory, suggest_batch_size

CPU = dict(device='cpu')
#: keys whose shape follows the port's layout, not the JAX one
LAYOUT = {'fft': ('R (transient)',)}


def _V(n=4, c=2, shape=(12, 10), seed=0):
    return np.random.default_rng(seed).random((n, c) + shape).astype(np.float32)


def _live(m):
    return {'V (device copy)': m._Vd, 'V prepared (loop-invariant)': m._Vp,
            'H (loop carrier)': m._H, 'W (dictionary)': m._W}


def _nbytes(t):
    return t.numel() * t.element_size()


def _check_live(est, live):
    for name, t in live.items():
        shape, dtype, b = est.tensors[name]
        assert b == _nbytes(t), (name, b, _nbytes(t))
        assert shape == tuple(t.shape) and dtype == str(t.dtype).removeprefix('torch.'), name


def _check_keys(est, want, layout=()):
    for name, (shape, _, _) in want.tensors.items():
        assert name in est.tensors, name
        if name not in layout:
            assert est.tensors[name][0] == shape, name


def _pair(A, **kw):
    return (tnmf_tpu_torch.TransformInvariantNMF(3, A, seed=0, **kw, **CPU),
            tnmf_tpu.TransformInvariantNMF(3, A, seed=0, dtype='float32', **kw))


@pytest.mark.parametrize('backend,mode', [
    ('jax_conv', 'valid'), ('jax_conv', 'full'),
    ('jax_fft', 'circular'), ('jax_fft', 'reflect'),
])
def test_estimate_matches_live_fit(backend, mode):
    V = _V()
    m, jm = _pair((4, 3), backend=backend, reconstruction_mode=mode)
    est = estimate_fit_memory(m, V.shape)
    want = jax_estimate(jm, V.shape)
    assert est.strategy == want.strategy
    _check_keys(est, want, LAYOUT.get(est.strategy, ()))
    m.fit(V, n_iterations=2)
    _check_live(est, _live(m))
    assert est.peak_bytes > est.persistent_bytes > 0
    assert 'MiB' in str(est)


def test_estimate_matches_dot_and_group():
    V = _V(c=1, shape=(8,))
    dot, jdot = _pair((8,), reconstruction_mode='full')
    est = estimate_fit_memory(dot, V.shape)
    assert est.strategy == 'dot'
    _check_keys(est, jax_estimate(jdot, V.shape))
    dot.fit(V, n_iterations=2)
    _check_live(est, _live(dot))
    # the prepared data and R's prepared form are V and R themselves
    assert set(est.shared) == {'V prepared (loop-invariant)', 'R prepared (transient)'}
    assert est.persistent_bytes == sum(_nbytes(t) for t in (dot._Vd, dot._H, dot._W))

    grp, jgrp = _pair((3, 3), transform_type='shift+flip')
    V2 = _V()
    est2 = estimate_fit_memory(grp, V2.shape)
    _check_keys(est2, jax_estimate(jgrp, V2.shape))
    grp.fit(V2, n_iterations=2)
    _check_live(est2, _live(grp))


def test_bfloat16_and_mesh_raise():
    m = tnmf_tpu_torch.TransformInvariantNMF(3, (4, 3), **CPU)
    with pytest.raises(NotImplementedError, match='item f'):
        estimate_fit_memory(m, (8, 1, 32, 32), dtype='bfloat16')
    m._mesh = object()
    with pytest.raises(NotImplementedError, match=r'item 14e\b'):
        estimate_fit_memory(m, (8, 1, 32, 32))


def test_suggest_batch_size_inverts_the_estimate():
    m = tnmf_tpu_torch.TransformInvariantNMF(n_atoms=4, atom_shape=(5, 5), **CPU)
    budget = 64 * 2 ** 20
    n = suggest_batch_size(m, (32, 32), n_channels=1, budget_bytes=budget, safety=1.0)
    assert n >= 1
    assert estimate_fit_memory(m, (n, 1, 32, 32)).peak_bytes <= budget
    assert estimate_fit_memory(m, (n + 1, 1, 32, 32)).peak_bytes > budget
    assert suggest_batch_size(m, (4096, 4096), n_channels=1, budget_bytes=budget,
                              safety=1.0) == 0


def test_guards():
    m = tnmf_tpu_torch.TransformInvariantNMF(n_atoms=3, atom_shape=(4, 3), **CPU)
    with pytest.raises(ValueError, match='V_shape'):
        estimate_fit_memory(m, (4, 8))


def test_budget_from_the_cards_memory(monkeypatch):
    """A CUDA model's default budget is the card's memory
    (``torch.cuda.mem_get_info``, faked here); a CPU model's raises the
    JAX package's error."""
    card = tnmf_tpu_torch.TransformInvariantNMF(3, (4, 3))
    assert card.device.type == 'cuda'
    monkeypatch.setattr(torch.cuda, 'mem_get_info', lambda device=None: (0, 64 * 2 ** 20))
    n = suggest_batch_size(card, (32, 32), n_channels=1, safety=1.0)
    assert n >= 1
    assert estimate_fit_memory(card, (n, 1, 32, 32)).peak_bytes <= 64 * 2 ** 20
    assert estimate_fit_memory(card, (n + 1, 1, 32, 32)).peak_bytes > 64 * 2 ** 20
    with pytest.raises(ValueError, match='memory limit'):
        suggest_batch_size(tnmf_tpu_torch.TransformInvariantNMF(3, (4, 3), **CPU), (32, 32))


def test_multiscale_estimate_matches_live_fit():
    kw = dict(n_atoms=(2, 3), atom_shapes=((3, 3), (5, 5)), seed=0)
    m = tnmf_tpu_torch.MultiScaleTNMF(**kw, **CPU)
    V = _V(n=3, c=1, shape=(14, 12))
    est = estimate_fit_memory(m, V.shape)
    _check_keys(est, jax_estimate(tnmf_tpu.MultiScaleTNMF(**kw, dtype='float32'), V.shape))
    m.fit(V, n_iterations=2)
    live = {'V (device copy)': m._Vd}
    for k in range(2):
        live.update({f'V prepared, scale {k}': m._Vps[k], f'H, scale {k} (loop carrier)': m._Hs[k],
                     f'W, scale {k}': m._Ws[k]})
    _check_live(est, live)
    assert est.peak_bytes > est.persistent_bytes
    n = suggest_batch_size(m, (14, 12), n_channels=1, budget_bytes=8 * 2 ** 20, safety=1.0)
    assert estimate_fit_memory(m, (n, 1, 14, 12)).peak_bytes <= 8 * 2 ** 20


def test_hals_estimates():
    """solver='hals': the plain-NMF engine's flat views against the live
    factors, the shift-invariant engine's padded residual and phase-major
    carrier against the port's ``_encode``; every JAX key with its shape."""
    from tnmf_tpu_torch import engine_hals_conv as ehc
    flat, jflat = _pair((24,), reconstruction_mode='full')
    e = estimate_fit_memory(flat, (6, 1, 24), solver='hals')
    assert e.strategy == 'hals'
    _check_keys(e, jax_estimate(jflat, (6, 1, 24), solver='hals'))
    flat.fit(_V(n=6, c=1, shape=(24,)), n_iterations=2, solver='hals')
    for name, t in (('V (device copy, flat view)', flat._Vd), ('H (n, m)', flat._H),
                    ('W (m, F)', flat._W)):
        assert e.tensors[name][2] == _nbytes(t), name

    conv, jconv = _pair((4,), reconstruction_mode='full')
    e = estimate_fit_memory(conv, (6, 1, 20), solver='hals')
    assert e.strategy == 'hals-conv'
    _check_keys(e, jax_estimate(jconv, (6, 1, 20), solver='hals'))
    E_pad, H_pm = ehc._encode(torch.zeros((6, 1, 20)), torch.zeros((3, 1, 4)),
                              torch.zeros((6, 3, 17)), conv._plan_for((20,)))
    assert e.tensors['E residual (padded carrier)'][0] == tuple(E_pad.shape)
    assert e.tensors['H (phase-major carrier)'][0] == tuple(H_pm.shape)

    with pytest.raises(ValueError, match='mu.*hals|hals'):
        estimate_fit_memory(flat, (6, 1, 24), solver='nope')
    shift = tnmf_tpu_torch.TransformInvariantNMF(2, (3,), **CPU)
    with pytest.raises(ValueError, match="reconstruction_mode='full'"):
        estimate_fit_memory(shift, (6, 1, 20), solver='hals')


class _StoragePeak(TorchDispatchMode):
    """The most storage that the tensors an operator took or made held at
    once, sampled after each operator (each storage counted once, views
    too, until it is freed)."""

    def __init__(self):
        super().__init__()
        self.live, self.peak = {}, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for t in (*outs, *args, *(kwargs or {}).values()):
            if isinstance(t, torch.Tensor):
                s = t.untyped_storage()
                if s._cdata not in self.live or self.live[s._cdata][0].expired():
                    self.live[s._cdata] = (StorageWeakRef(s), s.nbytes())
        self.live = {k: v for k, v in self.live.items() if not v[0].expired()}
        self.peak = max(self.peak, sum(b for _, b in self.live.values()))
        return out


def test_hals_conv_estimate_bounds_the_fits_peak():
    """Shift-invariant HALS at the flagship's proportions (one channel, 16
    atoms of 9 x 9, 'full'), cut to 4 samples of 64 x 64: the estimate's
    entries without the allocator's rounding are at least the CPU fit's
    peak of live storage over two iterations and at most 1.5 times it.  In
    float64, whose products make no float64 copies, as the card's float32
    ones make none (a float32 fit's HALS products accumulate in float64 on
    the CPU)."""
    V = np.random.default_rng(5).random((4, 1, 64, 64))
    m = tnmf_tpu_torch.TransformInvariantNMF(16, (9, 9), reconstruction_mode='full', seed=0,
                                             dtype='float64', **CPU)
    est = estimate_fit_memory(m, V.shape, solver='hals')
    counted = est.peak_bytes - est.tensors['allocator rounding (transient)'][2]
    with _StoragePeak() as peak:
        m.fit(V, n_iterations=2, solver='hals', sparsity_H=0.1)
    assert peak.peak <= counted <= 1.5 * peak.peak, (counted, peak.peak)
    _check_live(est, {'V (device copy)': m._Vd, 'V prepared (loop-invariant)': m._Vp,
                      "H (canonical, the model's)": m._H, 'W (dictionary)': m._W})


def test_estimate_allocates_nothing(monkeypatch):
    """The estimate runs on meta tensors: no CPU tensor is made."""
    made = []
    real = torch.empty

    def empty(*args, device=None, **kw):
        made.append(torch.device(device or 'cpu').type)
        return real(*args, device=device, **kw)
    monkeypatch.setattr(memory.torch, 'empty', empty)
    m = tnmf_tpu_torch.TransformInvariantNMF(3, (4, 3), backend='jax_fft', **CPU)
    estimate_fit_memory(m, (4, 2, 12, 10))
    assert made and set(made) == {'meta'}
