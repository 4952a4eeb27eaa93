"""The port's multi-scale model against the JAX package, in float64 on the CPU.

``tnmf_tpu_torch.MultiScaleTNMF`` against ``tnmf_tpu.models.multiscale``
from the same seed (both draw every H bank, then every W bank, from one
NumPy stream): full-batch fits on conv, fft and mixed scales in
``'valid'`` and ``'full'`` mode (also against the NumPy oracle multi-scale fit of
``tests/test_multiscale.py``), beta 1 and 0.5 with a mask, per-scale
sparsity, ``tol`` and ``record_energies`` traces, the callback path,
``transform``, checkpoints across the packages, the serving artifact, the
error paths with the JAX messages, and one scale against the port's
``TransformInvariantNMF``, each within 1e-8.  The minibatch and online fits
are in ``tests/test_torch_multiscale_fits.py``.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

from tnmf_tpu.models import multiscale as jax_ms
from tnmf_tpu.serving import load_serving as jax_load_serving

import tnmf_tpu_torch
from tnmf_tpu_torch import (MultiScaleTNMF, TransformInvariantNMF, engine, from_numpy_scales,
                            load_serving, serving)
from tnmf_tpu_torch.models import multiscale as ms
from tnmf_tpu_torch.ops.modes import ConvPlan

from .fake_cuda import kernel_ops, loops, ms_cuda_programs
from .test_multiscale import _data, _oracle_ms_fit

F64 = torch.float64
CPU = dict(device='cpu', dtype=F64)
TOL = dict(rtol=1e-8, atol=1e-10)

#: scale sets: 1-D conv or fft (backend names), and 2-D 'auto' giving one
#: conv and one fft scale (23 x 23 atoms pass the JAX rule's 512 elements)
SCALES = {
    'conv': dict(kw=dict(n_atoms=(2, 2), atom_shapes=((3,), (6,)), backend='jax_conv'),
                 data=dict(seed=5)),
    'fft': dict(kw=dict(n_atoms=(2, 2), atom_shapes=((3,), (6,)), backend='jax_fft'),
                data=dict(seed=5)),
    'mixed': dict(kw=dict(n_atoms=(2, 1), atom_shapes=((3, 3), (23, 23)), backend='auto'),
                  data=dict(seed=5, n=2, c=1, sample=(26, 26))),
}


def _pair(kw, method='fit', data=None, fit=None, V=None):
    """The JAX model and the port's, same constructor arguments, each after
    ``method(V, **fit)``."""
    V = _data(**(data or {})) if V is None else V
    out = []
    for cls, extra in ((jax_ms.MultiScaleTNMF, {}), (MultiScaleTNMF, CPU)):
        m = cls(**kw, **extra)
        getattr(m, method)(V, **(fit or {}))
        out.append(m)
    return (*out, V)


def _same(pm, jm, tol=TOL):
    for k in range(jm.n_scales):
        np.testing.assert_allclose(pm.W[k], np.asarray(jm.W[k]), **tol)
        np.testing.assert_allclose(pm.H[k], np.asarray(jm.H[k]), **tol)


@pytest.mark.parametrize('mode', ['valid', 'full'])
@pytest.mark.parametrize('scales', sorted(SCALES))
def test_fit_matches_jax_and_oracle(scales, mode):
    case = SCALES[scales]
    kw = dict(case['kw'], seed=7, reconstruction_mode=mode)
    jm, pm, V = _pair(kw, data=case['data'], fit=dict(n_iterations=5, sparsity_H=(0.02, 0.05)))
    assert pm._strategies == jm._strategies
    if scales == 'mixed':
        assert pm._strategies == ('conv', 'fft')
    _same(pm, jm)
    Ws, Hs = _oracle_ms_fit(V, kw['n_atoms'], kw['atom_shapes'], mode, 2.0, 5, 7, (0.02, 0.05))
    for k in range(2):
        np.testing.assert_allclose(pm.W[k], Ws[k], rtol=1e-7)
        np.testing.assert_allclose(pm.H[k], Hs[k], rtol=1e-7)
    np.testing.assert_allclose(pm.R, np.asarray(jm.R), **TOL)
    np.testing.assert_allclose(pm.R_scale(1), np.asarray(jm.R_scale(1)), **TOL)
    np.testing.assert_allclose(pm._energy_function(), jm._energy_function(), rtol=1e-10)


@pytest.mark.parametrize('backend,beta,masked', [('jax_conv', 1.0, True), ('jax_conv', 0.5, True),
                                                 ('jax_conv', 1.0, False),
                                                 ('jax_fft', 1.0, True), ('jax_fft', 0.5, False)])
def test_beta_and_mask_match_jax(backend, beta, masked):
    V = _data(seed=6, c=1)
    M = (np.random.default_rng(8).random(V.shape) > 0.3).astype(np.float64) if masked else None
    kw = dict(n_atoms=(2, 1), atom_shapes=((3,), (7,)), seed=9, backend=backend,
              beta_loss=beta)
    jm, pm, _ = _pair(kw, V=V, fit=dict(n_iterations=4, mask=M))
    _same(pm, jm)
    if backend == 'jax_conv' and masked:
        Ws, Hs = _oracle_ms_fit(V, (2, 1), ((3,), (7,)), 'valid', beta, 4, 9, (0.0, 0.0), M=M)
        for k in range(2):
            np.testing.assert_allclose(pm.W[k], Ws[k], rtol=1e-6)


def test_per_scale_sparsity():
    kw = dict(n_atoms=(2, 2), atom_shapes=((3,), (6,)), seed=2)
    jm, pm, V = _pair(kw, fit=dict(n_iterations=4, sparsity_H=(0.3, 0.0)))
    _same(pm, jm)
    scalar = MultiScaleTNMF(**kw, **CPU).fit(V, n_iterations=4, sparsity_H=0.1)
    tupled = MultiScaleTNMF(**kw, **CPU).fit(V, n_iterations=4, sparsity_H=(0.1, 0.1))
    for k in range(2):
        assert np.array_equal(scalar.H[k], tupled.H[k])


@pytest.mark.parametrize('fit', [dict(n_iterations=60, tol=5e-3, tol_check_every=5),
                                 dict(n_iterations=40, tol=5e-3, tol_check_every=5,
                                      record_energies=True),
                                 dict(n_iterations=8, tol=0.0, record_energies=True),
                                 dict(n_iterations=40, record_energies=True)],
                         ids=['tol', 'tol-record', 'tol0-record', 'record-two-chunks'])
def test_tol_and_energy_traces_match_jax(fit):
    kw = dict(n_atoms=(2, 2), atom_shapes=((3, 3), (5, 5)), seed=3)
    jm, pm, _ = _pair(kw, data=dict(seed=21, sample=(12, 12), c=1), fit=fit)
    assert pm.n_iterations_ == jm.n_iterations_
    if fit.get('tol'):
        assert 5 <= pm.n_iterations_ < fit['n_iterations']
    if fit.get('record_energies'):
        assert pm.energies_.shape == (pm.n_iterations_,)
        np.testing.assert_allclose(pm.energies_, np.asarray(jm.energies_), rtol=1e-10)
    else:
        assert pm.energies_ is None
    _same(pm, jm)


def test_callback_path_matches_fused_loop_and_jax():
    kw = dict(n_atoms=(2, 1), atom_shapes=((3,), (6,)), seed=7)
    V = _data(seed=14, c=1)
    fused = MultiScaleTNMF(**kw, **CPU).fit(V, n_iterations=5, sparsity_H=0.05)
    seen = []
    fit = dict(n_iterations=5, sparsity_H=0.05, record_energies=True,
               progress_callback=lambda model, it: seen.append(it) or True)
    jm, pm, _ = _pair(kw, V=V, fit=fit)
    assert seen == list(range(5)) * 2
    for k in range(2):
        assert np.array_equal(pm.W[k], fused.W[k]) and np.array_equal(pm.H[k], fused.H[k])
    np.testing.assert_allclose(pm.energies_, np.asarray(jm.energies_), rtol=1e-10)
    stopped = MultiScaleTNMF(**kw, **CPU).fit(V, n_iterations=5,
                                              progress_callback=lambda model, it: it < 1)
    two = MultiScaleTNMF(**kw, **CPU).fit(V, n_iterations=2)
    assert stopped.n_iterations_ == 2
    for k in range(2):
        assert np.array_equal(stopped.W[k], two.W[k])


@pytest.mark.parametrize('h_init', ['random', 'correlate'])
def test_transform_matches_jax(h_init):
    kw = dict(n_atoms=(2, 2), atom_shapes=((3, 3), (5, 5)), seed=4, h_init=h_init)
    jm, pm, V = _pair(kw, data=dict(seed=3, c=1, sample=(12, 12)), fit=dict(n_iterations=3))
    new = _data(seed=30, n=2, c=1, sample=(14, 14))
    Hj = jm.transform(new, n_iterations=4, sparsity_H=(0.1, 0.2))
    Hp = pm.transform(new, n_iterations=4, sparsity_H=(0.1, 0.2))
    assert len(Hp) == 2 and Hp[0].shape == (2, 2, 16, 16)
    for a, b in zip(Hp, Hj):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    _same(pm, jm)  # the dictionary stayed frozen
    np.testing.assert_allclose(pm.inverse_transform(), np.asarray(jm.inverse_transform()),
                               **TOL)


def test_tensor_input_equals_numpy_input():
    kw = dict(n_atoms=(2, 1), atom_shapes=((3, 3), (5, 5)), seed=5, w_init='patches')
    V = _data(seed=2, c=1, sample=(12, 12))
    a = MultiScaleTNMF(**kw, **CPU).fit(V, n_iterations=3)
    b = MultiScaleTNMF(**kw, **CPU).fit(torch.tensor(V), n_iterations=3)
    for k in range(2):
        assert np.array_equal(a.W[k], b.W[k]) and np.array_equal(a.H[k], b.H[k])


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_checkpoints_load_in_either_package(tmp_path, writer):
    kw = dict(n_atoms=(2, 2), atom_shapes=((3,), (6,)), seed=6)
    jm, pm, V = _pair(kw, data=dict(seed=13, c=1), fit=dict(n_iterations=5))
    path = str(tmp_path / 'ms')
    (jm if writer == 'jax' else pm).save(path, include_H=True)
    for loaded in (jax_ms.MultiScaleTNMF.load(path + '.npz'),
                   MultiScaleTNMF.load(path + '.npz', device='cpu')):
        assert loaded.n_atoms == (2, 2) and loaded.atom_shapes == ((3,), (6,))
        for k in range(2):
            np.testing.assert_allclose(np.asarray(loaded.W[k]), pm.W[k], **TOL)
            np.testing.assert_allclose(np.asarray(loaded.H[k]), pm.H[k], **TOL)
        np.testing.assert_allclose(np.asarray(loaded.R), pm.R, **TOL)
    port = MultiScaleTNMF.load(path + '.npz', device='cpu')
    assert port.dtype == F64 and port._strategies == pm._strategies
    # a loaded model without a seed draws H from the global NumPy stream
    np.random.seed(3)
    Hj = jax_ms.MultiScaleTNMF.load(path + '.npz').transform(V, n_iterations=3)
    np.random.seed(3)
    for a, b in zip(port.transform(V, n_iterations=3), Hj):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    w_only = str(tmp_path / 'w_only')
    pm.save(w_only)
    with np.load(w_only + '.npz') as z:
        assert 'H_0' not in z and int(z['n_scales']) == 2 and str(z['dtype']) == 'float64'


def test_from_numpy_scales_carries_the_jax_weights():
    kw = dict(n_atoms=(2, 1), atom_shapes=((3, 3), (5, 5)), seed=8)
    jm = jax_ms.MultiScaleTNMF(**kw)
    V = _data(seed=9, c=1, sample=(12, 12))
    jm.fit(V, n_iterations=3)
    Ws, Hs = from_numpy_scales(jm.W, jm.H, device='cpu', dtype=F64)
    assert all(isinstance(t, torch.Tensor) and t.dtype == F64 for t in Ws + Hs)
    plans = tuple(ConvPlan.create('valid', (12, 12), a) for a in kw['atom_shapes'])
    R = ms.ms_reconstruct(Ws, Hs, plans=plans, strategies=('conv', 'conv'))
    np.testing.assert_allclose(R.numpy(), np.asarray(jm.R), **TOL)
    assert from_numpy_scales(jm.W, device='cpu', dtype=F64)[1] is None


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('backend', ['jax_conv', 'jax_fft'])
def test_one_scale_equals_transform_invariant_nmf(backend, dtype):
    """K = 1: the same draws (H, then W) and the same updates as the
    single-scale model, bit for bit."""
    V = _data(seed=11, c=1, sample=(14, 14)).astype(np.float32 if dtype == torch.float32
                                                     else np.float64)
    one = MultiScaleTNMF((3,), ((4, 4),), seed=4, backend=backend, device='cpu', dtype=dtype)
    one.fit(V, n_iterations=6, sparsity_H=0.1)
    single = TransformInvariantNMF(3, (4, 4), seed=4, backend=backend, device='cpu',
                                   dtype=dtype)
    single.fit_batch(V, n_iterations=6, sparsity_H=0.1)
    assert np.array_equal(one.W[0], single.W) and np.array_equal(one.H[0], single.H)


def test_plain_nmf_corner_keeps_conv():
    """The multi-scale model resolves the plain-NMF geometry to 'conv'
    (``allow_dot=False``), as the JAX package does; the single-scale
    resolution is unchanged."""
    plan = ConvPlan.create('full', (8,), (8,))
    assert engine.resolve_strategy('conv', plan) == 'dot'
    assert engine.resolve_strategy('conv', plan, allow_dot=False) == 'conv'
    V = _data(seed=3, n=4, c=1, sample=(8,))
    kw = dict(n_atoms=(2, 1), atom_shapes=((8,), (3,)), seed=1, reconstruction_mode='full')
    jm, pm, _ = _pair(kw, V=V, fit=dict(n_iterations=3))
    assert pm._strategies == jm._strategies == ('conv', 'conv')
    _same(pm, jm)


def test_mu_H_is_mu_H_of_its_reconstruction():
    """``engine._mu_H`` is ``_mu_H_of`` against ``reconstruct(W, H)``, bit
    for bit (the single-scale step kept its arithmetic)."""
    rng = np.random.default_rng(0)
    plan = ConvPlan.create('valid', (12, 12), (3, 3))
    V = torch.tensor(rng.random((2, 1, 12, 12)))
    W = torch.tensor(rng.random((4, 1, 3, 3)))
    H = torch.tensor(rng.random((2, 4, 14, 14)))
    for strategy in ('conv', 'fft'):
        Vp = engine.prepare_data(V, plan=plan, strategy=strategy)
        R = engine.reconstruct(W, H, plan=plan, strategy=strategy)
        a = engine._mu_H(Vp, W, H, 0.1, plan=plan, strategy=strategy)
        b = engine._mu_H_of(Vp, R, W, H, 0.1, plan=plan, strategy=strategy)
        assert torch.equal(a, b)


def test_sklearn_protocol():
    from sklearn.base import clone
    m = MultiScaleTNMF((2, 1), ((3,), (5,)), seed=3, device='cpu', use_pallas=False)
    params = m.get_params()
    assert params['device'] == 'cpu' and params['use_pallas'] is False
    c = clone(m)
    assert c.get_params() == params and c is not m
    m.set_params(seed=4)
    assert m.get_params()['seed'] == 4
    with pytest.raises(ValueError, match='invalid parameter'):
        m.set_params(nope=1)
    assert m.__sklearn_tags__().transformer_tags is not None


# ------------------------------------------------------------------ serving

@lru_cache(maxsize=None)
def _served(kind):
    """(port model, its artifact, the JAX model's artifact) for 'conv' (two
    conv scales, with the decoder) or 'mixed' (conv + fft, beta = 1)."""
    if kind == 'conv':
        kw = dict(n_atoms=(2, 2), atom_shapes=((3, 3), (5, 5)), seed=6, h_init='correlate')
        data, export = dict(seed=1, c=1, sample=(12, 12)), dict(include_decoder=True)
    else:
        kw = dict(SCALES['mixed']['kw'], seed=6, h_init='correlate', beta_loss=1.0)
        data, export = SCALES['mixed']['data'], {}
    jm, pm, V = _pair(kw, data=data, fit=dict(n_iterations=3))
    export.update(n_iterations=4, sparsity_H=(0.1, 0.05))
    return pm, jm, V, pm.export_serving(**export), jm.export_serving(**export)


@pytest.mark.parametrize('kind', ['conv', 'mixed'])
def test_serving_round_trip_matches_transform_and_jax(kind):
    pm, jm, V, blob, jax_blob = _served(kind)
    served, jax_served = load_serving(blob), jax_load_serving(jax_blob)
    assert set(jax_served.header) - {'library'} <= set(served.header)
    for key in ('multiscale', 'n_atoms', 'atom_shape', 'sparsity_H', 'input_shape', 'mode',
                'n_transforms', 'beta_loss', 'n_iterations'):
        assert served.header[key] == jax_served.header[key], key
    new = _data(seed=40, n=3, c=1, sample=V.shape[2:])
    H = served.transform(new)
    assert isinstance(H, tuple) and len(H) == 2
    for a, b in zip(H, jax_served.transform(new)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    for a, b in zip(H, pm.transform(new, n_iterations=4, sparsity_H=(0.1, 0.05))):
        assert np.array_equal(a, b)
    Ht = served.transform(torch.tensor(new[:1]), n_iterations=2)
    assert all(isinstance(h, torch.Tensor) and h.shape[0] == 1 for h in Ht)
    if kind == 'conv':
        R = served.inverse_transform(H)
        np.testing.assert_allclose(R, np.asarray(jax_served.inverse_transform(H)), **TOL)
        assert np.array_equal(R, pm.R)


def test_serving_cuda_program_calls_the_kernels():
    """The multi-scale CUDA program, traced without a card: one loop whose
    body calls K3 for the conv scale and K1's ratio for the fft scale, no
    plain version; the decoder calls no kernel."""
    pm = _served('mixed')[0]
    m = MultiScaleTNMF(**dict(SCALES['mixed']['kw'], seed=6), device='cpu',
                       dtype=torch.float32)
    m._Ws = tuple(w.float() for w in pm._Ws)
    m._plans, m._strategies = pm._plans, pm._strategies
    recipe = serving._MSRecipe(Ws=m._Ws, plans=m._plans, strategies=m._strategies, beta=2.0,
                               n_atoms=m.n_atoms, sparsities=(0.1, 0.05), use_pallas=True,
                               in_dtype=torch.float32)
    programs = ms_cuda_programs(recipe, include_decoder=True)
    assert kernel_ops(programs['transform']) == ['mu_h', 'mu_ratio']
    assert loops(programs['transform']) == 1
    assert kernel_ops(programs['inverse_transform']) == []


# ------------------------------------------------------------- error paths

def _raises_like_jax(exc, make, call=None):
    """Both packages raise ``exc`` with the same message."""
    msgs = []
    for cls, extra in ((jax_ms.MultiScaleTNMF, {}), (MultiScaleTNMF, CPU)):
        with pytest.raises(exc) as info:
            m = make(cls, extra)
            if call is not None:
                call(m)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_error_paths_raise_the_jax_messages():
    V = _data(seed=1)
    _raises_like_jax(ValueError, lambda c, e: c((2,), ((3,), (5,)), **e))
    _raises_like_jax(ValueError, lambda c, e: c((2, 2), ((3,), (5, 5)), **e))
    _raises_like_jax(ValueError, lambda c, e: c((2,), ((3,),), w_init='nndsvd', **e))
    _raises_like_jax(ValueError, lambda c, e: c((2,), ((3,),), h_init='zeros', **e))
    two = lambda c, e: c((2, 2), ((3,), (5,)), **e)  # noqa: E731
    _raises_like_jax(ValueError, two, lambda m: m.fit(V, n_iterations=1, mask=-np.ones(V.shape)))
    _raises_like_jax(ValueError, two, lambda m: m.fit(V, n_iterations=1, mask=np.ones((3, 2))))
    _raises_like_jax(ValueError, two, lambda m: m.fit(-V, n_iterations=1))
    _raises_like_jax(ValueError, two, lambda m: m.fit(V, n_iterations=1, sparsity_H=(0.1,)))
    _raises_like_jax(ValueError, two, lambda m: m.fit(V, n_iterations=1, sparsity_H=-0.1))
    _raises_like_jax(ValueError, two, lambda m: m.fit(V, update_H=False, update_W=False))
    _raises_like_jax(ValueError, two, lambda m: m.fit(V, tol=1e-3,
                                                      progress_callback=lambda *a: True))
    _raises_like_jax(ValueError, two, lambda m: m.fit(V, tol=-1.0))
    _raises_like_jax(ValueError, two, lambda m: m.fit(V, tol=1.0, tol_check_every=0))
    _raises_like_jax(KeyError, lambda c, e: c((2,), ((3,),), backend='nope', **e),
                     lambda m: m.fit(V, n_iterations=1))
    _raises_like_jax(RuntimeError, two, lambda m: m.transform(V))
    _raises_like_jax(ValueError, two, lambda m: m.save('never'))
    _raises_like_jax(RuntimeError, two, lambda m: m.export_serving())
    fitted = lambda c, e: c((2, 2), ((3,), (5,)), **e).fit(V, n_iterations=1)  # noqa: E731
    _raises_like_jax(ValueError, fitted, lambda m: m.export_serving(l2_H=0.1))
    _raises_like_jax(ValueError, fitted, lambda m: m.export_serving(inhibition_strength=0.1))
    _raises_like_jax(ValueError, fitted,
                     lambda m: m.export_serving(cross_atom_inhibition_strength=0.1))


def test_unported_parts_raise():
    with pytest.raises(NotImplementedError, match='item 14e'):
        MultiScaleTNMF((2,), ((3,),), mesh=object(), **CPU)
    m = MultiScaleTNMF((2,), ((3,),), **CPU)
    for call in (lambda: m.save_sharded('x'), m.wait_for_checkpoints,
                 lambda: MultiScaleTNMF.load_sharded('x')):
        with pytest.raises(NotImplementedError, match='item 14e'):
            call()
    with pytest.raises(NotImplementedError, match='queue 2, item f'):
        MultiScaleTNMF((2,), ((3,),), dtype='bfloat16', device='cpu')
    with pytest.raises(ValueError, match='CPU model'):
        MultiScaleTNMF((2,), ((3,),), device='cpu', use_pallas=True)
    assert tnmf_tpu_torch.MultiScaleTNMF is MultiScaleTNMF
