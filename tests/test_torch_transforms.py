"""The port's transform groups (flip, rot90, D4) against the JAX package, in
float64 on the CPU: the group algebra, ``expand_w`` / ``tie_back`` and the
adapter's primitives against the JAX functions, the tie-back against
``torch.autograd`` of the expanded reconstruction, grouped fits on conv and
fft in the modes of ``tests/test_transforms.py`` (with inhibition, KL and a
mask), an identity group against ``'shift'``, the H view, ``R_partial``,
``save``/``load`` both ways, the minibatch, streaming, online and ``tol``
drivers, ``transform`` of a JAX D4 model's arrays, the dead-atom tools and
the error paths.

On CPU tensors the wrappers of K1-K4 run their plain versions; the kernels
at ``M*G`` maps are held against them on the card by ``chip_smoke.py``
phase 15."""

import numpy as np
import pytest
import torch

import tnmf_tpu
from tnmf_tpu import engine as jengine
from tnmf_tpu.ops import transforms as jtr
from tnmf_tpu.ops.modes import ConvPlan as JPlan
from tnmf_tpu.utils import atoms as jatoms

import tnmf_tpu_torch
from tnmf_tpu_torch import MiniBatchAlgorithm, engine
from tnmf_tpu_torch.ops import transforms as tr
from tnmf_tpu_torch.ops.modes import ConvPlan
from tnmf_tpu_torch.utils import atoms

F64 = torch.float64
TOL = dict(rtol=1e-8, atol=1e-10)
TYPES_2D = ['shift+flip', 'shift+rot90', 'shift+rot90+flip']
KERNELS = ('mu_ratio', 'mu_h', 'grad_w', 'mu_w', 'inhibited_mu_h')


def _data(seed=0, n=3, c=2, sample=(13,)):
    return np.random.default_rng(seed).random((n, c) + sample) + 0.05


def _model(module, n_atoms, atom_shape, **kw):
    if module is tnmf_tpu_torch:
        kw.update(device='cpu', dtype=F64)
    kw.setdefault('seed', 7)
    return module.TransformInvariantNMF(n_atoms, atom_shape, **kw)


def _both(n_atoms, atom_shape, V, init, fit_name='fit_batch', **fit):
    """The same seeded fit in both packages; returns (port, jax)."""
    out = []
    for module in (tnmf_tpu_torch, tnmf_tpu):
        m = _model(module, n_atoms, atom_shape, **init)
        kw = dict(fit)
        if 'algorithm' in kw:
            kw['algorithm'] = module.MiniBatchAlgorithm[kw['algorithm']]
        getattr(m, fit_name)(V, **kw)
        out.append(m)
    return out


def _assert_same(pm, jm):
    np.testing.assert_allclose(pm.W, jm.W, **TOL)
    np.testing.assert_allclose(pm.H, jm.H, **TOL)
    np.testing.assert_allclose(pm._energy_function(), jm._energy_function(), rtol=1e-8)


# ---------------------------------------------------------------- the algebra

@pytest.mark.parametrize('ttype,atom', [
    ('shift+flip', (5,)), ('shift+flip', (4, 3)), ('shift+flip', (3, 4, 2)),
    ('shift+rot90', (4, 4)), ('shift+rot90+flip', (4, 4)), ('shift+rot90', (2, 5, 5)),
])
def test_groups_match_jax_and_apply_inverse_inverts(ttype, atom):
    """The same elements as the JAX group, identity first, no duplicate
    image; ``apply`` equals JAX's and ``apply_inverse`` undoes it."""
    group, jgroup = tr.make_group(ttype, atom), jtr.make_group(ttype, atom)
    assert (group.name, group.ndim, group.elements) == (jgroup.name, jgroup.ndim,
                                                        jgroup.elements)
    assert group.elements[0] == (0, ())
    x = np.random.default_rng(1).random((2, 3) + atom)
    xt = torch.tensor(x)
    images = set()
    for e in group.elements:
        y = tr.apply(xt, e, 2, group.ndim)
        np.testing.assert_array_equal(y.numpy(), np.asarray(jtr.apply(x, e, 2, group.ndim)))
        assert torch.equal(tr.apply_inverse(y, e, 2, group.ndim), xt)
        images.add(y.numpy().tobytes())
    assert len(images) == group.size


def test_group_sizes_and_custom_group():
    assert [tr.make_group(t, (3, 3)).size for t in TYPES_2D] == [4, 4, 8]
    assert tr.make_group('shift+flip', (5,)).size == 2
    assert tr.make_group('shift', (3, 3)) is None
    custom = tr.TransformGroup('mirror-x', 2, ((0, ()), (0, (1,))))
    assert tr.make_group(custom, (3, 3)) is custom
    assert tr.TRANSFORM_TYPES == jtr.TRANSFORM_TYPES


@pytest.mark.parametrize('ttype,atom', [('shift+flip', (4,)), ('shift+rot90+flip', (3, 3))])
def test_expand_and_tie_back_match_jax(ttype, atom):
    group = tr.make_group(ttype, atom)
    rng = np.random.default_rng(2)
    W = rng.random((3, 2) + atom)
    We = tr.expand_w(torch.tensor(W), group)
    np.testing.assert_array_equal(We.numpy(), np.asarray(jtr.expand_w(W, jtr.make_group(ttype,
                                                                                         atom))))
    G = rng.random((3 * group.size, 2) + atom)
    np.testing.assert_allclose(tr.tie_back(torch.tensor(G), group).numpy(),
                               np.asarray(jtr.tie_back(G, jtr.make_group(ttype, atom))),
                               rtol=1e-15)


@pytest.mark.parametrize('strategy', ['conv', 'fft'])
@pytest.mark.parametrize('mode', ['valid', 'full', 'circular'])
@pytest.mark.parametrize('ttype,sample,atom', [
    ('shift+flip', (12,), (4,)),
    ('shift+rot90+flip', (9, 9), (3, 3)),
])
def test_tie_back_matches_autograd(strategy, mode, ttype, sample, atom):
    """``pos - neg`` of the grouped W statistics is the autograd gradient of
    the tied reconstruction energy: the permutation pull-back is exact."""
    rng = np.random.default_rng(3)
    group = tr.make_group(ttype, atom)
    plan = ConvPlan.create(mode, sample, atom)
    V = torch.tensor(rng.random((2, 2) + sample))
    W = torch.tensor(rng.random((2, 2) + atom), requires_grad=True)
    H = torch.tensor(rng.random((2, 2 * group.size) + plan.transform_shape))
    gops = engine.get_ops((strategy, group))
    R = gops.reconstruct(W, H, plan)
    (g_auto,) = torch.autograd.grad(0.5 * torch.sum((V - R) ** 2), W)
    W = W.detach()
    Vp = gops.prepare_data(V, plan)
    neg, pos = gops.grad_W_pair(Vp, gops.reconstruct(W, H, plan), H, plan)
    np.testing.assert_allclose((pos - neg).numpy(), g_auto.numpy(), rtol=1e-8, atol=1e-10)
    # the engine's statistics (K2's plain version on conv) are the same pair
    stats = engine.grad_W_stats(Vp, W, H, plan=plan, strategy=(strategy, group))
    np.testing.assert_allclose((stats[1] - stats[0]).numpy(), g_auto.numpy(),
                               rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize('strategy', ['conv', 'fft'])
def test_prepared_primitives_match_jax(strategy):
    """The adapter's primitives (the beta-divergence streams' path) against
    the JAX adapter's, on the base module's own signature."""
    rng = np.random.default_rng(4)
    group = tr.make_group('shift+rot90', (3, 3))
    plan, jplan = (P.create('valid', (8, 8), (3, 3)) for P in (ConvPlan, JPlan))
    jops = jengine.get_ops((strategy, jtr.make_group('shift+rot90', (3, 3))))
    gops = engine.get_ops((strategy, group))
    plan_arg = () if strategy == 'conv' else (plan,)
    V = rng.random((2, 1, 8, 8))
    W = rng.random((2, 1, 3, 3))
    H = rng.random((2, 8, 10, 10))
    A, B = (gops.prepare_data(torch.tensor(x), plan) for x in (V, V ** 2))
    jA, jB = (jops.prepare_data(x, jplan) for x in (V, V ** 2))
    Wt, Ht = torch.tensor(W), torch.tensor(H)
    pairs = [(gops.corr_H(A, Wt, *plan_arg), jops.corr_H(jA, W, jplan)),
             (gops.corr_W(A, Ht, *plan_arg), jops.corr_W(jA, H, jplan))]
    pairs += zip(gops.grad_H_pair_prepared(A, B, Wt, *plan_arg),
                 jops.grad_H_pair_prepared(jA, jB, W, jplan))
    pairs += zip(gops.grad_W_pair_prepared(A, B, Ht, *plan_arg),
                 jops.grad_W_pair_prepared(jA, jB, H, jplan))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert pairs[1][0].shape == (2, 1, 3, 3)


# --------------------------------------------------------- fits against JAX

@pytest.mark.parametrize('backend', ['jax_conv', 'jax_fft'])
@pytest.mark.parametrize('mode', ['valid', 'full', 'circular'])
def test_1d_flip_fits_match_jax(backend, mode):
    pm, jm = _both(2, (4,), _data(seed=5),
                   dict(backend=backend, transform_type='shift+flip', reconstruction_mode=mode),
                   n_iterations=6)
    assert pm._strategy == (backend.removeprefix('jax_'), pm._group)
    _assert_same(pm, jm)


@pytest.mark.parametrize('backend', ['jax_conv', 'jax_fft'])
@pytest.mark.parametrize('ttype', TYPES_2D)
def test_2d_fits_match_jax(ttype, backend):
    pm, jm = _both(2, (3, 3), _data(seed=6, n=2, c=1, sample=(9, 9)),
                   dict(backend=backend, transform_type=ttype), n_iterations=5,
                   sparsity_H=0.05)
    assert pm.H.shape == (2, 2, pm.n_transforms, 11, 11)
    _assert_same(pm, jm)


@pytest.mark.parametrize('backend', ['jax_conv', 'jax_fft'])
@pytest.mark.parametrize('case', ['inhibited', 'kl', 'masked', 'reflect_l2_ortho'])
def test_objectives_and_inhibition_with_groups_match_jax(backend, case):
    """D4 on 2-D data: same- and cross-atom inhibition over the ``M*G``
    maps, KL (the factor streams), a missing-data mask, and the reflect
    mode with ``l2_H`` and ``ortho_W``."""
    V = _data(seed=7, n=2, c=2, sample=(10, 10))
    init, fit = dict(backend=backend, transform_type='shift+rot90+flip'), {}
    if case == 'inhibited':
        fit = dict(inhibition_strength=0.1, cross_atom_inhibition_strength=0.05)
    elif case == 'kl':
        init['beta_loss'] = 1.0
    elif case == 'masked':
        fit['mask'] = (np.random.default_rng(8).random(V.shape) > 0.2).astype(float)
    else:
        init['reconstruction_mode'] = 'reflect'
        fit = dict(l2_H=0.1, ortho_W=0.1)
    pm, jm = _both(2, (3, 3), V, init, n_iterations=4, sparsity_H=0.05, **fit)
    _assert_same(pm, jm)


def test_cross_atom_inhibition_of_one_atom_spans_its_maps():
    """With one atom and G = 8 maps the cross-atom term spans the 8 maps
    (weight / 7), as in JAX; only a single map refuses it."""
    pm, jm = _both(1, (3, 3), _data(seed=9, n=2, c=1, sample=(9, 9)),
                   dict(backend='jax_conv', transform_type='shift+rot90+flip'), n_iterations=3,
                   cross_atom_inhibition_strength=0.2)
    _assert_same(pm, jm)
    with pytest.raises(ValueError, match='at least 2 atoms'):
        _model(tnmf_tpu_torch, 1, (3, 3)).fit(_data(n=2, c=1, sample=(9, 9)),
                                              cross_atom_inhibition_strength=0.2)


def test_identity_group_equals_shift():
    """A one-element group gives the shift model's bits."""
    V = _data(seed=9)
    ident = tr.TransformGroup(name='identity', ndim=1, elements=((0, ()),))
    m1 = _model(tnmf_tpu_torch, 3, (4,), backend='jax_conv', transform_type=ident)
    m2 = _model(tnmf_tpu_torch, 3, (4,), backend='jax_conv')
    m1.fit_batch(V, n_iterations=5, inhibition_strength=0.1)
    m2.fit_batch(V, n_iterations=5, inhibition_strength=0.1)
    assert m1.n_transforms == 1 and m1.transform_type == 'identity'
    assert torch.equal(m1._W, m2._W) and torch.equal(m1._H, m2._H)


def test_grouped_fit_calls_each_kernel_once_per_iteration(monkeypatch):
    """A D4 conv iteration calls K3's wrapper on the expanded dictionary of
    ``M*G`` atoms, K2's on H's ``M*G`` maps and ``mu_w`` on the canonical
    W, one call each; inhibited, K4 in place of K3."""
    calls = []

    def record(name, fn):
        def call(*args, **kwargs):
            calls.append((name, tuple(args[2].shape) if name == 'mu_h' else
                          tuple(args[1].shape) if name == 'grad_w' else tuple(args[0].shape)))
            return fn(*args, **kwargs)
        return call
    for name in KERNELS:
        monkeypatch.setattr(engine, name, record(name, getattr(engine, name)))
    # float32: the dtype the kernels take (their wrappers run the plain
    # versions on CPU tensors)
    m = tnmf_tpu_torch.TransformInvariantNMF(2, (3, 3), backend='jax_conv', seed=0,
                                             transform_type='shift+rot90+flip', device='cpu')
    V = _data(seed=1, n=2, c=1, sample=(8, 8))
    m.fit(V, n_iterations=2)
    W_exp, H, W = (16, 1, 3, 3), (2, 16, 10, 10), (2, 1, 3, 3)
    assert calls == [('mu_h', W_exp), ('grad_w', H), ('mu_w', W)] * 2
    calls.clear()
    m.fit(V, n_iterations=1, inhibition_strength=0.1, cross_atom_inhibition_strength=0.1)
    assert calls == [('inhibited_mu_h', H), ('grad_w', H), ('mu_w', W)]


# ------------------------------------------------------------ model surface

def _fit_small(module, ttype='shift+flip', **kw):
    V = _data(seed=11, n=4, c=1, sample=(12,))
    m = _model(module, 2, (4,), transform_type=ttype, seed=2, **kw)
    m.fit_batch(V, n_iterations=4)
    return m, V


def test_h_view_partial_additivity_and_inverse_transform():
    m, _ = _fit_small(tnmf_tpu_torch)
    assert m.H.shape == (4, 2, 2, 15) and m._H.shape == (4, 4, 15)
    R = m.R
    np.testing.assert_allclose(m.R_partial(0) + m.R_partial(1), R, rtol=1e-10)
    np.testing.assert_allclose(m.inverse_transform(m.H), R, rtol=1e-12)
    np.testing.assert_allclose(m.inverse_transform(m._H), R, rtol=1e-12)
    jm, _ = _fit_small(tnmf_tpu)
    np.testing.assert_allclose(m.R_partial(1), jm.R_partial(1), **TOL)


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_save_load_both_ways(writer, tmp_path):
    """A grouped checkpoint of either package carries ``transform_type``
    and the flat H; the other package restores the same model."""
    path = str(tmp_path / 'ckpt')
    pm, _ = _fit_small(tnmf_tpu_torch, 'shift+flip')
    jm, _ = _fit_small(tnmf_tpu, 'shift+flip')
    (pm if writer == 'port' else jm).save(path, include_H=True)
    with np.load(path + '.npz') as data:
        assert str(data['transform_type']) == 'shift+flip'
        assert data['H'].shape == (4, 4, 15)
    p2 = tnmf_tpu_torch.TransformInvariantNMF.load(path + '.npz', device='cpu')
    j2 = tnmf_tpu.TransformInvariantNMF.load(path + '.npz')
    for m in (p2, j2):
        assert m.transform_type == 'shift+flip' and m.n_transforms == 2
    np.testing.assert_allclose(p2.H, j2.H, rtol=0)
    np.testing.assert_allclose(p2.R, j2.R, **TOL)
    np.testing.assert_allclose(p2.R, pm.R, **TOL)


def test_transform_of_a_jax_d4_model_arrays():
    """A JAX D4 model's W and flat H, carried across with ``from_numpy``,
    encode new data as the JAX model does."""
    V = _data(seed=12, n=3, c=1, sample=(9, 9))
    jm = _model(tnmf_tpu, 2, (3, 3), transform_type='shift+rot90+flip', backend='jax_conv')
    jm.fit_batch(V, n_iterations=3, sparsity_H=0.1)
    pm = _model(tnmf_tpu_torch, 2, (3, 3), transform_type='shift+rot90+flip',
                backend='jax_conv')
    pm.set_dictionary(jm.W)
    pm._W, pm._H = tnmf_tpu_torch.from_numpy(np.asarray(jm._W), np.asarray(jm._H),
                                             device='cpu', dtype=F64)
    new = _data(seed=13, n=3, c=1, sample=(9, 9))
    got = pm.transform(new, n_iterations=4, sparsity_H=0.1, keep_H=True)
    want = jm.transform(new, n_iterations=4, sparsity_H=0.1, keep_H=True)
    assert got.shape == (3, 2, 8, 11, 11)
    np.testing.assert_allclose(got, want, **TOL)
    pm._rng, jm._rng = np.random.default_rng(5), np.random.default_rng(5)
    got = pm.transform(new, n_iterations=3, batch_size=2)
    np.testing.assert_allclose(got, jm.transform(new, n_iterations=3, batch_size=2), **TOL)


@pytest.mark.parametrize('algorithm', [a.name for a in MiniBatchAlgorithm])
def test_minibatch_algorithms_with_a_group_match_jax(algorithm):
    pm, jm = _both(2, (4,), _data(seed=13, n=6, c=1, sample=(12,)),
                   dict(transform_type='shift+flip', backend='jax_fft'),
                   fit_name='fit_minibatches', algorithm=algorithm, batch_size=4, n_epochs=2,
                   sag_lambda=0.8, sparsity_H=0.1)
    _assert_same(pm, jm)


def test_stream_online_and_tol_with_a_group_match_jax():
    """``fit_stream`` (ASG_MU per subsample), ``partial_fit`` steps (the SAG
    statistics at the canonical W's shape) and ``tol``."""
    V = _data(seed=25, n=9, c=1, sample=(12,))
    init = dict(transform_type='shift+flip', backend='jax_conv')
    out = []
    for module in (tnmf_tpu_torch, tnmf_tpu):
        m = _model(module, 2, (4,), **init)
        m.fit(iter(V), subsample_size=3, batch_size=2, n_epochs=2,
              algorithm=module.MiniBatchAlgorithm.ASG_MU)
        out.append(m)
    assert out[0].H.shape == (3, 2, 2, 15)
    _assert_same(*out)
    out = []
    for module in (tnmf_tpu_torch, tnmf_tpu):
        m = _model(module, 2, (4,), **init)
        for i in range(3):
            m.partial_fit(V[3 * i:3 * i + 3], sag_lambda=0.5, inhibition_strength=0.1)
        out.append(m)
    _assert_same(*out)
    assert out[0]._sag_stat_[0].shape == (2, 1, 4)
    pm, jm = _both(2, (4,), V[:4], init, n_iterations=500, tol=1e-3, tol_check_every=5)
    assert pm.n_iterations_ == jm.n_iterations_ < 500
    _assert_same(pm, jm)


def test_dead_atoms_sum_and_revive_all_maps_of_an_atom():
    """An atom is dead only when all its G maps are; revival re-draws them
    all, from the model's stream, as the JAX package does."""
    models = [_fit_small(module)[0] for module in (tnmf_tpu_torch, tnmf_tpu)]
    pm, jm = models
    H = pm.H
    H[:, 1, 0] = 0.          # one map of atom 1 dead: the atom lives
    pm._H = torch.tensor(H.reshape(pm._H.shape))
    assert atoms.find_dead_atoms(pm).size == 0
    H[:, 1] = 0.             # every map of atom 1
    pm._H = torch.tensor(H.reshape(pm._H.shape))
    jm._H = jm._H.at[:, 2:4].set(0.)
    np.testing.assert_array_equal(atoms._atom_mass(pm) > 0, jatoms._atom_mass(jm) > 0)
    revived = atoms.revive_dead_atoms(pm, rng=np.random.default_rng(0))
    jrevived = jatoms.revive_dead_atoms(jm, rng=np.random.default_rng(0))
    assert list(revived) == list(jrevived) == [1]
    np.testing.assert_allclose(pm.W[1], np.asarray(jm._W)[1], rtol=1e-15)
    np.testing.assert_allclose(pm.H[:, 1], jm.H[:, 1], rtol=1e-15)
    assert (pm.H[:, 1] > 0).all()


def test_error_paths():
    with pytest.raises(ValueError, match='square atoms'):
        tnmf_tpu_torch.TransformInvariantNMF(2, (3, 4), transform_type='shift+rot90')
    with pytest.raises(ValueError, match='2 shift dimensions'):
        tnmf_tpu_torch.TransformInvariantNMF(2, (5,), transform_type='shift+rot90')
    with pytest.raises(ValueError, match='unknown transform type'):
        tnmf_tpu_torch.TransformInvariantNMF(2, (5,), transform_type='shift+warp')
    with pytest.raises(ValueError, match='transform_type'):
        tnmf_tpu_torch.TransformInvariantNMF(2, (5,), transform_type='shift+flip',
                                             use_pallas=True)
    with pytest.raises(NotImplementedError, match='item 14'):
        tnmf_tpu_torch.TransformInvariantNMF(2, (5,), transform_type='shift+flip',
                                             shard_axis='spatial')
    # the default switch runs the kernels with a group
    model = tnmf_tpu_torch.TransformInvariantNMF(2, (5,), transform_type='shift+flip')
    assert model._use_pallas is None and model.n_transforms == 2
