"""The port's sklearn estimator protocol and atom-matching tools, on the CPU:
``get_params`` / ``set_params`` / ``clone`` / ``Pipeline`` / ``GridSearchCV``
and ``__sklearn_tags__`` as ``tests/test_sklearn.py`` holds the JAX
package to them (``device`` is one of the parameters), and
``atom_similarity`` / ``match_dictionaries`` against the JAX functions
under every transform type."""

import numpy as np
import pytest
import torch
from sklearn.base import clone
from sklearn.model_selection import GridSearchCV, KFold
from sklearn.pipeline import Pipeline

import tnmf_tpu
from tnmf_tpu.utils import atoms as jatoms

import tnmf_tpu_torch
from tnmf_tpu_torch import MiniBatchTransformInvariantNMF, TransformInvariantNMF
from tnmf_tpu_torch.utils import atoms

F64 = torch.float64


def _make_V():
    return np.random.default_rng(1).random((3, 1, 16, 16))


def _model(**kw):
    return TransformInvariantNMF(**dict(dict(n_atoms=3, atom_shape=(3, 3), seed=11,
                                             device='cpu', dtype=F64), **kw))


def test_get_params_roundtrip():
    nmf = _model(n_atoms=4, seed=7, reconstruction_mode='circular',
                 beta_loss='kullback-leibler', transform_type='shift+rot90', init='device')
    p = nmf.get_params()
    assert (p['n_atoms'], p['atom_shape'], p['seed'], p['reconstruction_mode'],
            p['beta_loss'], p['transform_type'], p['init'], p['device'], p['dtype']) == (
        4, (3, 3), 7, 'circular', 'kullback-leibler', 'shift+rot90', 'device', 'cpu', F64)
    # the JAX package's parameter names, and the port's device
    jax_names = set(tnmf_tpu.TransformInvariantNMF(2, (3, 3)).get_params())
    assert set(p) == jax_names | {'device'}
    assert TransformInvariantNMF(**p).get_params() == p


def test_clone_produces_an_equivalent_independent_model():
    V = _make_V()
    a = _model(transform_type='shift+flip')
    b = clone(a)
    assert b is not a and b.get_params() == a.get_params()
    a.fit(V, n_iterations=4)
    b.fit(V, n_iterations=4)
    assert torch.equal(a._W, b._W) and torch.equal(a._H, b._H)
    assert clone(a)._W is None


def test_set_params_reconfigures_and_validates():
    nmf = _model()
    assert nmf.set_params(n_atoms=5) is nmf and nmf.n_atoms == 5
    assert nmf.get_params()['n_atoms'] == 5
    with pytest.raises(ValueError, match='invalid parameter'):
        nmf.set_params(not_a_param=1)
    nmf.fit(_make_V(), n_iterations=2)
    nmf.set_params(n_atoms=2, transform_type='shift+rot90+flip')
    assert nmf._W is None and nmf.n_transforms == 8
    nmf.set_params(precision='high')
    assert nmf.get_params()['precision'] == 'high' and nmf.n_transforms == 8


def test_minibatch_model_parameters():
    m = MiniBatchTransformInvariantNMF(2, (3, 3), batch_size=2, algorithm='ASAG_MU',
                                       n_epochs=2, device='cpu', dtype=F64, seed=1)
    p = m.get_params()
    assert (p['batch_size'], p['algorithm'], p['n_epochs']) == (
        2, tnmf_tpu_torch.MiniBatchAlgorithm.ASAG_MU, 2)
    twin = clone(m)
    V = _make_V()
    m.fit(V)
    twin.fit(V)
    assert torch.equal(m._W, twin._W)
    m.set_params(n_epochs=3)
    assert m.n_epochs == 3 and m._W is None


def test_pipeline_fit_transform_matches_direct():
    V = _make_V()
    H_direct = _model(seed=5).fit_transform(V, n_iterations=3)
    pipe = Pipeline([('tnmf', _model(seed=5))])
    H_pipe = pipe.fit_transform(V, tnmf__n_iterations=3)
    np.testing.assert_array_equal(H_pipe, H_direct)
    assert pipe.transform(V).shape == H_direct.shape


def test_grid_search_over_constructor_params():
    V = _make_V()

    def scorer(est, X, y=None):
        del y
        est.transform(X, n_iterations=3)
        return -float(est._energy_function())

    gs = GridSearchCV(_model(n_atoms=2, seed=3), {'n_atoms': [2, 4],
                                                  'transform_type': ['shift', 'shift+flip']},
                      scoring=scorer, cv=KFold(n_splits=3), refit=True)
    gs.fit(V, n_iterations=3)
    assert gs.best_params_['n_atoms'] in (2, 4)
    assert gs.best_estimator_.W.shape[0] == gs.best_params_['n_atoms']


def test_sklearn_tags():
    tags = _model().__sklearn_tags__()
    assert tags.estimator_type == 'transformer'
    assert tags.no_validation and not tags.target_tags.required


# ------------------------------------------------------------ atom matching

@pytest.mark.parametrize('ttype', ['shift', 'shift+flip', 'shift+rot90', 'shift+rot90+flip'])
def test_atom_similarity_matches_jax(ttype):
    """A transformed, shifted, scaled copy scores 1 under its group (and
    less under 'shift' alone); any pair scores as in JAX; tensors too."""
    rng = np.random.default_rng(2)
    a = rng.random((2, 5, 5))
    b = 3.0 * np.rot90(np.flip(a, axis=-1), 1, axes=(1, 2))
    b = np.pad(b, ((0, 0), (1, 0), (0, 1)))
    got = atoms.atom_similarity(a, b, ttype)
    assert got == jatoms.atom_similarity(a, b, ttype)
    if ttype == 'shift+rot90+flip':
        assert got == pytest.approx(1.0, abs=1e-12)
    else:
        assert got < 0.99
    c = rng.random((2, 4, 4))
    assert atoms.atom_similarity(torch.tensor(a), torch.tensor(c), ttype) == \
        jatoms.atom_similarity(a, c, ttype)
    assert atoms.atom_similarity(np.zeros((2, 3, 3)), c, ttype) == 0.0


@pytest.mark.parametrize('ttype', ['shift', 'shift+flip'])
def test_match_dictionaries_matches_jax(ttype):
    """A permuted, flipped, rescaled copy of a dictionary, with one extra
    atom on one side: the JAX assignment, scores and similarity matrix."""
    rng = np.random.default_rng(3)
    W = rng.random((4, 1, 6))
    perm = [2, 0, 3, 1]
    W_b = np.concatenate([2.0 * W[perm][:, :, ::-1], rng.random((1, 1, 6))])
    got = atoms.match_dictionaries(W, torch.tensor(W_b.copy()), ttype)
    want = jatoms.match_dictionaries(W, W_b, ttype)
    np.testing.assert_array_equal(got['assignment'], want['assignment'])
    np.testing.assert_array_equal(got['similarity'], want['similarity'])
    assert got['score'] == want['score']
    if ttype == 'shift+flip':
        np.testing.assert_array_equal(got['assignment'], np.argsort(perm))
        assert got['score'] == pytest.approx(1.0, abs=1e-12)
    short = atoms.match_dictionaries(W_b, W[:2], ttype)
    np.testing.assert_array_equal(short['assignment'],
                                  jatoms.match_dictionaries(W_b, W[:2], ttype)['assignment'])
    assert (short['assignment'] == -1).sum() == 3


def test_match_fitted_dictionaries_of_both_packages():
    """The same seeded D4 fit in both packages matches itself atom for atom."""
    V = np.random.default_rng(4).random((2, 1, 10, 10))
    out = []
    for module in (tnmf_tpu_torch, tnmf_tpu):
        kw = dict(device='cpu', dtype=F64) if module is tnmf_tpu_torch else {}
        m = module.TransformInvariantNMF(2, (3, 3), seed=1, transform_type='shift+rot90+flip',
                                         **kw)
        m.fit(V, n_iterations=3)
        out.append(m.W)
    res = atoms.match_dictionaries(*out, transform_type='shift+rot90+flip')
    np.testing.assert_array_equal(res['assignment'], [0, 1])
    assert res['score'] == pytest.approx(1.0, abs=1e-9)
