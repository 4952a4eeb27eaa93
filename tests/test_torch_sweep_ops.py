"""The model axis of the kernels' operators and the sweep's own parts, on
the CPU: each operator's vmap rule (one call of the kernel's model-axis
wrapper for all the models) against a Python loop of the operator over the
models, bit for bit; K5's rule passing each operand's strides as they are
(no copy, a shared operand at model stride 0); the ``.t`` overloads
against the default ones; the schemas that exported programs rely on,
unchanged; a sweep of one model against ``engine.fit_loop`` from the same
init; the seeded draws; the float32 cast of float64 data; ``SweepResult``."""

import contextlib

import numpy as np
import pytest
import torch

from tnmf_tpu_torch import SweepResult, engine, sweep_fit
from tnmf_tpu_torch.kernels import _build, gw, hals, inhibit, mu, mu_h
from tnmf_tpu_torch.kernels import ops as kops
from tnmf_tpu_torch.models import sweep
from tnmf_tpu_torch.ops.inhibition import inhibition_kernels
from tnmf_tpu_torch.ops.modes import ConvPlan

S = 3
F64 = torch.float64


def _rand(gen, *shape):
    return torch.rand(shape, generator=gen, dtype=F64)


@pytest.fixture
def calls(monkeypatch):
    """Counts of each wrapper's calls over a model axis: the ``*_models``
    wrappers', and K1's with ``model_axis=True`` (its argument at
    ``axis_at``)."""
    counts = {}
    for mod, name, axis_at in ((mu, 'mu_ratio', 4), (mu, 'mu_w', 5), (gw, 'grad_w_models', None),
                               (mu_h, 'mu_h_models', None),
                               (inhibit, 'inhibited_mu_h_models', None),
                               (hals, 'hals_sweep_models', None)):
        def counting(*args, _fn=getattr(mod, name), _name=name, _at=axis_at, **kwargs):
            if _at is None or (len(args) > _at and args[_at]):
                counts[_name] = counts.get(_name, 0) + 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, counting)
    return counts


def _problem(nd: int):
    gen = torch.Generator().manual_seed(3 + nd)
    T, A = ((9, 11), (3, 2)) if nd == 2 else ((17,), (4,))
    N, C, M = 2, 2, 3
    E = tuple(t + a - 1 for t, a in zip(T, A))
    return dict(Vp=_rand(gen, N, C, *E), Vps=_rand(gen, S, N, C, *E), Rx=_rand(gen, S, N, C, *E),
                W=_rand(gen, S, M, C, *A), H=_rand(gen, S, N, M, *T),
                neg=_rand(gen, S, N, M, *T), pos=_rand(gen, S, N, M, *T),
                wneg=_rand(gen, S, M, C, *A), wpos=_rand(gen, S, M, C, *A),
                reg=1e-9 + torch.tensor([0.1, 0.0, 0.3], dtype=F64),
                inh=torch.tensor([0.2, 0.0, 0.1], dtype=F64),
                cross=torch.tensor([0.0, 0.0, 0.05], dtype=F64),
                ks=[torch.as_tensor(k, dtype=F64) for k in inhibition_kernels((2,) * nd)],
                nd=nd)


def _equal(a, b):
    a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple) else (b,))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and torch.equal(x, y)


@pytest.mark.parametrize('nd', [1, 2])
def test_mu_ratio_rules(nd, calls):
    p = _problem(nd)
    got = torch.func.vmap(kops.mu_ratio)(p['H'], p['neg'], p['pos'], p['reg'])
    want = torch.stack([kops.mu_ratio(p['H'][s], p['neg'][s], p['pos'][s], float(p['reg'][s]))
                        for s in range(S)])
    _equal(got, want)
    shared = torch.func.vmap(kops.mu_ratio, in_dims=(0, 0, 0, None))(p['H'], p['neg'],
                                                                     p['pos'], 0.25)
    _equal(shared, torch.stack([kops.mu_ratio(p['H'][s], p['neg'][s], p['pos'][s], 0.25)
                                for s in range(S)]))
    assert calls == {'mu_ratio': 2}


@pytest.mark.parametrize('nd', [1, 2])
@pytest.mark.parametrize('vp', ['shared', 'per model'])
def test_mu_h_rules(nd, vp, calls):
    p = _problem(nd)
    extra = None if vp == 'shared' else 0.1 * p['H']
    if vp == 'shared':
        got = torch.func.vmap(kops.mu_h, in_dims=(None, 0, 0, 0, 0, None))(
            p['Vp'], p['Rx'], p['W'], p['H'], p['reg'], None)
    else:
        got = torch.func.vmap(kops.mu_h)(p['Vps'], p['Rx'], p['W'], p['H'], p['reg'], extra)
    want = torch.stack([
        kops.mu_h(p['Vp'] if vp == 'shared' else p['Vps'][s], p['Rx'][s], p['W'][s], p['H'][s],
                  float(p['reg'][s]), None if extra is None else extra[s]) for s in range(S)])
    _equal(got, want)
    # one TF32 pass (its plain version rounds float32 operands)
    Vp, Rx, W, H = (p[k].float() for k in ('Vp', 'Rx', 'W', 'H'))
    one_pass = torch.func.vmap(lambda *a: kops.mu_h(*a, None, 1), in_dims=(None, 0, 0, 0, None))(
        Vp, Rx, W, H, 0.5)
    _equal(one_pass, torch.stack([kops.mu_h(Vp, Rx[s], W[s], H[s], 0.5, None, 1)
                                  for s in range(S)]))
    assert calls == {'mu_h_models': 2}


@pytest.mark.parametrize('nd', [1, 2])
@pytest.mark.parametrize('terms', [(True, False), (False, True), (True, True)])
def test_inhibited_mu_h_rules(nd, terms, calls):
    p = _problem(nd)
    use_same, use_cross = terms

    def update(H, neg, pos, inh, cross, reg):
        return kops.inhibited_mu_h(H, neg, pos, p['ks'], inh, cross, reg,
                                   use_same=use_same, use_cross=use_cross)
    got = torch.func.vmap(update)(p['H'], p['neg'], p['pos'], p['inh'], p['cross'], p['reg'])
    want = torch.stack([update(p['H'][s], p['neg'][s], p['pos'][s], float(p['inh'][s]),
                               float(p['cross'][s]), float(p['reg'][s])) for s in range(S)])
    _equal(got, want)
    floats = torch.func.vmap(update, in_dims=(0, 0, 0, None, None, None))(
        p['H'], p['neg'], p['pos'], 0.1, 0.2, 0.3)
    _equal(floats, torch.stack([update(p['H'][s], p['neg'][s], p['pos'][s], 0.1, 0.2, 0.3)
                                for s in range(S)]))
    assert calls == {'inhibited_mu_h_models': 2}


@pytest.mark.parametrize('nd', [1, 2])
def test_mu_w_and_grad_w_rules(nd, calls):
    p = _problem(nd)
    got = torch.func.vmap(kops.mu_w, in_dims=(0, 0, 0, None, None))(
        p['W'], p['wneg'], p['wpos'], engine.EPS, nd)
    _equal(got, torch.stack([kops.mu_w(p['W'][s], p['wneg'][s], p['wpos'][s], engine.EPS, nd)
                             for s in range(S)]))
    X2 = torch.cat([p['Vps'], p['Rx']], dim=2)
    got = torch.func.vmap(kops.grad_w, in_dims=(0, 0, None))(X2, p['H'], 3)
    want = [kops.grad_w(X2[s], p['H'][s]) for s in range(S)]
    _equal(got, tuple(torch.stack(w) for w in zip(*want)))
    _equal(want[0], gw.grad_w(X2[0], p['H'][0]))  # the wrapper itself
    assert calls == {'mu_w': 1, 'grad_w_models': 1}


def _hals_problem(side: str, rows: int = 11, m: int = 5):
    """``X (S, rows, m)``, ``G (S, m, m)``, ``P (S, rows, m)`` as a sweep's H
    side launches them (row-major), or as its W side does (transposed views
    of contiguous ``(S, m, rows)`` and ``(S, m, m)`` stacks)."""
    gen = torch.Generator().manual_seed(7)
    Y = _rand(gen, S, m, 3 * m)
    G = Y @ Y.transpose(1, 2)
    P = _rand(gen, S, rows, m) @ G
    X = _rand(gen, S, rows, m)
    if side == 'W':
        X, G, P = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (X, G, P))
    return X, G, P


@pytest.mark.parametrize('side', ['H', 'W'])
def test_hals_sweep_rules(side, calls):
    """K5's vmap rule on both schemas (float strengths: the default one;
    tensors: ``.t``), and with a G the models share, against a loop of the
    operator over the models; each model in X's layout."""
    X, G, P = _hals_problem(side)
    l1 = torch.tensor([0.1, 0.0, 0.3], dtype=F64)
    l2 = torch.tensor([0.0, 0.2, 0.05], dtype=F64)
    got = torch.func.vmap(kops.hals_sweep, in_dims=(0, 0, 0, None, None, None))(
        X, G, P, 0.1, 0.05, 2)
    _equal(got, torch.stack([kops.hals_sweep(X[s], G[s], P[s], 0.1, 0.05, 2)
                             for s in range(S)]))
    got = torch.func.vmap(kops.hals_sweep, in_dims=(0, 0, 0, 0, 0, None))(X, G, P, l1, l2, 2)
    _equal(got, torch.stack([kops.hals_sweep(X[s], G[s], P[s], float(l1[s]), float(l2[s]), 2)
                             for s in range(S)]))
    got = torch.func.vmap(kops.hals_sweep, in_dims=(0, None, 0, 0, None, None))(
        X, G[1], P, l1, 0.05, 1)
    _equal(got, torch.stack([kops.hals_sweep(X[s], G[1], P[s], float(l1[s]), 0.05, 1)
                             for s in range(S)]))
    assert calls == {'hals_sweep_models': 3}
    out = hals.hals_sweep_models(X, G, P, l1, l2, 1)
    assert out.stride() == X.stride()


def test_hals_sweep_rule_launches_strided_operands_without_a_copy(monkeypatch):
    """Under vmap on tensors off the CPU, K5's rule calls the C entry of the
    model axis once, with each operand's own address and its model, row
    and column strides: the W side's transposed views with no copy
    (``contiguous`` and ``clone`` of an operand refuse while it runs), the
    G the models share at model stride 0, the output in X's layout and the
    single launch's geometry.  Meta tensors stand in for CUDA ones, and a
    recording library for the kernel."""
    rows, m = 40, 6
    launches = []

    class Lib:
        def tnmf_hals_sweep_models(self, *args):
            launches.append(args)
            return 0
    monkeypatch.setattr(hals, '_multiprocessors', lambda device: 132)
    monkeypatch.setattr(_build, 'library', lambda: Lib())
    monkeypatch.setattr(_build, 'check_inputs', lambda *a, **k: None)
    monkeypatch.setattr(_build, 'stream_of', lambda t: 0)
    monkeypatch.setattr(torch.cuda, 'device', lambda d: contextlib.nullcontext())
    meta = dict(device='meta', dtype=torch.float32)
    X = torch.empty(S, m, rows, **meta).transpose(1, 2)
    P = torch.empty(S, m, rows, **meta).transpose(1, 2)
    G = torch.empty(m, m, **meta).T
    l1 = torch.empty(S, **meta)
    seen = []

    def record(fn):
        def call(*args, **kwargs):
            seen.append(args)
            return fn(*args, **kwargs)
        return call
    monkeypatch.setattr(hals, 'hals_sweep_models', record(hals.hals_sweep_models))
    model_launches = hals.hals_sweep.model_launches

    def refuse(t, *a, **k):
        if t.dim() >= 2:
            raise AssertionError('an operand was copied')
        return t
    with monkeypatch.context() as mp:
        mp.setattr(torch.Tensor, 'contiguous', refuse)
        mp.setattr(torch.Tensor, 'clone', refuse)
        out = torch.func.vmap(kops.hals_sweep, in_dims=(0, None, 0, 0, None, None))(
            X, G, P, l1, 0.0, 2)
    (args,), ((Xs, Gs, Ps, *_),) = launches, seen
    assert out.shape == X.shape and out.stride() == X.stride()
    assert Gs.stride() == (0, 1, m) and Xs.stride() == X.stride() and Ps.stride() == P.stride()
    geo = hals.launch_geometry(rows, m, X.device)
    assert args[:4] == (X.data_ptr(), m * rows, 1, rows)
    assert args[4:8] == (G.data_ptr(), 0, 1, m)
    assert args[8:12] == (P.data_ptr(), m * rows, 1, rows)
    assert args[13:16] == (m * rows, 1, rows)  # the output: X's layout
    assert args[18:] == (S, 2, rows, m, geo['rows_per_block'], int(geo['resident']),
                         geo['smem_bytes'], 0)
    assert hals.hals_sweep.model_launches == model_launches + 1
    hals.hals_sweep.launches -= 1
    hals.hals_sweep.model_launches = model_launches


def test_tensor_overloads_match_default_ones():
    """A ``.t`` call outside vmap (a model axis of one) against the default
    overload with the same strengths as floats."""
    p = _problem(2)
    H, neg, pos, Rx, W = (p[k][0] for k in ('H', 'neg', 'pos', 'Rx', 'W'))
    t = torch.tensor(0.25, dtype=F64)
    _equal(kops.mu_ratio_t_op(H, neg, pos, t), kops.mu_ratio_op(H, neg, pos, 0.25))
    _equal(kops.mu_h_t_op(p['Vp'], Rx, W, H, t, None, 3),
           kops.mu_h_op(p['Vp'], Rx, W, H, 0.25, None, 3))
    _equal(kops.inhibited_mu_h_t_op(H, neg, pos, p['ks'], t, t, t, True, True),
           kops.inhibited_mu_h_op(H, neg, pos, p['ks'], 0.25, 0.25, 0.25, True, True))
    for side in ('H', 'W'):
        X, G, P = (x[0] for x in _hals_problem(side))
        got = kops.hals_sweep_t_op(X, G, P, t, 0.5 * t, 2)
        _equal(got, kops.hals_sweep_op(X, G, P, 0.25, 0.125, 2))
        assert got.stride() == X.stride()
    assert str(torch.ops.tnmf.hals_sweep.t._schema) == (
        'tnmf::hals_sweep.t(Tensor X, Tensor G, Tensor P, Tensor l1, Tensor l2, int inner) '
        '-> Tensor')


def test_old_schemas_unchanged():
    """Programs exported before the model axis call these schemas."""
    want = {
        'mu_ratio': 'tnmf::mu_ratio(Tensor arr, Tensor neg, Tensor pos, float reg) -> Tensor',
        'mu_h': 'tnmf::mu_h(Tensor Vp, Tensor Rx, Tensor W, Tensor H, float denom_add, '
                'Tensor? pos_extra, int passes=3) -> Tensor',
        'inhibited_mu_h': 'tnmf::inhibited_mu_h(Tensor H, Tensor neg, Tensor pos, '
                          'Tensor[] kernels, float inhibition, float cross_inhibition, '
                          'float reg, bool use_same, bool use_cross) -> Tensor',
        'hals_sweep': 'tnmf::hals_sweep(Tensor X, Tensor G, Tensor P, float l1, float l2, '
                      'int inner) -> Tensor',
    }
    for name, schema in want.items():
        assert str(getattr(torch.ops.tnmf, name).default._schema) == schema


@pytest.mark.parametrize('strategy, inhibited', [('conv', False), ('conv', True),
                                                 ('fft', False)])
def test_one_model_matches_fit_loop(strategy, inhibited):
    """``n_models=1``: the sweep's model against ``engine.fit_loop`` from
    the same init with float strengths (float64, rtol 1e-12)."""
    V = torch.rand((3, 1, 12, 12), generator=torch.Generator().manual_seed(1), dtype=F64)
    kw = dict(sparsity=0.1, inhibition=0.1 if inhibited else 0.0)
    gen = torch.Generator().manual_seed(4)
    plan = ConvPlan.create('valid', (12, 12), (3, 3))
    W0, H0 = sweep._draw([gen], 1, (3, 1, 3, 3), (3, 3) + plan.transform_shape, 2, F64,
                         torch.device('cpu'))
    res = sweep._sweep_from_init(V, W0, H0, n_iterations=6, strategy=strategy, device='cpu',
                                 **kw)
    Vp = engine.prepare_data(V, plan=plan, strategy=strategy)
    ks = tuple(torch.as_tensor(k, dtype=F64) for k in inhibition_kernels((2, 2)))
    W, H = engine.fit_loop(Vp, W0[0], H0[0], 6, 0.1, kw['inhibition'], 0.0, ks, plan=plan,
                           strategy=strategy, use_inhibition=inhibited)
    np.testing.assert_allclose(res.W[0].numpy(), W.numpy(), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(res.H[0].numpy(), H.numpy(), rtol=1e-12, atol=1e-15)
    E = engine.energy(V, W, H, plan=plan, strategy=strategy)
    np.testing.assert_allclose(res.energies[0].item(), E.item(), rtol=1e-12)


def _V32():
    return np.random.default_rng(2).random((2, 1, 10, 10), dtype=np.float32)


def test_seeded_draws_reproducible_and_distinct():
    V = _V32()
    a = sweep_fit(V, 2, (3, 3), n_models=3, seed=9, n_iterations=0, device='cpu')
    b = sweep_fit(V, 2, (3, 3), n_models=3, seed=9, n_iterations=0, device='cpu')
    assert torch.equal(a.W, b.W) and torch.equal(a.H, b.H)
    assert not torch.equal(a.W[0], a.W[1]) and not torch.equal(a.H[1], a.H[2])
    np.testing.assert_array_equal(a.seeds, [0, 1, 2])  # positional labels
    assert float(a.H.min()) > 0 and float(a.H.max()) <= 1
    np.testing.assert_allclose(a.W.sum(dim=(-2, -1)).numpy(), 1.0, rtol=1e-6)
    # one generator of the scalar seed draws model 0's H and W, then model 1's
    g = torch.Generator().manual_seed(9)
    H0 = 1 - torch.rand(a.H.shape[1:], generator=g)
    W0 = 1 - torch.rand(a.W.shape[1:], generator=g)
    assert torch.equal(a.H[0], H0) and torch.equal(a.W[0], W0 / W0.sum(dim=(-2, -1), keepdim=True))
    # a seed vector: one generator per model; equal seeds draw equal inits
    c = sweep_fit(V, 2, (3, 3), seed=np.array([9, 4, 9]), n_iterations=0, device='cpu')
    np.testing.assert_array_equal(c.seeds, [9, 4, 9])
    assert torch.equal(c.H[0], c.H[2]) and not torch.equal(c.H[0], c.H[1])
    assert torch.equal(c.H[0], H0)


def test_float64_data_is_fitted_in_float32():
    V = _V32().astype(np.float64)
    res = sweep_fit(V, 2, (3, 3), n_models=2, n_iterations=2, device='cpu')
    assert res.W.dtype == res.H.dtype == res.energies.dtype == torch.float32
    ref = sweep_fit(V.astype(np.float32), 2, (3, 3), n_models=2, n_iterations=2, device='cpu')
    assert torch.equal(res.W, ref.W) and torch.equal(res.energies, ref.energies)


def test_sweep_result():
    V = _V32()
    res = sweep_fit(V, 2, (3, 3), n_models=3, n_iterations=3, device='cpu',
                    sparsity=[0.0, 0.5, 0.1])
    assert isinstance(res, SweepResult) and res.n_models == 3
    assert res.W.shape == (3, 2, 1, 3, 3) and res.H.shape == (3, 2, 2, 12, 12)
    assert res.best == int(np.argmin(res.energies.numpy()))
    W, H = res.model(1)
    assert isinstance(W, np.ndarray) and np.array_equal(W, res.W[1].numpy())
    assert np.array_equal(H, res.H[1].numpy())
