"""The HALS sweeps' products, one per model (faults C2 and C3).

Under ``torch.func.vmap`` a matrix product is one batched product for all
the models, which sums in another order than a single fit's product: on
the card cuBLAS's rounded 7 to 17 times more, and the nearly rank-one
W-side Gram of plain NMF amplified that into sweeps 0.17 off float64 where
the single fits were 9.6e-3 off (C2); on the CPU MKL's batched products on
AVX-512 round apart from its single ones (C3).  On every device the HALS
products (:func:`tnmf_tpu_torch.kernels.hals.dot`: the Grams, the energy's
product and the plain sweep's ``X @ G[:, j]``) go through
``tnmf::matmul``, whose vmap rule forms each model's product alone: each
model's Grams and sweeps, and so each model of a sweep, have its single
fit's bits.  On the CPU a float32 product accumulates in float64 and
rounds once; the card keeps float32.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from tnmf_tpu_torch import engine_hals
from tnmf_tpu_torch.kernels import hals, ops
from tnmf_tpu_torch.models import sweep


def _problem(n, F, m, S, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    V = torch.tensor(rng.random((n, 1, F)), dtype=dtype)
    W0 = torch.tensor(1 - rng.random((S, m, 1, F)), dtype=dtype)
    W0 = W0 / W0.sum(-1, keepdim=True)
    H0 = torch.tensor(1 - rng.random((S, n, m, 1)), dtype=dtype)
    return V, W0, H0


def _grams(V2, W2, H2):
    """The four Gram products of a HALS iteration, as ``_iteration`` forms
    them, and the energy's product."""
    Wt = W2.to(engine_hals._acc_dtype(W2)).T
    Ht = H2.to(engine_hals._acc_dtype(H2)).T
    return (engine_hals._dot(W2, Wt), engine_hals._dot(V2, Wt), engine_hals._dot(Ht, H2),
            engine_hals._dot(Ht, V2), engine_hals._dot(H2, W2))


def test_the_card_forms_each_models_products_alone(monkeypatch):
    """On CUDA tensors (fake ones here) the products reach ``tnmf::matmul``
    in float32, as cuBLAS forms them; on CPU tensors in float64."""
    seen = []
    monkeypatch.setattr(ops, 'matmul', lambda a, b: seen.append((a.device.type, a.dtype))
                        or torch.matmul(a, b))
    engine_hals._dot(torch.ones(3, 2), torch.ones(2, 4))
    with FakeTensorMode():
        out = engine_hals._dot(torch.empty(3, 2, device='cuda'), torch.empty(2, 4, device='cuda'))
    assert seen == [('cpu', torch.float64), ('cuda', torch.float32)]
    assert out.dtype == torch.float32


@pytest.mark.parametrize('n,F,m,S', [(300, 200, 16, 3), (64, 48, 7, 1), (129, 257, 33, 5)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_each_models_grams_in_a_sweep_are_its_own_bit_for_bit(n, F, m, S, dtype):
    V, W0, H0 = _problem(n, F, m, S, dtype=dtype)
    V2, W2, H2 = V.reshape(n, -1), W0.reshape(S, m, -1), H0.reshape(S, n, m)
    swept = torch.func.vmap(_grams, in_dims=(None, 0, 0))(V2, W2, H2)
    for s in range(S):
        for got, want in zip(swept, _grams(V2, W2[s], H2[s])):
            assert torch.equal(got[s], want)


@pytest.mark.parametrize('dims', [(0, 0), (None, 0), (0, None), (1, 2)])
def test_matmul_vmap_rule_forms_one_product_per_model(dims):
    rng = np.random.default_rng(1)
    S = 4
    a = torch.tensor(rng.random((S, 9, 5) if dims[0] is not None else (9, 5)))
    b = torch.tensor(rng.random((S, 5, 6) if dims[1] is not None else (5, 6)))
    if dims == (1, 2):  # the model axis elsewhere than first
        a, b = a.movedim(0, 1), b.movedim(0, 2)
    got = torch.func.vmap(ops.matmul, in_dims=dims)(a, b)
    for s in range(S):
        x = a if dims[0] is None else a.select(dims[0], s)
        y = b if dims[1] is None else b.select(dims[1], s)
        assert torch.equal(got[s], torch.matmul(x, y))


def test_matmul_outside_vmap_is_torch_matmul():
    rng = np.random.default_rng(2)
    a, b = (torch.tensor(rng.random(s), dtype=torch.float32) for s in ((7, 3), (3, 4)))
    assert torch.equal(ops.matmul(a, b), torch.matmul(a, b))
    assert tuple(ops.matmul_op(a, b).shape) == (7, 4)


def test_dot_takes_the_operator_on_the_card(monkeypatch):
    """On CUDA tensors (fake ones here) and on CPU tensors alike ``_dot``
    goes through :func:`~tnmf_tpu_torch.kernels.ops.matmul`."""
    calls = []
    monkeypatch.setattr(ops, 'matmul', lambda a, b: calls.append(a.device.type)
                        or torch.matmul(a, b))
    engine_hals._dot(torch.ones(3, 2), torch.ones(2, 4))
    with FakeTensorMode():
        out = engine_hals._dot(torch.empty(3, 2, device='cuda'), torch.empty(2, 4, device='cuda'))
    assert calls == ['cpu', 'cuda'] and tuple(out.shape) == (3, 4)


@pytest.mark.parametrize('n_iterations,inner', [(3, 'auto'), (2, 3)])
def test_hals_sweep_models_equal_their_single_fits_bit_for_bit(n_iterations, inner):
    V, W0, H0 = _problem(300, 200, 16, 3)
    sp = np.array([0.0, 0.1, 0.2], np.float32)
    res = sweep._sweep_from_init_hals(V, W0, H0, n_iterations=n_iterations, device='cpu',
                                      sparsity=sp, l2=0.1, hals_inner=inner)
    k = engine_hals.auto_inner(16, 200, inner, n_samples=300)
    for s in range(3):
        W, H = engine_hals.fit_loop(V, W0[s], H0[s], n_iterations, float(sp[s]), 0.1, 0., 0.,
                                    inner=k, update_H=True, update_W=True)
        assert torch.equal(res.W[s], W) and torch.equal(res.H[s], H)
        # the energy's product is the model's own; its sum runs batched
        E = engine_hals._energy(*engine_hals._flatten(V, W, H))
        assert abs(float(res.energies[s]) - float(E)) <= 1e-6 * abs(float(E))


def test_cpu_float32_products_round_once_from_float64():
    """C3: a float32 product on the CPU is the float64 product rounded
    once, whatever the BLAS's float32 order."""
    rng = np.random.default_rng(4)
    a, b = (torch.tensor(rng.random(s), dtype=torch.float32) for s in ((33, 129), (129, 17)))
    got = hals.dot(a, b)
    assert got.dtype == torch.float32
    assert torch.equal(got, (a.double() @ b.double()).float())
    assert torch.equal(hals.dot(a, b[:, 0]), (a.double() @ b[:, 0].double()).float())


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('side', ['H', 'W'])
def test_plain_sweep_under_vmap_is_each_models_own_bit_for_bit(dtype, side):
    """C3: the plain sweep under a sweep's vmap (``use_pallas=False``) is
    each model's own sweep, bit for bit, on the H side's row-major operands
    and on the W side's transposed views."""
    S, rows, m = 4, 37, 6
    rng = np.random.default_rng(5)
    X, P = (torch.tensor(rng.random((S, rows, m)), dtype=dtype) for _ in range(2))
    B = torch.tensor(rng.random((S, m, m)), dtype=dtype)
    G = B @ B.transpose(1, 2) + 0.1 * torch.eye(m, dtype=dtype)
    l1 = torch.tensor([0.0, 0.01, 0.05, 0.1], dtype=dtype)
    if side == 'W':  # W^T (F, m) of a contiguous (m, F) W, as _sweep_W passes it
        X, P = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (X, P))
        G = G.transpose(1, 2)
    swept = torch.func.vmap(lambda x, g, p, l: hals.hals_sweep_plain(x, g, p, l, 0.1, 2))(
        X, G, P, l1)
    for s in range(S):
        assert torch.equal(swept[s], hals.hals_sweep_plain(X[s], G[s], P[s], l1[s], 0.1, 2))
