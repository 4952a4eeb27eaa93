"""K5 ``hals_sweep`` in the order its kernel sums, its launch geometry and
the operands it launches on, without a card.

``hals_sweep_panels_plain`` (panel products, then a running correlation
inside each panel, as ``csrc/hals_sweep.cu`` sums) is held in float64 to
the plain version and to the JAX package's ``_sweep_H`` run ``inner``
times, within 1e-12 of the plain version's largest magnitude, elementwise
(a column clamped at 0 in one and a hair above 0 in the other must not
fail a purely relative test).  ``launch_geometry`` is checked over a grid
of shapes with 132 multiprocessors, and the operands the wrapper passes to
the C entry are the tensors' own addresses and strides, transposed views
included (no copy).
"""

import contextlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnmf_tpu import engine_hals as jeh
from tnmf_tpu_torch.kernels import _build, hals
from tnmf_tpu_torch.kernels.hals import hals_sweep_panels_plain, hals_sweep_plain

F64 = torch.float64
#: elementwise, relative to the plain version's largest magnitude
TOL = 1e-12
INT_MAX = 2**31 - 1


def _problem(m: int, gram: str = 'symmetric', rows: int = 23, seed: int = 0) -> tuple:
    """``X``, ``G``, ``P`` as an H sweep meets them (``G = W W^T``, ``P = V
    W^T`` of data near the span of ``W``), with a dead component (row 0 of
    ``W`` zero, so ``G[0, 0] = 0``); ``'general'`` adds an asymmetric part
    to ``G``, which the sweep's algebra must not assume away."""
    rng = np.random.default_rng(seed + m)
    F = 3 * m + 7
    W = rng.random((m, F))
    if m > 1:
        W[0] = 0.0
    V = rng.random((rows, m)) @ W + 0.01 * rng.random((rows, F))
    G, P = W @ W.T, V @ W.T
    if gram == 'general':
        G = G + 0.05 * rng.random((m, m)) * np.sqrt(np.outer(np.diag(G), np.diag(G)))
    return rng.random((rows, m)), G, P


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _close(got: np.ndarray, want: np.ndarray) -> None:
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize('m', [1, 16, 37, 64])
@pytest.mark.parametrize('inner', [1, 3])
@pytest.mark.parametrize('regs', [(0.0, 0.0), (0.03, 0.1)], ids=['plain', 'l1_l2'])
def test_panels_plain_matches_the_jax_sweep(m, inner, regs):
    """K5's order (32-column panels: one partial panel at m = 1 and 16, a
    ragged last one at 37, two whole ones at 64) is the JAX ``_sweep_H``
    applied ``inner`` times and the plain version, dead component and
    ``l1``/``l2`` included."""
    X, G, P = _problem(m)
    l1, l2 = regs
    Xj = jnp.asarray(X)
    for _ in range(inner):
        Xj = jeh._sweep_H(Xj, jnp.asarray(G), jnp.asarray(P), jnp.float64(l1), jnp.float64(l2))
    want = hals_sweep_plain(_t(X), _t(G), _t(P), l1, l2, inner).numpy()
    got = hals_sweep_panels_plain(_t(X), _t(G), _t(P), l1, l2, inner).numpy()
    _close(want, np.asarray(Xj))
    _close(got, want)
    _close(got, np.asarray(Xj))
    if m > 1 and regs == (0.0, 0.0):  # the dead component was skipped: kept as it was
        np.testing.assert_array_equal(got[:, 0], X[:, 0])


@pytest.mark.parametrize('m', [1, 16, 37, 64])
@pytest.mark.parametrize('panel', [5, 16, 32])
@pytest.mark.parametrize('gram', ['symmetric', 'general'])
def test_panels_plain_matches_plain_for_any_panel(m, panel, gram):
    """Panels that divide ``m`` and panels that do not give the plain
    version's sweep, three passes with ``l1``/``l2``, on a symmetric Gram
    and on a general one, and on the W side's transposed views."""
    X, G, P = _problem(m, gram, seed=1)
    want = hals_sweep_plain(_t(X), _t(G), _t(P), 0.02, 0.05, 3)
    got = hals_sweep_panels_plain(_t(X), _t(G), _t(P), 0.02, 0.05, 3, panel=panel)
    _close(got.numpy(), want.numpy())
    Xt, Gt, Pt = (_t(np.ascontiguousarray(a.T)).T for a in (X, G, P))
    got_t = hals_sweep_panels_plain(Xt, Gt, Pt, 0.02, 0.05, 3, panel=panel)
    _close(got_t.numpy(), want.numpy())


ROWS = [1, 1000, 4096, 16384, 50176, 10**6]
MS = [1, 16, 37, 256, 1024, 4096]
#: the main paths' shapes: the H and W sides of plain NMF at 16384 x 4096
#: with 256 atoms, a phase of shift-invariant HALS at the flagship
MAIN = {(16384, 256), (4096, 256), (50176, 16)}


@pytest.mark.parametrize('rows', ROWS)
@pytest.mark.parametrize('m', MS)
def test_launch_geometry_fits_every_shape(rows, m, monkeypatch):
    """Every shape has a geometry: its shared memory within a Hopper
    block's opt-in limit, its blocks within a grid's x axis, the tile in
    shared memory wherever one fits (the largest that still gives each of
    132 multiprocessors a block), streamed elsewhere; the main paths'
    shapes fill the card with at least 128 blocks."""
    monkeypatch.setattr(hals, '_multiprocessors', lambda device: 132)
    geo = hals.launch_geometry(rows, m, torch.device('cuda'))
    rt = geo['rows_per_block']
    assert rt in (16, 32, 64) and geo['panel'] == 32 and geo['threads'] == 128
    assert geo['smem_bytes'] == hals.smem_bytes(rt, m, geo['resident'])
    assert geo['smem_bytes'] <= _build.MAX_SMEM_BYTES
    assert geo['blocks'] == math.ceil(rows / rt) <= INT_MAX
    fits = [t for t in (64, 32, 16) if hals.smem_bytes(t, m, True) <= _build.MAX_SMEM_BYTES]
    assert geo['resident'] == bool(fits)
    if geo['resident']:
        filling = [t for t in fits if math.ceil(rows / t) >= 132]
        assert rt == (filling[0] if filling else fits[-1])
    if (rows, m) in MAIN:
        assert geo['resident'] and geo['blocks'] >= 128


def test_launch_geometry_at_the_main_paths(monkeypatch):
    """The H side tiles 64 rows (256 blocks of 88 KiB, two a
    multiprocessor), the W side 16 (256 blocks), the phase rows 64; 4096
    components stream."""
    monkeypatch.setattr(hals, '_multiprocessors', lambda device: 132)
    dev = torch.device('cuda')
    got = {shape: hals.launch_geometry(*shape, dev) for shape in
           [(16384, 256), (4096, 256), (50176, 16), (2048, 4096)]}
    assert {k: (g['rows_per_block'], g['blocks'], g['resident']) for k, g in got.items()} == {
        (16384, 256): (64, 256, True), (4096, 256): (16, 256, True),
        (50176, 16): (64, 784, True), (2048, 4096): (16, 128, False)}
    assert 2 * got[(16384, 256)]['smem_bytes'] <= 228 * 1024


def test_launch_operands_are_the_tensors_own():
    """The C entry reads each operand at its own address with its own
    strides: the H side's row-major H, the W side's transposed views of
    ``W``, ``A``, ``B`` (whose output ``empty_like(W^T)`` is a transposed
    view of a contiguous ``(m, F)`` tensor) and a row slice; no copy."""
    m, F, n = 5, 12, 9
    H, W = torch.rand(n, m), torch.rand(m, F)
    A, B = torch.rand(m, m), torch.rand(m, F)
    G, P = torch.rand(m, m), torch.rand(n, m)
    out = torch.empty_like(H)
    assert hals.launch_operands(H, G, P, out) == (
        H.data_ptr(), m, 1, G.data_ptr(), m, 1, P.data_ptr(), m, 1, out.data_ptr(), m, 1)
    Wt, At, Bt = W.T, A.T, B.T
    out = torch.empty_like(Wt)
    assert out.stride() == (1, F) and out.T.is_contiguous()
    assert hals.launch_operands(Wt, At, Bt, out) == (
        W.data_ptr(), 1, F, A.data_ptr(), 1, m, B.data_ptr(), 1, F, out.data_ptr(), 1, F)
    rows = H[3:]
    ops = hals.launch_operands(rows, G, P[3:], torch.empty_like(rows))
    assert ops[:3] == (H.data_ptr() + 3 * m * 4, m, 1)


@pytest.mark.parametrize('side', ['H', 'W'])
def test_wrapper_launches_strided_operands_without_a_copy(side, monkeypatch):
    """On a tensor off the CPU the wrapper calls the C entry with
    ``launch_operands`` of its inputs and an output in X's layout, and
    copies nothing (``contiguous`` and ``clone`` refuse while it runs): meta
    tensors stand in for CUDA ones, and a recording library for the
    kernel."""
    m, rows = 6, 40
    calls = []

    class Lib:
        def tnmf_hals_sweep(self, *args):
            calls.append(args)
            return 0
    monkeypatch.setattr(hals, '_multiprocessors', lambda device: 132)
    monkeypatch.setattr(_build, 'library', lambda: Lib())
    monkeypatch.setattr(_build, 'check_inputs', lambda *a, **k: None)
    monkeypatch.setattr(_build, 'stream_of', lambda t: 0)
    monkeypatch.setattr(torch.cuda, 'device', lambda d: contextlib.nullcontext())

    def refuse(*a, **k):
        raise AssertionError('the wrapper copied an operand')
    meta = dict(device='meta')
    if side == 'H':
        X, G, P = torch.empty(rows, m, **meta), torch.empty(m, m, **meta), torch.empty(rows, m,
                                                                                     **meta)
    else:
        X, G, P = (torch.empty(m, rows, **meta).T, torch.empty(m, m, **meta).T,
                   torch.empty(m, rows, **meta).T)
    launches = hals.hals_sweep.launches
    with monkeypatch.context() as mp:
        mp.setattr(torch.Tensor, 'contiguous', refuse)
        mp.setattr(torch.Tensor, 'clone', refuse)
        out = hals.hals_sweep(X, G, P, 0.1, 0.0, 2)
    assert out.shape == X.shape and out.stride() == X.stride()
    (args,) = calls
    assert args[:12] == hals.launch_operands(X, G, P, out)
    geo = hals.launch_geometry(rows, m, X.device)
    assert args[12:] == (0.1, 0.0, 2, rows, m, geo['rows_per_block'], int(geo['resident']),
                         geo['smem_bytes'], 0)
    assert hals.hals_sweep.launches == launches + 1
    hals.hals_sweep.launches = launches
