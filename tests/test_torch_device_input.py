"""Data given as torch tensors (fault F5 of ROADMAP.md, fixed): ``fit``,
``transform``, ``set_dictionary`` and ``inverse_transform`` take a tensor
without a NumPy copy of the data and give the bits of the same call on the
NumPy array, on the CPU, in float32 and float64, on the conv and fft
strategies.  The card's counterpart is a phase of chip_smoke.py."""

import contextlib

import numpy as np
import pytest
import torch

import tnmf_tpu_torch

from .fixtures import image_2d as _image_2d

_GUARDED = ('numpy', 'cpu', 'tolist', '__array__')


@contextlib.contextmanager
def no_host_copy(*tensors, counted=()):
    """Inside the block ``numpy()``, ``cpu()``, ``tolist()`` and
    ``__array__`` of any tensor that shares memory with ``tensors`` raise:
    the model may keep, view and compute on them, never copy them out.
    Those calls on a tensor that shares memory with ``counted`` go through
    and are recorded in the list the block receives."""
    ptrs = {t.untyped_storage().data_ptr() for t in tensors}
    counted_ptrs = {t.untyped_storage().data_ptr() for t in counted}
    copies = []
    saved = {name: getattr(torch.Tensor, name) for name in _GUARDED}

    def guard(name, fn):
        def call(self, *args, **kwargs):
            ptr = self.untyped_storage().data_ptr()
            if ptr in ptrs:
                raise AssertionError(f'{name}() of the input data')
            if ptr in counted_ptrs:
                copies.append(name)
            return fn(self, *args, **kwargs)
        return call
    for name, fn in saved.items():
        setattr(torch.Tensor, name, guard(name, fn))
    try:
        yield copies
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def test_the_guard_catches_host_copies():
    V = torch.rand(2, 3)
    with no_host_copy(V):
        for copy in (V.numpy, V.cpu, V.tolist, lambda: np.asarray(V),
                     lambda: V.detach().numpy(), lambda: V[0].cpu()):
            with pytest.raises(AssertionError, match='input data'):
                copy()
        assert torch.rand(2).numpy().shape == (2,)
    assert V.numpy().shape == (2, 3)


def _model(dtype, **kw):
    return tnmf_tpu_torch.TransformInvariantNMF(4, (5, 5), seed=3, device='cpu', dtype=dtype,
                                                **kw)


def _V(np_dtype):
    return np.random.default_rng(0).random((3, 2, 18, 20)).astype(np_dtype)


def _assert_same(a, b):
    np.testing.assert_array_equal(a.W, b.W)
    np.testing.assert_array_equal(a.H, b.H)
    assert a._energy_function() == b._energy_function()


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize('backend', ['jax_conv', 'jax_fft'])
def test_fit_takes_tensors_with_the_arrays_bits(backend, dtype):
    V = _V(np.float32 if dtype == torch.float32 else np.float64)
    fit = dict(n_iterations=3, sparsity_H=0.1, inhibition_strength=0.1)
    want = _model(dtype, backend=backend)
    want.fit(V, **fit)
    Vt = torch.tensor(V)
    got = _model(dtype, backend=backend)
    with no_host_copy(Vt):
        got.fit(Vt, **fit)
    _assert_same(got, want)
    # kept where it is, not copied
    assert got._Vd.untyped_storage().data_ptr() == Vt.untyped_storage().data_ptr()
    assert isinstance(got.V, np.ndarray)
    np.testing.assert_array_equal(got.V, V)
    np.testing.assert_array_equal(got.R, want.R)


def test_transform_and_inverse_transform_take_tensors():
    V, fit = _V(np.float64), dict(n_iterations=3, sparsity_H=0.1)
    trained = _model(torch.float64)
    trained.fit(V, **fit)
    W = trained.W
    new = np.random.default_rng(1).random((5, 2, 18, 20))
    out = {}
    for kind in ('array', 'tensor'):
        m = _model(torch.float64, backend='jax_fft')
        data = new if kind == 'array' else torch.tensor(new)
        guard = contextlib.nullcontext if kind == 'array' else lambda: no_host_copy(data)
        with guard():
            H = m.set_dictionary(W).transform(data, n_iterations=4, batch_size=2,
                                              sparsity_H=0.1)
        Hq = H if kind == 'array' else torch.tensor(H)
        with guard():
            R = m.inverse_transform(Hq[-1:])
        out[kind] = (H, R, m)
    np.testing.assert_array_equal(out['tensor'][0], out['array'][0])
    np.testing.assert_array_equal(out['tensor'][1], out['array'][1])
    _assert_same(out['tensor'][2], out['array'][2])


def test_set_dictionary_reads_the_dictionary_alone_on_the_host():
    """``set_dictionary`` normalises on the host in NumPy, as the JAX
    package's does (``np.asarray``), so a tensor and an array give the same
    bits: it reads the dictionary (n_atoms x n_channels x atom entries) on
    the host once, through ``detach().cpu().numpy()`` (a copy from the
    card, a view on the CPU), and the data of the ``transform`` that
    follows never."""
    W = np.random.default_rng(2).random((4, 2, 5, 5))
    V = np.random.default_rng(3).random((3, 2, 18, 20))
    Wt, Vt = torch.tensor(W), torch.tensor(V)
    got = _model(torch.float64)
    with no_host_copy(Vt, counted=(Wt,)) as copies:
        got.set_dictionary(Wt)
        assert copies == ['cpu', 'numpy']
        H = got.transform(Vt, n_iterations=2)
    assert copies == ['cpu', 'numpy']
    want = _model(torch.float64).set_dictionary(W)
    np.testing.assert_array_equal(got.W, want.W)
    np.testing.assert_array_equal(H, want.transform(V, n_iterations=2))
    np.testing.assert_array_equal(got.W.sum(axis=(-2, -1)) > 0, True)
    with pytest.raises(ValueError, match='nonnegative'):
        _model(torch.float64).set_dictionary(-Wt)


def test_the_guard_counts_the_copies_it_lets_through():
    W, V = torch.rand(2, 3), torch.rand(3)
    with no_host_copy(V, counted=(W,)) as copies:
        W.numpy()
        W[0].tolist()
        torch.rand(2).numpy()
        with pytest.raises(AssertionError, match='input data'):
            V.cpu()
    assert copies == ['numpy', 'tolist']


def test_golden_fit_from_a_tensor():
    image = _image_2d()
    out = []
    for data in (image, torch.tensor(image)):
        np.random.seed(42)
        m = tnmf_tpu_torch.TransformInvariantNMF(10, (7, 7), device='cpu', dtype=torch.float64)
        m.fit(data, sparsity_H=0.1, n_iterations=2)
        out.append(m)
    _assert_same(*out)


def test_negative_or_nan_tensor_raises():
    V = torch.tensor(_V(np.float64))
    V[1, 0, 3, 4] = -1e-9
    with pytest.raises(ValueError, match='non-negative'):
        _model(torch.float64).fit(V, n_iterations=1)
    V[1, 0, 3, 4] = float('nan')
    with pytest.raises(ValueError, match='non-negative'):
        _model(torch.float64).fit(V, n_iterations=1)


def test_tensor_of_another_dtype_is_cast_on_the_device():
    """A float32 tensor fits a float64 model as the float32 array does: the
    H and W draws take V's dtype, the cast runs where the tensor lies."""
    V = _V(np.float32)
    want, got = _model(torch.float64), _model(torch.float64)
    want.fit(V, n_iterations=2)
    got.fit(torch.tensor(V), n_iterations=2)
    _assert_same(got, want)
    assert got._Vd.dtype == torch.float64 and got.V.dtype == np.float32
