"""Host-to-device prefetch of the PyTorch port
(``tnmf_tpu_torch.utils.pipeline``), on the CPU: the cases of
``tests/test_pipeline.py`` (order and values, the dtype cast, the source's
exception, the buffer check), the sharded layout and the default device
refused rather than replaced by the CPU, and a ``partial_fit`` stream fed
from the prefetcher against the host feed (bit for bit) and against the
JAX package's stream (float64, 1e-8).  The CUDA stream path is checked on
the card by ``chip_smoke.py`` phase 21."""

import numpy as np
import pytest
import torch

import tnmf_tpu
import tnmf_tpu_torch
from tnmf_tpu_torch.utils.pipeline import prefetch_to_device

CPU = dict(device='cpu')


def _batches(k=5, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.random((2, 1, 8, 8)).astype(dtype) for _ in range(k)]


def test_order_values_and_placement():
    src = _batches()
    out = list(prefetch_to_device(iter(src), buffer_size=3, **CPU))
    assert len(out) == len(src)
    for got, want in zip(out, src):
        assert isinstance(got, torch.Tensor) and got.device.type == 'cpu'
        np.testing.assert_array_equal(got.numpy(), want)
        assert not np.shares_memory(got.numpy(), want)  # staged, not aliased


def test_dtype_cast():
    out = list(prefetch_to_device(iter(_batches(1)), dtype='bfloat16', **CPU))
    assert out[0].dtype == torch.bfloat16
    out = list(prefetch_to_device(iter(_batches(1)), dtype=np.float64, **CPU))
    assert out[0].dtype == torch.float64


def test_exception_propagates():
    def bad():
        yield _batches(1)[0]
        raise RuntimeError('source broke')

    it = prefetch_to_device(bad(), **CPU)
    next(it)
    with pytest.raises(RuntimeError, match='source broke'):
        next(it)


def test_buffer_size_validated():
    with pytest.raises(ValueError, match='buffer_size'):
        list(prefetch_to_device(iter([]), buffer_size=0, **CPU))


def test_sharding_and_the_default_device():
    with pytest.raises(NotImplementedError, match=r'item 14e\b'):
        list(prefetch_to_device(iter(_batches(1)), sharding=object(), **CPU))
    if not torch.cuda.is_available():  # the card by default, never the CPU in its place
        with pytest.raises((RuntimeError, AssertionError)):
            next(prefetch_to_device(iter(_batches(1))))


def _run(module, feed, **kw):
    m = module.TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3), seed=2, **kw)
    for b in feed:
        m.partial_fit(b, sparsity_H=0.1)
    return m


def test_partial_fit_from_prefetched_stream_matches_host_and_jax():
    src = _batches(4, seed=7, dtype=np.float64)
    kw = dict(dtype=torch.float64, **CPU)
    host = _run(tnmf_tpu_torch, iter(src), **kw)
    dev = _run(tnmf_tpu_torch, prefetch_to_device(iter(src), **CPU), **kw)
    assert torch.equal(dev._W, host._W) and torch.equal(dev._H, host._H)
    assert isinstance(dev._V, torch.Tensor)
    np.testing.assert_array_equal(dev.V, src[-1])
    jax = _run(tnmf_tpu, iter(src))
    np.testing.assert_allclose(dev.W, np.asarray(jax.W), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(dev.H, np.asarray(jax.H), rtol=1e-8, atol=1e-12)
