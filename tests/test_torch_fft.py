"""The PyTorch port's FFT operators (tnmf_tpu_torch.ops.fft) against the JAX
package's (tnmf_tpu.ops.fft) and the NumPy oracle (tnmf_tpu.ops.oracle), in
float64 on the CPU: every function, the four reconstruction modes, shift
ranks 1-4 and both FFT length policies (the torch counterpart of
test_ops_parity.py for the fft strategy)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnmf_tpu.ops import fft as jfft
from tnmf_tpu.ops import oracle
from tnmf_tpu.ops import modes as jmodes
from tnmf_tpu.ops.modes import ConvPlan as JConvPlan

from tnmf_tpu_torch.ops import fft, modes
from tnmf_tpu_torch.ops.modes import ConvPlan

CASES = [
    (1, (13,), (4,)),
    (2, (9, 11), (3, 4)),
    (2, (8, 8), (8, 8)),       # atom as large as the sample
    (3, (7, 6, 8), (2, 3, 2)),
    (4, (5, 6, 4, 7), (2, 2, 3, 2)),   # rank > 3: fft strategy only
]
MODES = ['valid', 'full', 'circular', 'reflect']
POLICIES = ['5-smooth', 'pow2']
RTOL = 1e-10
F64 = torch.float64


def _t(x):
    return torch.tensor(np.array(x), dtype=F64)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _problem(case, mode, policy):
    ndim, S, A = case
    if mode in ('full', 'reflect') and any(s < a for s, a in zip(S, A)):
        pytest.skip('the atom does not fit the sample in this mode')
    rng = np.random.default_rng(ndim * 100 + len(mode) + len(policy))
    plan = ConvPlan.create(mode, S, A, policy)
    jplan = JConvPlan.create(mode, S, A, policy)
    assert plan.fft_shape == jplan.fft_shape
    N, C, M = 2, 3, 4
    return (plan, jplan, rng.random((N, C) + S), rng.random((M, C) + A),
            rng.random((N, M) + plan.transform_shape))


@pytest.mark.parametrize('policy', POLICIES)
@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('case', CASES, ids=lambda c: f'{c[0]}d-{c[1]}x{c[2]}')
def test_operators_match_jax_and_oracle(case, mode, policy):
    plan, jplan, V, W, H = _problem(case, mode, policy)
    # transforms, extension, the prepared data
    Vx, jVx = fft.extend_data(_t(V), plan), jfft.extend_data(V, jplan)
    assert _rel(Vx, jVx) == 0.
    Vf, jVf = fft.prepare_data(_t(V), plan), jfft.prepare_data(V, jplan)
    assert Vf.dtype == torch.complex128
    assert _rel(Vf, jVf) <= RTOL
    zero = (0,) * plan.ndim
    assert _rel(fft._inverse(fft._freq_major(Vf), zero, plan.fft_shape, plan),
                jfft._irfftn(jVf, jplan)) <= RTOL
    # the reconstruction
    R, jR = fft.reconstruct(_t(W), _t(H), plan), jfft.reconstruct(W, H, jplan)
    assert R.dtype == F64
    assert _rel(R, jR) <= RTOL
    assert _rel(R, oracle.reconstruct(W, H, mode)) <= RTOL
    R = np.asarray(jR)
    # single-stream correlations
    assert _rel(fft.corr_H(Vf, _t(W), plan), jfft.corr_H(jVf, W, jplan)) <= RTOL
    assert _rel(fft.corr_W(Vf, _t(H), plan), jfft.corr_W(jVf, H, jplan)) <= RTOL
    # the gradient pairs, against JAX and against the oracle
    pairs = [
        (fft.grad_H_pair(Vf, _t(R), _t(W), plan), jfft.grad_H_pair(jVf, R, W, jplan),
         oracle.reconstruction_gradient_H(V, W, H, mode)),
        (fft.grad_W_pair(Vf, _t(R), _t(H), plan), jfft.grad_W_pair(jVf, R, H, jplan),
         oracle.reconstruction_gradient_W(V, W, H, mode)),
    ]
    for got, want, spec in pairs:
        for g, w, o in zip(got, want, spec):
            assert _rel(g, w) <= RTOL
            assert _rel(g, o) <= RTOL
    # the prepared pairs (two transformed streams)
    Rf, jRf = fft.prepare_data(_t(R), plan), jfft.prepare_data(R, jplan)
    for got, want in [
            (fft.grad_H_pair_prepared(Vf, Rf, _t(W), plan),
             jfft.grad_H_pair_prepared(jVf, jRf, W, jplan)),
            (fft.grad_W_pair_prepared(Vf, Rf, _t(H), plan),
             jfft.grad_W_pair_prepared(jVf, jRf, H, jplan))]:
        for g, w in zip(got, want):
            assert _rel(g, w) <= RTOL


@pytest.mark.parametrize('length', [7, 8, 30, 31])
def test_inverse_matches_jax_irfftn_odd_and_even(length):
    """The inverse transform over the leading axes of a frequency-major
    spectrum, cropped, gives ``jnp.fft.irfftn(..., s=)``'s result for odd
    and even last-axis lengths, from a half spectrum of any content."""
    rng = np.random.default_rng(length)
    plan = ConvPlan.create('circular', (6, length), (2, 2))
    assert plan.fft_shape == (6, length)
    X = rng.random((2, 3, 6, length // 2 + 1)) + 1j * rng.random((2, 3, 6, length // 2 + 1))
    want = np.asarray(jnp.fft.irfftn(X, s=plan.fft_shape, axes=plan.shift_axes))
    got = fft._inverse(fft._freq_major(torch.tensor(X)), (0, 0), plan.fft_shape, plan)
    assert _rel(got, want) <= 1e-14
    got = fft._inverse(fft._freq_major(torch.tensor(X)), (1, 2), (4, length - 3), plan)
    assert _rel(got, want[..., 1:5, 2:length - 1]) <= 1e-14


@pytest.mark.parametrize('policy', POLICIES)
def test_fft_lengths_match_jax(policy):
    for n in range(1, 400):
        assert modes.fast_fft_len(n, policy) == jmodes.fast_fft_len(n, policy)
    for mode in MODES:
        for S, A in [((256, 256), (9, 9)), ((128, 128), (31, 31)), ((16000,), (64,)),
                     ((4096,), (4096,)), ((5, 6, 4, 7), (2, 2, 3, 2))]:
            if mode in ('full', 'reflect') and any(s < a for s, a in zip(S, A)):
                continue
            assert (modes.fft_lengths(mode, S, A, policy)
                    == jmodes.fft_lengths(mode, S, A, policy))
    with pytest.raises(ValueError, match='policy'):
        modes.fast_fft_len(10, 'pow3')


def test_float32_spectra_are_complex64():
    plan = ConvPlan.create('valid', (12, 10), (3, 3))
    H = torch.rand((2, 4) + plan.transform_shape)
    assert fft._rfftn(H, plan).dtype == torch.complex64
    assert fft.reconstruct(torch.rand(4, 1, 3, 3), H, plan).dtype == torch.float32
