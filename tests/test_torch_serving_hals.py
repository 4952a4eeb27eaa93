"""The port's HALS serving artifacts (``export_serving(solver='hals')``).

Against the JAX package in float64 on the CPU (rtol 1e-8): the plain-NMF
geometry (the Gram of the frozen dictionary baked in, one Gauss–Seidel pass
per iteration) and the shift-invariant ``'full'`` geometry (one exact
phase-blocked sweep per iteration).  Against the port's own
``transform(solver='hals')``: exact in float32 at batch sizes 1, 3 and 5
from one artifact, and below the MU artifact's residual.  The CUDA
programs, traced under a ``FakeTensorMode``, call K5 ``tnmf::hals_sweep``
in their loop (once, and once per phase) and no plain version.
On the CPU the HALS products of a float32 fit accumulate in float64
and round once (``kernels.hals.dot``, C3), so the CPU's float32 program
is not the card's arithmetic (float32 cuBLAS); ``chip_smoke.py`` checks
the card's.
"""

import numpy as np
import pytest

import tnmf_tpu_torch
from tnmf_tpu_torch import load_serving

from .fake_cuda import cuda_programs, kernel_ops, loops
from .test_torch_serving import CPU, TOL, jax_and_port, recipe_of

#: (constructor keywords, sample shape, atom shape, export keywords)
HALS_CASES = {
    'plain': (dict(reconstruction_mode='full'), (24,), (24,), dict(sparsity_H=0.05)),
    'full': (dict(reconstruction_mode='full'), (14,), (3,), dict(sparsity_H=0.02, l2_H=0.1)),
}


@pytest.mark.parametrize('case', sorted(HALS_CASES))
def test_hals_artifact_matches_jax(case):
    jax_served, served, V = jax_and_port(*HALS_CASES[case], solver='hals')
    assert served.header['solver'] == jax_served.header['solver'] == 'hals'
    np.testing.assert_allclose(served.transform(V), np.asarray(jax_served.transform(V)), **TOL)


def _low_rank(rng, n, F, rank=3):
    return (rng.random((n, rank)) @ rng.random((rank, F))).reshape(n, 1, F).astype(np.float32)


@pytest.mark.parametrize('case', sorted(HALS_CASES))
def test_hals_artifact_matches_transform(case):
    """One artifact at batch sizes 1, 3 and 5, bit-equal to ``transform``;
    exact sweeps reach a lower residual than the MU artifact."""
    kw, S, A, export = HALS_CASES[case]
    rng = np.random.default_rng(1)
    m = tnmf_tpu_torch.TransformInvariantNMF(3, A, seed=0, h_init='correlate', **kw, **CPU)
    m.fit(_low_rank(rng, 6, S[0]), n_iterations=10, solver='hals')
    served = load_serving(m.export_serving(n_iterations=6, solver='hals', **export))
    inner = dict(hals_inner=1) if S == A else {}
    for n in (1, 3, 5):
        V = _low_rank(rng, n, S[0])
        np.testing.assert_array_equal(
            served(V), m.transform(V, n_iterations=6, solver='hals', **inner, **export))
    mu = load_serving(m.export_serving(n_iterations=6, **export))

    def residual(H):
        return float(np.sum((V.astype(np.float64) - m.inverse_transform(H)) ** 2))
    assert residual(served(V)) < residual(mu(V))


@pytest.mark.parametrize('case', sorted(HALS_CASES))
def test_hals_cuda_program_calls_k5(case):
    kw, S, A, export = HALS_CASES[case]
    encoder = cuda_programs(recipe_of(kw, S, A, export, solver='hals'))['transform']
    n_phases = 1 if S == A else A[0]
    assert kernel_ops(encoder) == ['hals_sweep'] * n_phases and loops(encoder) == 1
