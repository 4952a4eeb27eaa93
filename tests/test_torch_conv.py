"""The PyTorch port's direct-convolution operators against the JAX package's
(tnmf_tpu.ops.conv), in float64 on the CPU, for every reconstruction mode
and shift rank 1-3 (the torch counterpart of test_ops_parity.py)."""

import numpy as np
import pytest
import torch

from tnmf_tpu.ops import conv as jconv
from tnmf_tpu.ops.modes import ConvPlan as JConvPlan

from tnmf_tpu_torch.ops import conv
from tnmf_tpu_torch.ops.modes import ConvPlan

CASES = [
    (1, (13,), (4,)),
    (2, (9, 11), (3, 4)),
    (2, (8, 8), (8, 8)),       # atom as large as the sample
    (3, (7, 6, 8), (2, 3, 2)),
]
MODES = ['valid', 'full', 'circular', 'reflect']
OPS = ['reconstruct', 'grad_H_pair', 'grad_W_pair']
F64 = torch.float64


def _t(x):
    return torch.tensor(np.array(x), dtype=F64)


@pytest.mark.parametrize('op', OPS)
@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('case', CASES, ids=lambda c: f'{c[0]}d-{c[1]}x{c[2]}')
def test_operator_matches_jax(op, mode, case):
    _, S, A = case
    if mode == 'full' and any(s < a for s, a in zip(S, A)):
        pytest.skip('atom does not fit sample in full mode')
    rng = np.random.default_rng(7 * len(S) + len(mode))
    N, C, M = 2, 3, 4
    jplan = JConvPlan.create(mode, S, A)
    plan = ConvPlan.create(mode, S, A)
    assert plan.transform_shape == jplan.transform_shape
    V = rng.random((N, C) + S)
    W = rng.random((M, C) + A)
    H = rng.random((N, M) + plan.transform_shape)

    R_ref = np.asarray(jconv.reconstruct(W, H, jplan))
    if op == 'reconstruct':
        got, want = [conv.reconstruct(_t(W), _t(H), plan)], [R_ref]
    else:
        Vp_ref = jconv.prepare_data(V, jplan)
        Vp = conv.prepare_data(_t(V), plan)
        np.testing.assert_allclose(Vp.numpy(), np.asarray(Vp_ref), rtol=1e-12)
        other = (W, H)[op == 'grad_W_pair']
        want = getattr(jconv, op)(Vp_ref, R_ref, other, jplan)
        got = getattr(conv, op)(Vp, _t(R_ref), _t(other), plan)
    for g, w in zip(got, want):
        assert g.dtype == F64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize('mode', ['wrap', 'reflect'])
@pytest.mark.parametrize('size,left,right', [(5, 0, 4), (5, 4, 0), (3, 7, 9), (1, 2, 3)])
def test_pad_index_matches_numpy(mode, size, left, right):
    """Wrap/reflect extension by index gather matches numpy.pad for pads up
    to and beyond the axis length (where torch's own F.pad refuses)."""
    x = np.arange(size, dtype=np.float64)[None, None]
    want = np.pad(x, [(0, 0), (0, 0), (left, right)], mode=mode)
    got = conv._pad_spatial(_t(x), (left,), (right,), mode)
    np.testing.assert_array_equal(got.numpy(), want)
