"""The port's demo utilities (``tnmf_tpu_torch.utils.demo``) on the CPU:
the seven cases of ``tests/test_demo_utils.py`` (widget wiring,
ground-truth adoption, the SignalTool galleries, the fit cache), then
``fit_nmf_model`` against the JAX package's on the same data and
parameters, W and H in float64 within 1e-8 (as ``tests/test_torch_fit_driver.py``
holds fits), and the cache keyed on the device and the kernel switch."""

import matplotlib
matplotlib.use('Agg')

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tnmf_tpu import MiniBatchAlgorithm as JaxAlgorithm  # noqa: E402
from tnmf_tpu.utils import demo as jax_demo  # noqa: E402
from tnmf_tpu_torch import MiniBatchAlgorithm  # noqa: E402
from tnmf_tpu_torch.utils import demo  # noqa: E402
from tnmf_tpu_torch.utils.demo import (SignalTool, _FIT_CACHE, fit_nmf_model,  # noqa: E402
                                       st_define_nmf_params)

from .torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

TOL = dict(rtol=1e-8, atol=1e-10)


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    """The demos' fits on the CPU (their default device is the card)."""
    monkeypatch.setattr(demo, 'DEVICE', 'cpu')


def test_define_params_adopts_ground_truth():
    oracle = dict(n_atoms=7, atom_shape=(11, 9))
    nmf_params, fit_params = st_define_nmf_params(oracle, have_ground_truth=True,
                                                  verbose=True)
    assert nmf_params['n_atoms'] == 7
    assert nmf_params['atom_shape'] == (11, 9)
    assert nmf_params['reconstruction_mode'] == 'valid'
    assert 'n_iterations' in fit_params  # full-batch default


def test_define_params_without_ground_truth_uses_widgets():
    oracle = dict(n_atoms=4, atom_shape=(5,))
    nmf_params, _ = st_define_nmf_params(oracle, have_ground_truth=False, verbose=False)
    assert nmf_params['n_atoms'] == 4
    assert nmf_params['atom_shape'] == (5,)


def test_define_params_square_atoms_offer_rotations():
    nmf_params, _ = st_define_nmf_params(dict(n_atoms=3, atom_shape=(6, 6)), verbose=False)
    assert nmf_params['transform_type'] == 'shift'


def test_define_params_match_the_jax_package():
    for oracle, gt in ((dict(n_atoms=7, atom_shape=(11, 9)), True),
                       (dict(n_atoms=4, atom_shape=(5,)), False)):
        assert (st_define_nmf_params(oracle, have_ground_truth=gt, verbose=False)
                == jax_demo.st_define_nmf_params(oracle, have_ground_truth=gt, verbose=False))


@pytest.mark.parametrize('ndim', [1, 2])
def test_signal_tool_generate_and_galleries(ndim):
    tool = SignalTool(ndim)
    np.random.seed(0)
    V, oracle = tool.st_generate_input(verbose=True)
    if ndim == 1:
        assert V.shape == (3, 3, 60)
        assert oracle == dict(n_atoms=3, atom_shape=(20,))
    else:
        assert V.shape == (1, 3, 50, 50)
        assert oracle == dict(n_atoms=21, atom_shape=(10, 10))
    nmf_params, fit_params = st_define_nmf_params(oracle, verbose=False)
    fit_params['n_iterations'] = 3
    nmf = fit_nmf_model(V, nmf_params, fit_params)
    assert nmf.device == torch.device('cpu')
    R = nmf.R
    assert R.shape == V.shape and np.isfinite(R).all()
    tool.st_compare_signals(V, R, verbose=True)
    tool.st_compare_individual_signals(V, R, verbose=True)
    tool.st_plot_partial_reconstructions(V, nmf, verbose=True)


def test_signal_tool_rejects_unsupported_rank():
    with pytest.raises(ValueError, match='dimensions'):
        SignalTool(3)


def test_fit_cache_memoizes():
    np.random.seed(1)
    V = np.random.rand(2, 1, 30).astype(np.float32)
    params = (dict(n_atoms=2, atom_shape=(5,)), dict(n_iterations=2))
    n0 = len(_FIT_CACHE)
    m1 = fit_nmf_model(V, *params)
    m2 = fit_nmf_model(V, *params)
    assert m1 is m2 and len(_FIT_CACHE) == n0 + 1


def test_fit_cache_keys_the_kernel_switch_and_dtype():
    V = np.random.default_rng(2).random((2, 1, 30)).astype(np.float32)
    params = (dict(n_atoms=2, atom_shape=(5,)), dict(n_iterations=2))
    a = fit_nmf_model(V, *params)
    b = fit_nmf_model(V, *params, use_pallas=False)
    c = fit_nmf_model(V, *params, dtype=torch.float64)
    assert len({id(a), id(b), id(c)}) == 3
    assert c.dtype == torch.float64 and b._use_pallas is False


FITS = {
    '1-D inhibited': (np.random.default_rng(3).random((3, 2, 40)),
                      dict(n_atoms=3, atom_shape=(7,)),
                      dict(n_iterations=10, sparsity_H=0.1, inhibition_strength=0.1)),
    '2-D circular': (np.random.default_rng(4).random((2, 3, 16, 18)),
                     dict(n_atoms=4, atom_shape=(5, 5), reconstruction_mode='circular',
                          backend='auto', transform_type='shift'),
                     dict(n_iterations=8, sparsity_H=0.05, inhibition_strength=0.1,
                          cross_atom_inhibition_strength=0.05)),
    '1-D minibatch': (np.random.default_rng(5).random((6, 1, 40)),
                      dict(n_atoms=3, atom_shape=(5,)),
                      dict(algorithm='ASG_MU', batch_size=3, n_epochs=3, sag_lambda=0.2)),
}


@pytest.mark.parametrize('case', sorted(FITS))
def test_fit_nmf_model_matches_jax(case):
    V, nmf_params, fit_params = FITS[case]

    def params(enum):
        return ({**fit_params, 'algorithm': enum[fit_params['algorithm']]}
                if 'algorithm' in fit_params else dict(fit_params))
    jm = jax_demo.fit_nmf_model(V, dict(nmf_params), params(JaxAlgorithm), seed=11)
    pm = fit_nmf_model(V, dict(nmf_params), params(MiniBatchAlgorithm), seed=11,
                       dtype=torch.float64)
    np.testing.assert_allclose(pm.W, np.asarray(jm.W), **TOL)
    np.testing.assert_allclose(pm.H, np.asarray(jm.H), **TOL)
    np.testing.assert_allclose(pm._energy_function(), jm._energy_function(), **TOL)
