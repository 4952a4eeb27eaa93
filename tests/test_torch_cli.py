"""The PyTorch port's command line (``tnmf_tpu_torch.cli``), on the CPU:
``export`` of a checkpoint the JAX package wrote, the case of
``tests/test_serving_export.py::test_cli_export``, serving H within 1e-8 of
the JAX model's ``transform`` in float64; the export's error path; ``demo``,
``example`` and ``bench`` refused with the items they wait for.  The
command exports the card's program; here ``main`` runs in-process with the
checkpoint's load pointed at the CPU (``chip_smoke.py`` phase 21 runs the
command as a subprocess on the card)."""

import subprocess

import numpy as np
import pytest

import tnmf_tpu
from tnmf_tpu_torch import TransformInvariantNMF, load_serving
from tnmf_tpu_torch.cli import main


def _data(n=4, seed=0):
    return np.random.default_rng(seed).random((n, 1, 12, 10))


@pytest.fixture
def load_on_cpu(monkeypatch):
    """``TransformInvariantNMF.load`` with ``device='cpu'``."""
    load = TransformInvariantNMF.load
    monkeypatch.setattr(TransformInvariantNMF, 'load',
                        lambda path, **kw: load(path, **dict(kw, device='cpu')))


def test_cli_export_serves_the_jax_models_transform(tmp_path, capsys, load_on_cpu):
    m = tnmf_tpu.TransformInvariantNMF(n_atoms=3, atom_shape=(3, 3), seed=0,
                                       h_init='correlate', dtype='float64')
    m.fit(_data(), n_iterations=5)
    ckpt = str(tmp_path / 'model.npz')
    m.save(ckpt, include_H=True)
    out = str(tmp_path / 'enc.tnmfsrv')
    rc = main(['export', ckpt, out, '--iterations', '3', '--sparsity', '0.1', '--decoder'])
    printed = capsys.readouterr()
    assert rc == 0, printed.err
    assert printed.out.strip() == f'wrote {out}'
    served = load_serving(out)
    assert served.header['n_iterations'] == 3
    V = _data(n=2, seed=29)
    H = served(V)
    assert H.dtype == np.float64
    np.testing.assert_allclose(H, np.asarray(m.transform(V, n_iterations=3, sparsity_H=0.1)),
                               rtol=1e-8, atol=1e-12)
    assert np.isfinite(served.inverse_transform(H)).all()


def test_cli_export_error_exits_1(tmp_path, capsys, load_on_cpu):
    m = tnmf_tpu.TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3), seed=0, dtype='float64')
    m.fit(_data(), n_iterations=1)
    ckpt = str(tmp_path / 'w_only.npz')
    m.save(ckpt)  # W only: no sample geometry
    assert main(['export', ckpt, str(tmp_path / 'x')]) == 1
    assert 'sample_shape' in capsys.readouterr().err


@pytest.mark.parametrize('argv, item', [(['demo', '--headless'], '14d-ii'),
                                        (['example', 'quickstart'], '14d-ii'),
                                        (['bench'], '5')])
def test_unported_commands_exit_1(argv, item, capsys, monkeypatch):
    monkeypatch.setattr(subprocess, 'call', lambda *a, **k: pytest.fail('ran a script'))
    assert main(argv) == 1
    assert f'item {item})' in capsys.readouterr().err
