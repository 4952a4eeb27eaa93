"""The PyTorch port's command line (``tnmf_tpu_torch.cli``), on the CPU:
``export`` of a checkpoint the JAX package wrote, the case of
``tests/test_serving_export.py::test_cli_export``, serving H within 1e-8 of
the JAX model's ``transform`` in float64; the export's error path;
``example`` and ``demo`` launching the port's scripts (the subprocess call
captured), refusing unknown names, the mesh example of item 14e-ii and, without
streamlit, the interactive dashboard; ``bench`` refused with the item it
waits for.  The command exports the card's program; here ``main`` runs
in-process with the checkpoint's load pointed at the CPU (``chip_smoke.py``
phase 21 runs the export, and phase 22 ``example`` and ``demo --headless``,
as subprocesses on the card)."""

import os
import subprocess
import sys

import numpy as np
import pytest

import tnmf_tpu
from tnmf_tpu.cli import list_examples as jax_list_examples
from tnmf_tpu_torch import TransformInvariantNMF, load_serving
from tnmf_tpu_torch.cli import DEMO_NAMES, list_examples, main
from tnmf_tpu_torch.examples import EXAMPLES, MESH_EXAMPLES


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


@pytest.mark.parametrize('argv, item', [(['bench'], '5')])
def test_unported_commands_exit_1(argv, item, capsys, monkeypatch):
    monkeypatch.setattr(subprocess, 'call', lambda *a, **k: pytest.fail('ran a script'))
    assert main(argv) == 1
    assert f'item {item})' in capsys.readouterr().err


@pytest.fixture
def calls(monkeypatch):
    """``subprocess.call`` captured: the argument lists, each returning 0."""
    seen = []
    monkeypatch.setattr(subprocess, 'call', lambda args, **kw: seen.append((args, kw)) or 0)
    return seen


def test_examples_are_the_jax_packages_but_the_mesh_ones():
    assert list_examples() == sorted(EXAMPLES)
    assert set(jax_list_examples()) == set(EXAMPLES) | set(MESH_EXAMPLES)


@pytest.mark.parametrize('name', sorted(EXAMPLES))
def test_example_runs_the_ports_module(name, calls):
    assert main(['example', name]) == 0
    (args, kw), = calls
    assert args == [sys.executable, '-m', f'tnmf_tpu_torch.examples.{name}']
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert kw['env']['PYTHONPATH'].split(os.pathsep)[0] == root


def test_unknown_example_exits_1_with_the_list(calls, capsys):
    assert main(['example', 'quickstart']) == 1
    err = capsys.readouterr().err
    assert "unknown example 'quickstart'" in err
    assert all(name in err for name in EXAMPLES) and not calls


@pytest.mark.parametrize('name', MESH_EXAMPLES)
def test_mesh_example_exits_1_naming_item_14e(name, calls, capsys):
    assert main(['example', name]) == 1
    assert 'item 14e-ii)' in capsys.readouterr().err and not calls


def test_demo_without_streamlit_exits_1(calls, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, 'streamlit', None)
    assert main(['demo']) == 1
    assert 'streamlit is not installed; run with --headless' in capsys.readouterr().err
    assert not calls


@pytest.mark.parametrize('name', DEMO_NAMES)
def test_demo_headless_runs_the_ports_selector(name, calls):
    assert main(['demo', name, '--headless']) == 0
    (args, _), = calls
    assert args == [sys.executable, '-m', 'tnmf_tpu_torch.demos.demo_selector', name]


def test_demo_with_streamlit_serves_the_ports_selector(calls, monkeypatch):
    monkeypatch.setitem(sys.modules, 'streamlit', object())
    assert main(['demo']) == 0
    (args, _), = calls
    assert args[1:4] == ['-m', 'streamlit', 'run']
    assert args[4].endswith(os.path.join('tnmf_tpu_torch', 'demos', 'demo_selector.py'))
    assert args[5:] == ['--', '2-D Synthetic Signals']
