"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package, imports without nvcc, runs the plain versions for CPU tensors only,
refuses what it does not port yet with NotImplementedError, and runs the
strategies it has ported as the JAX package does."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import tnmf_tpu
import tnmf_tpu_torch
from tnmf_tpu_torch import engine
from tnmf_tpu_torch.kernels import _build, gw, inhibit, mu, mu_h
from tnmf_tpu_torch.ops.inhibition import inhibition_kernels
from tnmf_tpu_torch.ops.modes import ConvPlan

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / 'tnmf_tpu_torch'


def _run(code, env=None):
    return subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120, check=False)


def test_import_leaves_jax_out():
    code = ('import sys, tnmf_tpu_torch, tnmf_tpu_torch.engine, tnmf_tpu_torch.kernels.mu, '
            'tnmf_tpu_torch.kernels.gw, tnmf_tpu_torch.kernels.mu_h, '
            'tnmf_tpu_torch.kernels.inhibit, tnmf_tpu_torch.ops.inhibition, '
            'tnmf_tpu_torch.ops.fft, tnmf_tpu_torch.ops.dot, '
            'tnmf_tpu_torch.utils.data_loading, tnmf_tpu_torch.utils.signals, '
            'tnmf_tpu_torch.utils.atoms, tnmf_tpu_torch.utils.validation, '
            'tnmf_tpu_torch.utils.memory, tnmf_tpu_torch.utils.profiling, '
            'tnmf_tpu_torch.utils.pipeline, tnmf_tpu_torch.cli\n'
            'bad = sorted(m for m in sys.modules\n'
            '             if m.split(".")[0] in ("jax", "jaxlib", "tnmf_tpu"))\n'
            'print(bad)')
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == '[]'


def test_examples_and_demos_import_no_jax_and_no_plotting():
    """The examples, the demos and their utilities, in a fresh process, load
    no module of JAX or of the JAX package, and no matplotlib or streamlit
    module (both are optional; the card's machine has neither)."""
    from tnmf_tpu_torch.examples import EXAMPLES
    modules = ([f'tnmf_tpu_torch.examples.{name}' for name in EXAMPLES]
               + [f'tnmf_tpu_torch.demos.{name}' for name in (
                   'demo_selector', 'synthetic_signals', 'demo_image', 'demo_inpainting',
                   'demo_sweep')]
               + ['tnmf_tpu_torch.utils.demo', 'tnmf_tpu_torch.utils._st_shim',
                  'tnmf_tpu_torch.utils.drawing', 'tnmf_tpu_torch.cli'])
    code = ('import importlib, sys\n'
            f'for m in {modules!r}:\n'
            '    importlib.import_module(m)\n'
            'bad = sorted(m for m in sys.modules if m.split(".")[0] in\n'
            '             ("jax", "jaxlib", "tnmf_tpu", "matplotlib", "streamlit"))\n'
            'print(len(sys.modules), bad)')
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split(' ', 1)[1].strip() == '[]'


def test_sources_import_no_jax():
    """No module of the port names jax or the JAX package in an import."""
    for path in PKG.rglob('*.py'):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split('.')[0] not in ('jax', 'jaxlib', 'tnmf_tpu', 'triton'), \
                    f'{path}: imports {name}'


def test_kernel_modules_import_without_nvcc(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path))
    env.pop('CUDA_HOME', None)
    env.pop('CUDA_PATH', None)
    code = ('import tnmf_tpu_torch.kernels.mu, tnmf_tpu_torch.kernels.gw, '
            'tnmf_tpu_torch.kernels.inhibit as i, '
            'tnmf_tpu_torch.kernels.mu_h as k, tnmf_tpu_torch.kernels._build as b\n'
            'print(b._lib is None, k.mu_h.launches, i.inhibited_mu_h.launches)')
    proc = _run(code, env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ['True', '0', '0']


def test_build_flags_target_hopper():
    assert 'arch=compute_90a,code=sm_90a' in _build.NVCC_FLAGS
    names = {p.name for p in _build.SOURCE_DIR.glob('*.cu')}
    assert names == {'mu_ratio.cu', 'grad_w.cu', 'mu_h.cu', 'inhibited_mu_h.cu',
                     'hals_sweep.cu'}
    assert _build.library_path().parent == _build.BUILD_DIR
    assert 'tnmf_tpu_torch/_build/' in (ROOT / '.gitignore').read_text().split()


def _kernel_inputs(device):
    rng = np.random.default_rng(0)
    plan = ConvPlan.create('valid', (10, 9), (3, 2))
    T = plan.transform_shape
    E = tuple(t + a - 1 for t, a in zip(T, plan.atom_shape))

    def t(*shape):
        return torch.tensor(rng.random(shape), dtype=torch.float32, device=device)
    return plan, t(2, 2, *E), t(2, 2, *E), t(3, 2, 3, 2), t(2, 3, *T)


def _launches():
    return (mu.mu_ratio.launches, mu.mu_w.launches, gw.grad_w.launches, mu_h.mu_h.launches,
            inhibit.inhibited_mu_h.launches)


def test_cpu_tensors_take_plain_versions():
    plan, Vp, Rx, W, H = _kernel_inputs('cpu')
    before = _launches()
    assert torch.equal(mu.mu_ratio(W, W, W, 0.5), mu.mu_ratio_plain(W, W, W, 0.5))
    assert torch.equal(mu.mu_w(W, W, W, 0.5, 2), mu.mu_w_plain(W, W, W, 0.5, 2))
    X2 = torch.cat([Vp, Rx], dim=1)
    for a, b in zip(gw.grad_w(X2, H), gw.grad_w_plain(X2, H)):
        assert torch.equal(a, b)
    assert torch.equal(mu_h.mu_h(Vp, Rx, W, H, 0.1), mu_h.mu_h_plain(Vp, Rx, W, H, 0.1))
    ks = inhibition_kernels((1, 2))
    assert torch.equal(inhibit.inhibited_mu_h(H, H, H, ks, 0.1, 0.2, 0.1, use_cross=True),
                       inhibit.inhibited_mu_h_plain(H, H, H, ks, 0.1, 0.2, 0.1, use_cross=True))
    assert _launches() == before


def test_non_cpu_tensors_never_take_plain_versions():
    """A tensor off the CPU goes to the kernel or raises; here (meta
    tensors, no card) it raises before any build."""
    plan, Vp, Rx, W, H = _kernel_inputs('meta')
    with pytest.raises(ValueError, match='expected CUDA'):
        mu.mu_ratio(W, W, W, 0.5)
    with pytest.raises(ValueError, match='expected CUDA'):
        mu.mu_w(W, W, W, 0.5, 2)
    with pytest.raises(ValueError, match='expected CUDA'):
        gw.grad_w(torch.cat([Vp, Rx], dim=1), H)
    with pytest.raises(ValueError, match='expected CUDA'):
        mu_h.mu_h(Vp, Rx, W, H, 0.1)
    with pytest.raises(ValueError, match='expected CUDA'):
        inhibit.inhibited_mu_h(H, H, H, inhibition_kernels((1, 1)), 0.1, 0., 0.1)
    assert _build._lib is None


@pytest.mark.parametrize('backend', ['jax_fft', 'numpy_fft', 'pytorch_fft',
                                     'numpy_caching_fft'])
def test_fft_backend_runs_and_matches_jax(backend):
    """The fft backend names run the port's fft strategy (until item 8 they
    raised); the fit matches the JAX model's."""
    out = []
    for module, kw in ((tnmf_tpu_torch, dict(device='cpu', dtype=torch.float64)),
                       (tnmf_tpu, {})):
        nmf = module.TransformInvariantNMF(2, (3, 3), backend=backend, seed=0, **kw)
        nmf.fit(np.ones((1, 1, 8, 8)), n_iterations=1)
        out.append(nmf)
    assert out[0]._strategy == out[1]._strategy == 'fft'
    np.testing.assert_allclose(out[0].W, out[1].W, rtol=1e-10)
    np.testing.assert_allclose(out[0].H, out[1].H, rtol=1e-10)


@pytest.mark.parametrize('case', ['large atoms', 'plain NMF'])
def test_auto_large_atoms_and_plain_nmf_run(case):
    """'auto' picks fft for atoms above the direct-conv threshold, and a
    single transform (atoms as large as the samples, 'full') is plain NMF on
    the matmul strategy: both ran into NotImplementedError until item 8."""
    atom, V, mode = (((25, 25), np.ones((1, 1, 30, 30)), 'valid') if case == 'large atoms'
                     else ((4, 4), np.ones((3, 1, 4, 4)), 'full'))
    out = []
    for module, kw in ((tnmf_tpu_torch, dict(device='cpu', dtype=torch.float64)),
                       (tnmf_tpu, {})):
        nmf = module.TransformInvariantNMF(2, atom, reconstruction_mode=mode, seed=0, **kw)
        nmf.fit(V, n_iterations=1)
        out.append(nmf)
    assert out[0]._strategy == out[1]._strategy == ('fft' if case == 'large atoms' else 'dot')
    np.testing.assert_allclose(out[0].W, out[1].W, rtol=1e-10)
    np.testing.assert_allclose(out[0].H, out[1].H, rtol=1e-10)


def test_phased_is_not_ported():
    with pytest.raises(NotImplementedError, match='phased.*item 15'):
        engine.require_ported('phased')
    with pytest.raises(NotImplementedError, match='item 15'):
        engine.get_ops('phased')
    with pytest.raises(ValueError, match='unknown strategy'):
        engine.get_ops('fftw')
    assert [engine.get_ops(s).__name__.rsplit('.', 1)[1] for s in ('conv', 'fft', 'dot')] \
        == ['conv', 'fft', 'dot']


@pytest.mark.parametrize('kwargs', [
    dict(sparsity_W=0.1), dict(l2_W=0.1),
    dict(hals_inner=4), dict(solver='hals'),
    dict(max_subsamples=2, sparsity_W=0.1),
])
def test_unported_fit_arguments_raise(kwargs):
    """The HALS arguments (item 13, ported) through each method ``fit``
    dispatches to (``fit_batch``; ``fit_stream`` for ``max_subsamples``)
    do what the JAX package's do on a shift-invariant 'valid' problem: the
    same ``ValueError`` and message (``sparsity_W`` / ``l2_W`` under MU,
    HALS on a geometry it does not take), or a fit (``hals_inner`` alone,
    read only by HALS)."""
    outcomes = []
    for module, kw in ((tnmf_tpu_torch, dict(device='cpu', dtype=torch.float64)),
                       (tnmf_tpu, {})):
        nmf = module.TransformInvariantNMF(2, (3, 3), seed=0, **kw)
        try:
            nmf.fit(np.ones((1, 1, 8, 8)), n_iterations=1, **kwargs)
            outcomes.append(('ran', nmf.W))
        except ValueError as e:
            outcomes.append(('ValueError', str(e)))
    assert outcomes[0][0] == outcomes[1][0] == ('ran' if kwargs == dict(hals_inner=4)
                                                else 'ValueError')
    if outcomes[0][0] == 'ran':
        np.testing.assert_allclose(outcomes[0][1], outcomes[1][1], rtol=1e-10)
    else:
        assert outcomes[0][1] == outcomes[1][1]


def test_fit_arguments_at_jax_defaults_are_accepted():
    nmf = tnmf_tpu_torch.TransformInvariantNMF(2, (3, 3), device='cpu', beta_loss='frobenius',
                                               precision=None, init='host')
    nmf.fit(np.ones((1, 1, 8, 8)), n_iterations=1, inhibition_strength=0.,
            l2_H=0, mask=None, solver='mu', tol=None)
    assert nmf.n_iterations_ == 1


# 'atoms' is ported (tests/test_torch_mesh_atoms.py): 'both' waits for 14e-iii
@pytest.mark.parametrize('kwargs', [dict(shard_axis='spatial'), dict(shard_axis='both')])
def test_unported_constructor_arguments_raise(kwargs):
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        tnmf_tpu_torch.TransformInvariantNMF(2, (3, 3), device='cpu', **kwargs)


@pytest.mark.parametrize('precision', [None, 'default', 'high', 'highest'])
def test_precision_is_a_ported_constructor_argument(precision):
    """``precision`` is taken as the JAX class takes it (ROADMAP item 16)
    and reaches the fit's plan."""
    nmf = tnmf_tpu_torch.TransformInvariantNMF(2, (3, 3), device='cpu', precision=precision)
    nmf.fit(np.ones((1, 1, 8, 8)), n_iterations=1)
    assert nmf.get_params()['precision'] == nmf._plan.precision == precision


def test_minibatch_and_unknown_arguments():
    """``fit(batch_size=…)`` runs the minibatch driver (item 11), which
    takes no ``sparsity_W`` (a HALS penalty, item 13), as the JAX one takes
    none."""
    nmf = tnmf_tpu_torch.TransformInvariantNMF(2, (3, 3), device='cpu')
    nmf.fit(np.ones((4, 1, 8, 8)), batch_size=2, n_epochs=1)
    assert np.isfinite(nmf.W).all()
    with pytest.raises(TypeError, match='sparsity_W'):
        nmf.fit(np.ones((4, 1, 8, 8)), batch_size=2, sparsity_W=0.1)
    with pytest.raises(TypeError, match='unexpected keyword'):
        nmf.fit(np.ones((4, 1, 8, 8)), n_iterationz=2)
    with pytest.raises(ValueError, match='non-negative'):
        nmf.fit(-np.ones((1, 1, 8, 8)), n_iterations=1)
