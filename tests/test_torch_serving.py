"""The port's serving artifact (``tnmf_tpu_torch.serving``, ``torch.export``).

Against the JAX package: both packages' artifacts, exported from one
dictionary (W-only models with ``sample_shape``), encode one seeded batch
to within rtol 1e-8 in float64 on the CPU, on conv, fft, dot, inhibited,
``l2_H``, a transform group and ``beta_loss=1`` (HALS:
``test_torch_serving_hals.py``).  Against the port's own ``transform``:
exact on the CPU in float32 (a symbolic batch served at sizes 1, 3 and 5,
the runtime count, a fixed batch and its shape guard, the decoder, a W-only
checkpoint, ``input_dtype``, ``warmup``, tensor inputs) and the guards.
The CUDA programs, traced under a ``FakeTensorMode`` (:mod:`.fake_cuda`),
call the kernels' custom operators in their loop and no plain version; the
four operators pass ``torch.library.opcheck``.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import tnmf_tpu
import tnmf_tpu_torch
from tnmf_tpu_torch import load_serving, serving
from tnmf_tpu_torch.kernels import ops
from tnmf_tpu_torch.kernels.hals import hals_sweep_plain
from tnmf_tpu_torch.kernels.inhibit import inhibited_mu_h_plain
from tnmf_tpu_torch.kernels.mu import mu_ratio_plain
from tnmf_tpu_torch.kernels.mu_h import mu_h_plain
from tnmf_tpu_torch.ops.inhibition import inhibition_kernels

from .fake_cuda import cuda_programs, kernel_ops, loops

TOL = dict(rtol=1e-8, atol=1e-12)
CPU = dict(device='cpu')


def _data(n=3, shape=(12, 10), channels=1, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((n, channels) + shape).astype(np.float32)


def _fitted(mode='valid', **kw):
    m = tnmf_tpu_torch.TransformInvariantNMF(n_atoms=3, atom_shape=(4, 3), seed=0,
                                             reconstruction_mode=mode, h_init='correlate',
                                             **CPU, **kw)
    m.fit(_data(), n_iterations=4)
    return m


@pytest.fixture(scope='module', name='model')
def fixture_model():
    return _fitted()


@pytest.fixture(scope='module', name='codec')
def fixture_codec(model, tmp_path_factory):
    """``(path, blob, served)``: the conv artifact with its decoder, written
    to a file and loaded from it."""
    path = str(tmp_path_factory.mktemp('serving') / 'codec.tnmfsrt')
    blob = model.export_serving(path=path, n_iterations=6, sparsity_H=0.1,
                                include_decoder=True)
    return path, blob, load_serving(path)


# ------------------------------------------------------------ against JAX

# (constructor keywords, sample shape, atom shape, export keywords)
JAX_CASES = {
    'conv': (dict(), (12, 10), (4, 3), dict(sparsity_H=0.1)),
    'fft': (dict(backend='jax_fft'), (12, 10), (4, 3), dict(sparsity_H=0.1)),
    'dot': (dict(reconstruction_mode='full'), (24,), (24,), dict(sparsity_H=0.05)),
    'inhibited': (dict(reconstruction_mode='circular', inhibition_range=2), (12, 10), (4, 3),
                  dict(sparsity_H=0.05, inhibition_strength=0.4,
                       cross_atom_inhibition_strength=0.2)),
    'l2_H': (dict(), (12, 10), (4, 3), dict(sparsity_H=0.05, l2_H=2.0)),
    'group': (dict(transform_type='shift+flip'), (12, 10), (3, 3), dict()),
    'beta1': (dict(beta_loss=1.0), (20,), (4,), dict()),
}


def jax_and_port(kw, S, A, export, seed=0, n_iterations=5, **extra):
    """``(jax_served, port_served, V)``: both packages' float64 artifacts of
    one seeded dictionary, installed with ``set_dictionary`` and exported
    for ``S``, and a seeded batch of 4."""
    rng = np.random.default_rng(seed)
    W = rng.random((3, 1) + A)
    V = rng.random((4, 1) + S) + (0.1 if kw.get('beta_loss') else 0.)
    served = []
    for package, dtype, more in ((tnmf_tpu, 'float64', {}), (tnmf_tpu_torch, torch.float64, CPU)):
        m = package.TransformInvariantNMF(3, A, dtype=dtype, h_init='correlate', **kw, **more)
        m.set_dictionary(W)
        served.append(package.load_serving(m.export_serving(
            sample_shape=S, n_iterations=n_iterations, **export, **extra)))
    return served[0], served[1], V


@pytest.mark.parametrize('case', sorted(JAX_CASES))
def test_artifact_matches_jax(case):
    jax_served, served, V = jax_and_port(*JAX_CASES[case])
    H = served.transform(V)
    want = np.asarray(jax_served.transform(V))
    assert H.shape == want.shape and H.dtype == np.float64
    np.testing.assert_allclose(H, want, **TOL)
    assert served.header['library'] == 'tnmf_tpu_torch'
    for key in ('input_shape', 'input_dtype', 'h_leading', 'n_atoms', 'n_transforms', 'mode',
                'atom_shape', 'sparsity_H', 'inhibition_strength',
                'cross_atom_inhibition_strength', 'l2_H', 'beta_loss', 'solver',
                'n_iterations'):
        assert served.header[key] == jax_served.header[key], key
    if case == 'group':  # H's (n, atoms, transforms, *shift) layout
        assert H.shape[:3] == (4, 3, 4)


def test_each_loader_refuses_the_others_artifacts(codec):
    m = tnmf_tpu.TransformInvariantNMF(3, (4, 3), h_init='correlate')
    m.set_dictionary(np.ones((3, 1, 4, 3)))
    with pytest.raises(ValueError, match='tnmf_tpu.load_serving'):
        load_serving(m.export_serving(sample_shape=(12, 10), n_iterations=1))
    with pytest.raises(ValueError, match='magic'):
        tnmf_tpu.load_serving(codec[1])
    with pytest.raises(ValueError, match='magic'):
        load_serving(b'not an artifact at all')


# ------------------------------------------------ against the port itself

def test_roundtrip_and_symbolic_batch(model, codec):
    path, blob, served = codec
    assert blob[:8] == serving._MAGIC
    with open(path, 'rb') as f:
        assert f.read() == blob
    assert served.header['input_shape'] == ['b', 1, 12, 10]
    for n in (1, 3, 5):
        V = _data(n=n, seed=n)
        np.testing.assert_array_equal(served(V), model.transform(V, n_iterations=6,
                                                                 sparsity_H=0.1))


def test_runtime_iteration_count(model, codec):
    served = load_serving(codec[1])  # from bytes
    V = _data(seed=5)
    for n in (1, 6, None):
        want = model.transform(V, n_iterations=6 if n is None else n, sparsity_H=0.1)
        np.testing.assert_array_equal(served.transform(V, n_iterations=n), want)


def test_header_metadata(codec):
    served = codec[2]
    h = served.header
    assert h['n_atoms'] == served.n_atoms == 3
    assert h['n_iterations'] == 6 and h['sparsity_H'] == 0.1
    assert h['mode'] == 'valid' and h['atom_shape'] == [4, 3]
    assert h['input_dtype'] == 'float32' and h['solver'] == 'mu'
    assert served.platforms == ('cpu',)
    assert set(h['sections']) == {'transform@cpu', 'inverse_transform@cpu'}


def test_decoder_section(model, codec):
    served = codec[2]
    H = served(_data(n=2, seed=17))
    np.testing.assert_array_equal(served.inverse_transform(H), model.inverse_transform(H))
    plain = load_serving(model.export_serving(n_iterations=2, batch_size=2))
    with pytest.raises(RuntimeError, match='decoder'):
        plain.inverse_transform(H)
    # the encoder-only artifact with a fixed batch, and its shape guard
    V2 = _data(n=2, seed=9)
    assert plain.header['input_shape'] == [2, 1, 12, 10]
    np.testing.assert_array_equal(plain(V2), model.transform(V2, n_iterations=2))
    with pytest.raises(ValueError, match='shape'):
        plain(_data(n=4, seed=9))
    with pytest.raises(ValueError, match='shape'):
        plain(_data(n=2, shape=(12, 11), seed=9))


def test_tensor_inputs_give_tensors(model, codec):
    served = codec[2]
    V = torch.as_tensor(_data(n=2, seed=19))
    H = served(V)
    assert isinstance(H, torch.Tensor) and H.device.type == 'cpu'
    np.testing.assert_array_equal(H.numpy(), served(V.numpy()))
    np.testing.assert_array_equal(served.inverse_transform(H).numpy(),
                                  model.inverse_transform(H))


def test_warmup(model, codec):
    served = load_serving(codec[1])
    assert served.warmup(batch_sizes=(1, 3)) is served
    V = _data(n=3, seed=41)
    np.testing.assert_array_equal(served(V), model.transform(V, n_iterations=6,
                                                             sparsity_H=0.1))


def test_export_from_w_only_checkpoint(model, tmp_path):
    ckpt = str(tmp_path / 'w_only.npz')
    model.save(ckpt)
    loaded = tnmf_tpu_torch.TransformInvariantNMF.load(ckpt, h_init='correlate', **CPU)
    with pytest.raises(RuntimeError, match='sample_shape'):
        loaded.export_serving()
    served = load_serving(loaded.export_serving(sample_shape=(12, 10), n_iterations=3,
                                                input_dtype='float64'))
    assert served.header['input_dtype'] == 'float64'
    V = _data(n=2, seed=23).astype(np.float64)
    H = served(V)
    assert H.dtype == np.float32  # computed in the model's dtype
    np.testing.assert_array_equal(H, model.transform(V, n_iterations=3))


def test_fp32_pins_hold_around_the_program(model, codec):
    """The artifact computes in full float32 under any caller setting, and
    gives the caller's setting back."""
    served = codec[2]
    V = _data(n=2, seed=29)
    want = served(V)
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision('medium')
    try:
        np.testing.assert_array_equal(served(V), want)
        assert torch.get_float32_matmul_precision() == 'medium'
    finally:
        torch.set_float32_matmul_precision(saved)


def test_guards(model):
    with pytest.raises(RuntimeError, match='fitted'):
        tnmf_tpu_torch.export_serving(tnmf_tpu_torch.TransformInvariantNMF(2, (3, 3), **CPU))
    with pytest.raises(ValueError, match='solver must be'):
        model.export_serving(solver='nope')
    with pytest.raises(ValueError, match='MU-only'):
        model.export_serving(solver='hals', inhibition_strength=0.1)
    with pytest.raises(ValueError, match='degenerate'):
        model.export_serving(solver='hals')
    with pytest.raises(ValueError, match='sparsity_H'):
        model.export_serving(sparsity_H=-1.)
    with pytest.raises(ValueError, match='platforms'):
        model.export_serving(platforms=('tpu',))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='card'):
            model.export_serving(platforms=('cuda', 'cpu'))


# ------------------------------------------------ the CUDA programs' graphs

# (constructor keywords, sample shape, atom shape, export keywords, operator)
CUDA_CASES = {
    'conv': (dict(), (12, 10), (4, 3), dict(sparsity_H=0.1), 'mu_h'),
    'fft': (dict(backend='jax_fft'), (12, 10), (4, 3), dict(sparsity_H=0.1), 'mu_ratio'),
    'dot': (dict(reconstruction_mode='full'), (24,), (24,), dict(sparsity_H=0.1), 'mu_ratio'),
    'inhibited': (dict(), (12, 10), (4, 3),
                  dict(inhibition_strength=0.1, cross_atom_inhibition_strength=0.05),
                  'inhibited_mu_h'),
}


def recipe_of(kw, S, A, export, solver='mu'):
    """The recipe of a float32 W-only model's artifact for ``S``."""
    m = tnmf_tpu_torch.TransformInvariantNMF(3, A, h_init='correlate', **kw, **CPU)
    m.set_dictionary(np.random.default_rng(0).random((3, 1) + A))
    full = dict(sparsity_H=0., inhibition_strength=0., cross_atom_inhibition_strength=0.,
                l2_H=0.)
    full.update(export)
    return serving._recipe(m, **full, input_dtype=None, sample_shape=S, solver=solver)


@pytest.mark.parametrize('case', sorted(CUDA_CASES))
def test_cuda_program_calls_the_kernels(case):
    """The CUDA program, traced without a card, runs one loop whose body
    calls the kernel's operator once per iteration, and no plain version
    (:func:`.fake_cuda.cuda_programs` fails on any)."""
    *args, op = CUDA_CASES[case]
    programs = cuda_programs(recipe_of(*args), include_decoder=case == 'conv')
    encoder = programs['transform']
    assert kernel_ops(encoder) == [op] and loops(encoder) == 1
    assert {str(t.device) for t in encoder.state_dict.values()} == {'cuda:0'}
    if case == 'conv':
        assert kernel_ops(programs['inverse_transform']) == []


# ------------------------------------------------------------ the operators

def _op_args():
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.rand(shape, generator=g)
    H = r(2, 3, 10, 9)
    taps = [torch.as_tensor(k, dtype=torch.float32) for k in inhibition_kernels((2, 3))]
    return {
        'mu_ratio': (ops.mu_ratio_op, (H, r(2, 3, 10, 9), r(2, 3, 10, 9), 0.1)),
        'mu_h': (ops.mu_h_op, (r(2, 1, 13, 11), r(2, 1, 13, 11), r(3, 1, 4, 3), H, 0.1,
                               r(2, 3, 10, 9))),
        'inhibited_mu_h': (ops.inhibited_mu_h_op, (H, r(2, 3, 10, 9), r(2, 3, 10, 9), taps,
                                                   0.2, 0.1, 0.1, True, True)),
        'hals_sweep': (ops.hals_sweep_op, (r(4, 20).T, r(4, 4) + torch.eye(4), r(20, 4),
                                           0.1, 0.05, 2)),
    }


#: each operator's plain version, called with the operator's arguments
PLAIN = {
    'mu_ratio': mu_ratio_plain, 'mu_h': mu_h_plain, 'hals_sweep': hals_sweep_plain,
    'inhibited_mu_h': lambda *a: inhibited_mu_h_plain(*a[:-2], use_same=a[-2],
                                                      use_cross=a[-1]),
}


def _fake(mode, args):
    return [mode.from_tensor(a) if isinstance(a, torch.Tensor)
            else [mode.from_tensor(t) for t in a] if isinstance(a, list) else a for a in args]


@pytest.mark.parametrize('name', sorted(PLAIN))
def test_operator(name):
    """``opcheck`` (schema, fake, autograd registration, AOT dispatch) on
    CPU inputs; the operator's output is its plain version's, bits and
    strides, and so are the fake's shape, dtype and strides."""
    op, args = _op_args()[name]
    torch.library.opcheck(op, args)
    out, want = op(*args), PLAIN[name](*args)
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    with FakeTensorMode() as mode:
        fake = op(*_fake(mode, args))
    for t in (out, fake):
        assert (t.shape, t.dtype, t.stride()) == (want.shape, want.dtype, want.stride())


def test_hals_sweep_fake_on_cuda_is_the_kernels_layout():
    """On a CUDA tensor K5's output takes X's layout (``torch.empty_like``):
    row-major for a row-major X, a transposed view for the W side's ``W^T``;
    the fake gives those strides."""
    with FakeTensorMode():
        X = torch.empty(20, 4, device='cuda')
        G = torch.empty(4, 4, device='cuda')
        out = ops.hals_sweep_op(X, G, X, 0.1, 0., 1)
        Xt = torch.empty(4, 20, device='cuda').t()
        out_t = ops.hals_sweep_op(Xt, G.t(), Xt, 0.1, 0., 1)
    assert out.shape == (20, 4) and out.stride() == (4, 1)
    assert out_t.shape == (20, 4) and out_t.stride() == (1, 20)
