"""The port's ``precision`` (tnmf_tpu_torch.ops.precision) against the JAX
package's, on the CPU: the mapping of each level to the card's settings,
the pins (restoring the caller's settings, nested and across threads),
the constructor and the sklearn protocol, fits at every level on every
strategy and solver against JAX in float64 (JAX on the CPU ignores the
level, and so does the port there: every level is bit-equal to None), the
TF32 rounding of the one-pass routes' plain versions against NumPy bit
arithmetic, those plain versions against today's on pre-rounded operands,
the level reaching K2's and K3's launches and the CUDA serving program, and
the serving artifact's recorded level."""

import contextlib
import json
import struct
import threading
import types

import numpy as np
import pytest
import torch

import tnmf_tpu
import tnmf_tpu_torch
from tnmf_tpu_torch import MiniBatchAlgorithm, engine, load_serving, serving
from tnmf_tpu_torch.kernels import _build, gw, mu_h
from tnmf_tpu_torch.ops import conv, precision
from tnmf_tpu_torch.ops.modes import ConvPlan

from .fake_cuda import cuda_programs

F64 = torch.float64
TOL = dict(rtol=1e-8, atol=1e-12)
LEVELS = (None, 'default', 'high', 'highest')
CPU = dict(device='cpu')


@contextlib.contextmanager
def caller_settings(matmul: str, cudnn_tf32: bool):
    """The caller's process settings inside the block, the test's own back
    after it."""
    saved = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision(matmul)
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


def current() -> tuple:
    return torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32


# ------------------------------------------------------------ the mapping

@pytest.mark.parametrize('level', LEVELS)
def test_the_mapping(level):
    """TF32 (one pass on K2 and K3) for 'default' and 'high' on float32
    CUDA tensors; full float32 (3xTF32) for None and 'highest', on the CPU
    and for float64 at every level."""
    tf32 = level in ('default', 'high')
    want = precision.Settings(cudnn_tf32=tf32, matmul='high' if tf32 else 'highest',
                              passes=1 if tf32 else 3)
    assert precision.settings(level, 'cuda') == want
    assert precision.settings(level, torch.device('cuda', 0)) == want
    full = precision.Settings(cudnn_tf32=False, matmul='highest', passes=3)
    assert precision.settings(level, 'cpu') == full
    assert precision.settings(level, 'cuda', torch.float64) == full


@pytest.mark.parametrize('level', LEVELS)
@pytest.mark.parametrize('caller', [('highest', False), ('high', True), ('medium', True)])
def test_pins_override_and_restore_the_callers_settings(level, caller):
    """Each pin sets its level's settings whatever the caller set, both
    ways, and gives the caller's back, nested inside another level too."""
    tf32 = level in ('default', 'high')
    mine = ('high' if tf32 else 'highest', tf32)
    with caller_settings(*caller):
        with precision.pinned(level, 'cuda'):
            assert current() == mine
            with precision.pinned('highest' if tf32 else 'default', 'cuda'):
                assert current() == (('highest', False) if tf32 else ('high', True))
            assert current() == mine
            with precision.convolution_pin(None, 'cuda'):
                assert current() == (mine[0], False)
            assert current() == mine
        assert current() == caller
        with precision.matmul_pin(level, 'cuda'):
            assert current() == (mine[0], caller[1])
        with precision.convolution_pin(level, 'cuda'):
            assert current() == (caller[0], tf32)
        with precision.pinned(level, 'cpu'):
            assert current() == ('highest', False)
        assert current() == caller


def test_pins_restore_on_error():
    with caller_settings('medium', True):
        with pytest.raises(RuntimeError):
            with precision.pinned(None, 'cuda'):
                raise RuntimeError
        assert current() == ('medium', True)


def test_pins_of_two_threads_do_not_interleave():
    """A pin holds the settings for its thread's whole block: another
    thread's pin waits for it to close, so neither sees the other's level,
    and the caller's settings come back after both."""
    opened, seen, errors = threading.Event(), {}, []

    def first():
        try:
            with precision.pinned('default', 'cuda'):
                opened.set()
                for _ in range(50):  # the second thread tries to pin meanwhile
                    seen.setdefault('first', set()).add(current())
                    threading.Event().wait(0.002)
        except BaseException as e:  # pragma: no cover - reported below
            errors.append(e)

    def second():
        opened.wait()
        with precision.pinned(None, 'cuda'):
            seen['second'] = {current()}

    with caller_settings('medium', True):
        threads = [threading.Thread(target=first), threading.Thread(target=second)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        assert seen == {'first': {('high', True)}, 'second': {('highest', False)}}
        assert current() == ('medium', True)


# --------------------------------------------------- constructor, protocol

@pytest.mark.parametrize('level', ['bogus', 'HIGH', 1, 'tensorfloat32'])
def test_other_values_raise_the_jax_error(level):
    """A value outside the four raises the JAX package's ``ValueError``,
    with its text, where a fit builds its plan."""
    V = np.random.default_rng(0).random((2, 1, 8, 8))
    messages = []
    for module, kw in ((tnmf_tpu, {}), (tnmf_tpu_torch, CPU)):
        nmf = module.TransformInvariantNMF(2, (3, 3), precision=level, **kw)
        with pytest.raises(ValueError) as info:
            nmf.fit(V, n_iterations=1)
        messages.append(str(info.value))
    assert messages[0] == messages[1]
    with pytest.raises(ValueError, match='precision must be'):
        precision.settings(level, 'cuda')


@pytest.mark.parametrize('level', LEVELS)
def test_protocol_keeps_the_level(level):
    from sklearn.base import clone
    nmf = tnmf_tpu_torch.TransformInvariantNMF(2, (3, 3), precision=level, **CPU)
    assert nmf.get_params()['precision'] == level
    assert clone(nmf).get_params()['precision'] == level
    other = 'high' if level != 'high' else None
    assert nmf.set_params(precision=other).get_params()['precision'] == other
    mb = tnmf_tpu_torch.MiniBatchTransformInvariantNMF(2, (3, 3), batch_size=2,
                                                       precision=level, **CPU)
    assert mb.get_params()['precision'] == clone(mb).get_params()['precision'] == level


def test_load_takes_the_level(tmp_path):
    V = np.random.default_rng(1).random((2, 1, 10, 10))
    nmf = tnmf_tpu_torch.TransformInvariantNMF(2, (3, 3), dtype=F64, **CPU)
    nmf.fit(V, n_iterations=2)
    nmf.save(str(tmp_path / 'ckpt.npz'), include_H=True)
    loaded = tnmf_tpu_torch.TransformInvariantNMF.load(str(tmp_path / 'ckpt.npz'),
                                                       precision='default', **CPU)
    assert loaded.get_params()['precision'] == loaded._plan.precision == 'default'


# ----------------------------------------------- fits against JAX in float64

# (constructor keywords, data shape, atom shape, fit keywords)
FITS = {
    'conv': (dict(backend='jax_conv'), (3, 2, 14, 13), (4, 3),
             dict(sparsity_H=0.1, inhibition_strength=0.1)),
    'fft': (dict(backend='jax_fft'), (3, 2, 14, 13), (4, 3), dict(sparsity_H=0.1)),
    'dot': (dict(reconstruction_mode='full'), (6, 1, 20), (20,), dict(sparsity_H=0.1)),
    'hals plain': (dict(reconstruction_mode='full'), (6, 1, 20), (20,),
                   dict(solver='hals', sparsity_H=0.05)),
    'hals full': (dict(reconstruction_mode='full'), (2, 1, 12, 11), (3, 3),
                  dict(solver='hals', sparsity_H=0.05)),
    'minibatch': (dict(backend='jax_conv'), (6, 1, 12, 12), (3, 3),
                  dict(batch_size=2, n_epochs=2, algorithm='ASAG_MU', sag_lambda=0.5)),
}


def _fit(module, case, level, dtype=F64, seed=3):
    kw, shape, A, fit = FITS[case]
    fit = dict(fit)
    if 'algorithm' in fit:
        fit['algorithm'] = module.MiniBatchAlgorithm[fit['algorithm']]
    V = np.random.default_rng(seed).random(shape)
    extra = dict(dtype=dtype, **CPU) if module is tnmf_tpu_torch else {}
    np.random.seed(seed)
    nmf = module.TransformInvariantNMF(3, A, precision=level, **kw, **extra)
    if 'batch_size' in fit:
        nmf.fit_minibatches(V, **fit)
    else:
        nmf.fit(V, n_iterations=3, **fit)
    H = nmf.transform(V[:2], n_iterations=2, sparsity_H=0.1) if case == 'conv' else None
    return nmf, H


@pytest.mark.parametrize('level', LEVELS)
@pytest.mark.parametrize('case', sorted(FITS))
def test_fits_match_jax_at_each_level(case, level):
    jm, jH = _fit(tnmf_tpu, case, level)
    pm, pH = _fit(tnmf_tpu_torch, case, level)
    assert pm._plan.precision == level
    np.testing.assert_allclose(pm.W, np.asarray(jm.W), **TOL)
    np.testing.assert_allclose(pm.H, np.asarray(jm.H), **TOL)
    if jH is not None:
        np.testing.assert_allclose(pH, np.asarray(jH), **TOL)


@pytest.mark.parametrize('case', sorted(FITS))
def test_every_level_is_none_on_the_cpu(case):
    """On the CPU every level runs full float32: bit-equal to None."""
    want, want_H = _fit(tnmf_tpu_torch, case, None, torch.float32)
    for level in LEVELS[1:]:
        got, got_H = _fit(tnmf_tpu_torch, case, level, torch.float32)
        np.testing.assert_array_equal(got.W, want.W)
        np.testing.assert_array_equal(got.H, want.H)
        if want_H is not None:
            np.testing.assert_array_equal(got_H, want_H)


def test_a_fit_leaves_the_callers_settings():
    with caller_settings('medium', True):
        _fit(tnmf_tpu_torch, 'fft', 'default', torch.float32)
        _fit(tnmf_tpu_torch, 'hals plain', 'highest', torch.float32)
        assert current() == ('medium', True)


# ------------------------------------------------------- the TF32 rounding

def _tf32_numpy(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest, ties away from zero, to 10 mantissa bits, by
    float64 arithmetic on the value (not its bits): the quantum of |x|'s
    binade (of the subnormal range below 2**-126) times the rounded count."""
    x64 = x.astype(np.float64)
    mag = np.abs(x64)
    e = np.floor(np.log2(np.where(mag > 0, mag, 1.0)))
    q = np.exp2(np.maximum(e, -126.0) - 10.0)
    r = np.sign(x64) * np.floor(mag / q + 0.5) * q
    with np.errstate(over='ignore'):  # past the largest float32: infinity
        return np.where(np.isfinite(x64), r, x64).astype(np.float32)


def test_round_tf32_against_numpy():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2 ** 32, size=200000, dtype=np.uint64).astype(np.uint32)
    x = bits.view(np.float32)
    x = x[np.isfinite(x)]
    # ties: the 13 dropped bits exactly half, in normal and subnormal values
    ties = (rng.integers(0, 2 ** 19, size=4000, dtype=np.uint64).astype(np.uint32) << 13) | 0x1000
    specials = np.array([0.0, -0.0, 1.0, -1.0, 1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11,
                         np.finfo(np.float32).tiny, np.finfo(np.float32).max,
                         -np.finfo(np.float32).max, 2.0 ** -140, -(2.0 ** -149)], np.float32)
    x = np.concatenate([x, ties.view(np.float32), -np.abs(ties.view(np.float32)), specials])
    x = x[np.isfinite(x)]
    got = precision.round_tf32(torch.from_numpy(x)).numpy()
    want = _tf32_numpy(x)
    finite = np.isfinite(want)  # the largest values round up to infinity
    np.testing.assert_array_equal(got[finite], want[finite])
    assert np.isinf(got[~finite]).all() and (np.sign(got[~finite]) == np.sign(x[~finite])).all()
    assert (got.view(np.uint32) & 0x1FFF == 0).all()
    # bit arithmetic: the magnitude plus half the dropped bits' weight, truncated
    u = x.view(np.uint32)
    np.testing.assert_array_equal(got.view(np.uint32), (u + 0x1000) & 0xFFFFE000)
    # ties go away from zero; subnormals keep multiples of 2**-136 (the tie
    # 2**-137 rounds up to it, 2**-138 down to 0)
    assert precision.round_tf32(torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11)])).tolist() == [
        1 + 2 ** -10, -(1 + 2 ** -10)]
    assert precision.round_tf32(torch.tensor(
        [2.0 ** -136, 3 * 2.0 ** -136, 2.0 ** -137, 2.0 ** -138])).tolist() == [
        2.0 ** -136, 3 * 2.0 ** -136, 2.0 ** -136, 0.0]


def test_round_tf32_keeps_nan_and_infinities():
    x = torch.tensor([float('nan'), float('inf'), -float('inf'), 1.5])
    x = torch.cat([x, torch.tensor([0x7F800001], dtype=torch.int32).view(torch.float32)])
    got = precision.round_tf32(x)
    assert torch.isnan(got[0]) and torch.isnan(got[4])
    assert got[1:4].tolist() == [float('inf'), -float('inf'), 1.5]
    with pytest.raises(TypeError):
        precision.round_tf32(x.double())


# --------------------------------------- the one-pass routes' plain versions

def _k3_inputs(seed=0, extra=True):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.rand(s, generator=g)  # noqa: E731
    return (r(2, 2, 13, 11), r(2, 2, 13, 11), r(3, 2, 4, 3), r(2, 3, 10, 9), 0.1,
            r(2, 3, 10, 9) if extra else None)


def test_mu_h_one_pass_plain_is_the_plain_version_on_rounded_operands():
    Vp, Rx, W, H, d, pe = _k3_inputs()
    rounded = [precision.round_tf32(t) for t in (Vp, Rx, W)]
    want = mu_h.mu_h_plain(*rounded, H, d, pe)
    assert torch.equal(mu_h.mu_h_plain(Vp, Rx, W, H, d, pe, 1), want)
    # CPU tensors run the plain version of the pass count they are given
    assert torch.equal(mu_h.mu_h(Vp, Rx, W, H, d, pe, 1), want)
    assert torch.equal(mu_h.mu_h(Vp, Rx, W, H, d, pe), mu_h.mu_h_plain(Vp, Rx, W, H, d, pe))
    assert not torch.equal(want, mu_h.mu_h_plain(Vp, Rx, W, H, d, pe))
    with pytest.raises(ValueError, match='passes'):
        mu_h.mu_h(Vp, Rx, W, H, d, pe, 2)


def test_grad_w_one_pass_plain_is_the_plain_version_on_rounded_operands():
    g = torch.Generator().manual_seed(1)
    plan = ConvPlan.create('valid', (10, 9), (4, 3))
    X2 = torch.rand((2, 4, 16, 13), generator=g)
    H = torch.rand((2, 3) + plan.transform_shape, generator=g)
    want = gw.grad_w_plain(precision.round_tf32(X2), precision.round_tf32(H))
    for got in (gw.grad_w_plain(X2, H, 1), gw.grad_w(X2, H, 1)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(gw.grad_w(X2, H),
                                                 gw.grad_w_plain(X2, H)))
    with pytest.raises(ValueError, match='passes'):
        gw.grad_w(X2, H, 2)


# --------------------------------------- the level reaching K2's and K3's launches

class _Recorder:
    """A kernel library that records its calls."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture(name='meta_launch')
def fixture_meta_launch(monkeypatch):
    """The wrappers launch on meta tensors (stand-ins for CUDA ones) into a
    recording library, on an H100's 132 SMs."""
    lib = _Recorder()
    props = type('Props', (), {'multi_processor_count': 132})()
    monkeypatch.setattr(_build, 'library', lambda: lib)
    monkeypatch.setattr(_build, 'check_inputs', lambda *a, **k: None)
    monkeypatch.setattr(_build, 'stream_of', lambda t: 0)
    monkeypatch.setattr(torch.cuda, 'device', lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, 'get_device_properties', lambda d: props)
    for wrapper in (gw.grad_w, mu_h.mu_h):  # from 0; the counts come back after the test
        for count in ('launches', 'one_pass_launches'):
            monkeypatch.setattr(wrapper, count, 0)
    return lib


@pytest.mark.parametrize('passes', [1, 3])
def test_mu_h_launches_its_passes(passes, meta_launch):
    """The pass count reaches K3's geometry array (its last entry) and the
    one-pass route stages less shared memory (no small halves)."""
    Vp, Rx, W, H, d, _ = (t.to('meta') if isinstance(t, torch.Tensor) else t
                          for t in _k3_inputs(extra=False))
    mu_h.mu_h(Vp, Rx, W, H, d, None, passes)
    (name, args), = meta_launch.calls
    assert name == 'tnmf_mu_h_mma' and list(args[14])[-1] == passes
    assert (mu_h.mu_h.launches, mu_h.mu_h.one_pass_launches) == (1, passes == 1)
    one, three = (mu_h._geometry(64, 16, 1, 248, 248, 9, 9, 132, True, mu_h._ROUTES, p)
                  for p in (1, 3))
    assert one['smem_bytes'] < three['smem_bytes'] and one['passes'] == 1


@pytest.mark.parametrize('level', LEVELS)
def test_the_engine_picks_the_plans_passes(level):
    """The engine hands K2 and K3 its plan's level's pass count for the
    tensors' device and dtype: one pass at a TF32 level on float32 CUDA
    tensors, three elsewhere."""
    plan = ConvPlan.create('valid', (10, 9), (4, 3), precision=level)

    def like(device, dtype=torch.float32):
        return types.SimpleNamespace(device=torch.device(device), dtype=dtype)
    assert engine._passes(plan, like('cuda')) == (1 if level in ('default', 'high') else 3)
    assert engine._passes(plan, like('cpu')) == engine._passes(plan, like('cuda', F64)) == 3


@pytest.mark.parametrize('passes', [1, 3])
def test_grad_w_launches_its_passes(passes, meta_launch):
    """The pass count reaches K2's geometry array (its last entry); the
    one-pass split layout holds two planes, 3xTF32's three."""
    plan = ConvPlan.create('valid', (10, 9), (4, 3))
    X2 = torch.empty((2, 4, 16, 13), device='meta')
    H = torch.empty((2, 3) + plan.transform_shape, device='meta')
    gw.grad_w(X2, H, passes)
    (name, args), = meta_launch.calls
    geometry = list(args[11])
    assert name == 'tnmf_grad_w' and geometry[-2:] == [2 if passes == 1 else 3, passes]
    assert (gw.grad_w.launches, gw.grad_w.one_pass_launches) == (1, passes == 1)


@pytest.mark.parametrize('level', LEVELS)
def test_cuda_program_bakes_k3s_passes(level):
    """The conv serving program traced on (fake) CUDA tensors calls
    ``tnmf::mu_h`` with its level's pass count."""
    m = tnmf_tpu_torch.TransformInvariantNMF(3, (4, 3), h_init='correlate', precision=level,
                                             **CPU)
    m.set_dictionary(np.random.default_rng(0).random((3, 1, 4, 3)))
    recipe = serving._recipe(m, sparsity_H=0.1, inhibition_strength=0.,
                             cross_atom_inhibition_strength=0., l2_H=0., input_dtype=None,
                             sample_shape=(12, 10), solver='mu')
    program = cuda_programs(recipe)['transform']
    passes = [node.args[6] if len(node.args) > 6 else node.kwargs.get('passes', 3)
              for gm in program.graph_module.modules() if isinstance(gm, torch.fx.GraphModule)
              for node in gm.graph.nodes
              if node.op == 'call_function' and str(node.target).startswith('tnmf.mu_h')]
    assert passes == [1 if level in ('default', 'high') else 3]


# ------------------------------------------------------------------ serving

@pytest.fixture(scope='module', name='served')
def fixture_served():
    V = np.random.default_rng(5).random((3, 1, 12, 10)).astype(np.float32)
    nmf = tnmf_tpu_torch.TransformInvariantNMF(3, (4, 3), seed=1, precision='default',
                                               h_init='correlate', **CPU)
    nmf.fit(V, n_iterations=3)
    return nmf, V, nmf.export_serving(n_iterations=3, sparsity_H=0.1)


def test_artifact_records_its_level(served):
    nmf, V, blob = served
    loaded = load_serving(blob)
    assert loaded.header['precision'] == loaded.precision == 'default'
    with caller_settings('medium', True):
        H = loaded.transform(V)
        assert current() == ('medium', True)
    np.testing.assert_array_equal(H, nmf.transform(V, n_iterations=3, sparsity_H=0.1))


def test_artifact_without_the_key_loads_as_none(served):
    """A file written before the port took ``precision`` (no header key)
    loads at None and computes as it did."""
    nmf, V, blob = served
    (n,) = struct.unpack('<I', blob[8:12])
    header = json.loads(blob[12:12 + n])
    del header['precision']
    head = json.dumps(header).encode()
    old = blob[:8] + struct.pack('<I', len(head)) + head + blob[12 + n:]
    loaded = load_serving(old)
    assert 'precision' not in loaded.header and loaded.precision is None
    np.testing.assert_array_equal(loaded.transform(V), load_serving(blob).transform(V))


def test_minibatch_model_runs_each_level():
    V = np.random.default_rng(2).random((4, 1, 10, 10))
    for level in LEVELS:
        nmf = tnmf_tpu_torch.MiniBatchTransformInvariantNMF(
            2, (3, 3), batch_size=2, n_epochs=1, algorithm=MiniBatchAlgorithm.ASG_MU,
            precision=level, dtype=F64, seed=0, **CPU)
        nmf.fit(V)
        assert nmf._plan.precision == level and np.isfinite(nmf.W).all()


def test_conv_primitives_take_an_optional_plan():
    """Without a plan (the kernels' plain versions) the conv primitives run
    at None; with one, at its level: the same values on the CPU."""
    g = torch.Generator().manual_seed(4)
    Xp, W = torch.rand((2, 2, 9, 8), generator=g), torch.rand((3, 2, 4, 3), generator=g)
    plan = ConvPlan.create('valid', (6, 6), (4, 3), precision='high')
    assert torch.equal(conv.corr_H(Xp, W), conv.corr_H(Xp, W, plan))
    H = torch.rand((2, 3, 6, 6), generator=g)
    assert torch.equal(conv.corr_W(Xp, H), conv.corr_W(Xp, H, plan))
