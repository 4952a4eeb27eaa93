"""The port's demos (``tnmf_tpu_torch.demos``) headless on the CPU, through
the streamlit shim with every widget at its default, in-process with the
demos' device pointed at the CPU (their default is the card), as
``tests/test_demos.py`` runs the JAX package's; a headless run without
matplotlib (the card's machine has none) that still computes every
reconstruction it would draw; and ``racoon_image`` equal to the JAX
package's."""

import sys

import matplotlib
matplotlib.use('Agg')

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from tnmf_tpu.utils import data_loading as jax_data_loading  # noqa: E402
from tnmf_tpu_torch import TransformInvariantNMF  # noqa: E402
from tnmf_tpu_torch.demos import demo_selector  # noqa: E402
from tnmf_tpu_torch.utils import demo, drawing  # noqa: E402
from tnmf_tpu_torch.utils.data_loading import racoon_image, synthetic_face  # noqa: E402

from .torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

DEMOS = ['1-D Synthetic Signals', '2-D Synthetic Signals', 'Test Image',
         'Image Inpainting (masked fit)', 'Hyperparameter Sweep (vmapped)']


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    """The demos' fits on the CPU, at the JAX demo tests' smoke settings."""
    monkeypatch.setattr(demo, 'DEVICE', 'cpu')
    monkeypatch.setenv('TNMF_TPU_SMOKE', '1')


def test_selector_names_the_jax_demos():
    assert list(demo_selector.DEMO_NAME_DICT) == DEMOS


@pytest.mark.parametrize('name', DEMOS)
def test_demo_headless(name):
    out = demo_selector.main(name)
    assert np.isfinite(out['energy']).all()
    import matplotlib.pyplot as plt
    plt.close('all')


def test_demo_without_matplotlib_computes_what_it_would_draw(monkeypatch, capsys):
    """matplotlib missing: the drawing is skipped, said once on stderr, and
    every atom's partial reconstruction is still computed."""
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    monkeypatch.setattr(drawing, '_said', [])
    calls = []
    partial = TransformInvariantNMF.R_partial
    monkeypatch.setattr(TransformInvariantNMF, 'R_partial',
                        lambda self, i: calls.append(i) or partial(self, i))
    out = demo_selector.main('1-D Synthetic Signals')
    assert np.isfinite(out['energy'])
    assert calls == [0, 1, 2]
    err = capsys.readouterr().err
    assert err.count('matplotlib is not installed') == 1


@pytest.fixture(scope='module')
def jax_face():
    """The JAX package's synthetic face in color, made once (seconds)."""
    return jax_data_loading.synthetic_face(gray=False)


@pytest.mark.parametrize('gray', [True, False])
def test_synthetic_face_is_the_jax_packages(gray, jax_face):
    """The port's copy, whose color image is made once per process, equals
    the JAX package's whole image; gray as ``synthetic_face`` makes it."""
    want = jax_face @ np.array([0.299, 0.587, 0.114]) if gray else jax_face
    np.testing.assert_array_equal(synthetic_face(gray), want)


@pytest.mark.parametrize('gray', [True, False])
@pytest.mark.parametrize('scale', [1, 0.25])
def test_racoon_image_is_the_jax_packages(gray, scale, jax_face, monkeypatch):
    """Both packages' ``racoon_image`` where no local scipy image lies: the
    JAX function's synthetic face from the fixture, the port's its own."""
    monkeypatch.setattr(jax_data_loading, 'synthetic_face', lambda gray: (
        jax_face @ np.array([0.299, 0.587, 0.114]) if gray else jax_face.copy()))
    img = racoon_image(gray=gray, scale=scale)
    np.testing.assert_array_equal(img, jax_data_loading.racoon_image(gray=gray, scale=scale))
    assert img.min() >= 0 and img.max() <= 1
    assert img.shape[:2] == tuple(int(scale * s) for s in (768, 1024))
