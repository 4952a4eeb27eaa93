"""The port's examples (``tnmf_tpu_torch.examples``) against the JAX
package's (``examples/*.py``), on the CPU at their smoke settings: the
plain-NMF, serving, shift-invariant, transform and image examples
(``tests/test_torch_examples.py`` holds the others, and the rules: the JAX
example unedited and in-process, the port's ``run(smoke=True,
device='cpu')`` in the JAX example's dtype, figure by figure, float64
within rtol 1e-8 and float32 within 1e-3 plus the printed rounding).

Left out, because they cannot match: the wall times of
``shift_invariant_solvers``; of ``serving_deployment`` the memory planner's
table and the batch it suggests (the port's estimate has entries of its
own: the transients of its eager iteration and the caching allocator's
rounding), the checkpoint's and the artifact's paths and sizes (a
``torch.export`` program against a StableHLO one) and the artifact's
platforms."""

import numpy as np
import pytest
import torch

import tnmf_tpu
from tnmf_tpu.utils import data_loading as jax_data_loading
from tnmf_tpu_torch.examples import masked_inpainting
from tnmf_tpu_torch.utils.data_loading import synthetic_face

from .torch_examples import assert_figures, check_example, jax_lines
from .torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
_SERVING_LEFT_OUT = ('predicted fit footprint', 'strategy:', '  ', 'largest batch',
                     'checkpoint:', 'artifact:', 'artifact platforms:')

CASES = {
    'plain_nmf_solvers': dict(dtype=torch.float32, rtol=1e-3),
    'serving_deployment': dict(
        dtype=F64, rtol=1e-8,
        keep=lambda line: not line.lstrip('\n').startswith(_SERVING_LEFT_OUT)),
    'shift_invariant_decomposition': dict(dtype=F64, rtol=1e-8),
    'shift_invariant_solvers': dict(dtype=torch.float32, rtol=1e-3,
                                    drop=[(r'\([\d.]+ s\)', '(? s)')]),
    'transform_invariances': dict(dtype=F64, rtol=1e-8),
}


@pytest.mark.usefixtures('one_torch_thread')
@pytest.mark.parametrize('name', sorted(CASES))
def test_example_matches_jax(name, monkeypatch, capsys):
    assert check_example(name, monkeypatch, capsys, **CASES[name]) > 0


def test_masked_inpainting_matches_the_jax_calls(monkeypatch, capsys):
    """The JAX example, unedited and in-process, against the port's
    ``run(smoke=True, device='cpu')``, both in float32: the JAX example's
    image is float64 under the tests' x64 switch, and the port's float64
    run costs about 54 s on the CPU (torch's float64 convolutions take its
    slow path there).  So the JAX ``racoon_image`` is wrapped to return its
    image in float32, the dtype the example runs in on a TPU and the port's
    run on the card, and the example's own iterations, mask and models
    run as it has them.  Its printed lines against the port's figure by
    figure (rtol 1e-3 plus the printed rounding), then each MSE at the
    missing pixels, computed from the reconstructions the example's models
    return (``inverse_transform``, recorded), within rtol 1e-3 of the
    port's.  The JAX image is made from the port's synthetic face, made
    once per process (the two are equal: ``tests/test_torch_demos.py``)."""
    monkeypatch.setattr(jax_data_loading, 'synthetic_face', synthetic_face)
    racoon = jax_data_loading.racoon_image
    monkeypatch.setattr(jax_data_loading, 'racoon_image',
                        lambda *a, **k: racoon(*a, **k).astype(np.float32))
    recs, inverse = [], tnmf_tpu.TransformInvariantNMF.inverse_transform

    def recorded(self, *a, **k):
        out = inverse(self, *a, **k)
        recs.append(np.clip(np.asarray(out)[0, 0], 0, 1))
        return out
    monkeypatch.setattr(tnmf_tpu.TransformInvariantNMF, 'inverse_transform', recorded)
    jax = jax_lines('masked_inpainting', monkeypatch, capsys)
    port = masked_inpainting.run(smoke=True, device='cpu', dtype=torch.float32)
    assert assert_figures(masked_inpainting.lines(port), jax, 1e-3) == 4
    img = racoon(gray=True, scale=0.25).astype(np.float32)
    miss = np.random.default_rng(0).random(img.shape) <= masked_inpainting.MISSING
    assert len(recs) == 2
    for name, rec in zip(('masked fit', 'unmasked fit'), recs):
        mse = float(np.mean((rec[miss] - img[miss]) ** 2))
        np.testing.assert_allclose(port['mse'][name], mse, rtol=1e-3)
