"""The deterministic synthetic test image (NumPy only).

A copy of :func:`tnmf_tpu.utils.data_loading.synthetic_face`, so the port
can build the repository's golden 2-D fixture without importing JAX.
"""

from __future__ import annotations

import numpy as np

_FACE_SHAPE = (768, 1024)


def synthetic_face(gray: bool = True) -> np.ndarray:
    """Deterministic smooth multi-scale test image in [0, 1].

    Built from a fixed-seed random Fourier series (a 1/f-like spectrum), so
    it has the long-range correlations of a natural photo without any data
    dependency.  Independent of the global NumPy RNG state.
    """
    rng = np.random.default_rng(20260816)
    h, w = _FACE_SHAPE
    y = np.linspace(0, 2 * np.pi, h, endpoint=False)[:, None]
    x = np.linspace(0, 2 * np.pi, w, endpoint=False)[None, :]
    channels = []
    for _ in range(3):
        img = np.zeros((h, w))
        for ky in range(-4, 5):
            for kx in range(-4, 5):
                if kx == 0 and ky == 0:
                    continue
                amp = 1.0 / (kx * kx + ky * ky)
                phase = rng.uniform(0, 2 * np.pi)
                img += amp * np.cos(ky * y + kx * x + phase)
        img -= img.min()
        img /= img.max()
        channels.append(img)
    rgb = np.stack(channels, axis=-1)
    if gray:
        return rgb @ np.array([0.299, 0.587, 0.114])
    return rgb
