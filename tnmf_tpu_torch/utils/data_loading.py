"""The test images (NumPy only).

Copies of :func:`tnmf_tpu.utils.data_loading.synthetic_face` and
``racoon_image``, so the port can build the repository's golden 2-D fixture
and the examples' and demos' image without importing JAX.
"""

from __future__ import annotations

import bz2
import functools
from pathlib import Path
from typing import Optional

import numpy as np

_FACE_SHAPE = (768, 1024)


def synthetic_face(gray: bool = True) -> np.ndarray:
    """Deterministic smooth multi-scale test image in [0, 1].

    Built from a fixed-seed random Fourier series (a 1/f-like spectrum), so
    it has the long-range correlations of a natural photo without any data
    dependency.  Independent of the global NumPy RNG state.  The color
    image is made once per process (seconds on a CPU); each call returns a
    new array.
    """
    rgb = _synthetic_rgb()
    if gray:
        return rgb @ np.array([0.299, 0.587, 0.114])
    return rgb.copy()


@functools.lru_cache(maxsize=1)
def _synthetic_rgb() -> np.ndarray:
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
    return np.stack(channels, axis=-1)


def _local_face(gray: bool) -> Optional[np.ndarray]:
    """``scipy.datasets.face(gray)`` where its file already lies in pooch's
    cache, decoded as scipy decodes it; None otherwise.  Never downloads:
    ``scipy.datasets.face`` fetches a missing file from the network."""
    try:
        import pooch
        path = Path(pooch.os_cache('scipy-data')) / 'face.dat'
    except Exception:
        return None
    if not path.is_file():
        return None
    face = np.frombuffer(bz2.decompress(path.read_bytes()), dtype='uint8').reshape((768, 1024, 3))
    if gray:
        face = (0.21 * face[:, :, 0] + 0.71 * face[:, :, 1]
                + 0.07 * face[:, :, 2]).astype('uint8')
    return face


def racoon_image(gray: bool = True, scale: float = 1.) -> np.ndarray:
    """The raccoon test photo (if available offline) or its synthetic
    stand-in, rescaled by ``scale`` and normalized to [0, 1].

    The JAX package's attempts in its order: the local scipy image, then
    :func:`synthetic_face`; PIL's resize, then a strided subsample.  Keeps
    the reference's name/signature (including its spelling).
    """
    try:
        img = _local_face(gray)
        img = synthetic_face(gray) if img is None else np.asarray(img, dtype=float) / 255
    except Exception:
        img = synthetic_face(gray)
    if scale != 1.:
        try:
            from PIL import Image
            pil = Image.fromarray(np.uint8(np.clip(img, 0, 1) * 255))
            pil = pil.resize([int(scale * s) for s in pil.size])
            img = np.asarray(pil, dtype=float) / 255
        except Exception:
            step = max(1, int(round(1 / scale)))
            img = img[::step, ::step]
    return img
